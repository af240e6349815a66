"""The harness the kernel sweeps with a `--parent` mode share
(`dsa_sweep`, `spattn_sweep`): the card's line, each checkout's
measurements in a process of its own, in turns on one card, and the rule
for a whole profiler trace (`whole_trace`), which chip_smoke.py reads
too.

A sweep module gives `measure()` (the measurements of the `fcd_tpu_torch`
on sys.path, as a JSON-able dict), `plans()` (its `--plans` mode) and a
printer of one measurement, and its `main` calls `main` here. The child
that measures a checkout loads the sweep module's own file and this file
with that checkout first on sys.path, so an older checkout is measured by
this checkout's code: this file stands in the child as
`fcd_tpu_torch.kernels._sweep`, and a sweep module imports it inside its
functions, not at its top (an older checkout's package is imported
first).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# run by the child: load this file and the sweep module from their files
# and print measure()'s result as the last line
_CHILD = """
import importlib.util, json, sys
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
load("fcd_tpu_torch.kernels._sweep", sys.argv[2])
print(json.dumps(load("sweep_measure", sys.argv[1]).measure()))
"""

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def whole_trace(fn, iters: int, tries: int = 5, cpu: bool = False):
    """(the device events of `iters` calls of fn, their wall seconds) from
    a whole trace (torch.profiler; `cpu`: host activity traced too). On the
    card the profiler sometimes records no event, or drops some, which
    would read as too little device time. So each try also traces one
    call, and the trace of `iters` calls is kept only when it holds each
    op `iters` times as often as that one call launched it; with `iters`
    1, each try takes one trace, kept when any earlier one agrees with it
    op for op (a train step's op count can differ by one from step to
    step). Fails after `tries` tries. The caller warms fn up first."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])

    def trace(n):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return [e for e in prof.events()
                if e.device_type == DeviceType.CUDA], wall

    seen = []
    for _ in range(tries):
        one = [Counter(e.name for e in trace(1)[0])] if iters > 1 else seen
        events, wall = trace(iters)
        got = Counter(e.name for e in events)
        if any(c and got == Counter({k: n * iters for k, n in c.items()})
               for c in one):
            if len(seen) > (iters == 1):
                print(f"  (the profiler dropped events or the calls' ops "
                      f"differed: {len(seen)} trace(s) taken again)")
            return events, wall
        seen.append(got)
    raise AssertionError(f"no whole trace of {iters} calls in {tries} tries "
                         f"(device ops a trace: "
                         f"{[sum(c.values()) for c in seen]})")


def measure_in(script: str, root: str) -> dict:
    """measure() of the sweep module at `script`, in a process of its own
    with the checkout `root` first on sys.path."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, script,
                           os.path.abspath(__file__)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"measuring {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def turns(parent, n: int) -> list:
    """(label, checkout) in the order they are measured: this checkout
    alone, or parent, this, this, parent, ... for n turns."""
    if not parent:
        return [("this", REPO)]
    pair = [("parent", os.path.abspath(parent)), ("this", REPO)]
    return [lab for i in range(n) for lab in (pair if i % 2 == 0
                                               else pair[::-1])]


def main(doc: str, script: str, plans, show, argv=None) -> int:
    """A sweep's command line: --parent DIR [--turns N], or --plans."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--parent", help="another checkout to compare with")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--plans", action="store_true",
                    help="time this checkout under every plan")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print(f"{os.path.basename(script)}: no CUDA device", file=sys.stderr)
        return 1
    line = card()
    print(f"card: {line}", flush=True)
    if args.plans:
        from fcd_tpu_torch.kernels import _build

        # every library before the first trace: a process that builds one
        # (nvcc) after it has read a trace gets empty traces from then on
        _build.build_all()
        plans()
    else:
        for label, root in turns(args.parent, args.turns):
            show(label, measure_in(script, root))
    print(f"card: {line}")
    return 0
