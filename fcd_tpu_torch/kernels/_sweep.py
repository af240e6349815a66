"""The harness the kernel sweeps with a `--parent` mode share
(`dsa_sweep`, `spattn_sweep`): the card's line, and each checkout's
measurements in a process of its own, in turns on one card.

A sweep module gives `measure()` (the measurements of the `fcd_tpu_torch`
on sys.path, as a JSON-able dict), `plans()` (its `--plans` mode) and a
printer of one measurement, and its `main` calls `main` here. The child
that measures a checkout loads the sweep module's own file with that
checkout first on sys.path, so an older checkout is measured by this
checkout's code; the sweep module must therefore import this module
inside its `main`, not at its top (an older checkout has no `_sweep`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# run by the child: load the sweep module from its file and print
# measure()'s result as the last line
_CHILD = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("sweep_measure", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.measure()))
"""

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def measure_in(script: str, root: str) -> dict:
    """measure() of the sweep module at `script`, in a process of its own
    with the checkout `root` first on sys.path."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, script], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=1800)
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
        plans()
    else:
        for label, root in turns(args.parent, args.turns):
            show(label, measure_in(script, root))
    print(f"card: {line}")
    return 0
