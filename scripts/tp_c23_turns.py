"""The bf16 TP step's distance from one card's step, in turns with another
checkout (ROADMAP C23: the column-parallel convs' data gradient summed over
the model axis in f32 and rounded once, or each rank's share rounded
first).

    python scripts/tp_c23_turns.py --parent DIR [--turns N]

DIR holds another checkout (e.g. `git archive <commit> | tar -x -C DIR`
under `build/`). Each checkout runs `chip_smoke.tp_route` on the kernel
route (MS_DSA_NET fs16, bf16: one 128^3 patch and one 1 x 128^3 train
step on two gloo ranks sharing the card as a (1, 2) mesh, against one
card's patch and step from the same state, and a one-card step on an
input nudged by 1e-6, the control) in a process of its own with that
checkout first on sys.path, in the order parent, this, this, parent. For
each it prints, per parameter group, the TP step's rel-L2 and cosine
from the one-card step beside the nudged step's, the gradient norms'
log-ratios TP / one card, the losses, the launch counts of the step and
ms a patch and a step. Needs one card; about 2 min a turn after the
builds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = ("grads", "ref_grads", "norms", "single_norms", "nudged_norms",
        "loss", "single_loss", "nudged_loss", "fwd_rel", "fwd_ms",
        "step_ms", "single_fwd_ms", "single_step_ms", "step_counts")


def _rank(root: str) -> dict:
    """One rank: chip_smoke's bf16 TP route of the checkout at `root`."""
    import torch

    import chip_smoke
    from fcd_tpu_torch.parallel import tp

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = tp.make_tp_mesh(1, 2, device=dev)
    t0 = time.perf_counter()
    r = chip_smoke.tp_route(mesh, dev, {}, False, False)
    out = {k: r[k] for k in KEEP}
    out.update(seconds=time.perf_counter() - t0, rank=mesh.model.rank,
               root=root)
    return out


def child(root: str) -> None:
    """Measure the checkout at `root` (its package and chip_smoke first on
    sys.path) and print rank 0's result as the last line."""
    sys.path.insert(0, root)
    os.chdir(root)
    from fcd_tpu_torch.parallel.mesh import launch

    ranks = launch(_rank, 2, root, backend="gloo", device_type="cuda",
                   devices=["cuda:0"] * 2)
    print(json.dumps(ranks[0]))


def show(label: str, r: dict) -> None:
    rel = abs(r["loss"] - r["single_loss"]) / abs(r["single_loss"])
    nudged = (abs(r["nudged_loss"] - r["single_loss"])
              / abs(r["single_loss"]))
    print(f"{label} ({r['root']}): {r['seconds']:.1f} s; TP patch "
          f"{r['fwd_ms']:.1f} ms (one card {r['single_fwd_ms']:.1f}), rel "
          f"{r['fwd_rel']:.3e}; TP step {r['step_ms']:.1f} ms (one card "
          f"{r['single_step_ms']:.1f}); loss rel {rel:.3e} (nudged "
          f"{nudged:.3e})", flush=True)
    print(f"  step launches {r['step_counts']}", flush=True)
    print("  group: TP rel-L2/cosine (nudged), norm log-ratio TP / one "
          "card", flush=True)
    for key, (d, cos) in r["grads"].items():
        rd, rc = r["ref_grads"][key]
        one = r["single_norms"][key]
        lr = (math.log(r["norms"][key] / one) if one > 0
              and r["norms"][key] > 0 else float("nan"))
        print(f"  {key}: {d:.4e}/{cos:.6f} ({rd:.4e}/{rc:.6f}), "
              f"{lr:+.3e}", flush=True)


def turns(parent: str, n: int) -> list:
    pair = [("parent", os.path.abspath(parent)), ("this", REPO)]
    return [lab for i in range(n) for lab in (pair if i % 2 == 0
                                               else pair[::-1])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout to compare with")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    if not args.parent:
        ap.error("--parent DIR is needed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    for label, root in turns(args.parent, args.turns):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        show(label, json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
