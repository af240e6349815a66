"""K2 on the card, against another checkout of the port (run from the
repository root):

    python -m fcd_tpu_torch.kernels.finale_sweep [--parent DIR] [--turns N]
    python -m fcd_tpu_torch.kernels.finale_sweep --plans

At each of the 23 K2 calls of a train step (the default MS_DSA_NET at
batch 4 x 128^3: eleven shapes, `STEP_CALLS`) it times one
`Finale.backward` as the step calls it, by the device time of everything
it launches (torch.profiler, 20 calls after a warm-up), with the K2
kernels' share, the count of device ops and the wall per call beside it,
and sums them over the step's calls; then the train step itself: ms/step
over three synchronised steps, three times, and one profiled step's device
busy time and device kernel count.

With --parent DIR (an unpacked checkout, e.g. the parent commit's `git
archive` under build/), the same measurements run for DIR's port and for
this one in separate processes, in turns (parent, this, this, parent for
--turns 2), on the same card. With --plans, this checkout's K2 kernels
under every channel width, block count and walk `plan_for` takes at the
step's shapes instead (* marks finale_bwd_plan's choice). Prints the card's
name and power limit first. Card only.
"""

from __future__ import annotations

import sys
import types

BATCH, SLOPE = 4, 0.01
# the K2 calls of one train step: (label, grid, C, mode, calls); mode
# `none` (no pooled output), `even` or `chain` (how tied maxima share gq)
STEP_CALLS = (
    ("enc1", 128, 16, "even", 1),
    ("dec[4]", 128, 16, "none", 1),
    ("enc2", 64, 32, "even", 1),
    ("dec[3]", 64, 32, "none", 1),
    ("enc3", 32, 64, "chain", 1),
    ("level-3 transformers, dec[2]", 32, 32, "none", 4),
    ("enc4", 16, 128, "chain", 1),
    ("level-4 transformers, dec[1]", 16, 64, "none", 4),
    ("enc5", 8, 256, "chain", 1),
    ("level-5 transformers, dec[0]", 8, 128, "none", 4),
    ("enc6", 4, 512, "none", 1),
    ("level-6 transformers", 4, 256, "none", 3),
)


def inputs(grid: int, c: int, mode: str, gen):
    """A Finale.backward's context and cotangents at one shape: bf16 ys, rs
    and gp (and gq when pooled), f32 (B, C) affines."""
    import torch

    dev, bf = torch.device("cuda"), torch.bfloat16
    shape = (BATCH, grid, grid, grid, c)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev)

    ys, rs, gp = (rnd(*shape).to(bf) for _ in range(3))
    gq = (None if mode == "none"
          else rnd(BATCH, grid // 2, grid // 2, grid // 2, c).to(bf))
    aff = (rnd(BATCH, c).abs() + 0.5, 0.1 * rnd(BATCH, c),
           rnd(BATCH, c).abs() + 0.5, 0.1 * rnd(BATCH, c))
    ctx = types.SimpleNamespace(saved_tensors=(ys, rs, *aff), slope=SLOPE,
                                pool=gq is not None,
                                tie="even" if mode == "none" else mode)
    return ctx, gp, gq


def _row(fn, iters=20, tries=5) -> dict:
    """fn's device time, K2's share of it, its device ops and its wall per
    call. The profiler on the card sometimes drops events: a trace of
    `iters` calls is kept only when it counts each op, per call, as a trace
    of one call does, and is taken again up to `tries` times."""
    from fcd_tpu_torch.kernels.dsa_sweep import _device_ops, _wall_ms

    for _ in range(tries):
        one = {k: n for k, (n, _) in _device_ops(fn, 1).items()}
        ops = _device_ops(fn, iters)
        if one and {k: n for k, (n, _) in ops.items()} == one:
            break
    else:
        raise RuntimeError(f"no whole trace of {iters} calls in {tries} tries")
    return {"device_ms": sum(ms for _, ms in ops.values()),
            "kernel_ms": sum(ms for k, (_, ms) in ops.items()
                             if "finale_bwd" in k),
            "device_ops": sum(m for m, _ in ops.values()),
            "wall_ms": _wall_ms(fn, iters)}


def plans(iters: int = 20) -> None:
    """K2 under every vec its mode takes and a range of block counts, at
    each of the step's shapes: each plan's device time / wall per call,
    and whether its outputs are the chosen plan's (d_ys, d_rs bit-equal,
    the sums within 1e-4 of their max; BAD otherwise)."""
    import torch

    from fcd_tpu_torch.kernels import finale as k2

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, grid, c, mode, _ in STEP_CALLS:
        ctx, gp, gq = inputs(grid, c, mode, gen)
        ys, rs, *aff = ctx.saved_tensors
        chosen = k2.finale_bwd_plan(BATCH, grid, grid, grid, c, mode)
        want = k2.finale_bwd(ys, rs, *aff, gp, gq, SLOPE, ctx.tie)
        tried = [chosen] + [
            k2.plan_for(BATCH, grid, grid, grid, c, mode, vec, blocks)
            for vec in k2.BUILT if c % vec == 0 and (vec == 1 or mode == "none")
            for blocks in (8, 16, 33, 66, 132, 264, 528)]
        cells = []
        for plan in sorted(dict.fromkeys(tried),
                           key=lambda p: (-p.vec, p.grid[0])):
            def call():
                return k2.finale_bwd(ys, rs, *aff, gp, gq, SLOPE, ctx.tie,
                                     plan=plan)

            got = call()
            same = all(torch.equal(a, b) for a, b in zip(got[:2], want))
            same = same and all(
                float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
                for a, b in zip(got[2:], want[2:]))
            ms = _row(call, iters)
            mark = "*" if plan == chosen else ""
            cells.append(f"v{plan.vec} {plan.grid[0]}x{BATCH} blocks "
                         f"({plan.tiles_per_block} tiles){mark} "
                         f"{ms['device_ms']:.4f}/{ms['wall_ms']:.4f}"
                         f"{'' if same else ' BAD'}")
        print(f"{label} {BATCH}x{grid}^3x{c} {mode}: " + " | ".join(cells),
              flush=True)
        del ctx, gp, gq, ys, rs, aff, want
        torch.cuda.empty_cache()


def measure() -> dict:
    """The measurements of the `fcd_tpu_torch` on sys.path."""
    import torch

    from fcd_tpu_torch.kernels.finale import Finale

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"calls": {}}
    for label, grid, c, mode, calls in STEP_CALLS:
        ctx, gp, gq = inputs(grid, c, mode, gen)
        row = _row(lambda: Finale.backward(ctx, gp, gq))
        row["calls"] = calls
        out["calls"][f"{label} {BATCH}x{grid}^3x{c} {mode}"] = row
        del ctx, gp, gq
    torch.cuda.empty_cache()
    out["per_step_ms"] = sum(r["device_ms"] * r["calls"]
                             for r in out["calls"].values())
    out["per_step_ops"] = sum(r["device_ops"] * r["calls"]
                              for r in out["calls"].values())
    # an older checkout's spattn_sweep has the same train_step
    from fcd_tpu_torch.kernels.spattn_sweep import train_step

    out["step"] = train_step()
    return out


def show(label: str, res: dict) -> None:
    """Print one checkout's measurements."""
    print(f"{label}:", flush=True)
    for shape, r in res["calls"].items():
        print(f"  Finale.backward {shape} (x{r['calls']} a step): "
              f"{r['device_ms']:.4f} ms device ({r['kernel_ms']:.4f} in "
              f"finale_bwd kernels, {r['device_ops']:g} ops, wall "
              f"{r['wall_ms']:.4f})")
    st = res["step"]
    print(f"  K2 per step (the 23 calls, all they launch): "
          f"{res['per_step_ms']:.3f} ms device in {res['per_step_ops']:g} "
          f"ops")
    print(f"  train step 4x128^3: ms/step "
          f"{', '.join(f'{v:.1f}' for v in st['ms_per_step'])}; "
          f"profiled wall {st['wall_ms_profiled']:.2f} ms, device busy "
          f"{st['device_busy_ms']:.3f} ms, idle "
          f"{100 * st['idle_share']:.1f}%, {st['device_kernels']} device "
          f"kernels", flush=True)


def main(argv=None) -> int:
    # imported here: measure() runs in a child whose fcd_tpu_torch may
    # be an older checkout
    from fcd_tpu_torch.kernels import _sweep

    return _sweep.main(__doc__, __file__, plans, show, argv)


if __name__ == "__main__":
    sys.exit(main())
