"""conv_finish on the card, against another checkout of the port (run from
the repository root):

    python -m fcd_tpu_torch.kernels.finish_sweep [--parent DIR] [--turns N]
    python -m fcd_tpu_torch.kernels.finish_sweep --plans

At the 35 `conv_finish` calls of one tensor-parallel patch (MS_DSA_NET
fs16 at 1 x 128^3 over a model axis of 2, `chip_smoke.py`'s tp phase: the
23 res-block conv2s and the 12 transformer conv1s run row-parallel,
`TP_CALLS`) it times one call at each of their ten shapes by the device
time of everything the wrapper launches (torch.profiler, 20 calls after a
warm-up, whole traces only), with its device ops and the wall per call
beside it, and the bound: the f32 sum read, the bf16 output written, 6
bytes an element at 3.35 TB/s. Each shape's time times its calls, summed,
is the patch's total.

With --parent DIR (an unpacked checkout, e.g. the parent commit's `git
archive` under build/), the same measurements run for DIR's port and for
this one in separate processes, in turns (parent, this, this, parent for
--turns 2), on the same card. With --plans, this checkout's kernels at each
shape under both plans (one launch at every cluster size up to the card's
limit, two launches at a range of block counts; * marks `finish_plan`'s
choice), each plan's y checked bit-equal to the chosen plan's and its sums
within rel 1e-5. Prints the card's name and power limit first. Card only.
"""

from __future__ import annotations

import sys

PEAK_BYTES = 3.35e12
SUM_REL_TOL = 1e-5


def row_conv_calls(fs: int = 16, size: int = 128) -> tuple:
    """(label, grid, C, calls a patch) of MS_DSA_NET's row-parallel 3x3x3
    convs at feature size fs on a size^3 patch, three transformer layers
    a level: each encoder's and decoder's conv2, and both convs of each
    transformer's conv block. Their outputs are whole: C is the conv's
    output width."""
    tb = "tb x6"
    return (("enc1, dec1", size, fs, 2),
            ("enc2, dec2", size // 2, 2 * fs, 2),
            ("enc3", size // 4, 4 * fs, 1),
            (f"level3 {tb}, dec3", size // 4, 2 * fs, 7),
            ("enc4", size // 8, 8 * fs, 1),
            (f"level4 {tb}, dec4", size // 8, 4 * fs, 7),
            ("enc5", size // 16, 16 * fs, 1),
            (f"level5 {tb}, dec5", size // 16, 8 * fs, 7),
            ("enc6", size // 32, 32 * fs, 1),
            (f"level6 {tb}", size // 32, 16 * fs, 6))


TP_CALLS = row_conv_calls()


def bound_ms(grid: int, c: int) -> float:
    return 6 * grid ** 3 * c / PEAK_BYTES * 1e3


def _input(grid: int, c: int, gen):
    import torch

    return torch.randn((1, grid, grid, grid, c), generator=gen,
                       device="cuda") + 0.3


def plans(iters: int = 20) -> None:
    """Each shape under both plans: device time / wall per call, and BAD
    where y is not the chosen plan's bits or a sum is off by more than
    SUM_REL_TOL."""
    import torch

    from fcd_tpu_torch.kernels import conv_finish as cf
    from fcd_tpu_torch.kernels.pool_sweep import _row

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    limit = cf.cluster_limit(torch.device("cuda"))
    print(f"the card's largest cluster of the one-launch kernel: {limit}",
          flush=True)
    for label, grid, c, calls in TP_CALLS:
        s = _input(grid, c, gen)
        nvox = grid ** 3
        chosen = cf.finish_plan(1, nvox, c, max_cluster=limit)
        want = cf.conv_finish(s, plan=chosen)
        tried = [chosen] + [
            cf.finish_plan(1, nvox, c, one_launch=True, cluster=k)
            for k in (1, 2, 4, 8, 12, 16) if k <= min(limit, nvox)] + [
            cf.finish_plan(1, nvox, c, one_launch=False, blocks=n)
            for n in (66, 132, 264, 528)]
        cells = []
        for plan in dict.fromkeys(tried):
            def call():
                return cf.conv_finish(s, plan=plan)

            got = call()
            good = torch.equal(got[0], want[0]) and all(
                float((a - b).abs().max() / b.abs().max()) <= SUM_REL_TOL
                for a, b in zip(got[1:], want[1:]))
            ms = _row(call, iters)
            kind = (f"1 launch, cluster {plan.cluster}" if plan.cluster
                    else f"2 launches, {plan.runs} blocks")
            cells.append(f"{kind}{'*' if plan == chosen else ''} "
                         f"{ms['device_ms']:.4f}/{ms['wall_ms']:.4f}"
                         f"{'' if good else ' BAD'}")
        print(f"{label} 1x{grid}^3x{c} (bound {bound_ms(grid, c):.4f} ms): "
              + " | ".join(cells), flush=True)
        del s, want
        torch.cuda.empty_cache()


def measure() -> dict:
    """The measurements of the `fcd_tpu_torch` on sys.path."""
    import torch

    from fcd_tpu_torch.kernels.conv_finish import conv_finish
    from fcd_tpu_torch.kernels.pool_sweep import _row

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, grid, c, calls in TP_CALLS:
        s = _input(grid, c, gen)
        row = _row(lambda: conv_finish(s))
        row.update(bound_ms=bound_ms(grid, c), calls=calls)
        out[f"{label} 1x{grid}^3x{c}"] = row
        del s
    torch.cuda.empty_cache()
    return out


def show(label: str, res: dict) -> None:
    """Print one checkout's measurements and the patch's total."""
    print(f"{label}:", flush=True)
    for shape, r in res.items():
        print(f"  conv_finish {shape} x{r['calls']}: {r['device_ms']:.4f} ms "
              f"device ({r['device_ops']:g} ops, wall {r['wall_ms']:.4f}), "
              f"bound {r['bound_ms']:.4f} ms, share "
              f"{100 * r['bound_ms'] / r['device_ms']:.2f}%", flush=True)
    total = sum(r["calls"] * r["device_ms"] for r in res.values())
    bound = sum(r["calls"] * r["bound_ms"] for r in res.values())
    calls = sum(r["calls"] for r in res.values())
    print(f"  {calls} calls a TP patch: {total:.4f} ms device, bound "
          f"{bound:.4f} ms", flush=True)


def main(argv=None) -> int:
    # imported here: measure() runs in a child whose fcd_tpu_torch may
    # be an older checkout
    from fcd_tpu_torch.kernels import _sweep

    return _sweep.main(__doc__, __file__, plans, show, argv)


if __name__ == "__main__":
    sys.exit(main())
