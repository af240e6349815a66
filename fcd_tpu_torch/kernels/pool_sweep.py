"""B9 on the card, against another checkout of the port (run from the
repository root):

    python -m fcd_tpu_torch.kernels.pool_sweep [--parent DIR] [--turns N]
    python -m fcd_tpu_torch.kernels.pool_sweep --plans

At the gated train step's two B9 calls (FCD_FINALE_POOL=0,
FCD_FINALE_TRAIN=0 at batch 4 x 128^3: encoders 1 and 2, `STEP_CALLS`)
and at one C % 8 != 0 shape it times one `max_pool2x_bwd` by the device
time of everything it launches (torch.profiler, 20 calls after a warm-up,
whole traces only), with its device ops and the wall per call beside it,
and the bound: x read, g read once, dx written, at 3.35 TB/s.

With --parent DIR (an unpacked checkout, e.g. the parent commit's `git
archive` under build/), the same measurements run for DIR's port and for
this one in separate processes, in turns (parent, this, this, parent for
--turns 2), on the same card. With --plans, this checkout's kernel under
every channel width and a range of block counts `plan_for` takes (*
marks pool2x_bwd_plan's choice), each plan's dx checked bit-equal to the
chosen plan's. Prints the card's name and power limit first. Card only.
"""

from __future__ import annotations

import sys

BATCH = 4
PEAK_BYTES = 3.35e12
# (label, grid, C, tied inputs): the gated step's two calls, and a width
# that takes narrower accesses
STEP_CALLS = (
    ("enc1", 128, 16, True),
    ("enc2", 64, 32, False),
    ("enc2 grid at C 12", 64, 12, False),
)


def inputs(grid: int, c: int, tied: bool, gen):
    """x (small integers when tied, so that blocks hold exact ties) and g,
    bf16, at one shape."""
    import torch

    dev, bf = torch.device("cuda"), torch.bfloat16
    shape = (BATCH, grid, grid, grid, c)
    x = (torch.randint(-3, 4, shape, generator=gen, device=dev).to(bf)
         if tied else torch.randn(shape, generator=gen, device=dev).to(bf))
    g = torch.randn((BATCH, grid // 2, grid // 2, grid // 2, c),
                    generator=gen, device=dev).to(bf)
    return x, g


def bound_ms(grid: int, c: int) -> float:
    n = BATCH * grid ** 3 * c
    return (2 * n + 2 * n // 8 + 2 * n) / PEAK_BYTES * 1e3


def _row(fn, iters=20, tries=5) -> dict:
    """fn's device time, device ops and wall per call, from a whole trace
    (each op `iters` times as often as in a trace of one call)."""
    from fcd_tpu_torch.kernels.dsa_sweep import _device_ops, _wall_ms

    for _ in range(tries):
        one = {k: n for k, (n, _) in _device_ops(fn, 1).items()}
        ops = _device_ops(fn, iters)
        if one and {k: n for k, (n, _) in ops.items()} == one:
            break
    else:
        raise RuntimeError(f"no whole trace of {iters} calls in {tries} tries")
    return {"device_ms": sum(ms for _, ms in ops.values()),
            "device_ops": sum(m for m, _ in ops.values()),
            "wall_ms": _wall_ms(fn, iters)}


def plans(iters: int = 20) -> None:
    """B9 under every channel width its C takes and a range of block
    counts at each of STEP_CALLS' shapes: device time / wall per call, and
    BAD where dx is not the chosen plan's bits."""
    import torch

    from fcd_tpu_torch.kernels import pool2x

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, grid, c, tied in STEP_CALLS:
        x, g = inputs(grid, c, tied, gen)
        shape = (BATCH, grid, grid, grid, c)
        chosen = pool2x.pool2x_bwd_plan(*shape)
        want = pool2x.max_pool2x_bwd(x, g)
        if not torch.equal(want, pool2x.max_pool2x_bwd_plain(x, g)):
            raise AssertionError(f"{label}: dx is not the plain version's")
        tried = [chosen] + [pool2x.plan_for(*shape, vec, blocks)
                            for vec in pool2x.BUILT if c % vec == 0
                            for blocks in (132, 396, 528, 1024, 2048, 4096,
                                           10 ** 6)]
        cells = []
        for plan in sorted(dict.fromkeys(tried),
                           key=lambda p: (-p.vec, p.grid[0])):
            def call():
                return pool2x.max_pool2x_bwd(x, g, plan=plan)

            same = torch.equal(call(), want)
            ms = _row(call, iters)
            mark = "*" if plan == chosen else ""
            cells.append(f"v{plan.vec} {plan.grid[0]}x{BATCH} blocks "
                         f"({plan.tiles_per_block} tiles){mark} "
                         f"{ms['device_ms']:.4f}/{ms['wall_ms']:.4f}"
                         f"{'' if same else ' BAD'}")
        print(f"{label} {BATCH}x{grid}^3x{c} (bound "
              f"{bound_ms(grid, c):.4f} ms): " + " | ".join(cells),
              flush=True)
        del x, g, want
        torch.cuda.empty_cache()


def measure() -> dict:
    """The measurements of the `fcd_tpu_torch` on sys.path."""
    import torch

    from fcd_tpu_torch.kernels.pool2x import max_pool2x_bwd

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, grid, c, tied in STEP_CALLS:
        x, g = inputs(grid, c, tied, gen)
        row = _row(lambda: max_pool2x_bwd(x, g))
        row["bound_ms"] = bound_ms(grid, c)
        out[f"{label} {BATCH}x{grid}^3x{c}{', tied' if tied else ''}"] = row
        del x, g
    torch.cuda.empty_cache()
    return out


def show(label: str, res: dict) -> None:
    """Print one checkout's measurements."""
    print(f"{label}:", flush=True)
    for shape, r in res.items():
        print(f"  max_pool2x_bwd {shape}: {r['device_ms']:.4f} ms device "
              f"({r['device_ops']:g} ops, wall {r['wall_ms']:.4f}), bound "
              f"{r['bound_ms']:.4f} ms, share "
              f"{100 * r['bound_ms'] / r['device_ms']:.2f}%", flush=True)


def main(argv=None) -> int:
    # imported here: measure() runs in a child whose fcd_tpu_torch may
    # be an older checkout
    from fcd_tpu_torch.kernels import _sweep

    return _sweep.main(__doc__, __file__, plans, show, argv)


if __name__ == "__main__":
    sys.exit(main())
