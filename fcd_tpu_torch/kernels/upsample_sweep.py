"""B4's tile choice, on the card (run from the repository root):

    python -m fcd_tpu_torch.kernels.upsample_sweep

At the decoders' shapes (batch 1 and 4, the default config) it times the
kernel under every tile of `upsample.TILES` by the device time of its
launches (torch.profiler, 20 calls after a warm-up), marks the tile that
`upsample_plan` picks, and prints each tile's block count, to check the
plan's rule; then the plan's tile with its walks kept at 2, 4, 8 and 12
blocks per SM, and with one voxel tile a block (no walk).
It prints the card's name and power limit first. Card only.
"""

from __future__ import annotations

import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fcd_tpu_torch.kernels.upsample import (
    TILES,
    plan_for,
    upsample2x,
    upsample_plan,
)

# (batch, coarse grid, ci, co): the five decoders of a 128^3 patch, fs16
SHAPES = [(b, g, ci, co) for b in (1, 4)
          for g, ci, co in ((4, 256, 128), (8, 128, 64), (16, 64, 32),
                            (32, 32, 32), (64, 32, 16))]


def kernel_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of the upsample kernel's launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "upsample_kernel" in e.name)
    if us == 0:
        raise AssertionError("the profiler saw no upsample_kernel")
    return us / iters / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("upsample_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for b, g, ci, co in SHAPES:
        x = torch.randn((b, g, g, g, ci), generator=gen,
                        device=dev).bfloat16()
        k = torch.randn((2, 2, 2, ci, co), generator=gen, device=dev) * 0.1
        chosen = upsample_plan(b, g, g, g, ci, co)
        cells = []
        for i in range(len(TILES)):
            plan = plan_for(i, b * g ** 3, 8 * co)
            ms = kernel_ms(lambda: upsample2x(x, k, plan=plan))
            mark = "*" if i == chosen.tile else ""
            cells.append(f"{plan.bm}x{plan.bn}{mark} {plan.blocks} blocks "
                         f"{ms:.4f}")
        # the plan's tile under other walks, and with one voxel tile a block
        m = b * g ** 3
        for per_sm in (2, 4, 8, 12):
            plan = plan_for(chosen.tile, m, 8 * co, per_sm)
            ms = kernel_ms(lambda: upsample2x(x, k, plan=plan))
            cells.append(f"{per_sm}/SM {plan.blocks} blocks {ms:.4f}")
        flat = chosen._replace(m_blocks=chosen.m_tiles)
        ms = kernel_ms(lambda: upsample2x(x, k, plan=flat))
        cells.append(f"unwalked {flat.blocks} blocks {ms:.4f}")
        print(f"{b}x{g}^3 {ci}->{co}: " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
