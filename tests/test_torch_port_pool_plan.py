"""B9's plan (`fcd_tpu_torch/kernels/pool2x.py::pool2x_bwd_plan`,
`plan_for`), pure Python, on the CPU: the decomposition that
`csrc/pool2x_bwd.cu` walks.

* Every (pooled voxel, channel group) of a batch item is one unit, and
  the blocks' tiles take every unit exactly once, at the gated train
  step's two shapes and at ragged ones, under each channel width and a
  range of block counts.
* V divides C, the plan takes 8-byte accesses where C % 4 == 0 and the
  tensors are aligned, each block takes BUILT[V] tiles, and the grid fits
  the card's launch limits.
* An emulation of the kernel's indexing (unit -> pooled voxel, channel
  group, the eight children's offsets, g's offset) with the plain
  version's arithmetic gives the plain version's bits.
"""

import numpy as np
import pytest
import torch

from fcd_tpu_torch.kernels.pool2x import (
    BUILT,
    THREADS,
    max_pool2x_bwd_plain,
    plan_for,
    pool2x_bwd_plan,
)

import torch_port_workers

torch_port_workers.share_cores()

STEP_SHAPES = [(4, 128, 128, 128, 16), (4, 64, 64, 64, 32)]
RAGGED = [(1, 2, 2, 2, 1), (3, 6, 10, 4, 24), (2, 4, 6, 8, 6),
          (1, 4, 4, 4, 5)]


def _covered(plan) -> np.ndarray:
    """How often each unit of a batch item is taken: block x walks tiles
    x * tiles // blocks up to (x + 1) * tiles // blocks, thread t of tile
    i takes unit i * threads + t when it is below `units`."""
    blocks = plan.grid[0]
    hits = np.zeros(plan.units, np.int64)
    for x in range(blocks):
        t0 = x * plan.tiles // blocks
        t1 = (x + 1) * plan.tiles // blocks
        assert t1 - t0 <= plan.tiles_per_block
        u = np.arange(t0 * plan.threads, t1 * plan.threads)
        np.add.at(hits, u[u < plan.units], 1)
    return hits


@pytest.mark.parametrize("shape", STEP_SHAPES + RAGGED)
def test_every_unit_is_taken_once(shape):
    b, d, h, w, c = shape
    for vec in BUILT:
        if c % vec:
            with pytest.raises(ValueError, match="dividing C"):
                plan_for(*shape, vec)
            continue
        for blocks in (None, 1, 5, 132, 10 ** 6):
            plan = plan_for(*shape, vec, blocks)
            assert plan.groups * vec == c
            assert plan.units == d * h * w // 8 * plan.groups
            assert (_covered(plan) == 1).all(), plan


@pytest.mark.parametrize("shape", STEP_SHAPES + RAGGED)
def test_the_plan_fits_the_card(shape):
    b, d, h, w, c = shape
    plan = pool2x_bwd_plan(*shape)
    assert c % plan.vec == 0
    assert plan.vec == (4 if c % 4 == 0 else 2 if c % 2 == 0 else 1)
    assert plan.threads == THREADS <= 1024
    assert 1 <= plan.grid[0] < 2 ** 31 and plan.grid[1] == b < 65536
    assert plan.tiles_per_block == min(BUILT[plan.vec], plan.tiles)
    # unaligned tensors: one channel a thread
    assert pool2x_bwd_plan(*shape, aligned=False).vec == 1


def test_the_gated_train_steps_plans():
    """At enc1 and enc2: 4 channels a thread, one tile a block."""
    p1 = pool2x_bwd_plan(*STEP_SHAPES[0])
    p2 = pool2x_bwd_plan(*STEP_SHAPES[1])
    assert (p1.vec, p1.grid, p1.tiles_per_block) == (4, (4096, 4), 1)
    assert (p2.vec, p2.grid, p2.tiles_per_block) == (4, (1024, 4), 1)


def _emulate(x: torch.Tensor, g: torch.Tensor, plan) -> torch.Tensor:
    """dx as the kernel computes it: per unit the offsets of its eight
    children and of g, the max with NaN kept, the tie count, an f32
    division and a rounding to x's dtype."""
    b, d, h, w, c = x.shape
    hp, wp, v = h // 2, w // 2, plan.vec
    npool = d // 2 * hp * wp
    xf, gf = x.reshape(-1).float(), g.reshape(-1).float()
    out = torch.zeros_like(xf)
    u = torch.arange(plan.units)
    pv, cg = u // plan.groups, u % plan.groups
    px, rest = pv % wp, pv // wp
    py, pz = rest % hp, rest // hp
    rowc, slabc = w * c, w * c * h
    j = torch.arange(v)
    for bi in range(b):
        base = ((bi * d + 2 * pz) * slabc + 2 * py * rowc + 2 * px * c
                + cg * v)
        kids = torch.stack([base + (k >> 2) * slabc + ((k >> 1) & 1) * rowc
                            + (k & 1) * c for k in range(8)])     # (8, units)
        off = kids[:, :, None] + j                                # (8, units, v)
        xv = xf[off]
        m = xv.amax(dim=0)
        m = torch.where(torch.isnan(xv).any(dim=0), float("nan"), m)
        eq = xv == m
        share = gf[((bi * npool + pv) * c + cg * v)[:, None] + j] / \
            eq.sum(dim=0).float()
        out[off] = torch.where(eq, share, 0.0)
    return out.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 16), (1, 6, 4, 10, 24),
                                   (2, 4, 6, 8, 6), (1, 4, 4, 4, 5)])
def test_the_kernels_indexing_gives_the_plain_versions_bits(shape):
    gen = torch.Generator().manual_seed(3)
    b, d, h, w, c = shape
    x = torch.randint(-3, 4, shape, generator=gen).to(torch.bfloat16)
    x[0, 0, 0, 0, 0] = float("nan")
    g = torch.randn((b, d // 2, h // 2, w // 2, c), generator=gen).to(
        torch.bfloat16)
    want = max_pool2x_bwd_plain(x, g)
    for vec in BUILT:
        if c % vec == 0:
            assert torch.equal(_emulate(x, g, plan_for(*shape, vec)), want)
