"""K1's work split (`fcd_tpu_torch/kernels/conv_wgrad.py::wgrad_plan`) and
its fixed-order reduction, on the CPU.

* The plan's chunks cover every voxel of every batch item exactly once,
  tile after tile in chunk order, at the 51 weight gradients of one
  MS_DSA_NET train step (4 x 128^3, the default config) and at ragged
  shapes; the partial sums stay under the stated scratch bound (16 MiB);
  the 128^3 and 64^3 convs split into chunks and the widest 4^3 ones do
  not.
* The kernel's reduction in plain PyTorch (each chunk's partial dW, added
  in the second pass's order) equals `conv3d_wgrad_plain` to 1e-5 of
  max |dW| (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fcd_tpu_torch.kernels.conv_wgrad import (
    MIN_SPLIT,
    SCRATCH_CAP,
    chunk_voxels,
    conv3d_wgrad_chunked,
    conv3d_wgrad_plain,
    sum_partials,
    wgrad_plan,
)
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET


def main_path_calls(batch=4, patch=128, fs=16):
    """(b, d, h, w, ci, co) of every K1 call of one train step, read off
    the model: per residual block one call per part of conv1 and one for
    conv2; encoder i at patch / 2^i, the transformer blocks of level l at
    patch / 2^(l + 2), decoder k at patch / 2^(4 - k) over its two parts
    (upsampled, skip)."""
    model = MS_DSA_NET(2, (patch,) * 3, feature_size=fs)
    blocks = [(enc, patch >> i, 1) for i, enc in enumerate(model.encoders)]
    blocks += [(blk.conv_block, patch >> (li + 2), 1)
               for li, stack in enumerate(model.transformers)
               for blk in stack]
    blocks += [(dec.block, patch >> (4 - k), 2)
               for k, dec in enumerate(model.decoders)]
    calls = []
    for blk, s, nparts in blocks:
        ci, co = blk.conv1.shape[3], blk.conv1.shape[4]
        calls += [(batch, s, s, s, ci // nparts, co)] * nparts
        calls.append((batch, s, s, s, co, co))
    return calls


MAIN = sorted(set(main_path_calls()))
RAGGED = [(b, *grid, ci, co)
          for b in (1, 2) for grid in ((6, 10, 7), (1, 9, 17))
          for ci in (2, 8, 20, 24) for co in (8, 20)]


def test_main_path_has_the_steps_k1_calls():
    calls = main_path_calls()
    assert len(calls) == chip_smoke.per_train_step()["conv3d_wgrad"] == 51
    assert {c[1] for c in calls} == {128, 64, 32, 16, 8, 4}


@pytest.mark.parametrize("shape", MAIN + RAGGED + [
    (2, 20, 24, 24, 16, 16), (2, 10, 18, 21, 20, 20)])
def test_plan_covers_every_voxel_once_in_chunk_order(shape):
    b, d, h, w, ci, co = shape
    plan = wgrad_plan(*shape)
    per = chunk_voxels(plan, (b, d, h, w))
    assert len(per) == plan.chunks and all(len(v) for v in per)
    flat = torch.cat(per)
    n = b * d * h * w
    assert len(flat) == n
    assert torch.equal(torch.sort(flat).values, torch.arange(n))
    # chunk k walks the tiles k, k + chunks, k + 2 chunks, ... (at most
    # per_chunk of them): the tile of each of its voxels, in walking order
    gz, gy, gx = plan.grid
    for k, v in enumerate(per):
        z, y, x = (v // (h * w)) % d, (v // w) % h, v % w
        tile = (((v // (d * h * w)) * gz + z // 4) * gy + y // 8) * gx + x // 8
        assert bool((tile % plan.chunks == k).all())
        assert bool((tile[1:] >= tile[:-1]).all())
        assert len(torch.unique(tile)) <= plan.per_chunk


@pytest.mark.parametrize("shape", MAIN + RAGGED)
def test_plan_scratch_stays_under_its_bound(shape):
    """Partial sums: at most SCRATCH_CAP (16 MiB), none with one chunk; a
    split has at least MIN_SPLIT chunks."""
    b, d, h, w, ci, co = shape
    plan = wgrad_plan(*shape)
    dw_bytes = 4 * 27 * ci * co
    assert SCRATCH_CAP == 16 << 20
    assert plan.scratch_bytes == (plan.chunks * dw_bytes
                                  if plan.chunks > 1 else 0)
    assert plan.scratch_bytes <= SCRATCH_CAP
    assert plan.chunks == 1 or plan.chunks >= min(MIN_SPLIT, plan.tiles)
    assert plan.ci_tile >= min(ci, 32) and plan.co_tile >= min(co, 32)
    if d >= 64:
        assert plan.chunks >= 128         # the voxels split over the SMs
    if d == 4 and ci >= 256:
        assert plan.chunks == 1 and plan.blocks >= 64   # dW tiled instead


@pytest.mark.parametrize("shape,pro", [
    ((2, 6, 10, 7, 2, 8), True), ((2, 6, 10, 7, 2, 20), False),
    ((1, 12, 20, 14, 8, 8), True), ((2, 5, 18, 34, 8, 20), False),
    ((2, 20, 24, 24, 16, 16), True), ((2, 20, 24, 24, 2, 16), False),
    ((2, 10, 18, 21, 20, 20), True), ((2, 10, 18, 21, 24, 8), False)])
def test_chunked_reduction_matches_plain(shape, pro):
    b, d, h, w, ci, co = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.tensor(rng.normal(size=(b, d, h, w, ci)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(b, d, h, w, co)).astype(np.float32))
    prologue = None
    if pro:
        prologue = (torch.tensor(rng.rand(b, ci).astype(np.float32) + 0.5),
                    torch.tensor(rng.normal(0, 1, (b, ci)).astype(np.float32)),
                    0.01)
    plan = wgrad_plan(*shape)
    assert plan.chunks > 1
    got = conv3d_wgrad_chunked(x, g, prologue, plan)
    want = conv3d_wgrad_plain(x, g, prologue)
    assert got.shape == want.shape == (27, ci, co)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_sum_partials_order():
    """The second pass: runs of ceil(chunks / 8) consecutive chunks, each
    summed in order, then the runs in order (f32, so the order shows)."""
    part = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    # runs of one chunk: ((((1e8 + 1) - 1e8) + 1) + 3) in f32
    want = torch.tensor(1e8, dtype=torch.float32) + 1.0
    want = want - 1e8 + 1.0 + 3.0
    assert torch.equal(sum_partials(part), want)
    many = torch.arange(20, dtype=torch.float32)
    assert float(sum_partials(many)) == float(many.sum())
