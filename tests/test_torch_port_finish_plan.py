"""The finishing pass's plan (`fcd_tpu_torch/kernels/conv_finish.py::
finish_plan`), pure Python, on the CPU: the decomposition that
`csrc/conv_finish.cu` walks.

* The 35 calls of a tensor-parallel patch at fs16 (`finish_sweep.
  TP_CALLS`: ten shapes), and every row-parallel width of MS_DSA_NET fs8
  and fs32: one launch (a cluster of at most 16 blocks, one a batch
  item) up to ONE_LAUNCH elements, which takes levels 4-6 at fs16; two
  launches above it, with about TARGET_BLOCKS blocks.
* An emulation of the kernel's walk (its thread rows through each chunk
  of its ring in turn, each thread's f32 sums in order, the block's rows
  added in the fixed tree, then the blocks' rows in order) takes every
  (voxel, channel group)
  exactly once, at those shapes (cut in depth) and at ragged ones under
  both plans; its sums are the plain version's within rel 1e-5 (y's
  rounding is held bit-equal on the card, `test_torch_port_cuda.py`).
* C that the kernel does not take is refused.
"""

import numpy as np
import pytest
import torch

from fcd_tpu_torch.kernels.conv_finish import (
    CHUNK_BYTES,
    MAX_CLUSTER,
    ONE_LAUNCH,
    TARGET_BLOCKS,
    THREADS,
    VEC,
    conv_finish_plain,
    finish_plan,
)
from fcd_tpu_torch.kernels.finish_sweep import TP_CALLS, row_conv_calls

import torch_port_workers

torch_port_workers.share_cores()


def test_tp_calls_are_the_patch_row_convs():
    """23 res-block conv2s and 12 transformer conv1s (chip_smoke.py's
    TP_ROW_CONVS), at the widths of MS_DSA_NET fs16."""
    assert sum(n for *_, n in TP_CALLS) == 35
    assert [(g, c) for _, g, c, _ in TP_CALLS] == [
        (128, 16), (64, 32), (32, 64), (32, 32), (16, 128), (16, 64),
        (8, 256), (8, 128), (4, 512), (4, 256)]


@pytest.mark.parametrize("fs", [8, 16, 32])
def test_plan_by_size(fs):
    for _, grid, c, _ in row_conv_calls(fs):
        nvox = grid ** 3
        plan = finish_plan(1, nvox, c)
        assert plan.rows * plan.runs >= nvox > plan.rows * (plan.runs - 1)
        if nvox * c <= ONE_LAUNCH:
            assert plan.cluster == plan.runs
            assert 1 <= plan.cluster <= min(MAX_CLUSTER, nvox)
            assert finish_plan(1, nvox, c, max_cluster=8).cluster <= 8
        else:
            assert plan.cluster == 0
            assert plan.runs >= min(nvox, TARGET_BLOCKS) // 2
        # levels 4-6 at fs16 run in one launch, enc4 (16^3 x 128) in two
        if fs == 16:
            assert bool(plan.cluster) == (grid * grid * grid * c <= 2 ** 18)


def _walk(plan, g, c, nvox):
    """Each block's thread rows and the voxels they read at once, as the
    kernel walks its run: THREADS // g rows of threads through each chunk
    of CHUNK_BYTES in turn (-1: no voxel)."""
    rb = THREADS // g
    cv = max(1, CHUNK_BYTES // (c * 4))
    for run in range(plan.runs):
        v0 = run * plan.rows
        v1 = min(nvox, v0 + plan.rows)
        steps = []
        for k in range(-(-max(0, v1 - v0) // cv)):
            m = min(cv, v1 - v0 - k * cv)
            for r in range(0, m, rb):
                w = v0 + k * cv + r + np.arange(rb)
                steps.append(np.where(r + np.arange(rb) < m, w, -1))
        yield rb, steps


def _emulate(s: np.ndarray, plan):
    """The kernels' walk of an f32 (B, nvox, C) sum: (sum, sumsq, visits
    of each (b, voxel, channel group))."""
    b, nvox, c = s.shape
    g = c // VEC
    visits = np.zeros((b, nvox, g), np.int64)
    out1 = np.zeros((b, g, VEC), np.float32)
    out2 = np.zeros((b, g, VEC), np.float32)
    vec = s.reshape(b, nvox, g, VEC)
    for bi in range(b):
        rows1, rows2 = [], []
        for rb, steps in _walk(plan, g, c, nvox):
            a = np.zeros((rb, g, VEC), np.float32)
            q = np.zeros((rb, g, VEC), np.float32)
            for w in steps:
                on = w >= 0
                t = vec[bi, w[on]]
                a[on] += t
                q[on] += t * t
                visits[bi, w[on]] += 1
            p = 1
            while p < rb:
                p *= 2
            h = p // 2
            while h:                       # the block's fixed tree
                n = max(0, min(h, rb - h))
                a[:n] += a[h:h + n]
                q[:n] += q[h:h + n]
                h //= 2
            rows1.append(a[0])
            rows2.append(q[0])
        for r1, r2 in zip(rows1, rows2):   # rank or run order
            out1[bi] += r1
            out2[bi] += r2
    return out1.reshape(b, c), out2.reshape(b, c), visits


CASES = [((1, 4, 4, 4, 512), None), ((1, 4, 4, 4, 1024), None),
         ((2, 5, 7, 9, 8), None), ((1, 8, 8, 8, 128), None),
         ((1, 16, 16, 16, 64), None), ((1, 3, 5, 7, 24), None),
         ((2, 9, 8, 5, 20), dict(one_launch=False, blocks=7)),
         ((1, 6, 10, 7, 16), dict(one_launch=False)),
         ((2, 6, 10, 7, 16), dict(one_launch=True, cluster=3)),
         ((1, 16, 16, 16, 64), dict(one_launch=False, blocks=528)),
         ((2, 9, 8, 5, 20), dict(one_launch=False, blocks=5)),
         ((1, 3, 5, 7, 1024), dict(one_launch=True, cluster=16))]


@pytest.mark.parametrize("shape,kw", CASES)
def test_emulated_kernel_matches_plain(shape, kw):
    rng = np.random.RandomState(3)
    s = (rng.normal(size=shape) + 0.3).astype(np.float32)
    b, c = shape[0], shape[-1]
    nvox = shape[1] * shape[2] * shape[3]
    plan = finish_plan(b, nvox, c, **(kw or {}))
    s1, s2, visits = _emulate(s.reshape(b, nvox, c), plan)
    assert (visits == 1).all()
    _, w1, w2 = conv_finish_plain(torch.from_numpy(s), torch.bfloat16)
    for got, want in ((s1, w1), (s2, w2)):
        want = want.numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c", [2, 6, 1028])
def test_plan_refuses_what_the_kernel_does_not_take(c):
    with pytest.raises(ValueError, match="multiple of 4"):
        finish_plan(1, 64, c)
