"""B1's tiling and weight packing on the CPU (`kernels/block_conv.py`).

The CUDA kernel `csrc/conv3d.cu` runs only on the card, but the wrapper
chooses its tile, its grid and its partial-sum rows (one per spatial tile),
and packs its weights, in Python. These tests hold that choice to what the
kernel assumes: the tiles and cout slices partition the output, the tile
and slice widths name one of the kernel's instances, and the packed weights
sit where the kernel's wgmma descriptors read them. The kernel's decode of
a block into its tile is held on the card, at ragged grids, by
`tests/test_torch_port_cuda.py`.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fcd_tpu_torch.kernels.block_conv import (
    KC,
    SMS,
    TILE_HW,
    conv_tiling,
    pack_weights,
)

import torch_port_workers

torch_port_workers.share_cores()

grids = st.tuples(st.integers(1, 4), st.integers(1, 70), st.integers(1, 70),
                  st.integers(1, 70), st.integers(1, 1024))


@settings(max_examples=100, deadline=None)
@given(grids)
def test_tiles_cover_every_voxel_and_channel_once(shape):
    """Along each axis the tiles (td, 8, 8 voxels) and along cout the
    slices (bn channels) start at multiples of their width, reach the end
    and none starts past it: every voxel and channel lies in exactly one
    block, and no block is empty (the kernel masks the ragged last one)."""
    b, d, h, w, cout = shape
    t = conv_tiling(b, d, h, w, cout)
    for n, size, extent in ((t.ntz, t.td, d), (t.nty, TILE_HW, h),
                            (t.ntx, TILE_HW, w), (t.ncout, t.bn, cout)):
        assert (n - 1) * size < extent <= n * size


@settings(max_examples=100, deadline=None)
@given(grids)
def test_tiling_stays_inside_the_kernels_instances(shape):
    """td and bn name one of conv3d.cu's six instances; the cout split
    narrows bn only while the grid has fewer blocks than the card's SMs."""
    b, d, h, w, cout = shape
    t = conv_tiling(b, d, h, w, cout)
    assert t.td in (2, 4) and t.bn in (16, 32, 64)
    assert t.td == 2 or d > 2
    assert t.ncout <= 65535 and b <= 65535
    widest = 16 if cout <= 16 else 32 if cout <= 32 else 64
    if t.bn < widest:
        assert t.rows * -(-cout // (2 * t.bn)) * b < SMS


@pytest.mark.parametrize("c,cout,bn", [(16, 16, 16), (2, 16, 16),
                                       (24, 20, 16), (40, 72, 32),
                                       (8, 8, 64)])
def test_packed_weights_sit_where_the_kernel_reads_them(c, cout, bn):
    """Packed (slice, k-step, tap, plane, n, k) is w[tap, 16 k-step +
    8 plane + k, bn slice + n], zero outside (C, cout)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 3, 3, c, cout, generator=gen)
    p = pack_weights(w, bn)
    nch, nt = -(-c // KC), -(-cout // bn)
    assert p.shape == (nt, nch, 27, 2, bn, 8) and p.is_contiguous()
    s, ch, tap, cg, n, k = np.meshgrid(*[np.arange(v) for v in p.shape],
                                       indexing="ij")
    ci, co = ch * KC + cg * 8 + k, s * bn + n
    inside = (ci < c) & (co < cout)
    wf = w.reshape(27, c, cout).numpy()
    want = np.where(inside, wf[tap, np.minimum(ci, c - 1),
                               np.minimum(co, cout - 1)], 0.0)
    np.testing.assert_array_equal(p.numpy(), want)


@pytest.mark.parametrize("c,cout,bn", [(16, 16, 16), (2, 24, 16),
                                       (48, 100, 64)])
def test_packed_shortcut_sits_where_the_kernel_reads_it(c, cout, bn):
    """The 1x1 shortcut's (C, cout) weights pack as one tap."""
    gen = torch.Generator().manual_seed(1)
    wr = torch.randn(c, cout, generator=gen)
    p = pack_weights(wr, bn)
    nch, nt = -(-c // KC), -(-cout // bn)
    assert p.shape == (nt, nch, 1, 2, bn, 8) and p.is_contiguous()
    s, ch, _, cg, n, k = np.meshgrid(*[np.arange(v) for v in p.shape],
                                     indexing="ij")
    ci, co = ch * KC + cg * 8 + k, s * bn + n
    want = np.where((ci < c) & (co < cout),
                    wr.numpy()[np.minimum(ci, c - 1),
                               np.minimum(co, cout - 1)], 0.0)
    np.testing.assert_array_equal(p.numpy(), want)


@pytest.mark.parametrize("shape,td,bn,blocks", [
    ((1, 128, 128, 128, 16), 4, 16, 8192),   # enc1: 32 x 16 x 16 tiles
    ((1, 64, 64, 64, 32), 4, 32, 1024),      # enc2 / dec2
    ((1, 4, 4, 4, 512), 4, 16, 32),          # enc6: the cout split
    ((4, 16, 16, 16, 128), 4, 32, 256),      # enc4 at train batch 4
    ((1, 1, 9, 17, 24), 2, 16, 12)])         # a 1-voxel-thick grid
def test_main_path_tilings(shape, td, bn, blocks):
    t = conv_tiling(*shape)
    assert (t.td, t.bn, t.rows * t.ncout * shape[0]) == (td, bn, blocks)
