"""B4's tiling (`fcd_tpu_torch/kernels/upsample.py::upsample_plan`) and the
exit's vector width (`fcd_tpu_torch/kernels/sw_io.py::exit_group`), with
plain PyTorch emulations of what the two CUDA kernels index, on the CPU.

* B4's blocks, each walking voxel tiles with one column tile, cover every
  (batch, coarse voxel) row and every output column of the GEMM exactly
  once, at the ten decoder calls of the main path (five decoders at batch
  1 and 4) and at ragged shapes, launch at least one block per SM (132) at
  the main path's shapes, and fit shared memory.
* An emulation of the kernel (the weight of column n read from row 7 - q
  of the (8, Ci, Co) kernel and rounded to bf16 on load, f32 products, the
  bias in f32, one bf16 rounding, and the epilogue's scatter of each row's
  columns onto its fine runs) writes every output element once and equals
  `upsample2x_plain` exactly (inputs whose products and sums are exact in
  f32).
* The exit's unit width G, and an emulation of its grid-stride walk: every
  output element written once, every vector access aligned, the result
  bit-equal to `sw_exit_plain`.
* The same for the entry (`entry_group`, the walk of `sw_entry_kernel`):
  every padded element written once, every access aligned and wholly in
  the volume or in the pad, bit-equal to `sw_entry_plain`.
"""

import pytest
import torch

import chip_smoke
from fcd_tpu_torch.kernels.sw_io import (
    entry_group,
    entry_pad,
    exit_group,
    sw_entry_plain,
    sw_exit_plain,
)
from fcd_tpu_torch.kernels.upsample import (
    SMEM_CAP,
    SMS,
    TILES,
    plan_for,
    smem_bytes,
    upsample2x_plain,
    upsample_matrix,
    upsample_plan,
)
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET

import torch_port_workers

torch_port_workers.share_cores()

torch.set_grad_enabled(False)


def decoder_calls(patch=128, fs=16):
    """(coarse grid, ci, co) of each decoder's upsample, read off the
    model: decoder k upsamples patch / 2^(5 - k)."""
    model = MS_DSA_NET(2, (patch,) * 3, feature_size=fs)
    return [(patch >> (5 - k), dec.transp.shape[3], dec.transp.shape[4])
            for k, dec in enumerate(model.decoders)]


MAIN = [(b, g, g, g, ci, co) for b in (1, 4) for g, ci, co in decoder_calls()]
RAGGED = [(1, 3, 5, 4, 12, 20), (2, 3, 5, 4, 12, 20), (1, 5, 3, 7, 2, 16),
          (2, 1, 1, 1, 2, 3), (1, 7, 9, 5, 40, 12), (3, 2, 3, 5, 24, 6)]


def test_decoder_calls_are_chip_smokes():
    assert [(g, ci, co) for _, g, ci, co in chip_smoke.DECODERS] == \
        decoder_calls()
    assert chip_smoke.per_train_step()["upsample2x"] == len(decoder_calls())


def _covered(n, tiles, size):
    """How often each of n indices is covered by the given tiles of
    `size`, each masking its ragged end as the kernel does."""
    idx = (tiles[:, None] * size + torch.arange(size)).flatten()
    return torch.bincount(idx[idx < n], minlength=n)


def walk(plan):
    """The voxel tiles the kernel's blocks walk, block after block: block
    bx takes bx, bx + m_blocks, bx + 2 m_blocks, ... below m_tiles."""
    return torch.cat([torch.arange(bx, plan.m_tiles, plan.m_blocks)
                      for bx in range(plan.m_blocks)])


@pytest.mark.parametrize("shape", MAIN + RAGGED)
def test_plan_covers_every_row_and_column_once(shape):
    b, d, h, w, ci, co = shape
    plan = upsample_plan(*shape)
    wm, wn, ni = TILES[plan.tile]
    assert (plan.bm, plan.bn) == (16 * wm, 8 * ni * wn)
    assert smem_bytes(plan.tile, ci) <= SMEM_CAP
    m, n = b * d * h * w, 8 * co
    ones = torch.ones
    # the grid is m_blocks x n_tiles blocks, each walking voxel tiles with
    # one column tile: (row, column) is covered once when each axis is
    assert torch.equal(_covered(m, walk(plan), plan.bm),
                       ones(m, dtype=torch.long))
    assert torch.equal(_covered(n, torch.arange(plan.n_tiles), plan.bn),
                       ones(n, dtype=torch.long))


@pytest.mark.parametrize("shape", MAIN)
def test_plan_fills_the_card_at_every_decoder(shape):
    plan = upsample_plan(*shape)
    assert plan.blocks >= SMS
    # and takes the largest tile that does
    m, n = shape[0] * shape[1] * shape[2] * shape[3], 8 * shape[5]
    for i in range(plan.tile):
        smaller = plan_for(i, m, n)
        assert smaller.m_tiles * smaller.n_tiles < SMS


@pytest.mark.parametrize("ci", [2, 12, 32, 256, 512, 1024])
def test_plan_fits_shared_memory(ci):
    plan = upsample_plan(1, 64, 64, 64, ci, 16)
    assert smem_bytes(plan.tile, ci) <= SMEM_CAP


def emulate_weights(kernel):
    """The kernel's (Ci, 8*Co) operand: column n = q*co + o reads row
    7 - q of the kernel viewed (8, Ci, Co), rounded to bf16 on load."""
    ci, co = kernel.shape[3], kernel.shape[4]
    n = torch.arange(8 * co)
    rows = kernel.reshape(8, ci, co)[7 - n // co, :, n % co]   # (8co, ci)
    return rows.t().to(torch.bfloat16).float()


def emulate_upsample(x, kernel, bias):
    """The kernel's arithmetic and its epilogue's addresses in PyTorch."""
    b, d, h, w, ci = x.shape
    co = kernel.shape[4]
    acc = x.reshape(-1, ci).float() @ emulate_weights(kernel)   # (M, 8co)
    if bias is not None:
        acc = acc + bias.float()[torch.arange(8 * co) % co]
    vals = acc.to(x.dtype)
    # rowbase: the fine voxel (2z, 2y, 2x) of each coarse voxel
    m = torch.arange(b * d * h * w)
    xx, y = m % w, (m // w) % h
    z, bb = (m // (w * h)) % d, m // (w * h * d)
    base = (((bb * 2 * d + 2 * z) * 2 * h + 2 * y) * 2 * w + 2 * xx) * co
    n = torch.arange(8 * co)
    pair = n // (2 * co)
    off = (pair >> 1) * (4 * h * w * co) + (pair & 1) * (2 * w * co) \
        + n - pair * 2 * co
    addr = (base[:, None] + off[None, :]).flatten()
    out = torch.zeros(b * 8 * d * h * w * co, dtype=x.dtype)
    out[addr] = vals.flatten()
    written = torch.bincount(addr, minlength=out.numel())
    return out.reshape(b, 2 * d, 2 * h, 2 * w, co), written


@pytest.mark.parametrize("shape,bias", [
    ((1, 2, 2, 2, 256, 128), False), ((1, 2, 3, 2, 128, 64), False),
    ((2, 3, 2, 4, 64, 32), False), ((1, 4, 3, 5, 32, 32), False),
    ((2, 5, 4, 3, 32, 16), False), ((1, 3, 5, 4, 12, 20), True),
    ((2, 3, 5, 4, 12, 20), True), ((1, 5, 3, 7, 2, 16), True),
    ((2, 1, 1, 1, 2, 3), True)])
def test_emulated_kernel_equals_plain(shape, bias):
    b, d, h, w, ci, co = shape
    g = torch.Generator().manual_seed(ci * 1000 + co)
    # small integers for x; the kernel's bf16 values are k/64, |k| in
    # 1..63, each moved by 2^-10 of itself so that the load's rounding
    # brings it back: products and sums are exact in f32
    x = torch.randint(-3, 4, (b, d, h, w, ci), generator=g).to(torch.bfloat16)
    k = torch.randint(1, 64, (2, 2, 2, ci, co), generator=g).float() / 64
    k = k * torch.where(torch.rand(k.shape, generator=g) < 0.5, -1.0, 1.0)
    k = k * (1 + torch.where(torch.rand(k.shape, generator=g) < 0.5,
                             -1.0, 1.0) * 2 ** -10)
    assert not torch.equal(k.to(torch.bfloat16).float(), k)
    bb = torch.randn(co, generator=g) if bias else None
    got, written = emulate_upsample(x, k, bb)
    assert torch.equal(written, torch.ones_like(written))
    want = upsample2x_plain(x, k, bb)
    assert got.dtype == want.dtype
    assert torch.equal(got.float(), want.float())


@pytest.mark.parametrize("ci,co", [(256, 128), (32, 16), (12, 20), (2, 3)])
def test_emulated_weights_are_the_flipped_bf16_kernel(ci, co):
    """Row 7 - q with the bf16 round on load is `upsample_matrix` of the
    kernel cast to bf16: the flip folded into the index, the same bits."""
    k = torch.randn((2, 2, 2, ci, co), generator=torch.Generator()
                    .manual_seed(ci + co))
    assert torch.equal(emulate_weights(k),
                       upsample_matrix(k.to(torch.bfloat16)).float())


# -- sw_exit ------------------------------------------------------------------

@pytest.mark.parametrize("o,w,pw,ow,aligned,want", [
    (2, 240, 240, 0, True, 2),     # the CLI's exit: two voxels a float4
    (2, 236, 240, 2, True, 2),
    (2, 234, 240, 3, True, 1),     # odd corner: one voxel a float2
    (2, 7, 14, 3, True, 1),        # the crop at (1, 2, 3)
    (2, 9, 14, 0, True, 1),        # odd width
    (2, 240, 240, 0, False, 0),    # unaligned tensors: the general path
    (1, 240, 240, 0, True, 0),     # other O: the general path
    (1, 7, 14, 3, True, 0),
    (3, 240, 240, 0, True, 0),
    (3, 7, 14, 3, True, 0),
    (4, 240, 240, 0, True, 0)])
def test_exit_group(o, w, pw, ow, aligned, want):
    assert exit_group(o, w, pw, ow, aligned) == want


def emulate_exit(acc, inv, start, size, g):
    """The kernel's walk: unit u covers G voxels (one of O scalars on the
    general path, g = 0) and writes out[u*G*O : (u+1)*G*O]."""
    (od, oh, ow), (d, h, w) = start, size
    pd, ph, pw, o = acc.shape
    gg = g or 1
    u = torch.arange(d * h * (w // gg))
    r, xg = u // (w // gg), u % (w // gg)
    z, y = r // h, r % h
    pv = ((z + od) * ph + (y + oh)) * pw + ow + xg * gg
    if g:
        # every access starts at a multiple of its width
        assert bool((pv % g == 0).all())
    j = torch.arange(gg * o)
    src = (pv[:, None] * o + j).flatten()                 # acc elements
    cov = (pv[:, None] + j // o).flatten()                # their coverage
    dst = (u[:, None] * gg * o + j).flatten()
    out = torch.zeros(d * h * w * o)
    out[dst] = acc.flatten()[src] * inv.flatten()[cov]
    written = torch.bincount(dst, minlength=out.numel())
    return out.reshape(d, h, w, o), written


@pytest.mark.parametrize("o", [1, 2, 3])
@pytest.mark.parametrize("start,size", [((0, 0, 0), (10, 12, 14)),
                                        ((1, 2, 3), (7, 9, 8)),
                                        ((1, 2, 3), (7, 9, 11)),
                                        ((2, 0, 2), (6, 12, 12))])
def test_emulated_exit_walk_equals_plain(o, start, size):
    g = torch.Generator().manual_seed(o)
    acc = torch.randn((10, 12, 14, o), generator=g)
    inv = torch.rand((10, 12, 14, 1), generator=g) + 0.1
    grp = exit_group(o, size[2], acc.shape[2], start[2])
    got, written = emulate_exit(acc, inv, start, size, grp)
    assert torch.equal(written, torch.ones_like(written))
    assert torch.equal(got, sw_exit_plain(acc, inv, start, size))


@pytest.mark.parametrize("c,w,pw,bw,aligned,want", [
    (2, 240, 240, 0, True, 4),     # the CLI's entry: two voxels a float4
    (2, 100, 128, 14, True, 4),    # even lead pad
    (2, 125, 128, 1, True, 2),     # odd lead pad: one voxel a float2
    (2, 7, 8, 0, True, 2),
    (3, 7, 8, 0, True, 1),         # odd rows: the general path
    (4, 7, 8, 0, True, 4),
    (1, 8, 16, 4, True, 4),
    (1, 8, 10, 1, True, 1),
    (2, 240, 240, 0, False, 1)])   # unaligned tensors: the general path
def test_entry_group(c, w, pw, bw, aligned, want):
    assert entry_group(c, w, pw, bw, aligned) == want


def emulate_entry(vol, roi, g):
    """The kernel's walk: unit u covers G elements of the padded output,
    read from the input row at its place minus the lead pad, or zeros."""
    d, h, w, c = vol.shape
    (bd, _), (bh, _), (bw, _) = entry_pad((d, h, w), roi)
    pd, ph, pw = (max(s, r) for s, r in zip((d, h, w), roi))
    row_units, wc_units, lead = pw * c // g, w * c // g, bw * c // g
    u = torch.arange(pd * ph * pw * c // g)
    r = u // row_units
    k = u - r * row_units - lead
    z, y = r // ph, r % ph
    sz, sy = z - bd, y - bh
    inside = (sz >= 0) & (sz < d) & (sy >= 0) & (sy < h) & (k >= 0) & (
        k < wc_units)
    src = ((sz * h + sy) * wc_units + k) * g
    # every read starts at a multiple of its width, every unit lies wholly
    # in the volume or in the pad
    assert bool((src[inside] % g == 0).all())
    j = torch.arange(g)
    dst = (u[:, None] * g + j).flatten()
    out = torch.zeros(pd * ph * pw * c)
    flat = vol.flatten()
    srcs = (src[:, None] + j).flatten()
    keep = inside[:, None].expand(-1, g).flatten()
    out[dst[keep]] = flat[srcs[keep]]
    written = torch.bincount(dst, minlength=out.numel())
    return out.reshape(pd, ph, pw, c), written


@pytest.mark.parametrize("shape,roi", [((10, 16, 8, 2), (8, 16, 8)),
                                       ((10, 12, 7, 2), (16, 16, 8)),
                                       ((9, 12, 7, 3), (16, 8, 8)),
                                       ((12, 10, 8, 2), (16, 16, 16)),
                                       ((10, 9, 5, 2), (12, 12, 8))])
def test_emulated_entry_walk_equals_plain(shape, roi):
    vol = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    pads = entry_pad(shape[:3], roi)
    pw = shape[2] + sum(pads[2])
    g = entry_group(shape[3], shape[2], pw, pads[2][0])
    got, written = emulate_entry(vol, roi, g)
    assert torch.equal(written, torch.ones_like(written))
    assert torch.equal(got, sw_entry_plain(vol, roi, torch.float32))
