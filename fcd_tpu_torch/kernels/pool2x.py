"""B3 and B9: the 2x2x2 max pool in a pass of its own, and its backward.

Where encoders 1-2 do not pool inside their block finale (the gates of
`fcd_tpu_torch/flags.py::pool_in_finale`), they pool here:

    B3   pooled = max over each 2x2x2 block of x
         x (B, D, H, W, C) -> (B, D/2, H/2, W/2, C), in x's dtype
    B9   dx = where(x == max of its block, g / (ties in the block), 0)
         the quotient in f32, stored in x's dtype; g is the cotangent of
         `pooled`, and the max is recomputed from x

B3 replaces `fcd_tpu/kernels/pool.py::pool_fwd_pallas` (:121, pallas_call
:144) and B9 `pool.py::pool_bwd_pallas` (:53, pallas_call :74; it too
recomputes the max, `del m` at :73). Both TPU kernels pool over the eight
parity lane groups of an s2d tensor, optionally reading the interior rows
of a padded-chain input; on the port's dense channels-last tensors that
is the 2x2x2 block of each pooled voxel. B9's even split among exact
ties is the s2d pool's custom VJP (`fcd_tpu/ops/s2d_ops.py:237-252`),
which torch's max-pool backward does not give (it sends the gradient to a
single index, ROADMAP C1).

Route: Triton. Both kernels are memory-bound and have no product: B3 is
an 8-way max reduction, B9 an elementwise pass with an 8-way compare and
count (B2 and K2 are Triton for the same reason). What bounds them: the
bytes, 2.25 per element for B3 (x read, pooled written) against 1 max,
4.25 for B9 (x read, g read once per block, dx written) against ~4
operations. The design gives each program a tile of pooled voxels: B3
walks their eight children and keeps the max in registers; B9 loads the
children as one [voxels, 8, channels] block, so the max, the tie count
and the split come from registers and every input is read once. B9
divides with `div_rn` (Triton's `/` on f32 is not correctly rounded), so
dx is bit-equal to the plain version.

CPU tensors take the plain PyTorch versions; CUDA tensors launch the
kernels or raise. Triton is imported only when a kernel is launched.
`max_pool2x_op` is the differentiable op (`MaxPool2x`): forward B3,
backward B9.
"""

from __future__ import annotations

import os

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import blocks_2x, max_pool_2x, unblocks_2x

REPLACES_FWD = "fcd_tpu/kernels/pool.py:121"  # pool_fwd_pallas (pallas_call :144)
REPLACES_BWD = "fcd_tpu/kernels/pool.py:53"   # pool_bwd_pallas (pallas_call :74)

max_pool2x_plain = max_pool_2x   # B3's function: torch max_pool3d(x, 2, 2)


def max_pool2x_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B9's function: each tied maximum of a block takes g / ties (f32),
    the rest 0, in x's dtype."""
    xb = blocks_2x(x.float())                             # (B, .., 8, C)
    eq = xb == xb.amax(dim=4, keepdim=True)
    share = g.float()[:, :, :, :, None, :] / eq.float().sum(dim=4,
                                                            keepdim=True)
    return unblocks_2x(torch.where(eq, share, 0.0)).to(x.dtype)


_KERNELS = None


def _kernels():
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def pool_fwd_kernel(x_ptr, out_ptr, D, H, W, C,
                        BLOCK_V: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        hp = H // 2
        wp = W // 2
        npool = (D // 2) * hp * wp
        pv = pid * BLOCK_V + tl.arange(0, BLOCK_V)
        cs = tl.arange(0, BLOCK_C)
        mask = (pv < npool)[:, None] & (cs < C)[None, :]
        pz = pv // (hp * wp)
        py = (pv // wp) % hp
        px = pv % wp
        m = tl.full([BLOCK_V, BLOCK_C], float("-inf"), tl.float32)
        for k in tl.static_range(8):
            z = 2 * pz + k // 4
            y = 2 * py + (k // 2) % 2
            x = 2 * px + k % 2
            vox = ((b * D + z).to(tl.int64) * H + y) * W + x
            v = tl.load(x_ptr + vox[:, None] * C + cs[None, :], mask=mask,
                        other=float("-inf"))
            m = tl.maximum(m, v.to(tl.float32))
        poff = (b.to(tl.int64) * npool + pv)[:, None] * C + cs[None, :]
        tl.store(out_ptr + poff, m.to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def pool_bwd_kernel(x_ptr, g_ptr, dx_ptr, D, H, W, C,
                        BLOCK_V: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        hp = H // 2
        wp = W // 2
        npool = (D // 2) * hp * wp
        pv = pid * BLOCK_V + tl.arange(0, BLOCK_V)
        cs = tl.arange(0, BLOCK_C)
        vmask = pv < npool
        cmask = cs < C
        pz = pv // (hp * wp)
        py = (pv // wp) % hp
        px = pv % wp
        k = tl.arange(0, 8)
        z = 2 * pz[:, None] + (k // 4)[None, :]
        y = 2 * py[:, None] + ((k // 2) % 2)[None, :]
        x = 2 * px[:, None] + (k % 2)[None, :]
        vox = ((b * D + z).to(tl.int64) * H + y) * W + x          # [V, 8]
        off = vox[:, :, None] * C + cs[None, None, :]             # [V, 8, C]
        mask = vmask[:, None, None] & cmask[None, None, :]
        xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        m = tl.max(xv, axis=1)
        eq = xv == m[:, None, :]
        cnt = tl.sum(eq.to(tl.float32), axis=1)
        poff = (b.to(tl.int64) * npool + pv)[:, None] * C + cs[None, :]
        g = tl.load(g_ptr + poff, mask=vmask[:, None] & cmask[None, :],
                    other=0.0).to(tl.float32)
        share = tl.math.div_rn(g, tl.maximum(cnt, 1.0))
        dx = tl.where(eq, share[:, None, :], 0.0)
        tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    _KERNELS = (pool_fwd_kernel, pool_bwd_kernel)
    return _KERNELS


def _check(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5:
        raise ValueError(f"{what}: x must be (B, D, H, W, C), got "
                         f"{tuple(x.shape)}")
    d, h, w = x.shape[1:4]
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"{what}: the 2x pool needs even D, H, W, got "
                         f"{(d, h, w)}")


def _launch_shape(x: torch.Tensor, per_block: int):
    b, d, h, w, c = x.shape
    block_c = 1 << max(0, (c - 1).bit_length())
    block_v = max(1, per_block // block_c)
    n = (d // 2) * (h // 2) * (w // 2)
    return ((n + block_v - 1) // block_v, b), block_v, block_c


def _on_card(ts, what: str) -> None:
    if ts[0].device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ts[0].device}")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"{what} kernel takes bf16 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors")


def max_pool2x(x: torch.Tensor) -> torch.Tensor:
    """B3 wrapper: (B, D, H, W, C) -> (B, D/2, H/2, W/2, C)."""
    _check(x, "max_pool2x")
    if x.device.type == "cpu":
        return max_pool2x_plain(x)
    _on_card([x], "max_pool2x")
    b, d, h, w, c = x.shape
    out = torch.empty((b, d // 2, h // 2, w // 2, c), dtype=x.dtype,
                      device=x.device)
    # ~1024 elements per child load, read for each of the eight children
    grid, block_v, block_c = _launch_shape(x, 1024)
    _kernels()[0][grid](x, out, d, h, w, c, BLOCK_V=block_v,
                        BLOCK_C=block_c, num_warps=4)
    max_pool2x.launches += 1
    return out


max_pool2x.launches = 0


def max_pool2x_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B9 wrapper: x (B, D, H, W, C), g (B, D/2, H/2, W/2, C) -> dx."""
    _check(x, "max_pool2x_bwd")
    b, d, h, w, c = x.shape
    if tuple(g.shape) != (b, d // 2, h // 2, w // 2, c):
        raise ValueError(f"g {tuple(g.shape)} does not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return max_pool2x_bwd_plain(x, g)
    _on_card([x, g], "max_pool2x_bwd")
    dx = torch.empty_like(x)
    # ~4096 elements per [V, 8, C] block
    grid, block_v, block_c = _launch_shape(x, 512)
    _kernels()[1][grid](x, g, dx, d, h, w, c, BLOCK_V=block_v,
                        BLOCK_C=block_c, num_warps=4)
    max_pool2x_bwd.launches += 1
    return dx


max_pool2x_bwd.launches = 0


class MaxPool2x(torch.autograd.Function):
    """pooled = the 2x2x2 max pool; forward B3, backward B9 (even split)."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.save_for_backward(x)
        return max_pool2x(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool2x_bwd(x, g.to(x.dtype).contiguous())


def max_pool2x_op(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x max pool (`MaxPool2x`)."""
    return MaxPool2x.apply(x)
