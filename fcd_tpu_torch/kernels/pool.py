"""B2: the eval residual block's finale, with the 2x2x2 max pool fused.

Replaces `fcd_tpu/kernels/pool.py::fused_finale_pool` (pallas_call :215):

    out    = bf16(leaky(y2 * s2[b, c] + b2[b, c] + r * sr[b, c] + br[b, c]))
    pooled = max over each 2x2x2 block of `out` (the bf16-ROUNDED values,
             as the TPU kernel takes them, pool.py:177-180)

Route: Triton. B2 is a memory-bound elementwise pass with an 8-element
max: it has no product and no reuse across blocks, so masked block loads
do all it needs. What bounds it: the bytes, ~2 reads and 1-1.125 writes
of 2 bytes per element against ~5 operations. The design reads y2 and r
once and writes `out` once; with the pool, each program owns a tile of
pooled voxels and walks their eight children, so the pooled tensor is
produced from values still in registers and `out` is never read back.

CPU tensors take the plain PyTorch version; CUDA tensors launch the
kernel or raise. Triton is imported only when the kernel is launched.
"""

from __future__ import annotations

import os
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import max_pool_2x

REPLACES = "fcd_tpu/kernels/pool.py:185"  # fused_finale_pool (pallas_call :215)

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def finale_pool_plain(y2, r, s2, b2, sr, br, slope: float,
                      pool: bool = False) -> Result:
    def aff(t):
        return t.float()[:, None, None, None, :]

    t = y2.float() * aff(s2) + aff(b2) + (r.float() * aff(sr) + aff(br))
    out = F.leaky_relu(t, slope).to(y2.dtype)
    if not pool:
        return out
    return out, max_pool_2x(out)


_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def finale_kernel(y_ptr, r_ptr, s2_ptr, b2_ptr, sr_ptr, br_ptr, out_ptr,
                      pool_ptr, D, H, W, C, slope,
                      POOL: tl.constexpr, BLOCK_V: tl.constexpr,
                      BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cs = tl.arange(0, BLOCK_C)
        cmask = cs < C
        s2 = tl.load(s2_ptr + b * C + cs, mask=cmask, other=0.0)[None, :]
        b2 = tl.load(b2_ptr + b * C + cs, mask=cmask, other=0.0)[None, :]
        sr = tl.load(sr_ptr + b * C + cs, mask=cmask, other=0.0)[None, :]
        br = tl.load(br_ptr + b * C + cs, mask=cmask, other=0.0)[None, :]
        if POOL:
            hp = H // 2
            wp = W // 2
            npool = (D // 2) * hp * wp
            pv = pid * BLOCK_V + tl.arange(0, BLOCK_V)
            vmask = pv < npool
            pz = pv // (hp * wp)
            py = (pv // wp) % hp
            px = pv % wp
            mask = vmask[:, None] & cmask[None, :]
            m = tl.full([BLOCK_V, BLOCK_C], float("-inf"), tl.float32)
            for k in tl.static_range(8):
                z = 2 * pz + k // 4
                y = 2 * py + (k // 2) % 2
                x = 2 * px + k % 2
                vox = ((b * D + z).to(tl.int64) * H + y) * W + x
                off = vox[:, None] * C + cs[None, :]
                yv = tl.load(y_ptr + off, mask=mask, other=0.0).to(tl.float32)
                rv = tl.load(r_ptr + off, mask=mask, other=0.0).to(tl.float32)
                t = (yv * s2 + b2) + (rv * sr + br)
                f = tl.where(t >= 0, t, slope * t)
                fb = f.to(out_ptr.dtype.element_ty)
                tl.store(out_ptr + off, fb, mask=mask)
                m = tl.maximum(m, fb.to(tl.float32))
            poff = (b.to(tl.int64) * npool + pv)[:, None] * C + cs[None, :]
            tl.store(pool_ptr + poff, m.to(pool_ptr.dtype.element_ty),
                     mask=mask)
        else:
            nvox = D * H * W
            v = pid * BLOCK_V + tl.arange(0, BLOCK_V)
            vmask = v < nvox
            mask = vmask[:, None] & cmask[None, :]
            off = (b.to(tl.int64) * nvox + v)[:, None] * C + cs[None, :]
            yv = tl.load(y_ptr + off, mask=mask, other=0.0).to(tl.float32)
            rv = tl.load(r_ptr + off, mask=mask, other=0.0).to(tl.float32)
            t = (yv * s2 + b2) + (rv * sr + br)
            f = tl.where(t >= 0, t, slope * t)
            tl.store(out_ptr + off, f.to(out_ptr.dtype.element_ty), mask=mask)

    _KERNEL = finale_kernel
    return _KERNEL


def finale_pool(y2: torch.Tensor, r: torch.Tensor, s2: torch.Tensor,
                b2: torch.Tensor, sr: torch.Tensor, br: torch.Tensor,
                slope: float, pool: bool = False) -> Result:
    """B2 wrapper. y2, r: (B, D, H, W, C); s2, b2, sr, br: (B, C) f32.
    Returns out, or (out, pooled) with pool=True (even D, H, W)."""
    if y2.dim() != 5 or r.shape != y2.shape:
        raise ValueError(f"y2 {tuple(y2.shape)} and r {tuple(r.shape)} must be "
                         "equal (B, D, H, W, C) tensors")
    b, d, h, w, c = y2.shape
    for t in (s2, b2, sr, br):
        if tuple(t.shape) != (b, c):
            raise ValueError(f"finale affines must be ({b}, {c})")
    if pool and (d % 2 or h % 2 or w % 2):
        raise ValueError(f"the 2x pool needs even D, H, W, got {(d, h, w)}")
    if y2.device.type == "cpu":
        return finale_pool_plain(y2, r, s2, b2, sr, br, slope, pool)
    if y2.device.type != "cuda":
        raise ValueError(f"finale_pool: unsupported device {y2.device}")
    if y2.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
        raise TypeError(f"finale_pool kernel got {y2.dtype} y2 and {r.dtype} "
                        "r" + _build.BF16_ONLY)
    if not (y2.is_contiguous() and r.is_contiguous()):
        raise ValueError("finale_pool kernel takes contiguous tensors")
    aff = [t.to(device=y2.device, dtype=torch.float32).contiguous()
           for t in (s2, b2, sr, br)]
    out = torch.empty_like(y2)
    pooled = (torch.empty((b, d // 2, h // 2, w // 2, c), dtype=y2.dtype,
                          device=y2.device) if pool else out)
    block_c = 1 << max(0, (c - 1).bit_length())
    # ~4096 elements per tile load (read 8 times over with the pool)
    block_v = max(1, (1024 if pool else 4096) // block_c)
    n = (d // 2) * (h // 2) * (w // 2) if pool else d * h * w
    grid = ((n + block_v - 1) // block_v, b)
    _kernel()[grid](y2, r, *aff, out, pooled, d, h, w, c, float(slope),
                    POOL=pool, BLOCK_V=block_v, BLOCK_C=block_c,
                    num_warps=4)
    finale_pool.launches += 1
    return (out, pooled) if pool else out


finale_pool.launches = 0
