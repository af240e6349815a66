"""The differentiable train finale (B8): forward B2, backward K2.

Replaces `fcd_tpu/kernels/finale.py::finale_fwd_pallas` (:70, whose
function B2's kernel in `kernels/pool.py` computes) and
`finale_bwd_pallas` (:170, K2 here):

    t      = (ys * s2[b, c] + b2[b, c]) + (rs * sr[b, c] + br[b, c])
    out    = bf16(leaky(t));  pooled = 2x2x2 max of out (optional)

K2, given gp (cotangent of out) and gq (of pooled, or None):

    g  = gp + share(out's 2x2x2 block) * gq
    dt = g * (t >= 0 ? 1 : slope)                        -> bf16
    a1 = sum dt * ys,  a2 = sum dt,  a3 = sum dt * rs    per (b, c), f32

t is recomputed in B2's association order and the pool mask is taken on
the bf16-ROUNDED output. How tied maxima share gq follows the pool the JAX
package runs at the block's level (ROADMAP C1, C8):

- `even` (levels 1-2, the s2d pool's custom VJP, `fcd_tpu/ops/
  s2d_ops.py:237-252`, and `fcd_tpu/kernels/finale.py:148-156`): each tied
  maximum takes gq / (ties in the block);
- `chain` (levels 3-5, `fcd_tpu/ops/layers.py::max_pool_2x`): the pool is
  a `jnp.maximum` chain over W pairs, then D pairs, then H pairs, and
  `jnp.maximum` gives half to each side of a tie, so a child takes gq times
  its factor at each of the three stages: 0 where its branch is not the
  pair's maximum, 1/2 where the pair ties, 1 otherwise.

Route: Triton. K2 is an elementwise pass with an 8-way max/count and
per-channel sums, with no product: masked block loads and block
reductions are all it needs. What bounds it: the bytes, ~8.25 per
element (ys, rs, gp read, dt written, gq read once per 8) against ~15
operations. The design walks each pooled voxel's eight children as one
[voxels, 8, channels] block, so the max, the tie count and the split are
taken from registers and every input is read once; in `chain` mode the
eight children are eight [V, C] blocks instead, so that each pair of the
chain is an elementwise op on two of them. Each program writes its
per-channel partial sums once, at its slot of a (programs, B, C) buffer,
and the wrapper adds them over the programs in a fixed order (no atomics),
so a1..a3 are the same bits from run to run.

CPU tensors take the plain PyTorch version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.kernels.pool import finale_pool
from fcd_tpu_torch.ops.layers import blocks_2x, unblocks_2x

REPLACES = "fcd_tpu/kernels/finale.py:170"  # finale_bwd_pallas (pallas_call :207)
TIES = ("even", "chain")


def _pair(a, b):
    """One `jnp.maximum` of the chain: (max, a's factor, b's factor), each
    factor 0 off the maximum, 1/2 on a tie, 1 otherwise."""
    m = torch.maximum(a, b)
    half = torch.where(a == b, 0.5, 1.0)
    return m, torch.where(a == m, half, 0.0), torch.where(b == m, half, 0.0)


def chain_factors(fb: torch.Tensor) -> torch.Tensor:
    """(..., 8, C) blocks (child k = 4 kd + 2 kh + kw) -> each child's share
    of the pooled cotangent under the W, D, H `jnp.maximum` chain."""
    v = fb.unflatten(-2, (2, 2, 2))                       # (..., kd, kh, kw, C)
    mw, w0, w1 = _pair(v[..., 0, :], v[..., 1, :])        # (..., kd, kh, C)
    md, d0, d1 = _pair(mw[..., 0, :, :], mw[..., 1, :, :])  # (..., kh, C)
    _, h0, h1 = _pair(md[..., 0, :], md[..., 1, :])       # (..., C)
    fw = torch.stack([w0, w1], dim=-2)                    # (..., kd, kh, kw, C)
    fd = torch.stack([d0, d1], dim=-3)                    # (..., kd, kh, C)
    fh = torch.stack([h0, h1], dim=-2)                    # (..., kh, C)
    f = fw * fd.unsqueeze(-2) * fh.unsqueeze(-2).unsqueeze(-4)
    return f.flatten(-4, -2)


def finale_bwd_plain(ys, rs, s2, b2, sr, br, gp, gq, slope: float,
                     tie: str = "even"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """K2's function in plain PyTorch: (dt in ys's dtype, a1, a2, a3)."""
    def aff(a):
        return a.float()[:, None, None, None, :]

    yf, rf = ys.float(), rs.float()
    t = (yf * aff(s2) + aff(b2)) + (rf * aff(sr) + aff(br))
    g = gp.float()
    if gq is not None:
        fb = blocks_2x(torch.where(t >= 0, t, slope * t).to(ys.dtype).float())
        gq8 = gq.float()[:, :, :, :, None, :]
        if tie == "chain":
            share = gq8 * chain_factors(fb)
        else:
            eq = fb == fb.amax(dim=4, keepdim=True)
            share = torch.where(eq, gq8 / eq.float().sum(dim=4, keepdim=True),
                                0.0)
        g = g + unblocks_2x(share)
    dt = g * torch.where(t >= 0, 1.0, slope)
    dims = (1, 2, 3)
    return (dt.to(ys.dtype), (dt * yf).sum(dims), dt.sum(dims),
            (dt * rf).sum(dims))


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
    def _tl_pair(a, b):
        m = tl.maximum(a, b)
        half = tl.where(a == b, 0.5, 1.0)
        return m, tl.where(a == m, half, 0.0), tl.where(b == m, half, 0.0)

    @triton.jit
    def _tl_child(ys_ptr, rs_ptr, off, mask, s2, b2, sr, br, slope):
        """One child of every pooled voxel: (ys, rs, t, bf16-rounded out)."""
        yv = tl.load(ys_ptr + off, mask=mask, other=0.0).to(tl.float32)
        rv = tl.load(rs_ptr + off, mask=mask, other=0.0).to(tl.float32)
        t = (yv * s2[None, :] + b2[None, :]) + (rv * sr[None, :] + br[None, :])
        f = tl.where(t >= 0, t, slope * t)
        return yv, rv, t, f.to(ys_ptr.dtype.element_ty).to(tl.float32)

    @triton.jit
    def _tl_child_dt(gp_ptr, dt_ptr, off, mask, yv, rv, t, share, slope):
        """Store one child's dt; its partial sums of dt*ys, dt, dt*rs."""
        g = tl.load(gp_ptr + off, mask=mask, other=0.0).to(tl.float32) + share
        dt = g * tl.where(t >= 0, 1.0, slope)
        dt = tl.where(mask, dt, 0.0)
        tl.store(dt_ptr + off, dt.to(dt_ptr.dtype.element_ty), mask=mask)
        return (tl.sum(dt * yv, axis=0), tl.sum(dt, axis=0),
                tl.sum(dt * rv, axis=0))

    @triton.jit
    def finale_bwd_kernel(ys_ptr, rs_ptr, s2_ptr, b2_ptr, sr_ptr, br_ptr,
                          gp_ptr, gq_ptr, dt_ptr, a1_ptr, a2_ptr, a3_ptr,
                          D, H, W, C, slope,
                          POOL: tl.constexpr, CHAIN: tl.constexpr,
                          BLOCK_V: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cs = tl.arange(0, BLOCK_C)
        cmask = cs < C
        s2 = tl.load(s2_ptr + b * C + cs, mask=cmask, other=0.0)
        b2 = tl.load(b2_ptr + b * C + cs, mask=cmask, other=0.0)
        sr = tl.load(sr_ptr + b * C + cs, mask=cmask, other=0.0)
        br = tl.load(br_ptr + b * C + cs, mask=cmask, other=0.0)
        if POOL and CHAIN:
            # the eight children as eight [V, C] blocks, so that each pair
            # of the W, D, H maximum chain is an elementwise op
            hp = H // 2
            wp = W // 2
            npool = (D // 2) * hp * wp
            pv = pid * BLOCK_V + tl.arange(0, BLOCK_V)
            vmask = pv < npool
            pz = pv // (hp * wp)
            py = (pv // wp) % hp
            px = pv % wp
            v0 = ((b * D + 2 * pz).to(tl.int64) * H + 2 * py) * W + 2 * px
            sd = H * W
            mask = vmask[:, None] & cmask[None, :]
            o000 = v0[:, None] * C + cs[None, :]
            o001 = o000 + C
            o010 = o000 + W * C
            o011 = o010 + C
            o100 = o000 + sd * C
            o101 = o100 + C
            o110 = o100 + W * C
            o111 = o110 + C
            y000, r000, t000, f000 = _tl_child(ys_ptr, rs_ptr, o000, mask, s2, b2, sr, br, slope)
            y001, r001, t001, f001 = _tl_child(ys_ptr, rs_ptr, o001, mask, s2, b2, sr, br, slope)
            y010, r010, t010, f010 = _tl_child(ys_ptr, rs_ptr, o010, mask, s2, b2, sr, br, slope)
            y011, r011, t011, f011 = _tl_child(ys_ptr, rs_ptr, o011, mask, s2, b2, sr, br, slope)
            y100, r100, t100, f100 = _tl_child(ys_ptr, rs_ptr, o100, mask, s2, b2, sr, br, slope)
            y101, r101, t101, f101 = _tl_child(ys_ptr, rs_ptr, o101, mask, s2, b2, sr, br, slope)
            y110, r110, t110, f110 = _tl_child(ys_ptr, rs_ptr, o110, mask, s2, b2, sr, br, slope)
            y111, r111, t111, f111 = _tl_child(ys_ptr, rs_ptr, o111, mask, s2, b2, sr, br, slope)
            # W pairs (per kd, kh), then D pairs (per kh), then the H pair
            m00, w000, w001 = _tl_pair(f000, f001)
            m01, w010, w011 = _tl_pair(f010, f011)
            m10, w100, w101 = _tl_pair(f100, f101)
            m11, w110, w111 = _tl_pair(f110, f111)
            md0, d00, d10 = _tl_pair(m00, m10)
            md1, d01, d11 = _tl_pair(m01, m11)
            _, h0, h1 = _tl_pair(md0, md1)
            poff = (b.to(tl.int64) * npool + pv)[:, None] * C + cs[None, :]
            gq = tl.load(gq_ptr + poff, mask=mask, other=0.0).to(tl.float32)
            q00 = gq * d00 * h0
            q01 = gq * d01 * h1
            q10 = gq * d10 * h0
            q11 = gq * d11 * h1
            p1, p2, p3 = _tl_child_dt(gp_ptr, dt_ptr, o000, mask, y000, r000, t000, q00 * w000, slope)
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o001, mask, y001, r001, t001, q00 * w001, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o010, mask, y010, r010, t010, q01 * w010, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o011, mask, y011, r011, t011, q01 * w011, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o100, mask, y100, r100, t100, q10 * w100, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o101, mask, y101, r101, t101, q10 * w101, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o110, mask, y110, r110, t110, q11 * w110, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
            s1, s2_, s3 = _tl_child_dt(gp_ptr, dt_ptr, o111, mask, y111, r111, t111, q11 * w111, slope)
            p1, p2, p3 = p1 + s1, p2 + s2_, p3 + s3
        elif POOL:
            hp = H // 2
            wp = W // 2
            npool = (D // 2) * hp * wp
            pv = pid * BLOCK_V + tl.arange(0, BLOCK_V)
            vmask = pv < npool
            pz = pv // (hp * wp)
            py = (pv // wp) % hp
            px = pv % wp
            k = tl.arange(0, 8)
            z = 2 * pz[:, None] + (k // 4)[None, :]
            y = 2 * py[:, None] + ((k // 2) % 2)[None, :]
            x = 2 * px[:, None] + (k % 2)[None, :]
            vox = ((b * D + z).to(tl.int64) * H + y) * W + x      # [V, 8]
            off = vox[:, :, None] * C + cs[None, None, :]         # [V, 8, C]
            mask = vmask[:, None, None] & cmask[None, None, :]
            yv = tl.load(ys_ptr + off, mask=mask, other=0.0).to(tl.float32)
            rv = tl.load(rs_ptr + off, mask=mask, other=0.0).to(tl.float32)
            t = (yv * s2[None, None, :] + b2[None, None, :]) + \
                (rv * sr[None, None, :] + br[None, None, :])
            f = tl.where(t >= 0, t, slope * t)
            fb = f.to(dt_ptr.dtype.element_ty).to(tl.float32)
            m = tl.max(fb, axis=1)
            eq = fb == m[:, None, :]
            cnt = tl.sum(eq.to(tl.float32), axis=1)
            poff = (b.to(tl.int64) * npool + pv)[:, None] * C + cs[None, :]
            pmask = vmask[:, None] & cmask[None, :]
            gq = tl.load(gq_ptr + poff, mask=pmask, other=0.0).to(tl.float32)
            share = gq / tl.maximum(cnt, 1.0)
            g = tl.load(gp_ptr + off, mask=mask, other=0.0).to(tl.float32)
            g = g + tl.where(eq, share[:, None, :], 0.0)
            dt = g * tl.where(t >= 0, 1.0, slope)
            dt = tl.where(mask, dt, 0.0)
            tl.store(dt_ptr + off, dt.to(dt_ptr.dtype.element_ty), mask=mask)
            p1 = tl.sum(tl.sum(dt * yv, axis=1), axis=0)
            p2 = tl.sum(tl.sum(dt, axis=1), axis=0)
            p3 = tl.sum(tl.sum(dt * rv, axis=1), axis=0)
        else:
            nvox = D * H * W
            v = pid * BLOCK_V + tl.arange(0, BLOCK_V)
            vmask = v < nvox
            mask = vmask[:, None] & cmask[None, :]
            off = (b.to(tl.int64) * nvox + v)[:, None] * C + cs[None, :]
            yv = tl.load(ys_ptr + off, mask=mask, other=0.0).to(tl.float32)
            rv = tl.load(rs_ptr + off, mask=mask, other=0.0).to(tl.float32)
            t = (yv * s2[None, :] + b2[None, :]) + (rv * sr[None, :] + br[None, :])
            g = tl.load(gp_ptr + off, mask=mask, other=0.0).to(tl.float32)
            dt = g * tl.where(t >= 0, 1.0, slope)
            dt = tl.where(mask, dt, 0.0)
            tl.store(dt_ptr + off, dt.to(dt_ptr.dtype.element_ty), mask=mask)
            p1 = tl.sum(dt * yv, axis=0)
            p2 = tl.sum(dt, axis=0)
            p3 = tl.sum(dt * rv, axis=0)
        # this program's partial sums, at its slot
        row = (pid * tl.num_programs(1) + b) * C
        tl.store(a1_ptr + row + cs, p1, mask=cmask)
        tl.store(a2_ptr + row + cs, p2, mask=cmask)
        tl.store(a3_ptr + row + cs, p3, mask=cmask)

    _KERNEL = finale_bwd_kernel
    return _KERNEL


def finale_bwd(ys: torch.Tensor, rs: torch.Tensor, s2: torch.Tensor,
               b2: torch.Tensor, sr: torch.Tensor, br: torch.Tensor,
               gp: torch.Tensor, gq: Optional[torch.Tensor], slope: float,
               tie: str = "even"):
    """K2 wrapper. ys, rs, gp: (B, D, H, W, C); affines (B, C) f32; gq:
    (B, D/2, H/2, W/2, C) or None; tie: how tied maxima share gq, `even`
    or `chain`. Returns (dt, a1, a2, a3)."""
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    if ys.dim() != 5 or rs.shape != ys.shape or gp.shape != ys.shape:
        raise ValueError(f"ys {tuple(ys.shape)}, rs {tuple(rs.shape)} and "
                         f"gp {tuple(gp.shape)} must be equal 5-D tensors")
    b, d, h, w, c = ys.shape
    for t in (s2, b2, sr, br):
        if tuple(t.shape) != (b, c):
            raise ValueError(f"finale affines must be ({b}, {c})")
    if gq is not None and (d % 2 or h % 2 or w % 2 or tuple(gq.shape) != (
            b, d // 2, h // 2, w // 2, c)):
        raise ValueError(f"gq {tuple(gq.shape)} does not fit {tuple(ys.shape)}")
    if ys.device.type == "cpu":
        return finale_bwd_plain(ys, rs, s2, b2, sr, br, gp, gq, slope, tie)
    if ys.device.type != "cuda":
        raise ValueError(f"finale_bwd: unsupported device {ys.device}")
    ts = (ys, rs, gp) + (() if gq is None else (gq,))
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError("finale_bwd kernel takes bf16 ys, rs, gp and gq")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("finale_bwd kernel takes contiguous tensors")
    aff = [t.to(device=ys.device, dtype=torch.float32).contiguous()
           for t in (s2, b2, sr, br)]
    dt = torch.empty_like(ys)
    pool = gq is not None
    chain = pool and tie == "chain"
    block_c = 1 << max(0, (c - 1).bit_length())
    # ~4096 elements per block: [V, 8, C] with the pool, [V, C] without;
    # the chain's eight live [V, C] children take ~2048
    block_v = max(1, (256 if chain else 512 if pool else 4096) // block_c)
    n = (d // 2) * (h // 2) * (w // 2) if pool else d * h * w
    grid = ((n + block_v - 1) // block_v, b)
    # per-program partial sums, added over the programs in a fixed order
    part = torch.empty((3, grid[0], b, c), dtype=torch.float32,
                       device=ys.device)
    _kernel()[grid](ys, rs, *aff, gp, gq if pool else gp, dt,
                    part[0], part[1], part[2], d, h, w, c, float(slope),
                    POOL=pool, CHAIN=chain, BLOCK_V=block_v,
                    BLOCK_C=block_c, num_warps=4)
    finale_bwd.launches += 1
    sums = part.sum(1)
    return dt, sums[0], sums[1], sums[2]


finale_bwd.launches = 0


class Finale(torch.autograd.Function):
    """out (, pooled) = the block finale; forward B2, backward K2."""

    @staticmethod
    def forward(ctx, ys, rs, s2, b2, sr, br, slope: float, pool: bool,
                tie: str):
        ys, rs = ys.contiguous(), rs.contiguous()
        ctx.save_for_backward(ys, rs, s2, b2, sr, br)
        ctx.slope, ctx.pool, ctx.tie = slope, pool, tie
        return finale_pool(ys, rs, s2, b2, sr, br, slope, pool=pool)

    @staticmethod
    def backward(ctx, gp, gq=None):
        ys, rs, s2, b2, sr, br = ctx.saved_tensors
        gp = gp.to(ys.dtype).contiguous()
        gq = None if gq is None else gq.to(ys.dtype).contiguous()
        dt, a1, a2, a3 = finale_bwd(ys, rs, s2, b2, sr, br, gp, gq, ctx.slope,
                                    ctx.tie)
        dtf = dt.float()
        d_ys = (dtf * s2.float()[:, None, None, None, :]).to(ys.dtype)
        d_rs = (dtf * sr.float()[:, None, None, None, :]).to(rs.dtype)
        return (d_ys, d_rs, a1.to(s2.dtype), a2.to(b2.dtype),
                a3.to(sr.dtype), a2.to(br.dtype), None, None, None)


def finale(ys, rs, s2, b2, sr, br, slope: float, pool: bool = False,
           tie: str = "even"):
    """Differentiable finale: out, or (out, pooled) with pool=True; `tie`
    is how the pool's backward splits among tied maxima (see K2)."""
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    return Finale.apply(ys, rs, s2, b2, sr, br, slope, pool, tie)
