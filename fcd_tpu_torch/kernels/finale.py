"""The differentiable train finale (B8): forward B2, backward K2.

Replaces `fcd_tpu/kernels/finale.py::finale_fwd_pallas` (:70, whose
function B2's kernel in `kernels/pool.py` computes) and
`finale_bwd_pallas` (:170, K2 here):

    t      = (ys * s2[b, c] + b2[b, c]) + (rs * sr[b, c] + br[b, c])
    out    = bf16(leaky(t));  pooled = 2x2x2 max of out (optional)

K2, given gp (cotangent of out) and gq (of pooled, or None):

    g    = gp + share(out's 2x2x2 block) * gq
    dt   = g * (t >= 0 ? 1 : slope)
    d_ys = bf16(bf16(dt) * s2),  d_rs = bf16(bf16(dt) * sr)
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

The JAX kernel writes one dt slab and its consumers scale it inside their
own fusions; eager PyTorch has no consumer fusion, so K2 writes the two
input gradients itself. Route: CUDA, `fcd_tpu_torch/csrc/finale_bwd.cu`
(its header: bound by bytes; a thread owns 8 channels of two voxels as
16-byte accesses, or with the pool one channel of a pooled voxel's eight
children, all its loads in flight; blocks walk many tiles carrying their
partial sums, a fixed-order tree and a finishing kernel add them, no
atomics). One call is two kernels; `finale_bwd_plan` (pure Python) picks
the decomposition. d_ys and d_rs are the plain version's bits; a1..a3
differ by summation order only.

CPU tensors take the plain PyTorch version; CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.kernels.pool import finale_pool
from fcd_tpu_torch.ops.layers import blocks_2x, unblocks_2x

REPLACES = "fcd_tpu/kernels/finale.py:170"  # finale_bwd_pallas (pallas_call :207)
TIES = ("even", "chain")
MODES = ("none",) + TIES    # the kernel's modes: no pool, or the pool's tie split


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
    """`finale_bwd_pallas`'s function in plain PyTorch: (dt in ys's dtype,
    a1, a2, a3)."""
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


def finale_grads_plain(ys, rs, s2, b2, sr, br, gp, gq, slope: float,
                       tie: str = "even"):
    """K2's function in plain PyTorch: `finale_bwd_plain`, then dt's two
    scalings. Returns (d_ys, d_rs, a1, a2, a3)."""
    dt, a1, a2, a3 = finale_bwd_plain(ys, rs, s2, b2, sr, br, gp, gq, slope,
                                      tie)
    dtf = dt.float()
    d_ys = (dtf * s2.float()[:, None, None, None, :]).to(ys.dtype)
    d_rs = (dtf * sr.float()[:, None, None, None, :]).to(rs.dtype)
    return d_ys, d_rs, a1, a2, a3


SMS = 132                # the H100's streaming multiprocessors
# the kernel's instances, as csrc/finale_bwd.cu's `launch_mode` builds them:
# channels a thread -> (its launch bound, its minimum blocks an SM); 8
# channels a thread without the pool only
BUILT = {8: (256, 2), 1: (1024, 1)}
MIN_WALK = 4             # tiles a block walks by default, where the work allows


class FinaleBwdPlan(NamedTuple):
    """K2's decomposition of one call. A unit is one pooled voxel's eight
    children (pool modes) or one voxel (`none`), times `vec` channels; a
    tile is threads x per_thread units, thread i taking units i, i +
    threads, ...; block x of batch item b walks that item's tiles x *
    tiles // blocks up to (x + 1) * tiles // blocks and writes partial row
    b * blocks + x, and the finishing kernel adds each item's rows in
    block order."""
    mode: str
    vec: int
    groups: int             # C / vec: a thread's channels are group tid % groups
    threads: int            # groups * 2^k
    per_thread: int         # units a thread takes a tile
    units: int              # a batch item's units x groups
    tiles: int              # a batch item's tiles
    tiles_per_block: int    # the most a block walks
    grid: Tuple[int, int]   # (blocks a batch item, batch)
    rows: int               # partial rows
    smem: int               # bytes: the affines and the reduction tree


def plan_for(b: int, d: int, h: int, w: int, c: int, mode: str, vec: int,
             blocks: Optional[int] = None) -> FinaleBwdPlan:
    """The plan with `vec` channels a thread and `blocks` blocks a batch
    item: by default enough to fill the SMS SMs with the blocks of 256
    threads vec's instance holds, but no more than let each block walk
    MIN_WALK tiles (at 4 x 8^3-16^3 on an H100 blocks of one tile were the
    slowest of every block count tried, PERF.md). Raises ValueError on
    what the kernel does not take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if vec not in BUILT or c % vec:
        raise ValueError(f"vec {vec} does not divide C {c}")
    pooled = mode != "none"
    if pooled and vec != 1:
        raise ValueError(f"the pool takes one channel a thread, not {vec}")
    if pooled and (d % 2 or h % 2 or w % 2):
        raise ValueError(f"the pool needs an even grid, got {(d, h, w)}")
    bound, min_blocks = BUILT[vec]
    groups = c // vec
    if groups > bound:
        raise ValueError(f"C {c} at vec {vec} needs {groups} threads a "
                         f"block, more than {bound}")
    threads = groups
    while threads * 2 <= 256:
        threads *= 2
    per_thread = 1 if pooled else 2
    units = (d * h * w // 8 if pooled else d * h * w) * groups
    tiles = max(1, math.ceil(units / (threads * per_thread)))
    if blocks is None:
        blocks = min(math.ceil(SMS * bound * min_blocks / threads / b),
                     tiles // MIN_WALK)
    blocks = max(1, min(blocks, tiles))
    return FinaleBwdPlan(
        mode=mode, vec=vec, groups=groups, threads=threads,
        per_thread=per_thread, units=units, tiles=tiles,
        tiles_per_block=math.ceil(tiles / blocks), grid=(blocks, b),
        rows=blocks * b, smem=4 * (4 * c + 3 * vec * threads))


@functools.lru_cache(maxsize=None)
def finale_bwd_plan(b: int, d: int, h: int, w: int, c: int, mode: str,
                    aligned: bool = True) -> FinaleBwdPlan:
    """K2's decomposition for a (b, d, h, w, c) call in `mode` (`none`,
    `even`, `chain`): without the pool, 8 channels a thread (16-byte
    accesses) where C % 8 == 0, the tensors are 16-byte aligned and that
    plan's blocks fill the SMS SMs; otherwise one channel a thread. The
    pool: a pooled voxel's eight children of 8 channels hold too many
    registers (the header of csrc/finale_bwd.cu). A small call (16^3 and
    less in the train step): one channel a thread gives eight times the
    blocks (on an H100 at 4x4^3x512 0.0053-0.0058 against 0.0083 ms, at
    4x8^3x128 0.0066-0.0073 against 0.0086-0.0105, PERF.md)."""
    if mode == "none" and c % 8 == 0 and aligned:
        plan = plan_for(b, d, h, w, c, mode, 8)
        if plan.rows >= SMS or c > BUILT[1][0]:
            return plan
    return plan_for(b, d, h, w, c, mode, 1)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("finale_bwd").fcd_finale_bwd
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([vp] * 8 + [i64] * 4 + [vp] * 4 + [ci] * 12
                       + [ctypes.c_float, vp])
        fn.restype = ci
        _FN = fn
    return _FN


def finale_bwd(ys: torch.Tensor, rs: torch.Tensor, s2: torch.Tensor,
               b2: torch.Tensor, sr: torch.Tensor, br: torch.Tensor,
               gp: torch.Tensor, gq: Optional[torch.Tensor], slope: float,
               tie: str = "even", plan: Optional[FinaleBwdPlan] = None):
    """K2 wrapper. ys, rs, gp: (B, D, H, W, C); affines (B, C) f32 (a
    batch stride of 0 is taken as it is); gq: (B, D/2, H/2, W/2, C) or
    None; tie: how tied maxima share gq, `even` or `chain`; plan: another
    decomposition (`plan_for`), for the sweep. Returns (d_ys, d_rs, a1,
    a2, a3)."""
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
        return finale_grads_plain(ys, rs, s2, b2, sr, br, gp, gq, slope, tie)
    if ys.device.type != "cuda":
        raise ValueError(f"finale_bwd: unsupported device {ys.device}")
    ts = (ys, rs, gp) + (() if gq is None else (gq,))
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError("finale_bwd kernel got ys, rs, gp and gq in "
                        f"{[str(t.dtype) for t in ts]}" + _build.BF16_ONLY)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("finale_bwd kernel takes contiguous tensors")
    aff = []
    for t in (s2, b2, sr, br):
        t = t.to(device=ys.device, dtype=torch.float32)
        aff.append(t if t.stride(1) == 1 else t.contiguous())
    mode = "none" if gq is None else tie
    d_ys, d_rs = torch.empty_like(ys), torch.empty_like(rs)
    aligned = all(t.data_ptr() % 16 == 0 for t in ts + (d_ys, d_rs))
    if plan is None:
        plan = finale_bwd_plan(b, d, h, w, c, mode, aligned)
    elif plan != plan_for(b, d, h, w, c, mode, plan.vec, plan.grid[0]):
        raise ValueError(f"plan {plan} does not fit {tuple(ys.shape)} {mode}")
    if plan.vec == 8 and not aligned:
        raise ValueError("8 channels a thread need 16-byte aligned tensors")
    part = torch.empty((plan.rows, 3, c), dtype=torch.float32,
                       device=ys.device)
    out = torch.empty((3, b, c), dtype=torch.float32, device=ys.device)
    err = _fn()(
        *(_build.ptr(t) for t in (ys, rs, gp, gq, *aff)),
        *(t.stride(0) for t in aff),
        *(_build.ptr(t) for t in (d_ys, d_rs, part, out)),
        b, d, h, w, c, MODES.index(mode), plan.vec, plan.threads, plan.units,
        plan.tiles, plan.grid[0], plan.smem, float(slope), _build.stream())
    _build.check(err, "finale_bwd")
    finale_bwd.launches += 1
    return d_ys, d_rs, out[0], out[1], out[2]


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
        d_ys, d_rs, a1, a2, a3 = finale_bwd(ys, rs, s2, b2, sr, br, gp, gq,
                                            ctx.slope, ctx.tie)
        return (d_ys, d_rs, a1.to(s2.dtype), a2.to(b2.dtype),
                a3.to(sr.dtype), a2.to(br.dtype), None, None, None)


def finale(ys, rs, s2, b2, sr, br, slope: float, pool: bool = False,
           tie: str = "even"):
    """Differentiable finale: out, or (out, pooled) with pool=True; `tie`
    is how the pool's backward splits among tied maxima (see K2)."""
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    return Finale.apply(ys, rs, s2, b2, sr, br, slope, pool, tie)
