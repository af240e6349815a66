"""B4: the decoders' k2 s2 transposed convolution.

Replaces `fcd_tpu/kernels/upsample.py::upsample_s2d_pad` (pallas_call :216).
The CUDA kernel is `fcd_tpu_torch/csrc/upsample.cu`; its header says what
bounds it on the card and what its design does about that.

    out[b, 2z+a, 2y+c, 2x+e, :] = bias + sum_i x[b, z, y, x, i] * kernel[1-a, 1-c, 1-e, i, :]

`kernel` is the flax (2, 2, 2, Ci, Co) ConvTranspose3d kernel.
`fcd_tpu/ops/layers.py::ConvTranspose3d` applies it with
`lax.conv_transpose(..., padding='VALID')` and no kernel transpose: the
input is dilated by 2 and padded by k-1 = 1 on each side, then correlated
with the kernel as it is, so out[2z] = x[z] * kernel[1] and
out[2z+1] = x[z] * kernel[0]; output parity a reads tap 1-a on each axis.

The forward is one launch: the kernel reads the flax kernel as it is
(bf16 or f32, rounded to bf16 on load) and folds the flip into its index.
`upsample_plan` picks its tile (pure Python, held by the CPU tests).
CPU tensors take the plain PyTorch version; CUDA tensors launch the
kernel or raise.

`upsample2x_op` is the op with gradients (`Upsample2x`): forward B4, and
the backward as the two products of `fcd_tpu/ops/s2d_ops.py:932-964`,
which the JAX package leaves to XLA and the port to `torch.matmul`: the
fine cotangent regrouped per coarse voxel, g8 (M, 8*Co), gives
dx = g8 @ wm^T and dwm = x^T @ g8 (f32), with wm = `upsample_matrix`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import blocks_2x, conv_transpose3d

REPLACES = "fcd_tpu/kernels/upsample.py:167"  # upsample_s2d_pad (pallas_call :216)


def upsample_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, Ci, Co) flax kernel -> (Ci, 8*Co) matrix whose column
    block q = 4a + 2c + e holds the tap that output parity (a, c, e) reads
    (the backward's products; the forward's kernel reads row 7 - q of the
    kernel viewed as (8, Ci, Co), the same tap)."""
    ci, co = kernel.shape[3], kernel.shape[4]
    flipped = torch.flip(kernel, dims=(0, 1, 2))
    return flipped.reshape(8, ci, co).permute(1, 0, 2).reshape(ci, 8 * co)


def upsample2x_plain(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`ops/layers.py::conv_transpose3d` (lax.conv_transpose's k2 s2) in
    f32 arithmetic on the activation-dtype inputs, rounded to x's dtype."""
    out = conv_transpose3d(x.float(), kernel.to(x.dtype).float(),
                           None if bias is None else bias.float())
    return out.to(x.dtype)


# the kernel's block tiles, largest first: (WM, WN, NI) = warps along the
# coarse voxels and along the columns, and 8-column mma tiles per warp; a
# tile is 16 * WM voxels by 8 * NI * WN columns (`fcd_upsample`'s `tile`)
TILES = ((4, 1, 8), (2, 2, 4), (2, 2, 2), (1, 2, 1))
SMS = 132             # the H100's streaming multiprocessors
PER_SM = 6            # blocks the walks keep on each SM
STAGES = 4            # the kernel's ring of x tiles
SMEM_CAP = 232448     # shared memory one block may hold (227 KiB)


class UpsamplePlan(NamedTuple):
    tile: int      # index into TILES
    bm: int        # coarse voxels per tile
    bn: int        # output columns (of 8 * co) per tile
    m_tiles: int
    n_tiles: int
    m_blocks: int  # blocks per column tile, each walking m_tiles / m_blocks

    @property
    def blocks(self) -> int:
        return self.m_blocks * self.n_tiles


def smem_bytes(tile: int, ci: int) -> int:
    """Shared memory of one block: the weights (ci rounded up to 16 rows),
    the ring of x tiles, the output tile, and the rows' offsets."""
    wm, wn, ni = TILES[tile]
    bm, np_ = 16 * wm, 8 * ni * wn + 8
    kt = -(-ci // 16) * 16
    return 2 * (kt * np_ + STAGES * bm * (kt + 8) + bm * np_) + 8 * bm


def plan_for(tile: int, m: int, n: int,
             per_sm: int = PER_SM) -> UpsamplePlan:
    """Tile `tile` over the (m voxels, n columns) GEMM: each column tile
    walked by enough blocks to keep per_sm of them on every SM."""
    wm, wn, ni = TILES[tile]
    bm, bn = 16 * wm, 8 * ni * wn
    m_tiles, n_tiles = -(-m // bm), -(-n // bn)
    m_blocks = min(m_tiles, -(-SMS * per_sm // n_tiles))
    return UpsamplePlan(tile, bm, bn, m_tiles, n_tiles, m_blocks)


def upsample_plan(b: int, d: int, h: int, w: int, ci: int,
                  co: int) -> UpsamplePlan:
    """The block tile of one B4 call: the largest of TILES whose shared
    memory fits and whose tiles give at least one block per SM, else the
    smallest that fits. The GEMM is M = b*d*h*w coarse voxels by N = 8*co
    columns."""
    m, n = b * d * h * w, 8 * co
    fits = [i for i in range(len(TILES)) if smem_bytes(i, ci) <= SMEM_CAP]
    if not fits:
        raise ValueError(f"upsample2x kernel: ci = {ci} does not fit shared "
                         "memory")
    for i in fits:
        plan = plan_for(i, m, n)
        if plan.m_tiles * plan.n_tiles >= SMS:
            break
    return plan


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("upsample").fcd_upsample
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci] * 11 + [vp]
        fn.restype = ci
        _FN = fn
    return _FN


def upsample2x(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               plan: Optional[UpsamplePlan] = None) -> torch.Tensor:
    """B4 wrapper. x: (B, D, H, W, Ci); kernel: (2, 2, 2, Ci, Co);
    bias: (Co,) or None; plan: the tile (`upsample_plan`'s by default).
    Returns (B, 2D, 2H, 2W, Co) in x's dtype."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, C), got {tuple(x.shape)}")
    ci = x.shape[-1]
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (2, 2, 2, ci):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    co = kernel.shape[-1]
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias must be ({co},)")
    if x.device.type == "cpu":
        return upsample2x_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"upsample2x kernel got {x.dtype} x"
                        + _build.BF16_ONLY)
    if not x.is_contiguous():
        raise ValueError("upsample2x kernel takes a contiguous x")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t is None:
            continue
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"upsample2x kernel takes an f32 or bf16 {name}, "
                            f"got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"upsample2x kernel takes a contiguous {name} "
                             f"on {x.device}")
    b, d, h, w = x.shape[:4]
    if b * d * h * w >= 2 ** 31:
        raise ValueError("upsample2x kernel indexes coarse voxels in 32 bits")
    if plan is None:
        plan = upsample_plan(b, d, h, w, ci, co)
    out = torch.empty((b, 2 * d, 2 * h, 2 * w, co), dtype=x.dtype,
                      device=x.device)
    err = _fn()(_build.ptr(x), _build.ptr(kernel), _build.ptr(bias),
                _build.ptr(out), b, d, h, w, ci, co,
                int(kernel.dtype == torch.float32),
                int(bias is not None and bias.dtype == torch.float32),
                plan.tile, plan.m_tiles, plan.m_blocks, _build.stream())
    _build.check(err, "upsample")
    upsample2x.launches += 1
    return out


upsample2x.launches = 0


class Upsample2x(torch.autograd.Function):
    """Differentiable `upsample2x`: forward B4, backward two matmuls. With
    `grad_sum` (a column-parallel upsample's sum over the model axis: x
    replicated, the kernel this rank's output-channel shard) x's gradient
    is the ranks' f32 shares summed, then rounded once (ROADMAP C23)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, grad_sum):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.has_bias = bias is not None
        ctx.grad_sum = grad_sum
        return upsample2x(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        ci, co = kernel.shape[3], kernel.shape[4]
        # g8[m, q * co + o]: the cotangent of output parity q of voxel m
        g8 = blocks_2x(g.to(x.dtype)).reshape(-1, 8 * co)
        wm = upsample_matrix(kernel).to(x.dtype)
        if ctx.grad_sum is None:
            dx = torch.matmul(g8, wm.t()).reshape(x.shape)
        else:
            dx = torch.matmul(g8.float(), wm.float().t()).reshape(x.shape)
            dx = ctx.grad_sum(dx.contiguous()).to(x.dtype)
        dwm = torch.matmul(x.reshape(-1, ci).t().float(), g8.float())
        dk = torch.flip(dwm.reshape(ci, 8, co).permute(1, 0, 2).reshape(
            2, 2, 2, ci, co), dims=(0, 1, 2))
        db = (g.float().sum(dim=(0, 1, 2, 3)) if ctx.has_bias else None)
        return dx, dk.to(kernel.dtype), db, None


def upsample2x_op(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  grad_sum=None) -> torch.Tensor:
    """`upsample2x` with gradients (the `Upsample2x` Function);
    `grad_sum`: a column-parallel upsample's sum over the model axis."""
    return Upsample2x.apply(x, kernel, bias, grad_sum)
