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
from typing import Optional

import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import blocks_2x

REPLACES = "fcd_tpu/kernels/upsample.py:167"  # upsample_s2d_pad (pallas_call :216)


def upsample_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, Ci, Co) flax kernel -> (Ci, 8*Co) matrix whose column
    block q = 4a + 2c + e holds the tap that output parity (a, c, e) reads."""
    ci, co = kernel.shape[3], kernel.shape[4]
    flipped = torch.flip(kernel, dims=(0, 1, 2))
    return flipped.reshape(8, ci, co).permute(1, 0, 2).reshape(ci, 8 * co)


def upsample2x_plain(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.conv_transpose3d with the flipped kernel (torch's transposed conv
    flips the kernel, lax.conv_transpose does not), f32 arithmetic on the
    activation-dtype inputs."""
    dtype = x.dtype
    w = torch.flip(kernel.to(dtype).float(), dims=(0, 1, 2))
    out = F.conv_transpose3d(x.float().permute(0, 4, 1, 2, 3),
                             w.permute(3, 4, 0, 1, 2), stride=2)
    out = out.permute(0, 2, 3, 4, 1)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype).contiguous()


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("upsample").fcd_upsample
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _FN = fn
    return _FN


def upsample2x(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B4 wrapper. x: (B, D, H, W, Ci); kernel: (2, 2, 2, Ci, Co);
    bias: (Co,) or None. Returns (B, 2D, 2H, 2W, Co) in x's dtype."""
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
        raise TypeError(f"upsample2x kernel takes bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("upsample2x kernel takes a contiguous x")
    b, d, h, w = x.shape[:4]
    wm = upsample_matrix(kernel.to(device=x.device, dtype=torch.bfloat16)
                         ).contiguous()
    bf = (None if bias is None else
          bias.to(device=x.device, dtype=torch.float32).contiguous())
    out = torch.empty((b, 2 * d, 2 * h, 2 * w, co), dtype=x.dtype,
                      device=x.device)
    err = _fn()(_build.ptr(x), _build.ptr(wm), _build.ptr(bf),
                _build.ptr(out), b, d, h, w, ci, co, _build.stream())
    _build.check(err, "upsample")
    upsample2x.launches += 1
    return out


upsample2x.launches = 0


class Upsample2x(torch.autograd.Function):
    """Differentiable `upsample2x`: forward B4, backward two matmuls."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.has_bias = bias is not None
        return upsample2x(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        ci, co = kernel.shape[3], kernel.shape[4]
        # g8[m, q * co + o]: the cotangent of output parity q of voxel m
        g8 = blocks_2x(g.to(x.dtype)).reshape(-1, 8 * co)
        wm = upsample_matrix(kernel)
        dx = torch.matmul(g8, wm.to(x.dtype).t()).reshape(x.shape)
        dwm = torch.matmul(x.reshape(-1, ci).t().float(), g8.float())
        dk = torch.flip(dwm.reshape(ci, 8, co).permute(1, 0, 2).reshape(
            2, 2, 2, ci, co), dims=(0, 1, 2))
        db = (g.float().sum(dim=(0, 1, 2, 3)) if ctx.has_bias else None)
        return dx, dk.to(kernel.dtype), db


def upsample2x_op(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`upsample2x` with gradients (the `Upsample2x` Function)."""
    return Upsample2x.apply(x, kernel, bias)
