"""K1: the weight gradient of the 3x3x3 "same" convolution.

Replaces `fcd_tpu/kernels/block_conv.py::blocked_conv_a2o_dw` and
`blocked_conv_o2a_dw` (B7) and `blocked_conv_s2d_dw` (B13). The CUDA
kernel is `fcd_tpu_torch/csrc/conv3d_wgrad.cu`; its header says what bounds
it on the card and what its design does about that.

    dW[tap, ci, co] = sum_{b, v} pro(x)[b, v + tap, ci] * g[b, v, co]

with zero padding outside the volume applied after the optional prologue
`pro(v) = bf16(leaky(v * scale[b, c] + shift[b, c]))` (B1's convention).
`tap = 9 * kz + 3 * ky + kx`, so `dW.reshape(3, 3, 3, ci, co)` is the
gradient of a flax (3, 3, 3, ci, co) kernel.

CPU tensors take the plain PyTorch version; CUDA tensors launch the kernel
or raise. The kernel takes bf16 x and g.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels import _build

# blocked_conv_a2o_dw (pallas_call :1412); also blocked_conv_o2a_dw :1435
# and blocked_conv_s2d_dw :1626
REPLACES = "fcd_tpu/kernels/block_conv.py:1390"

Prologue = Tuple[torch.Tensor, torch.Tensor, float]


def apply_prologue(x: torch.Tensor, prologue: Prologue) -> torch.Tensor:
    """`leaky(x * scale[b, c] + shift[b, c])` in f32, rounded to x's dtype."""
    scale, shift, slope = prologue
    t = x.float() * scale.float()[:, None, None, None, :] \
        + shift.float()[:, None, None, None, :]
    return F.leaky_relu(t, slope).to(x.dtype)


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                       prologue: Optional[Prologue] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one f32 product per tap of
    the zero-padded (prologued) input against g. Returns (27, ci, co) f32."""
    a = apply_prologue(x, prologue) if prologue is not None else x
    b, d, h, w, ci = a.shape
    co = g.shape[-1]
    ap = F.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gm = g.float().reshape(-1, co)
    out = []
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                xs = ap[:, kz:kz + d, ky:ky + h, kx:kx + w].reshape(-1, ci)
                out.append(xs.t() @ gm)
    return torch.stack(out)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("conv3d_wgrad").fcd_conv3d_wgrad
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp,
                       ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _FN = fn
    return _FN


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor,
                 prologue: Optional[Prologue] = None) -> torch.Tensor:
    """K1 wrapper. x: (B, D, H, W, ci); g: (B, D, H, W, co); prologue:
    (scale, shift, slope) with (B, ci) affines, or None. Returns
    (27, ci, co) f32."""
    if x.dim() != 5 or g.dim() != 5 or x.shape[:4] != g.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be "
                         "(B, D, H, W, C) tensors on one grid")
    if x.device != g.device:
        raise ValueError("x and g must be on one device")
    b, d, h, w, ci = x.shape
    co = g.shape[-1]
    if prologue is not None:
        for t in prologue[:2]:
            if tuple(t.shape) != (b, ci):
                raise ValueError(f"prologue affine must be ({b}, {ci})")
    if x.device.type == "cpu":
        return conv3d_wgrad_plain(x, g, prologue)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_wgrad: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_wgrad kernel takes bf16 x and g, got "
                        f"{x.dtype} and {g.dtype}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv3d_wgrad kernel takes contiguous x and g")
    scale = shift = None
    slope = 0.0
    if prologue is not None:
        scale = prologue[0].to(device=x.device, dtype=torch.float32).contiguous()
        shift = prologue[1].to(device=x.device, dtype=torch.float32).contiguous()
        slope = float(prologue[2])
    dw = torch.zeros((27, ci, co), dtype=torch.float32, device=x.device)
    err = _fn()(_build.ptr(x), _build.ptr(g), _build.ptr(scale),
                _build.ptr(shift), slope, _build.ptr(dw), b, d, h, w, ci, co,
                _build.stream())
    _build.check(err, "conv3d_wgrad")
    conv3d_wgrad.launches += 1
    return dw


conv3d_wgrad.launches = 0
