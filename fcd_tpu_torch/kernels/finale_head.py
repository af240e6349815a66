"""B15: the last decoder block's finale fused with the 1x1 segmentation
head, at eval.

Replaces `fcd_tpu/kernels/block_conv.py::fused_finale_head` (:1546,
pallas_call :1578, kernel body :1514-1543):

    t      = ((y2 * s2[b, c] + b2[b, c]) + r * sr[b, c]) + br[b, c]   (f32)
    a      = round(leaky(t)) to the activation dtype (bf16 on the card)
    logits = round(a @ w + bias), w rounded to the activation dtype, the
             products summed in f32, the f32 bias added before the single
             rounding to the output dtype

Its logits are not the default head's: the default path computes
`conv1x1(y1, head, bias)` (`ops/layers.py`) in bf16, rounding the product
and then the sum with the bias, as the JAX package's default head does,
so the two differ by up to about one bf16 ulp. B15 is held to
`fused_finale_head`, not to the default path.

The CUDA kernel is `fcd_tpu_torch/csrc/finale_head.cu`; its header says
what bounds it on the card and what its design does about that. The TPU
kernel computes the head's product in its own body, so a library matmul
is not its port.

CPU tensors take the plain PyTorch version; CUDA tensors launch the
kernel or raise. The kernel takes bf16 y2 and r with a channel count that
is a multiple of 8 and at most 8 outputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fcd_tpu_torch.kernels import _build

REPLACES = "fcd_tpu/kernels/block_conv.py:1546"  # fused_finale_head (pallas_call :1578)
MAX_O = 8   # outputs a thread of csrc/finale_head.cu keeps in registers


def finale_head_plain(y2, r, s2, b2, sr, br, w, bias, slope: float,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    def aff(a):
        return a.float()[:, None, None, None, :]

    dtype = y2.dtype
    t = ((y2.float() * aff(s2) + aff(b2)) + r.float() * aff(sr)) + aff(br)
    a = torch.where(t >= 0, t, slope * t).to(dtype).float()
    out = torch.matmul(a, w.to(dtype).float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype or dtype)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("finale_head").fcd_finale_head
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                       ctypes.c_int64, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
        _FN = fn
    return _FN


def finale_head(y2: torch.Tensor, r: torch.Tensor, s2: torch.Tensor,
                b2: torch.Tensor, sr: torch.Tensor, br: torch.Tensor,
                w: torch.Tensor, bias: Optional[torch.Tensor], slope: float,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """B15 wrapper. y2, r: (B, D, H, W, C); s2, b2, sr, br: (B, C) f32;
    w: (C, O); bias: (O,) or None. Returns (B, D, H, W, O) logits in
    out_dtype (default: y2's dtype)."""
    if y2.dim() != 5 or r.shape != y2.shape:
        raise ValueError(f"y2 {tuple(y2.shape)} and r {tuple(r.shape)} must be "
                         "equal (B, D, H, W, C) tensors")
    b, d, h, wd, c = y2.shape
    for t in (s2, b2, sr, br):
        if tuple(t.shape) != (b, c):
            raise ValueError(f"finale affines must be ({b}, {c})")
    if w.dim() != 2 or w.shape[0] != c:
        raise ValueError(f"head weights {tuple(w.shape)} do not fit C={c}")
    o = w.shape[1]
    if bias is not None and tuple(bias.shape) != (o,):
        raise ValueError(f"head bias {tuple(bias.shape)} must be ({o},)")
    if y2.device.type == "cpu":
        return finale_head_plain(y2, r, s2, b2, sr, br, w, bias, slope,
                                 out_dtype)
    if y2.device.type != "cuda":
        raise ValueError(f"finale_head: unsupported device {y2.device}")
    if y2.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
        raise TypeError(f"finale_head kernel got {y2.dtype} y2 and {r.dtype} "
                        "r" + _build.BF16_ONLY)
    out_dtype = out_dtype or y2.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"finale_head kernel writes bf16 or f32, not {out_dtype}")
    if c % 8 or o > MAX_O:
        raise ValueError(f"finale_head kernel takes C % 8 == 0 and O <= "
                         f"{MAX_O}, got C={c}, O={o}")
    if not (y2.is_contiguous() and r.is_contiguous()) \
            or y2.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("finale_head kernel takes contiguous, 16-byte "
                         "aligned y2 and r")
    dev = y2.device
    aff = [t.to(device=dev, dtype=torch.float32).contiguous()
           for t in (s2, b2, sr, br)]
    wk = w.to(device=dev, dtype=torch.bfloat16).float().contiguous()
    bk = (None if bias is None
          else bias.to(device=dev, dtype=torch.float32).contiguous())
    out = torch.empty((b, d, h, wd, o), dtype=out_dtype, device=dev)
    err = _fn()(_build.ptr(y2), _build.ptr(r), *(_build.ptr(t) for t in aff),
                _build.ptr(wk), _build.ptr(bk), _build.ptr(out),
                int(out_dtype == torch.bfloat16), b, d * h * wd, c, o,
                float(slope), _build.stream())
    _build.check(err, "finale_head")
    finale_head.launches += 1
    return out


finale_head.launches = 0
