"""K3 / K4: the train spatial-attention tail of the DSA block.

Replaces `fcd_tpu/kernels/spatial_attn.py::spatial_attn_fwd_pallas` (K3)
and `spatial_attn_bwd_pallas` (K4). The CUDA kernels are
`fcd_tpu_torch/csrc/spatial_attn.cu`; its header gives the math, what
bounds them on the card and what their design does about that.

    attn = softmax_per_head(qn @ kpb) dropped out (rate, inverted scaling)
    out  = bf16(attn) @ vpb

qn (B, N, C), kpb (B, C, h*P) (block-expanded keys, temperature folded),
vpb (B, h*P, C). `SpatialAttn` is the `torch.autograd.Function` the train
DSA calls: forward K3, backward K4.

Dropout bits come from a counter-based hash of (seed, salt, b, token,
column) (`keep_mask`), written identically in the kernels and here with
int64 torch ops, so the kernel's masks and the plain version's are the
same bits and K4 regenerates K3's mask. The seed is drawn per step and
the salt names the layer, so every layer of every step draws its own
mask. The JAX package draws from another stream (ROADMAP C2): parity with
it holds at rate 0.

CPU tensors take the plain PyTorch versions; CUDA tensors launch the
kernels or raise. The kernels take bf16 tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fcd_tpu_torch.kernels import _build

REPLACES_FWD = "fcd_tpu/kernels/spatial_attn.py:156"  # spatial_attn_fwd_pallas (pallas_call :166)
REPLACES_BWD = "fcd_tpu/kernels/spatial_attn.py:178"  # spatial_attn_bwd_pallas (pallas_call :190)

_M32 = 0xFFFFFFFF


def _mul32(h, k: int):
    """(h * k) mod 2^32 for h in [0, 2^32), without int64 overflow."""
    return ((h & 0xFFFF) * k + ((((h >> 16) * k) & _M32) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finaliser on ints (Python or int64 tensors)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_key(seed: int, salt: int) -> int:
    """The 32-bit key of one layer (salt) in one step (seed)."""
    return _fmix32((int(seed) & _M32) ^ _fmix32((int(salt) + 0x632BE5AB) & _M32))


def keep_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), _M32)


def keep_mask(b: int, n: int, hp: int, key: int, rate: float,
              device=None) -> torch.Tensor:
    """(B, N, hP) bool: the kernels' dropout keep bits."""
    idx = torch.arange(b * n * hp, dtype=torch.int64, device=device) & _M32
    h = _fmix32(_mul32(idx, 0x9E3779B1) ^ key)
    return (h >= keep_threshold(rate)).reshape(b, n, hp)


def _softmax_segments(logits: torch.Tensor, h: int) -> torch.Tensor:
    b, n, hp = logits.shape
    return torch.softmax(logits.reshape(b, n, h, hp // h), dim=-1).reshape(
        b, n, hp)


def _attn(qn, kpb, h, key, rate):
    """(soft, attn, keep): the f32 segment softmax, the dropped attention
    rounded to qn's dtype, and the keep mask (None at rate 0)."""
    b, n, _ = qn.shape
    hp = kpb.shape[-1]
    soft = _softmax_segments(qn.float() @ kpb.float(), h)
    keep = None
    attn = soft
    if rate > 0.0:
        keep = keep_mask(b, n, hp, key, rate, qn.device)
        attn = torch.where(keep, soft * (1.0 / (1.0 - rate)),
                           torch.zeros_like(soft))
    return soft, attn.to(qn.dtype).float(), keep


def spatial_attn_fwd_plain(qn, kpb, vpb, h: int, key: int,
                           rate: float) -> torch.Tensor:
    _, attn, _ = _attn(qn, kpb, h, key, rate)
    return (attn @ vpb.float()).to(qn.dtype)


def spatial_attn_bwd_plain(qn, kpb, vpb, g, h: int, key: int, rate: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dqn in qn's dtype, dkpb f32, dvpb f32)."""
    b, n, _ = qn.shape
    hp = kpb.shape[-1]
    soft, attn, keep = _attn(qn, kpb, h, key, rate)
    gf = g.float()
    dvpb = attn.transpose(1, 2) @ gf
    da = gf @ vpb.float().transpose(1, 2)
    if keep is not None:
        da = torch.where(keep, da * (1.0 / (1.0 - rate)), torch.zeros_like(da))
    s4 = soft.reshape(b, n, h, hp // h)
    d4 = da.reshape(b, n, h, hp // h)
    ds = (s4 * (d4 - (d4 * s4).sum(-1, keepdim=True))).reshape(b, n, hp)
    ds = ds.to(qn.dtype).float()
    dqn = (ds @ kpb.float().transpose(1, 2)).to(qn.dtype)
    dkpb = qn.float().transpose(1, 2) @ ds
    return dqn, dkpb, dvpb


_FNS = {}


def _fns():
    if not _FNS:
        lib = _build.load("spatial_attn")
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        fwd = lib.fcd_spatial_attn_fwd
        fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, cu, cu, cf, ci, vp]
        fwd.restype = ci
        bwd = lib.fcd_spatial_attn_bwd
        bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cu,
                        cu, cf, ci, vp]
        bwd.restype = ci
        blocks = lib.fcd_spatial_attn_bwd_blocks
        blocks.argtypes = [ci, ci, ctypes.POINTER(ci)]
        blocks.restype = ci
        _FNS.update(fwd=fwd, bwd=bwd, blocks=blocks)
    return _FNS


def _check(qn, kpb, vpb, h, g=None):
    if qn.dim() != 3 or kpb.dim() != 3 or vpb.dim() != 3:
        raise ValueError("qn, kpb, vpb must be 3-D")
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    if tuple(kpb.shape) != (b, c, hp) or tuple(vpb.shape) != (b, hp, c):
        raise ValueError(f"kpb {tuple(kpb.shape)} / vpb {tuple(vpb.shape)} "
                         f"do not fit qn {tuple(qn.shape)}")
    if hp % h:
        raise ValueError(f"{h} heads do not divide hP = {hp}")
    if g is not None and g.shape != qn.shape:
        raise ValueError("g must have qn's shape")
    for t in (kpb, vpb) + (() if g is None else (g,)):
        if t.device != qn.device:
            raise ValueError("spatial_attn tensors must share one device")
    if qn.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spatial_attn: unsupported device {qn.device}")


def _kernel_args(qn, kpb, vpb, g=None):
    ts = (qn, kpb, vpb) + (() if g is None else (g,))
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError("spatial_attn kernels take bf16 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("spatial_attn kernels take contiguous tensors")


def spatial_attn_fwd(qn: torch.Tensor, kpb: torch.Tensor, vpb: torch.Tensor,
                     h: int, key: int, rate: float) -> torch.Tensor:
    """K3 wrapper: (B, N, C) out in qn's dtype."""
    _check(qn, kpb, vpb, h)
    if qn.device.type == "cpu":
        return spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate)
    _kernel_args(qn, kpb, vpb)
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    out = torch.empty_like(qn)
    err = _fns()["fwd"](
        _build.ptr(qn), _build.ptr(kpb), _build.ptr(vpb), _build.ptr(out),
        b, n, c, hp, hp // h, key, keep_threshold(rate),
        1.0 / (1.0 - rate), int(rate > 0.0), _build.stream())
    _build.check(err, "spatial_attn_fwd")
    spatial_attn_fwd.launches += 1
    return out


def spatial_attn_bwd(qn: torch.Tensor, kpb: torch.Tensor, vpb: torch.Tensor,
                     g: torch.Tensor, h: int, key: int, rate: float):
    """K4 wrapper: (dqn in qn's dtype, dkpb f32, dvpb f32)."""
    _check(qn, kpb, vpb, h, g)
    if qn.device.type == "cpu":
        return spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    _kernel_args(qn, kpb, vpb, g)
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    dqn = torch.empty_like(qn)
    # one partial per block along the tokens, added over the blocks in a
    # fixed order (the same bits run to run)
    blocks = _fns()["blocks"](b, n, ctypes.byref(ctypes.c_int()))
    dkpb = torch.empty((blocks, b, c, hp), dtype=torch.float32,
                       device=qn.device)
    dvpb = torch.empty((blocks, b, hp, c), dtype=torch.float32,
                       device=qn.device)
    err = _fns()["bwd"](
        _build.ptr(qn), _build.ptr(kpb), _build.ptr(vpb), _build.ptr(g),
        _build.ptr(dqn), _build.ptr(dkpb), _build.ptr(dvpb),
        b, n, c, hp, hp // h, key, keep_threshold(rate),
        1.0 / (1.0 - rate), int(rate > 0.0), _build.stream())
    _build.check(err, "spatial_attn_bwd")
    spatial_attn_bwd.launches += 1
    return dqn, dkpb.sum(0), dvpb.sum(0)


spatial_attn_fwd.launches = 0
spatial_attn_bwd.launches = 0


class SpatialAttn(torch.autograd.Function):
    """Differentiable spatial-attention tail: forward K3, backward K4.
    kpb and vpb are taken in qn's dtype, as the TPU kernel takes them."""

    @staticmethod
    def forward(ctx, qn, kpb, vpb, h: int, key: int, rate: float):
        kq, vq = kpb.to(qn.dtype).contiguous(), vpb.to(qn.dtype).contiguous()
        qn = qn.contiguous()
        ctx.save_for_backward(qn, kq, vq)
        ctx.h, ctx.key, ctx.rate = h, key, rate
        ctx.dtypes = (kpb.dtype, vpb.dtype)
        return spatial_attn_fwd(qn, kq, vq, h, key, rate)

    @staticmethod
    def backward(ctx, g):
        qn, kq, vq = ctx.saved_tensors
        dqn, dkpb, dvpb = spatial_attn_bwd(
            qn, kq, vq, g.to(qn.dtype).contiguous(), ctx.h, ctx.key, ctx.rate)
        return (dqn, dkpb.to(ctx.dtypes[0]), dvpb.to(ctx.dtypes[1]),
                None, None, None)


def spatial_attn(qn, kpb, vpb, h: int, key: int = 0,
                 rate: float = 0.0) -> torch.Tensor:
    return SpatialAttn.apply(qn, kpb, vpb, h, key, rate)
