"""The sliding-window engine's volume entry (B17) and blend exit (B6).

`sw_entry` replaces `fcd_tpu/kernels/s2d_entry.py::s2d_entry` (pallas_call
:102) and `sw_exit` replaces `fcd_tpu/kernels/d2s_exit.py::d2s_exit_flat`
(pallas_call :100). Both TPU kernels exist to lay a volume out in the
TPU's space-to-depth lanes; on the card each is the op it serves, in one
pass (ROADMAP ground rules):

    sw_entry:  (D, H, W, C) f32 -> zero pad to at least the roi, split
               p // 2 before and p - p // 2 after, then cast to the compute
               dtype: (PD, PH, PW, C) bf16 or f32
    sw_exit:   (acc * inv)[od:od+D, oh:oh+H, ow:ow+W] with acc (PD, PH, PW,
               O) f32 and inv (PD, PH, PW, 1) f32 -> contiguous (D, H, W, O)
               f32, whose (D, H, W*O) view is the JAX engine's flat output

The CUDA kernels are `fcd_tpu_torch/csrc/sw_io.cu`, bound by the bytes
they move (its header). Each is bit-equal to its plain version: the entry
copies and rounds to nearest even as `Tensor.to` does, the exit is one f32
multiply per element.

CPU tensors take the plain PyTorch versions; CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels import _build

REPLACES_ENTRY = "fcd_tpu/kernels/s2d_entry.py:90"  # s2d_entry (pallas_call :102)
REPLACES_EXIT = "fcd_tpu/kernels/d2s_exit.py:87"  # d2s_exit_flat (pallas_call :100)


def entry_pad(shape: Sequence[int], roi: Sequence[int]) -> List[Tuple[int, int]]:
    """(before, after) zero pad per spatial axis that brings `shape` up to
    `roi` (MONAI's symmetric split: half before, the rest after)."""
    out = []
    for s, r in zip(shape, roi):
        p = max(int(r) - int(s), 0)
        out.append((p // 2, p - p // 2))
    return out


def sw_entry_plain(vol: torch.Tensor, roi: Sequence[int],
                   dtype: torch.dtype) -> torch.Tensor:
    """F.pad then the cast, as the engine did before the kernel."""
    cfg = []
    for before, after in reversed(entry_pad(vol.shape[:3], roi)):
        cfg += [before, after]
    return F.pad(vol, [0, 0] + cfg).to(dtype)


_FNS = {}


def _fn(name: str, nptr: int, nint: int):
    """The C entry point `name` of sw_io.cu: nptr pointers, nint ints, the
    stream."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("sw_io"), name)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * nptr + [ci] * nint + [vp]
        fn.restype = ci
        _FNS[name] = fn
    return fn


def sw_entry(vol: torch.Tensor, roi: Sequence[int],
             dtype: torch.dtype) -> torch.Tensor:
    """B17 wrapper. vol: (D, H, W, C) f32; roi: (rd, rh, rw); dtype:
    torch.bfloat16 or torch.float32. Returns the padded (PD, PH, PW, C)
    volume in dtype."""
    if vol.dim() != 4 or len(roi) != 3:
        raise ValueError(f"vol must be (D, H, W, C) and roi 3 sizes, got "
                         f"{tuple(vol.shape)} and {tuple(roi)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"sw_entry casts to bf16 or f32, not {dtype}")
    if vol.device.type == "cpu":
        return sw_entry_plain(vol, roi, dtype)
    if vol.device.type != "cuda":
        raise ValueError(f"sw_entry: unsupported device {vol.device}")
    if vol.dtype != torch.float32 or not vol.is_contiguous():
        raise TypeError("sw_entry kernel takes a contiguous f32 volume")
    d, h, w, c = vol.shape
    pads = entry_pad((d, h, w), roi)
    pd, ph, pw = (s + a + b for s, (a, b) in zip((d, h, w), pads))
    out = torch.empty((pd, ph, pw, c), dtype=dtype, device=vol.device)
    err = _fn("fcd_sw_entry", 2, 11)(
        _build.ptr(vol), _build.ptr(out), int(dtype == torch.bfloat16),
        d, h, w, c, pd, ph, pw, pads[0][0], pads[1][0], pads[2][0],
        _build.stream())
    _build.check(err, "sw_entry")
    sw_entry.launches += 1
    return out


sw_entry.launches = 0


def sw_exit_plain(acc: torch.Tensor, inv: torch.Tensor,
                  start: Sequence[int], size: Sequence[int]) -> torch.Tensor:
    """acc * inv, cropped, as the engine did before the kernel."""
    (od, oh, ow), (d, h, w) = start, size
    return (acc * inv)[od:od + d, oh:oh + h, ow:ow + w].contiguous()


def sw_exit(acc: torch.Tensor, inv: torch.Tensor, start: Sequence[int],
            size: Sequence[int]) -> torch.Tensor:
    """B6 wrapper. acc: (PD, PH, PW, O) f32; inv: (PD, PH, PW, 1) f32;
    start, size: the crop's corner and (D, H, W). Returns the contiguous
    (D, H, W, O) f32 volume."""
    if acc.dim() != 4 or tuple(inv.shape) != (*acc.shape[:3], 1):
        raise ValueError(f"acc {tuple(acc.shape)} must be (PD, PH, PW, O) "
                         f"and inv {tuple(inv.shape)} (PD, PH, PW, 1)")
    start = tuple(int(v) for v in start)
    size = tuple(int(v) for v in size)
    if any(o < 0 or o + s > p for o, s, p in zip(start, size, acc.shape[:3])):
        raise ValueError(f"crop {start} + {size} outside {tuple(acc.shape)}")
    if acc.device.type == "cpu":
        return sw_exit_plain(acc, inv, start, size)
    if acc.device.type != "cuda":
        raise ValueError(f"sw_exit: unsupported device {acc.device}")
    if acc.dtype != torch.float32 or inv.dtype != torch.float32 or not (
            acc.is_contiguous() and inv.is_contiguous()):
        raise TypeError("sw_exit kernel takes contiguous f32 acc and inv")
    o = acc.shape[3]
    out = torch.empty((*size, o), dtype=torch.float32, device=acc.device)
    err = _fn("fcd_sw_exit", 3, 9)(
        _build.ptr(acc), _build.ptr(inv), _build.ptr(out), *size, o,
        acc.shape[1], acc.shape[2], *start, _build.stream())
    _build.check(err, "sw_exit")
    sw_exit.launches += 1
    return out


sw_exit.launches = 0
