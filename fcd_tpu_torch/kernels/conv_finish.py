"""The finishing pass of B1's row-parallel split.

Stands beside `fcd_tpu/kernels/block_conv.py::_fused8_call` (B1): where
tensor parallelism (`parallel/tp.py`) splits a 3x3x3 conv over the ranks'
input channels, each rank runs B1's partial instance
(`block_conv.conv3x3_partial`), the ranks' f32 partials are summed, and
this pass does what B1's epilogue does on one device: it rounds the sum to
the activation dtype and takes the per-(b, c) f32 sum and sum of squares
of the unrounded values (ROADMAP C3's rounding points). The CUDA kernel is
`fcd_tpu_torch/csrc/conv_finish.cu`; its header says what bounds it.

`conv_finish(s, dtype)` takes the plain version for a CPU tensor; a CUDA
tensor launches the kernel (f32 in, bf16 out) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from fcd_tpu_torch.kernels import _build

REPLACES = "fcd_tpu/kernels/block_conv.py:909"  # B1's epilogue, split off
THREADS = 256
MAX_C = 4 * THREADS
TARGET_BLOCKS = 4 * 132  # about four blocks on each of the H100's SMs


def conv_finish_plain(s: torch.Tensor, dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s rounded to dtype, per-(b, c) sum, sum of squares) of an f32
    (B, D, H, W, C) sum."""
    s = s.float()
    return (s.to(dtype).contiguous(), s.sum(dim=(1, 2, 3)),
            s.square().sum(dim=(1, 2, 3)))


def finish_plan(b: int, nvox: int, c: int) -> Tuple[int, int]:
    """(voxels a run, runs) of the kernel's grid for a (b, nvox, c) sum:
    runs enough for about TARGET_BLOCKS blocks, and no more runs than
    the rows a block's threads take at once."""
    rb = THREADS // min(c, THREADS)
    runs = max(1, min(-(-nvox // rb), -(-TARGET_BLOCKS // b)))
    rows = -(-nvox // runs)
    return rows, -(-nvox // rows)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("conv_finish").fcd_conv_finish
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _FN = fn
    return _FN


def conv_finish(s: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The finishing pass on an f32 (B, D, H, W, C) sum: the plain version
    for a CPU tensor, the CUDA kernel (bf16 out) for a CUDA one."""
    if s.dim() != 5:
        raise ValueError(f"the sum must be (B, D, H, W, C), got "
                         f"{tuple(s.shape)}")
    if s.device.type == "cpu":
        return conv_finish_plain(s, dtype)
    if s.device.type != "cuda":
        raise ValueError(f"conv_finish: unsupported device {s.device}")
    if s.dtype != torch.float32 or dtype != torch.bfloat16:
        raise TypeError(f"conv_finish kernel takes an f32 sum to bf16, got "
                        f"{s.dtype} to {dtype}" + _build.BF16_ONLY)
    if not s.is_contiguous():
        raise ValueError("conv_finish kernel takes a contiguous sum")
    b, c = s.shape[0], s.shape[-1]
    nvox = s.shape[1] * s.shape[2] * s.shape[3]
    if c > MAX_C or b * nvox * c >= 2 ** 31:
        raise ValueError(f"conv_finish kernel takes C <= {MAX_C} and under "
                         f"2^31 elements, got {tuple(s.shape)}")
    rows, runs = finish_plan(b, nvox, c)
    y = torch.empty(s.shape, dtype=torch.bfloat16, device=s.device)
    part = torch.empty((2, runs, b, c), dtype=torch.float32, device=s.device)
    err = _fn()(_build.ptr(s), _build.ptr(y), _build.ptr(part[0]),
                _build.ptr(part[1]), b, nvox, c, rows, runs, _build.stream())
    _build.check(err, "conv_finish")
    conv_finish.launches += 1
    # over the runs, in a fixed order (the same bits run to run)
    tot = part.sum(1)
    return y, tot[0], tot[1]


conv_finish.launches = 0
