"""U-Net blocks: UnetResBlock, UnetrBasicBlock, UnetrUpBlock.

Counterpart of `fcd_tpu/ops/blocks.py`, composed as
`fcd_tpu/ops/s2d_ops.py::_fused_resblock_eval8` (:1005-1182) composes the
TPU kernels at eval, on dense channels-last tensors, and differentiable
in train mode (`conv3x3_op`, `finale`, `upsample2x_op`: forward B1, B2,
B4, backward B1 + K1, K2, matmuls):

1. conv1 through B1 over the block's input parts (one part, or the
   decoder's upsample and skip, never concatenated), with the 1x1
   projection shortcut as a second output from the same reads and the
   statistics of both;
2. conv2 through B1, with norm1's affine and the activation applied in its
   prologue, and its statistics;
3. the finale through B2: norm2 + the (normalised) shortcut + activation,
   which also writes the 2x max pool when the caller's next op is the pool.

Instance norm takes its per-(b, c) affine from the kernel sums (var =
E[x^2] - mean^2, clamped at 0). Batch norm takes its running statistics
at eval; in train mode the batch statistics from the same sums summed over
b, and it updates its running statistics (`ops/layers.py::BatchNorm`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from fcd_tpu_torch.kernels.block_conv import conv3x3_op
from fcd_tpu_torch.kernels.finale import finale
from fcd_tpu_torch.kernels.upsample import upsample2x_op
from fcd_tpu_torch.ops.layers import (
    BatchNorm,
    instance_affine_from_sums,
    kaiming_normal_fan_out_,
)

NEGATIVE_SLOPE = 0.01  # leaky-ReLU of every MS_DSA_NET block


class UnetResBlock(nn.Module):
    """conv-norm-act -> conv-norm (+ projected shortcut) -> act.

    Parameters keep the flax layouts: conv1 (3, 3, 3, Cin, Cout), conv2
    (3, 3, 3, Cout, Cout), conv3 (Cin, Cout) (the 1x1 shortcut, present
    when Cin != Cout)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_name: str = "instance"):
        super().__init__()
        if norm_name not in ("instance", "batch"):
            raise NotImplementedError(
                f"norm {norm_name!r}: the port has instance and batch norm "
                "(see ROADMAP.md)")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm_name = norm_name
        co = out_channels
        self.conv1 = nn.Parameter(torch.empty(3, 3, 3, in_channels, co))
        self.conv2 = nn.Parameter(torch.empty(3, 3, 3, co, co))
        self.conv3 = (nn.Parameter(torch.empty(in_channels, co))
                      if in_channels != co else None)
        batch = norm_name == "batch"
        self.norm1 = BatchNorm(co) if batch else None
        self.norm2 = BatchNorm(co) if batch else None
        self.norm3 = (BatchNorm(co) if batch and self.conv3 is not None
                      else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.conv1, self.conv2, self.conv3):
            if w is not None:
                kaiming_normal_fan_out_(w, generator)
        for nm in (self.norm1, self.norm2, self.norm3):
            if nm is not None:
                nm.reset_parameters(generator)

    def _affine(self, norm, s1, s2, b: int, n: int):
        if norm is None:
            return instance_affine_from_sums(s1, s2, n)
        if self.training:
            return norm.affine_from_sums(s1, s2, n)
        w, sh = norm.affine()
        return w.expand(b, -1), sh.expand(b, -1)

    def forward(self, parts: Sequence[torch.Tensor], pool: bool = False,
                tie: str = "even"):
        """parts: 1 or 2 (B, D, H, W, Ci) tensors whose channel concat is the
        block input. Returns out, or (out, pooled) with pool=True; `tie` is
        how the pool's gradient splits among tied maxima (`kernels/
        finale.py`: `even` at levels 1-2, `chain` at levels 3-5)."""
        parts = list(parts)
        widths = [p.shape[-1] for p in parts]
        if sum(widths) != self.in_channels:
            raise ValueError(f"parts {widths} do not sum to "
                             f"{self.in_channels} input channels")
        if len(parts) > 1 and self.conv3 is None:
            raise ValueError("a multi-part input needs the 1x1 shortcut")
        b = parts[0].shape[0]
        n = parts[0].shape[1] * parts[0].shape[2] * parts[0].shape[3]
        w1 = list(torch.split(self.conv1, widths, dim=3))
        wr = (None if self.conv3 is None
              else list(torch.split(self.conv3, widths, dim=0)))
        stats = self.norm_name == "instance" or self.training
        o1 = conv3x3_op(parts, w1, shortcut=wr, want_stats=stats)
        scale1, shift1 = self._affine(self.norm1, o1.ysum, o1.ysq, b, n)
        o2 = conv3x3_op([o1.y], [self.conv2],
                     prologue=(scale1, shift1, NEGATIVE_SLOPE),
                     want_stats=stats)
        scale2, shift2 = self._affine(self.norm2, o2.ysum, o2.ysq, b, n)
        if self.conv3 is not None:
            r = o1.r
            scale_r, shift_r = self._affine(self.norm3, o1.rsum, o1.rsq, b, n)
        else:
            r = parts[0]
            scale_r = torch.ones_like(scale2)
            shift_r = torch.zeros_like(shift2)
        return finale(o2.y, r, scale2, shift2, scale_r, shift_r,
                      NEGATIVE_SLOPE, pool=pool, tie=tie)


class UnetrBasicBlock(UnetResBlock):
    """The res-or-basic selector of `fcd_tpu/ops/blocks.py` with
    res_block=True, the only form MS_DSA_NET uses."""


class UnetrUpBlock(nn.Module):
    """Transposed-conv (k2 s2, no bias) upsample through B4, then the res
    block over [upsampled, skip] (the concat is never materialised)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.transp = nn.Parameter(torch.empty(2, 2, 2, in_channels,
                                               out_channels))
        self.block = UnetResBlock(2 * out_channels, out_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.transp, generator)
        self.block.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block([upsample2x_op(x, self.transp), skip])
