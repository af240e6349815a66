"""The residual U-Net (MONAI UNet equivalent).

Counterpart of `fcd_tpu/models/unet.py` on dense channels-last tensors:
a strided `ResidualUnit` encoder (conv with bias, instance norm,
`ChannelDropout3d`, PReLU; a strided k3 or a 1x1 residual conv where the
shape changes), a bottom unit, and per level a transposed-conv decoder
(k3 s2 with lax's SAME padding, `ops/layers.py::conv_transpose3d`) over the
concatenated skip, then a one-subunit unit (`last_conv_only` at the top:
its conv alone, no norm or activation).

The JAX package leaves every conv of this model to XLA at its defaults:
`F.conv3d` and `F.conv_transpose3d` here. Under FCD_FAST_CONV=1 the 3x3
stride-1 convs run B1 (`ops/layers.py::Conv3d`, B14 by function), as the
DSA family's plain convs do. No other kernel is on its path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from fcd_tpu_torch.ops.attention import ChannelDropout3d
from fcd_tpu_torch.ops.layers import (
    Conv3d,
    ConvTranspose3d,
    DropoutRng,
    PReLU,
    instance_norm,
)


class ResidualUnit(nn.Module):
    """`fcd_tpu/models/unet.py::ResidualUnit` (MONAI's): `subunits` x
    (conv, instance norm, dropout, PReLU), the first strided, plus the
    residual (a strided k3 conv, a 1x1 conv where only the channels change,
    else the identity); `last_conv_only` drops the last subunit's norm,
    dropout and PReLU. Flax names: Conv3d_0.. (the subunits, then the
    residual), PReLU_0.. (one per activated subunit)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 subunits: int = 2, dropout: float = 0.0,
                 last_conv_only: bool = False,
                 rng: Optional[DropoutRng] = None, fast: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv3d(in_channels if i == 0 else out_channels, out_channels, 3,
                   stride if i == 0 else 1, True,
                   fast and (stride == 1 or i > 0))
            for i in range(subunits))
        self.n_act = subunits - 1 if last_conv_only else subunits
        self.acts = nn.ModuleList(PReLU(0.25) for _ in range(self.n_act))
        self.dropout = (ChannelDropout3d(dropout, rng) if dropout > 0
                        else None)
        self.residual = (
            Conv3d(in_channels, out_channels, 1 if stride == 1 else 3,
                   stride, True)
            if stride != 1 or in_channels != out_channels else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in [*self.convs, *self.acts] + (
                [] if self.residual is None else [self.residual]):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i, conv in enumerate(self.convs):
            out = conv(out)
            if i < self.n_act:
                out = instance_norm(out)
                if self.dropout is not None:
                    out = self.dropout(out)
                out = self.acts[i](out)
        res = x if self.residual is None else self.residual(x)
        return out + res


class UNet(nn.Module):
    """`fcd_tpu/models/unet.py::UNet` as the JAX factory builds it (strides
    2, two res units; the module docstring). forward: (B, D, H, W,
    in_channels) -> logits (B, D, H, W, out_channels) in compute_dtype.
    Level L has a down unit (channels[L], stride 2); the bottom unit widens
    to channels[-1]; the up path of level L runs a k3 s2 transposed conv of
    [down_L, inner] to channels[L - 1] (out_channels at the top), instance
    norm, dropout, PReLU and a one-subunit unit."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2,
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dropout: float = 0.1, fast: bool = False):
        super().__init__()
        chans = tuple(channels)
        levels = len(chans) - 1
        self.compute_dtype = torch.float32
        self.dropout_rng = rng = DropoutRng()

        def unit(cin, cout, stride, subunits, top=False):
            return ResidualUnit(cin, cout, stride, subunits, dropout, top,
                                rng, fast)

        self.downs = nn.ModuleList(
            unit(in_channels if lv == 0 else chans[lv - 1], chans[lv], 2, 2)
            for lv in range(levels))
        self.bottom = unit(chans[-2], chans[-1], 1, 2)
        self.up_convs = nn.ModuleList()
        self.up_acts = nn.ModuleList()
        self.up_units = nn.ModuleList()
        self.up_dropout = (ChannelDropout3d(dropout, rng) if dropout > 0
                           else None)
        for lv in range(levels):
            inner = chans[lv + 1] if lv == levels - 1 else chans[lv]
            cout = out_channels if lv == 0 else chans[lv - 1]
            self.up_convs.append(ConvTranspose3d(chans[lv] + inner, cout, 3,
                                                 True, 2))
            self.up_acts.append(PReLU(0.25))
            self.up_units.append(unit(cout, cout, 1, 1, top=lv == 0))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers, drawn from `generator`."""
        for m in (*self.downs, self.bottom, *self.up_convs, *self.up_acts,
                  *self.up_units):
            m.reset_parameters(generator)

    def _up(self, lv: int, cat: torch.Tensor) -> torch.Tensor:
        out = instance_norm(self.up_convs[lv](cat))
        if self.up_dropout is not None:
            out = self.up_dropout(out)
        return self.up_units[lv](self.up_acts[lv](out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.compute_dtype).contiguous()
        skips = []
        for down in self.downs:
            h = down(h)
            skips.append(h)
        inner = self.bottom(h)
        for lv in reversed(range(len(self.downs))):
            inner = self._up(lv, torch.cat([skips[lv], inner], dim=-1))
        return inner
