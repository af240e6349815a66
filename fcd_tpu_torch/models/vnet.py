"""V-Net (MONAI VNet equivalent).

Counterpart of `fcd_tpu/models/vnet.py` on dense channels-last tensors:
5x5x5 convs with bias, batch norm (`ops/layers.py::BatchNorm`: the batch's
statistics in train mode, updating the running ones, C7) and PReLU (init
0.2); a stem whose residual is the input tiled along the channels; k2 s2
down convs; k2 s2 transposed-conv ups over the concatenated skip;
`ChannelDropout3d` 0.5 on the deep levels (the up path drops the skip at
0.5 too); a 5^3 conv, batch norm and PReLU, then a 1x1 head.

The JAX package leaves every conv of this model to XLA (none is a 3x3
stride-1 conv, so FCD_FAST_CONV does not reach it either): `F.conv3d` and
`F.conv_transpose3d` here. No kernel is on its path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fcd_tpu_torch.ops.attention import ChannelDropout3d
from fcd_tpu_torch.ops.layers import (
    BatchNorm,
    Conv3d,
    ConvTranspose3d,
    DropoutRng,
    PReLU,
)

ACT_INIT = 0.2   # ("prelu", {"init": 0.2}), fcd_tpu/models/factory.py:218


class _ConvBnAct(nn.Module):
    """conv (bias), batch norm, PReLU: `_LUConv` (flax Conv3d_0,
    BatchNorm_0, PReLU_0), and the stem's and transitions' first layer."""

    def __init__(self, cin: int, cout: int, k: int = 5, stride: int = 1,
                 transpose: bool = False):
        super().__init__()
        self.conv = (ConvTranspose3d(cin, cout, k, True) if transpose
                     else Conv3d(cin, cout, k, stride, True))
        self.norm = BatchNorm(cout)
        self.act = PReLU(ACT_INIT)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.conv, self.norm, self.act):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        y = self.norm(self.conv(x))
        return self.act(y) if act else y


class _InputTransition(nn.Module):
    """conv 5^3 + batch norm, plus the input tiled to out_channels, PReLU."""

    def __init__(self, in_channels: int, out_channels: int = 16):
        super().__init__()
        if out_channels % in_channels:
            raise ValueError(f"the stem tiles {in_channels} input channels "
                             f"to {out_channels}")
        self.layer = _ConvBnAct(in_channels, out_channels)
        self.reps = out_channels // in_channels

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.layer(x, act=False)
        return self.layer.act(out + torch.cat([x] * self.reps, dim=-1))


class _DownTransition(nn.Module):
    """k2 s2 conv, batch norm, PReLU (PReLU_0); dropout; n_convs
    `_LUConv`s; the sum with the down output, PReLU (PReLU_1)."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int,
                 dropout: float, rng: DropoutRng):
        super().__init__()
        self.down = _ConvBnAct(in_channels, out_channels, 2, 2)
        self.dropout = (ChannelDropout3d(dropout, rng) if dropout > 0
                        else None)
        self.convs = nn.ModuleList(_ConvBnAct(out_channels, out_channels)
                                   for _ in range(n_convs))
        self.act = PReLU(ACT_INIT)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.down, *self.convs, self.act):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down = self.down(x)
        out = down if self.dropout is None else self.dropout(down)
        for conv in self.convs:
            out = conv(out)
        return self.act(out + down)


class _UpTransition(nn.Module):
    """dropout on x and (at 0.5) on the skip; k2 s2 transposed conv to
    out_channels / 2, batch norm, PReLU (PReLU_0); the concatenation with
    the skip; n_convs `_LUConv`s; the sum with the concatenation, PReLU
    (PReLU_1)."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int,
                 dropout: float, rng: DropoutRng):
        super().__init__()
        self.dropout = (ChannelDropout3d(dropout, rng) if dropout > 0
                        else None)
        self.skip_dropout = (ChannelDropout3d(0.5, rng) if dropout > 0
                             else None)
        self.up = _ConvBnAct(in_channels, out_channels // 2, 2,
                             transpose=True)
        self.convs = nn.ModuleList(_ConvBnAct(out_channels, out_channels)
                                   for _ in range(n_convs))
        self.act = PReLU(ACT_INIT)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.up, *self.convs, self.act):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x, skip = self.dropout(x), self.skip_dropout(skip)
        cat = torch.cat([self.up(x), skip], dim=-1)
        out = cat
        for conv in self.convs:
            out = conv(out)
        return self.act(out + cat)


class VNet(nn.Module):
    """`fcd_tpu/models/vnet.py::VNet` (the module docstring). forward:
    (B, D, H, W, in_channels) -> logits (B, D, H, W, out_channels) in
    compute_dtype; the grid must divide by 16."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2,
                 dropout_prob: float = 0.5):
        super().__init__()
        self.compute_dtype = torch.float32
        self.dropout_rng = rng = DropoutRng()
        p = dropout_prob
        self.stem = _InputTransition(in_channels, 16)
        self.downs = nn.ModuleList([
            _DownTransition(16, 32, 1, 0.0, rng),
            _DownTransition(32, 64, 2, 0.0, rng),
            _DownTransition(64, 128, 3, p, rng),
            _DownTransition(128, 256, 2, p, rng)])
        self.ups = nn.ModuleList([
            _UpTransition(256, 256, 2, p, rng),
            _UpTransition(256, 128, 2, p, rng),
            _UpTransition(128, 64, 1, 0.0, rng),
            _UpTransition(64, 32, 1, 0.0, rng)])
        self.out = _ConvBnAct(32, out_channels)
        self.head = Conv3d(out_channels, out_channels, 1, 1, True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers, drawn from `generator`."""
        for m in (self.stem, *self.downs, *self.ups, self.out, self.head):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).contiguous()
        skips = [self.stem(x)]
        for down in self.downs:
            skips.append(down(skips[-1]))
        u = skips.pop()
        for up in self.ups:
            u = up(u, skips.pop())
        return self.head(self.out(u))
