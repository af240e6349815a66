"""MS_DSA_NET: the 6-level res-block U-Net (instance norm,
leaky-ReLU 0.01, no conv bias) with pos-embedded DSA transformer stacks at
levels 3-6 and transposed-conv decoders.

Counterpart of `fcd_tpu/models/ms_dsa_net.py::MS_DSA_NET` (the reference's
ms_dsa_net.py:104-407) on dense channels-last tensors. The TPU package's
s2d residency, padded-depth chain and lane logic are TPU layout and have no
counterpart here. Encoders 1-5 emit their 2x max pool from the block
finale (B2); the decoders' concat is never materialised (B1 sums its two
parts). `model.train()` runs the training forward: batch statistics in
the transformers' conv blocks, dropout (`dropout_rate` in the attention,
0.1 on the conv branch's channels) drawn from `model.dropout_rng`, which
the trainer seeds each step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fcd_tpu_torch.ops.attention import TransformerBlock
from fcd_tpu_torch.ops.blocks import UnetrBasicBlock, UnetrUpBlock
from fcd_tpu_torch.ops.layers import (
    DropoutRng,
    conv1x1,
    group_norm,
    kaiming_normal_fan_out_,
)


def _triple(x) -> Tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x),) * 3


class PatchEmbed(nn.Module):
    """1x1 conv (no bias) halving the channels, then GroupNorm."""

    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        self.gn_scale = nn.Parameter(torch.ones(out_channels))
        self.gn_bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.kernel, generator)
        with torch.no_grad():
            self.gn_scale.fill_(1.0)
            self.gn_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = group_norm(conv1x1(x, self.kernel), self.groups, self.gn_scale,
                       self.gn_bias)
        return t.to(x.dtype)


class MS_DSA_NET(nn.Module):
    """MS_DSA_NET. forward: (B, D, H, W, in_channels) patches whose grid is
    img_size -> (B, D, H, W, out_channels) logits in compute_dtype."""

    def __init__(self, out_channels: int, img_size: Sequence[int],
                 in_channels: int = 2, feature_size: int = 16,
                 project_size: int = 64, num_heads: int = 4,
                 sa_type: str = "parallel", num_layers: int = 3,
                 dropout_rate: float = 0.0):
        super().__init__()
        fs = feature_size
        self.img_size = _triple(img_size)
        self.in_channels = in_channels
        self.compute_dtype = torch.float32
        self.dropout_rng = DropoutRng()
        chans = [in_channels, fs, fs * 2, fs * 4, fs * 8, fs * 16, fs * 32]
        self.encoders = nn.ModuleList(
            UnetrBasicBlock(chans[i], chans[i + 1]) for i in range(6))
        # (level divisor, embed channels, GroupNorm groups, projection size)
        levels = [(4, fs * 2, fs, project_size), (8, fs * 4, fs * 2, project_size),
                  (16, fs * 8, fs * 4, project_size), (32, fs * 16, fs * 8, 32)]
        self.embeds = nn.ModuleList()
        self.transformers = nn.ModuleList()
        for li, (div, emb, groups, proj) in enumerate(levels):
            n = 1
            for s in self.img_size:
                n *= s // div
            self.embeds.append(PatchEmbed(chans[li + 3], emb, groups))
            self.transformers.append(nn.ModuleList(
                TransformerBlock(n, emb, proj, num_heads, sa_type,
                                 dropout_rate, self.dropout_rng,
                                 salt=li * num_layers + k)
                for k in range(num_layers)))
        self.decoders = nn.ModuleList([
            UnetrUpBlock(fs * 16, fs * 8), UnetrUpBlock(fs * 8, fs * 4),
            UnetrUpBlock(fs * 4, fs * 2), UnetrUpBlock(fs * 2, fs * 2),
            UnetrUpBlock(fs * 2, fs)])
        self.head = nn.Parameter(torch.empty(fs, out_channels))
        self.head_bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers (kaiming-normal fan-out convs, xavier qkvv,
        uniform EF, gamma 1e-6, zero pos-embed) drawn from `generator`."""
        for enc in self.encoders:
            enc.reset_parameters(generator)
        for emb, stack in zip(self.embeds, self.transformers):
            emb.reset_parameters(generator)
            for blk in stack:
                blk.reset_parameters(generator)
        for dec in self.decoders:
            dec.reset_parameters(generator)
        kaiming_normal_fan_out_(self.head, generator)
        with torch.no_grad():
            self.head_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:4]) != self.img_size:
            raise ValueError(f"patch grid {tuple(x.shape[1:4])} != img_size "
                             f"{self.img_size}")
        x = x.to(self.compute_dtype).contiguous()
        enc = self.encoders
        x1, p1 = enc[0]([x], pool=True)
        x2, p2 = enc[1]([p1], pool=True)
        # the JAX package pools levels 1-2 through the s2d pool (even tie
        # split) and levels 3-5 through a jnp.maximum chain (ROADMAP C8)
        x3, p3 = enc[2]([p2], pool=True, tie="chain")
        x4, p4 = enc[3]([p3], pool=True, tie="chain")
        x5, p5 = enc[4]([p4], pool=True, tie="chain")
        x6 = enc[5]([p5])

        def attend(li, feat):
            t = self.embeds[li](feat)
            for blk in self.transformers[li]:
                t = blk(t)
            return t

        t3, t4, t5, t6 = (attend(i, f) for i, f in enumerate((x3, x4, x5, x6)))
        dec = self.decoders
        y5 = dec[0](t6, t5)
        y4 = dec[1](y5, t4)
        y3 = dec[2](y4, t3)
        y2 = dec[3](y3, x2)
        y1 = dec[4](y2, x1)
        return conv1x1(y1, self.head, self.head_bias)
