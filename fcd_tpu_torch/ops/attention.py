"""Eval dual self-attention: DSA, TransformerBlock, ChannelDropout3d.

Counterpart of `fcd_tpu/ops/attention.py` at eval. The transformer block
is `fcd_tpu/ops/attention.py::TransformerBlock` (conv_blocks.py:18-90 of
the reference):

    t = tokens + pos_embed
    y = t + gamma * DSA(LayerNorm(t))        (B5, residual in its epilogue)
    out = y + conv1x1(drop3d(UnetResBlock_batchnorm(y)))

The residual adds to the pos-embedded tokens (attention.py:120,132,
399-401). ChannelDropout3d is the identity at eval.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fcd_tpu_torch.kernels.dsa_attention import dsa_attention
from fcd_tpu_torch.ops.blocks import UnetResBlock
from fcd_tpu_torch.ops.layers import (
    conv1x1,
    kaiming_normal_fan_out_,
    xavier_uniform_,
)


class DSA(nn.Module):
    """Dual self-attention (sa_type 'parallel', no qkv bias) with flax
    parameter layouts: qkvv (C, 4C), temperature / temperature2 (h, 1, 1),
    EF (N, P)."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4, sa_type: str = "parallel"):
        super().__init__()
        if sa_type != "parallel":
            raise NotImplementedError(
                f"sa_type {sa_type!r}: the port has 'parallel', the default "
                "(see ROADMAP.md)")
        if hidden_size % num_heads:
            raise ValueError(f"{num_heads} heads do not divide {hidden_size}")
        self.num_heads = num_heads
        self.proj_size = proj_size
        c = hidden_size
        self.qkvv = nn.Parameter(torch.empty(c, 4 * c))
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.temperature2 = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.EF = nn.Parameter(torch.empty(input_size, proj_size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        xavier_uniform_(self.qkvv, generator)
        lim = 1.0 / self.proj_size ** 0.5
        with torch.no_grad():
            self.temperature.fill_(1.0)
            self.temperature2.fill_(1.0)
            self.EF.uniform_(-lim, lim, generator=generator)

    def forward(self, tokens: torch.Tensor, ln_scale: torch.Tensor,
                ln_bias: torch.Tensor, pos_embed: torch.Tensor,
                gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        """tokens (B, N, C), raw: returns t + gamma * DSA(LN(t)) with
        t = tokens + pos_embed (N, C)."""
        return dsa_attention(tokens, self.qkvv, self.EF, self.temperature,
                             self.temperature2, ln_scale, ln_bias, pos_embed,
                             gamma, self.num_heads, eps)


class ChannelDropout3d(nn.Module):
    """torch Dropout3d parity; the identity at eval (the only mode ported)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class TransformerBlock(nn.Module):
    """DSA transformer block on (B, D, H, W, C) features, eval."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4, sa_type: str = "parallel"):
        super().__init__()
        c = hidden_size
        self.pos_embed = nn.Parameter(torch.zeros(1, input_size, c))
        self.gamma = nn.Parameter(torch.full((c,), 1e-6))
        self.ln_scale = nn.Parameter(torch.ones(c))
        self.ln_bias = nn.Parameter(torch.zeros(c))
        self.dsa = DSA(input_size, c, proj_size, num_heads, sa_type)
        self.conv_block = UnetResBlock(c, c, norm_name="batch")
        self.dropout = ChannelDropout3d()
        self.conv8 = nn.Parameter(torch.empty(c, c))
        self.conv8_bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.pos_embed.zero_()
            self.gamma.fill_(1e-6)
            self.ln_scale.fill_(1.0)
            self.ln_bias.zero_()
            self.conv8_bias.zero_()
        self.dsa.reset_parameters(generator)
        self.conv_block.reset_parameters(generator)
        kaiming_normal_fan_out_(self.conv8, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        pe = self.pos_embed[0]
        if pe.shape[0] != d * h * w:
            raise ValueError(f"grid {(d, h, w)} does not match the "
                             f"{pe.shape[0]}-token pos-embed")
        tokens = self.dsa(x.reshape(b, d * h * w, c), self.ln_scale,
                          self.ln_bias, pe, self.gamma)
        y = tokens.to(x.dtype).reshape(b, d, h, w, c)
        conv = self.dropout(self.conv_block([y]))
        return y + conv1x1(conv, self.conv8, self.conv8_bias)
