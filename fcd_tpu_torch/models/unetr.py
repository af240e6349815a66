"""UNETR: a ViT encoder and a convolutional decoder (MONAI UNETR
equivalent).

Counterpart of `fcd_tpu/models/unetr.py` on dense channels-last tensors:

- a k16 s16 conv patch embed with bias (512 tokens at 128^3), a learned
  `pos_embed` (1, N, hidden), dropout, then 12 ViT blocks
  (`ViTBlock`: LayerNorm, multi-head self-attention without qkv bias,
  LayerNorm, `MLPBlock`), each keeping its output;
- the hidden states of blocks 3, 6 and 9 (of 12) become feature pyramids
  (`PrUpStack`: a k2 transposed conv without bias, then per further
  doubling a transposed conv and a `UnetrBasicBlock`), block 12's is the
  bottleneck, and a `UnetrBasicBlock` runs on the image itself;
- four `UnetrUpBlock`s and a 1x1 head with bias.

The rounding points are the JAX package's: `LayerNorm` returns f32 and each
Dense takes its input cast to the compute type; the attention scale
1/sqrt(head width) is divided out in the scores' dtype (`unetr.py:36`);
the softmax and both products are plain PyTorch, as the JAX package
computes them outside Pallas. The res blocks run B1 and B2 and the up
blocks B4 (K1 and K2 backward) on the kernel route, and the blocks' plain
branch on the plain route (`ops/layers.py::use_plain_route`); the patch
embed, the PrUp transposed convs and the head are left to XLA by the JAX
package, `F.conv3d` and `F.conv_transpose3d` here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from fcd_tpu_torch.ops.blocks import MLPBlock, UnetrBasicBlock, UnetrUpBlock
from fcd_tpu_torch.ops.layers import (
    Conv3d,
    ConvTranspose3d,
    Dense,
    DropoutRng,
    LayerNorm,
    dropout,
)


class SelfAttention(nn.Module):
    """`fcd_tpu/models/unetr.py::_SelfAttention`: qkv Dense (C, 3C) without
    bias, per head q k^T / sqrt(c) (c = C / heads, the divisor cast to the
    scores' dtype), softmax, dropout, times v, the output Dense with bias,
    dropout. x (B, N, C) in the compute type."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 rng: Optional[DropoutRng] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"{num_heads} heads do not divide {dim}")
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, use_bias=False)
        self.proj = Dense(dim, dim)
        self.dropout_rate = dropout_rate
        self.rng = DropoutRng() if rng is None else rng

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.qkv.reset_parameters(generator)
        self.proj.reset_parameters(generator)

    def _drop(self, t: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return t
        return dropout(t, self.dropout_rate, self.rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scale = torch.sqrt(torch.tensor(float(c // h))).to(q.dtype)
        attn = torch.matmul(q, k.transpose(-1, -2)) / scale
        attn = self._drop(torch.softmax(attn, dim=-1))
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self._drop(self.proj(out))


class ViTBlock(nn.Module):
    """`fcd_tpu/models/unetr.py::_ViTBlock`: x + attn(LN(x)), then + MLP(LN(
    x)); each LayerNorm's f32 output cast to x's dtype for the Dense."""

    def __init__(self, dim: int, mlp_dim: int, num_heads: int,
                 dropout_rate: float = 0.0, rng: Optional[DropoutRng] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, dropout_rate, rng)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, dropout_rate, rng)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(x.dtype))
        return x + self.mlp(self.ln2(x).to(x.dtype))


class PrUpStack(nn.Module):
    """The `deconv_stack` of `fcd_tpu/models/unetr.py:101-113` (MONAI's
    UnetrPrUpBlock with conv and res blocks): a k2 s2 transposed conv
    (no bias) from the hidden width, then n_up - 1 x (transposed conv,
    `UnetrBasicBlock`)."""

    def __init__(self, hidden: int, out_channels: int, n_up: int):
        super().__init__()
        self.ups = nn.ModuleList(
            ConvTranspose3d(hidden if i == 0 else out_channels, out_channels,
                            2, False) for i in range(n_up))
        self.blocks = nn.ModuleList(
            UnetrBasicBlock(out_channels, out_channels)
            for _ in range(n_up - 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (*self.ups, *self.blocks):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ups[0](x)
        for up, blk in zip(self.ups[1:], self.blocks):
            y = blk([up(y)])
        return y


PATCH = 16        # the patch embed's kernel and stride
NUM_LAYERS = 12   # the decoder reads the hidden states of blocks 3, 6, 9, 12


class UNETR(nn.Module):
    """`fcd_tpu/models/unetr.py::UNETR` with res blocks and instance norm,
    as the JAX factory builds it (the module docstring). forward: (B, D,
    H, W, in_channels) patches of `img_size` -> logits (B, D, H, W,
    out_channels) in compute_dtype."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2,
                 img_size: Sequence[int] = (128, 128, 128),
                 feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 1024, num_heads: int = 12,
                 dropout_rate: float = 0.1):
        super().__init__()
        fs = feature_size
        self.img_size = tuple(int(s) for s in img_size)
        self.grid = tuple(s // PATCH for s in self.img_size)
        self.hidden_size = hidden_size
        self.compute_dtype = torch.float32
        self.dropout_rng = rng = DropoutRng()
        self.dropout_rate = dropout_rate
        self.patch_embed = Conv3d(in_channels, hidden_size, PATCH, PATCH,
                                  True)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, math.prod(self.grid), hidden_size))
        self.blocks = nn.ModuleList(
            ViTBlock(hidden_size, mlp_dim, num_heads, dropout_rate, rng)
            for _ in range(NUM_LAYERS))
        self.enc1 = UnetrBasicBlock(in_channels, fs)
        self.stacks = nn.ModuleList([             # enc2, enc3, enc4
            PrUpStack(hidden_size, fs * 2, 3),
            PrUpStack(hidden_size, fs * 4, 2),
            PrUpStack(hidden_size, fs * 8, 1)])
        self.decoders = nn.ModuleList(            # d4, d3, d2, d1
            UnetrUpBlock(cin, cout) for cin, cout in (
                (hidden_size, fs * 8), (fs * 8, fs * 4), (fs * 4, fs * 2),
                (fs * 2, fs)))
        self.head = Conv3d(fs, out_channels, 1, 1, True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers, drawn from `generator` (pos_embed zeros)."""
        for m in (self.patch_embed, *self.blocks, self.enc1, *self.stacks,
                  *self.decoders, self.head):
            m.reset_parameters(generator)
        with torch.no_grad():
            self.pos_embed.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:4]) != self.img_size:
            raise ValueError(f"patch grid {tuple(x.shape[1:4])} != img_size "
                             f"{self.img_size}")
        x = x.to(self.compute_dtype).contiguous()
        b = x.shape[0]
        tokens = self.patch_embed(x).reshape(b, -1, self.hidden_size)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        if self.training:
            tokens = dropout(tokens, self.dropout_rate, self.dropout_rng)
        hidden = []
        for blk in self.blocks:
            tokens = blk(tokens)
            hidden.append(tokens)

        def feat(t):
            return t.reshape(b, *self.grid, self.hidden_size).contiguous()

        skips = [self.enc1([x])]
        skips += [stack(feat(hidden[i])) for stack, i in
                  zip(self.stacks, (2, 5, 8))]
        out = feat(hidden[11])
        for dec, skip in zip(self.decoders, skips[::-1]):
            out = dec(out, skip)
        return self.head(out)
