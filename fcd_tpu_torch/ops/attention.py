"""Dual self-attention: DSA, TransformerBlock, ChannelDropout3d.

Counterpart of `fcd_tpu/ops/attention.py`. The transformer block is
`fcd_tpu/ops/attention.py::TransformerBlock` (conv_blocks.py:18-90 of the
reference):

    t = tokens + pos_embed
    y = t + gamma * DSA(LayerNorm(t))
    out = y + conv1x1(drop3d(UnetResBlock_batchnorm(y)))

The residual adds to the pos-embedded tokens (attention.py:120,132,
399-401). At eval the DSA is B5 (residual in its epilogue) and
ChannelDropout3d is the identity. In train mode the DSA is `dsa_train`,
the JAX package's train formulation `_dsa_tokens_resident`
(attention.py:222-303) in plain PyTorch around the spatial-attention
kernels K3/K4, with channel and spatial attention dropout, and
ChannelDropout3d(0.1) drops whole channels. Every `sa_type` of the JAX
package runs: 'parallel' (the default), 'serial', 'spatial' and
'channel'; K3/K4 run for all but 'channel'. `EPABlock` is UNETR++'s
block, the same function at 'parallel'.

The kernels take the tokens' dtype: bf16 tokens run B5's and K3/K4's
bf16 instances, f16 tokens (ROADMAP C20) their f16 instances and f32
tokens (ROADMAP C18) their f32 ones, as the JAX package runs `dsa_fused`
and `spatial_attn_train` at the model's compute type. The conv residual
block follows the model's route (`ops/blocks.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from fcd_tpu_torch.kernels.dsa_attention import (
    _L2_EPS,
    dsa_attention,
    num_slots,
)
from fcd_tpu_torch.kernels.spatial_attn import dropout_key, spatial_attn
from fcd_tpu_torch.ops.blocks import UnetResBlock
from fcd_tpu_torch.ops.layers import (
    DropoutRng,
    conv1x1,
    dropout,
    kaiming_normal_fan_out_,
    layer_norm,
    xavier_uniform_,
)


def _norm_tokens(t: torch.Tensor) -> torch.Tensor:
    """l2-normalise each (b, channel) over the tokens (f32 sums)."""
    tf = t.float()
    return (tf * torch.rsqrt(tf.square().sum(dim=1, keepdim=True)
                             + _L2_EPS)).to(t.dtype)


def dsa_train(x, w_qkvv, ef, temperature, temperature2, ln_scale, ln_bias,
              pos_embed, gamma, num_heads: int, rate: float,
              rng: DropoutRng, salt: int, eps: float = 1e-5,
              sa_type: str = "parallel", tp=None) -> torch.Tensor:
    """The train DSA block: tokens x (B, N, C) -> t + gamma * DSA(LN(t)),
    t = x + pos_embed, in x's dtype, as `fcd_tpu/ops/attention.py:116-132,
    222-303` computes it for each `sa_type`: 'parallel' adds the channel
    attention (values v_ca) and the spatial attention (values v_sa);
    'channel' and 'spatial' are one of them on the third slot; 'serial'
    feeds the spatial output to the channel attention as its values, so
    autograd carries K3/K4's output through the channel matrix. Channel
    attention drops out on its (B, h, c, c) matrix; the spatial tail runs
    K3/K4 with the hash seeded by (rng.seed, salt). `ef` is None for
    'channel'. `tp`: the layout of a row-sharded `w_qkvv` (`conv1x1`)."""
    dtype = x.dtype
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    base = x if pos_embed is None else x + pos_embed.to(dtype)
    xln = layer_norm(base, ln_scale, ln_bias, eps).to(dtype)
    slots = conv1x1(xln, w_qkvv, tp=tp).split(c, dim=-1)
    if len(slots) != num_slots(sa_type):
        raise ValueError(f"qkvv has {len(slots)} slots, sa_type {sa_type!r} "
                         f"takes {num_slots(sa_type)}")
    q, k = slots[0], slots[1]
    qn = _norm_tokens(q)

    def channel(v):
        # the per-head diagonal blocks of the (C, C) Gram
        kn = _norm_tokens(k)
        gram = torch.einsum("bnc,bnd->bcd", qn, kn).reshape(b, h, ch, h, ch)
        blocks = torch.stack([gram[:, j, :, j, :] for j in range(h)], dim=1)
        attn = torch.softmax((blocks * temperature.to(dtype)).float(), dim=-1)
        attn = dropout(attn, rate, rng).to(dtype)
        return torch.einsum("bnhj,bhij->bnhi", v.reshape(b, n, h, ch),
                            attn).reshape(b, n, c)

    def spatial(v):
        # keys and values projected N -> P, block-expanded
        efd = ef.to(dtype)
        kp = torch.einsum("bnc,np->bcp", k, efd).reshape(b, h, ch, -1)
        vp = torch.einsum("bnc,np->bcp", v, efd).reshape(b, h, ch, -1)
        p = kp.shape[-1]
        eye = torch.eye(h, dtype=dtype, device=x.device)
        t2 = temperature2.reshape(h).to(dtype)
        kpb = torch.einsum("bhcp,hg->bhcgp", kp, eye * t2[:, None]).reshape(
            b, c, h * p)
        vpb = torch.einsum("bhcp,hg->bgphc", vp, eye).reshape(b, h * p, c)
        return spatial_attn(qn, kpb, vpb, h, dropout_key(rng.seed, salt),
                            rate, rng.offset)

    if sa_type == "channel":
        out = channel(slots[2])
    elif sa_type == "spatial":
        out = spatial(slots[2])
    elif sa_type == "serial":
        out = channel(spatial(slots[2]))
    else:
        out = channel(slots[2]) + spatial(slots[3])
    return base + gamma.to(dtype) * out.to(dtype)


class DSA(nn.Module):
    """Dual self-attention (no qkv bias) with flax parameter layouts: qkvv
    (C, 4C) for sa_type 'parallel', (C, 3C) for 'serial', 'spatial' and
    'channel', temperature / temperature2 (h, 1, 1), and EF (N, P) except
    for 'channel', which has none (`fcd_tpu/ops/attention.py:78-95`)."""

    tp = None

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4, sa_type: str = "parallel",
                 dropout_rate: float = 0.0, rng: Optional[DropoutRng] = None,
                 salt: int = 0):
        super().__init__()
        nslots = num_slots(sa_type)
        if hidden_size % num_heads:
            raise ValueError(f"{num_heads} heads do not divide {hidden_size}")
        self.num_heads = num_heads
        self.proj_size = proj_size
        self.dropout_rate = dropout_rate
        self.rng = DropoutRng() if rng is None else rng
        self.salt = salt
        self.sa_type = sa_type
        c = hidden_size
        self.qkvv = nn.Parameter(torch.empty(c, nslots * c))
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.temperature2 = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.EF = (None if sa_type == "channel"
                   else nn.Parameter(torch.empty(input_size, proj_size)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        xavier_uniform_(self.qkvv, generator)
        lim = 1.0 / self.proj_size ** 0.5
        with torch.no_grad():
            self.temperature.fill_(1.0)
            self.temperature2.fill_(1.0)
            if self.EF is not None:
                self.EF.uniform_(-lim, lim, generator=generator)

    def forward(self, tokens: torch.Tensor, ln_scale: torch.Tensor,
                ln_bias: torch.Tensor, pos_embed: torch.Tensor,
                gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        """tokens (B, N, C), raw: returns t + gamma * DSA(LN(t)) with
        t = tokens + pos_embed (N, C)."""
        if self.training:
            return dsa_train(tokens, self.qkvv, self.EF, self.temperature,
                             self.temperature2, ln_scale, ln_bias, pos_embed,
                             gamma, self.num_heads, self.dropout_rate,
                             self.rng, self.salt, eps, self.sa_type, self.tp)
        qkvv = self.qkvv if self.tp is None else self.tp.whole(self.qkvv)
        return dsa_attention(tokens, qkvv, self.EF, self.temperature,
                             self.temperature2, ln_scale, ln_bias, pos_embed,
                             gamma, self.num_heads, eps, self.sa_type)


class ChannelDropout3d(nn.Module):
    """torch Dropout3d parity: in train mode each (sample, channel) of a
    (B, D, H, W, C) tensor is zeroed with probability `rate` and the rest
    scaled by 1 / (1 - rate); the identity at eval."""

    def __init__(self, rate: float, rng: Optional[DropoutRng] = None):
        super().__init__()
        self.rate = rate
        self.rng = DropoutRng() if rng is None else rng

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, self.rng,
                       (x.shape[0], 1, 1, 1, x.shape[-1]))


class TransformerBlock(nn.Module):
    """DSA transformer block on (B, D, H, W, C) features. `rng` is the
    model's shared dropout state and `salt` this layer's index, which
    salts the spatial-attention dropout hash."""

    tp = None

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4, sa_type: str = "parallel",
                 dropout_rate: float = 0.0, rng: Optional[DropoutRng] = None,
                 salt: int = 0):
        super().__init__()
        rng = DropoutRng() if rng is None else rng
        c = hidden_size
        self.pos_embed = nn.Parameter(torch.zeros(1, input_size, c))
        self.gamma = nn.Parameter(torch.full((c,), 1e-6))
        self.ln_scale = nn.Parameter(torch.ones(c))
        self.ln_bias = nn.Parameter(torch.zeros(c))
        self.dsa = DSA(input_size, c, proj_size, num_heads, sa_type,
                       dropout_rate, rng, salt)
        self.conv_block = UnetResBlock(c, c, norm_name="batch")
        self.dropout = ChannelDropout3d(0.1, rng)
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
        return y + conv1x1(conv, self.conv8, self.conv8_bias, self.tp)


class EPABlock(TransformerBlock):
    """UNETR++'s efficient paired-attention block
    (`fcd_tpu/ops/attention.py::EPABlock`, :408-450): the DSA at sa_type
    'parallel' with LayerNorm, pos-embed and gamma, then the batch-norm
    conv residual on the attention output. That is `TransformerBlock`'s
    function at 'parallel' (`_conv_residual_branch` serves both in the JAX
    package); the class of its own names its weights EPABlock_i in the
    weight table."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4, dropout_rate: float = 0.0,
                 rng: Optional[DropoutRng] = None, salt: int = 0):
        super().__init__(input_size, hidden_size, proj_size, num_heads,
                         "parallel", dropout_rate, rng, salt)
