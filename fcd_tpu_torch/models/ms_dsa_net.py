"""MS_DSA_NET: the 6-level res-block U-Net (instance norm,
leaky-ReLU 0.01, no conv bias) with pos-embedded DSA transformer stacks at
levels 3-6 and transposed-conv decoders; MS_DSA_NET_PS, the same trunk
with pixelshuffle (or deconv, nontrainable) decoders; BaseUNet, the plain
res-block U-Net of depth 6 (`fcd_tpu/models/ms_dsa_net.py:30-78`).

Counterpart of `fcd_tpu/models/ms_dsa_net.py::MS_DSA_NET` (the reference's
ms_dsa_net.py:104-407) on dense channels-last tensors. The TPU package's
s2d residency, padded-depth chain and lane logic are TPU layout and have no
counterpart here. Encoders 1-5 emit their 2x max pool from the block
finale (B2); the decoders' concat is never materialised (B1 sums its two
parts).

Three decisions of the JAX package's gates change what runs
(`fcd_tpu_torch/flags.py::model_gates`); the factory resolves them when
it builds the model and freezes them here: `pool_in_finale` (eval, train)
says whether encoders 1-2 pool inside their finale or in a pass of their
own (B3, and B9 backward), `levels12_tie` how that pool's gradient splits
ties (`chain` keeps the pool in the finale, K2's chain split), and
`fused_head` whether, at eval, the last decoder's finale and the 1x1 head
run as one kernel (B15).

On the plain route (`ops/layers.py::use_plain_route`, ROADMAP C18,
C20) the blocks take their plain branch and every encoder pools with the
`jnp.maximum` chain, as the JAX package does at f32 and f16
(`fcd_tpu/models/ms_dsa_net.py:192-214`: no s2d level, `max_pool_2x` at
every level); the head stays the 1x1 conv with bias (no B15).

`model.train()` runs the training forward: batch statistics in
the transformers' conv blocks, dropout (`dropout_rate` in the attention,
0.1 on the conv branch's channels) drawn from `model.dropout_rng`, which
the trainer seeds each step.

MS_DSA_NET_PS runs no s2d level in the JAX package (`use_s2d1` is off for
an upsample_mode, `fcd_tpu/models/ms_dsa_net.py:144-148`), so all five of
its pools are the `jnp.maximum` chain: the port pools them in the finale
with K2's `chain` split, and the gates above do not apply to it. BaseUNet
pools outside its blocks, as the JAX model does (`max_pool_2x` after each
block): its finale runs without the pool (B2, K2), and the pool is
`ops/layers.py::max_pool_2x_chain`, whose gradient splits ties as the
chain does (ROADMAP C8).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fcd_tpu_torch.ops.attention import TransformerBlock
from fcd_tpu_torch.ops.blocks import (
    GeneralUnetrUpBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
)
from fcd_tpu_torch.ops.layers import (
    DropoutRng,
    GroupNorm,
    conv1x1,
    kaiming_normal_fan_out_,
    max_pool_2x_chain,
)


def _triple(x) -> Tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x),) * 3


class PatchEmbed(nn.Module):
    """1x1 conv (no bias) halving the channels, then GroupNorm (under
    tensor parallelism the conv runs split as `tp` says, `conv1x1`)."""

    tp = None
    tp_splits = {"kernel": ("col", "row")}

    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        self.gn = GroupNorm(out_channels, groups)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.kernel, generator)
        self.gn.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(conv1x1(x, self.kernel, tp=self.tp)).to(x.dtype)


class MS_DSA_NET(nn.Module):
    """MS_DSA_NET. forward: (B, D, H, W, in_channels) patches whose grid is
    img_size -> (B, D, H, W, out_channels) logits in compute_dtype. With
    an `upsample_mode`, the decoders are GeneralUnetrUpBlocks
    (MS_DSA_NET_PS); `fast` routes their pixelshuffle convs through B1.
    Under tensor parallelism a sharded head splits by its role
    (`conv1x1`; B15 reads it whole)."""

    plain_route = False
    tp = None
    tp_splits = {"head": ("col", "row")}

    def __init__(self, out_channels: int, img_size: Sequence[int],
                 in_channels: int = 2, feature_size: int = 16,
                 project_size: int = 64, num_heads: int = 4,
                 sa_type: str = "parallel", num_layers: int = 3,
                 dropout_rate: float = 0.0,
                 pool_in_finale: Tuple[bool, bool] = (True, True),
                 fused_head: bool = False, levels12_tie: str = "even",
                 upsample_mode: Optional[str] = None, fast: bool = False):
        super().__init__()
        if upsample_mode is not None:   # no s2d level: the chain, no B15
            pool_in_finale, fused_head = (True, True), False
            levels12_tie = "chain"
        fs = feature_size
        self.pool_in_finale = tuple(bool(v) for v in pool_in_finale)
        self.fused_head = bool(fused_head)
        self.levels12_tie = levels12_tie
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
        self.upsample_mode = upsample_mode

        def up(cin, cout):
            if upsample_mode is None:
                return UnetrUpBlock(cin, cout)
            return GeneralUnetrUpBlock(cin, cout, upsample_mode, fast)

        self.decoders = nn.ModuleList([
            up(fs * 16, fs * 8), up(fs * 8, fs * 4), up(fs * 4, fs * 2),
            up(fs * 2, fs * 2), up(fs * 2, fs)])
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
        # the JAX package pools levels 1-2 through the s2d pool (even tie
        # split; in the finale or in a pass of its own, as the gates say)
        # and levels 3-5 through a jnp.maximum chain (ROADMAP C8)
        tie12 = self.levels12_tie
        in_finale = tie12 != "even" or self.pool_in_finale[self.training]
        x1, p1 = enc[0]([x], pool=True, tie=tie12, pool_in_finale=in_finale)
        x2, p2 = enc[1]([p1], pool=True, tie=tie12, pool_in_finale=in_finale)
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
        if self.fused_head and not self.training and not self.plain_route:
            head = self.head if self.tp is None else self.tp.whole(self.head)
            return dec[4](y2, x1, head=(head, self.head_bias))
        y1 = dec[4](y2, x1)
        return conv1x1(y1, self.head, self.head_bias, self.tp)


class MS_DSA_NET_PS(MS_DSA_NET):
    """MS_DSA_NET with GeneralUnetrUpBlock decoders
    (`fcd_tpu/models/ms_dsa_net.py::MS_DSA_NET_PS`, :370-373), pixelshuffle
    by default."""

    def __init__(self, *args, upsample_mode: str = "pixelshuffle", **kw):
        super().__init__(*args, upsample_mode=upsample_mode, **kw)


class BaseUNet(nn.Module):
    """`fcd_tpu/models/ms_dsa_net.py::BaseUNet` (:30-78) as the factory
    builds it: `depth` UnetrBasicBlocks (res blocks, instance norm,
    leaky-ReLU 0.01, no bias) of fs, 2 fs, ... channels, a 2x max pool
    after each but the last, UnetrUpBlock decoders (B4 upsample) over the
    skips, and a 1x1 head with bias."""

    tp = None
    tp_splits = {"head": ("col", "row")}

    def __init__(self, out_channels: int, in_channels: int = 2,
                 feature_size: int = 16, depth: int = 6):
        super().__init__()
        fs = feature_size
        self.in_channels = in_channels
        self.compute_dtype = torch.float32
        self.dropout_rng = DropoutRng()   # the trainer seeds it; unused
        chans = [in_channels] + [fs * 2 ** i for i in range(depth)]
        self.encoders = nn.ModuleList(
            UnetrBasicBlock(chans[i], chans[i + 1]) for i in range(depth))
        self.decoders = nn.ModuleList(
            UnetrUpBlock(chans[depth - i], chans[depth - i - 1])
            for i in range(depth - 1))
        self.head = nn.Parameter(torch.empty(fs, out_channels))
        self.head_bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in list(self.encoders) + list(self.decoders):
            m.reset_parameters(generator)
        kaiming_normal_fan_out_(self.head, generator)
        with torch.no_grad():
            self.head_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.compute_dtype).contiguous()
        feats = []
        for i, enc in enumerate(self.encoders):
            out = enc([out])
            feats.append(out)
            if i != len(self.encoders) - 1:
                out = max_pool_2x_chain(out).contiguous()
        dec = out
        for i, up in enumerate(self.decoders):
            dec = up(dec, feats[-(i + 2)])
        return conv1x1(dec, self.head, self.head_bias, self.tp)
