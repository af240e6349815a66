"""SegResNet family: SegResNet, SegResNetVAE and, with DSA levels,
SegResNet_DSA and SegResNetVAE_DSA (`models/segresnet_dsa.py`).

Counterpart of `fcd_tpu/models/segresnet.py` (:26-283): a pre-activation
residual encoder (`blocks_down`), a sum-skip decoder (`blocks_up`) with
pixelshuffle, deconv or nontrainable upsampling, optional DSA transformer
levels (levels >= `dsa_start_level` get `dsa_num_layers`
TransformerBlocks on the level's own width, no patch embed), and an
optional VAE branch that reuses the decoder's weights and, in training,
returns (logits, vae_loss); at eval a VAE model returns (logits, None).

The residual blocks run B1 (`kernels/block_conv.py::conv3x3_op`): each
3x3x3 conv takes its instance norm and ReLU as B1's prologue (slope 0).
The first norm's statistics are a reduction of the block input (not a conv
output); the second's are B1's fused sums of conv1's output. The JAX
package runs the same block through its 27-tap kernel on the TPU (B12,
`_s2d_forward`, :36-48, whose `instance_norm_s2d` has no affine) and
densely elsewhere (:60-67); `make_norm('instance')` has no affine
parameters either, so one weight table serves both. convInit, the
stride-2 down convs, the 1x1 convs, the pixelshuffle convs and the VAE's
dense layers are convs and matmuls the JAX package leaves to XLA at its
defaults: `F.conv3d` and `torch.matmul` here (`ops/layers.py`), B1 for
the 3x3 stride-1 ones under FCD_FAST_CONV=1.

On the plain route (`ops/layers.py::use_plain_route`, C18, C20) a
ResBlock runs the JAX package's plain branch (:60-67: `instance_norm`,
act, `F.conv3d`, twice, plus the identity), `fast` is not taken and the
deconv upsample is `conv_transpose3d`: no B1 and no B4.

Under tensor parallelism (`parallel/tp.py`) a ResBlock's conv1 is
column-parallel and its conv2 row-parallel; their instance norm is per
channel, so conv2 runs on conv1's output shard: B1 with the prologue on
the whole input (x's gradient and the prologue's the ranks' f32 shares
summed, then rounded once), the shard's statistics, then B1's partial
instance, the all-reduce and the finishing pass (`ops/blocks.py::
conv3x3_row_op`); on the plain route `column_parallel` and
`conv3x3_row_plain`. Every other layer is a general layer of
`ops/layers.py`, split by its role, its output whole.

The VAE's normal draw (B, vae_nz) comes from the model's
`dropout_rng.generator` (a torch.Generator the trainer seeds), or from
`vae_noise` where the caller hands it in (the parity tests feed JAX's).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from fcd_tpu_torch.kernels.block_conv import conv3x3_op
from fcd_tpu_torch.ops.attention import ChannelDropout3d, TransformerBlock
from fcd_tpu_torch.ops.blocks import conv3x3_row_op, conv3x3_row_plain
from fcd_tpu_torch.ops.layers import (
    Conv3d,
    Dense,
    DropoutRng,
    UpSample,
    act_slope,
    conv3d,
    instance_affine_from_sums,
    instance_norm,
    kaiming_normal_fan_out_,
    make_act,
)
from fcd_tpu_torch.parallel.mesh import column_parallel, model_sum


class ResBlock(nn.Module):
    """Pre-activation residual block (MONAI segresnet_block.ResBlock):
    norm, act, conv, norm, act, conv, then the identity added; instance
    norm, the flax kernels conv1 / conv2 (3, 3, 3, C, C), no bias."""

    plain_route = False
    tp = None
    tp_splits = {"conv1": ("col",), "conv2": ("row",)}

    def __init__(self, channels: int, act=("relu", {})):
        super().__init__()
        c = channels
        self.slope = act_slope(act)
        self.act = make_act(act)
        self.conv1 = nn.Parameter(torch.empty(3, 3, 3, c, c))
        self.conv2 = nn.Parameter(torch.empty(3, 3, 3, c, c))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.conv1, generator)
        kaiming_normal_fan_out_(self.conv2, generator)

    def _split(self) -> bool:
        """Whether the block runs split on the model axis (the module
        docstring); a pairing other than (col, row) raises."""
        if self.tp is None:
            return False
        roles = (self.tp.role(self.conv1), self.tp.role(self.conv2))
        if roles == (None, None):
            return False
        if roles != ("col", "row"):
            raise NotImplementedError(
                f"a ResBlock with conv1 {roles[0]}-parallel and conv2 "
                f"{roles[1]}-parallel")
        return True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self._split()
        mm = self.tp.mesh if split else None
        if self.plain_route:
            a = self.act(instance_norm(x))
            if split:
                y = column_parallel(conv3d, a, self.conv1, mm)
                return conv3x3_row_plain(self.act(instance_norm(y)),
                                         self.conv2, mm) + x
            y = conv3d(a, self.conv1)
            return conv3d(self.act(instance_norm(y)), self.conv2) + x
        x = x.contiguous()
        n = x.shape[1] * x.shape[2] * x.shape[3]
        xf = x.float()
        scale1, shift1 = instance_affine_from_sums(
            xf.sum(dim=(1, 2, 3)), xf.square().sum(dim=(1, 2, 3)), n)
        o1 = conv3x3_op([x], [self.conv1],
                        prologue=(scale1, shift1, self.slope),
                        want_stats=True,
                        grad_sum=None if mm is None else model_sum(mm))
        # per channel: a shard's statistics are its own
        scale2, shift2 = instance_affine_from_sums(o1.ysum, o1.ysq, n)
        if split:
            o2 = conv3x3_row_op(o1.y, self.conv2, mm,
                                prologue=(scale2, shift2, self.slope))
        else:
            o2 = conv3x3_op([o1.y], [self.conv2],
                            prologue=(scale2, shift2, self.slope))
        return o2.y + x


class SegResNetCore(nn.Module):
    """`fcd_tpu/models/segresnet.py::_SegResNetCore`. forward: (B, D, H,
    W, in_channels) -> logits (B, D, H, W, out_channels) in compute_dtype;
    with `vae`, (logits, vae_loss) in training and (logits, None) at
    eval."""

    def __init__(self, out_channels: int = 2, in_channels: int = 2,
                 init_filters: int = 8,
                 dropout_prob: Optional[float] = None, act=("relu", {}),
                 blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1),
                 upsample_mode: str = "pixelshuffle",
                 dsa_start_level: Optional[int] = None,
                 dsa_img_size: Sequence[int] = (128, 128, 128),
                 dsa_project_size: int = 64, dsa_num_heads: int = 4,
                 dsa_dropout_rate: float = 0.0,
                 dsa_sa_type: str = "parallel", dsa_num_layers: int = 3,
                 vae: bool = False,
                 input_image_size: Optional[Sequence[int]] = None,
                 vae_default_std: float = 0.3, vae_nz: int = 256,
                 smallest_filters: int = 16, fast: bool = False):
        super().__init__()
        f = init_filters
        self.in_channels = in_channels
        self.act = make_act(act)
        self.compute_dtype = torch.float32
        self.dropout_rng = DropoutRng()
        self.conv_init = Conv3d(in_channels, f, 3, 1, False, fast)
        self.dropout = (None if dropout_prob is None
                        else ChannelDropout3d(dropout_prob, self.dropout_rng))
        self.down_pre = nn.ModuleList(          # levels 1 .. (level 0: none)
            Conv3d(f * 2 ** (i - 1), f * 2 ** i, 3, 2, False)
            for i in range(1, len(blocks_down)))
        self.down_blocks = nn.ModuleList(
            nn.ModuleList(ResBlock(f * 2 ** i, act) for _ in range(nb))
            for i, nb in enumerate(blocks_down))
        self.dsa_start_level = dsa_start_level
        self.transformer_levels = nn.ModuleList()
        if dsa_start_level is not None:
            img = tuple(dsa_img_size)
            for li, i in enumerate(range(dsa_start_level, len(blocks_down))):
                ch = f * 2 ** i
                n = math.prod(s // 2 ** i for s in img)
                self.transformer_levels.append(nn.ModuleList(
                    TransformerBlock(n, ch, dsa_project_size, dsa_num_heads,
                                     dsa_sa_type, dsa_dropout_rate,
                                     self.dropout_rng,
                                     salt=li * dsa_num_layers + k)
                    for k in range(dsa_num_layers)))
        n_up = len(blocks_up)
        chans = [f * 2 ** (n_up - i) for i in range(n_up)]
        self.up_convs = nn.ModuleList(               # up_samples_i_0
            Conv3d(ch, ch // 2, 1, 1, False) for ch in chans)
        self.up_samples = nn.ModuleList(             # up_samples_i_1
            UpSample(ch // 2, ch // 2, upsample_mode, True, fast)
            for ch in chans)
        self.up_layers = nn.ModuleList(
            nn.ModuleList(ResBlock(ch // 2, act) for _ in range(nb))
            for ch, nb in zip(chans, blocks_up))
        self.final_conv = Conv3d(f, out_channels, 1, 1, True)
        self.vae = vae
        if vae:
            zoom = 2 ** (len(blocks_down) - 1)
            v_filters = f * zoom
            self.fc_insize = tuple(s // (2 * zoom) for s in input_image_size)
            total = smallest_filters * math.prod(self.fc_insize)
            self.smallest_filters = smallest_filters
            self.vae_default_std = vae_default_std
            self.vae_nz = vae_nz
            self.vae_down_conv = Conv3d(v_filters, smallest_filters, 3, 2,
                                        True)
            self.vae_fc1 = Dense(total, vae_nz)
            self.vae_fc3 = Dense(vae_nz, total)
            self.vae_up_conv = Conv3d(smallest_filters, v_filters, 1, 1,
                                      False)
            self.vae_up_sample = UpSample(v_filters, v_filters, upsample_mode,
                                          True, fast)
            self.vae_final_conv = Conv3d(f, in_channels, 1, 1, True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers, drawn from `generator`."""
        layers = [self.conv_init, *self.down_pre, *self.up_convs,
                  *self.up_samples, self.final_conv]
        if self.vae:
            layers += [self.vae_down_conv, self.vae_fc1, self.vae_fc3,
                       self.vae_up_conv, self.vae_up_sample,
                       self.vae_final_conv]
        for blocks in [*self.down_blocks, *self.transformer_levels,
                       *self.up_layers]:
            layers += list(blocks)
        for m in layers:
            m.reset_parameters(generator)

    def encode(self, x: torch.Tensor):
        x = self.conv_init(x)
        if self.dropout is not None:
            x = self.dropout(x)
        down_x = []
        for i, blocks in enumerate(self.down_blocks):
            if i > 0:
                x = self.down_pre[i - 1](x)
            for blk in blocks:
                x = blk(x)
            if self.dsa_start_level is not None and i >= self.dsa_start_level:
                for tb in self.transformer_levels[i - self.dsa_start_level]:
                    x = tb(x)
            down_x.append(x)
        return x, down_x

    def _decode_level(self, i: int, x: torch.Tensor,
                      skip: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.up_samples[i](self.up_convs[i](x))
        if skip is not None:
            x = x + skip
        for blk in self.up_layers[i]:
            x = blk(x)
        return x

    def _head(self, x: torch.Tensor, conv: Conv3d) -> torch.Tensor:
        return conv(self.act(instance_norm(x)))

    def decode(self, x: torch.Tensor, down_x) -> torch.Tensor:
        for i in range(len(self.up_layers)):
            x = self._decode_level(i, x, down_x[i + 1])
        return self._head(x, self.final_conv)

    def vae_loss(self, net_input: torch.Tensor, feat: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`_vae_loss` (:228-270): the regulariser mean(z_mean^2) plus the
        reconstruction MSE, f32. `noise` (B, vae_nz) is the normal draw;
        without it, drawn from dropout_rng.generator."""
        x = self.vae_down_conv(self.act(instance_norm(feat)))
        x = self.act(instance_norm(x))
        b = x.shape[0]
        z_mean = self.vae_fc1(x.reshape(b, -1))
        if noise is None:
            noise = self.dropout_rng.normal(z_mean.shape, z_mean.device)
        reg = z_mean.square().mean().float()
        z = z_mean + self.vae_default_std * noise.to(z_mean.dtype)
        x = self.act(self.vae_fc3(z))
        x = x.reshape((b, self.smallest_filters) + self.fc_insize).permute(
            0, 2, 3, 4, 1).contiguous()
        x = self.vae_up_sample(self.vae_up_conv(x))
        x = self.act(instance_norm(x))
        for i in range(len(self.up_layers)):
            x = self._decode_level(i, x, None)
        x = self._head(x, self.vae_final_conv)
        mse = (net_input.float() - x.float()).square().mean()
        return reg + mse

    def forward(self, x: torch.Tensor,
                vae_noise: Optional[torch.Tensor] = None):
        x = x.to(self.compute_dtype).contiguous()
        feat, down_x = self.encode(x)
        out = self.decode(feat, down_x[::-1])
        if not self.vae:
            return out
        if not self.training:
            return out, None
        return out, self.vae_loss(x, feat, vae_noise)


def SegResNet(**kw) -> SegResNetCore:
    """MONAI-SegResNet-equivalent configuration (no VAE, no DSA)."""
    kw.setdefault("vae", False)
    kw.setdefault("dsa_start_level", None)
    return SegResNetCore(**kw)


def SegResNetVAE(**kw) -> SegResNetCore:
    """SegResNet with the VAE regularisation branch."""
    kw["vae"] = True
    kw.setdefault("dsa_start_level", None)
    return SegResNetCore(**kw)
