"""U-Net blocks: UnetResBlock, UnetrBasicBlock, UnetrUpBlock,
GeneralUnetrUpBlock; and the transformers' MLPBlock.

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
   which also writes the 2x max pool when the caller's next op is the pool
   (or, where the model's gates say so, the pool in a pass of its own
   after it, B3 forward and B9 backward; or, at the last decoder with the
   fused head, the finale and the 1x1 head as one kernel, B15).

Instance norm takes its per-(b, c) affine from the kernel sums (var =
E[x^2] - mean^2, clamped at 0). Batch norm takes its running statistics
at eval; in train mode the batch statistics from the same sums summed over
b, and it updates its running statistics (`ops/layers.py::BatchNorm`).

On the plain route (`ops/layers.py`, ROADMAP C18, C20) the blocks run the
plain branch of `fcd_tpu/ops/blocks.py:416-433` instead, where the JAX
package runs it at f32 and f16: conv, norm, act, conv, norm, the projected shortcut
(1x1 conv and norm) over the concatenated parts, act; library convs,
`instance_norm` (var = mean((x - mean)^2), as `make_norm('instance')`) or
`BatchNorm` itself, the 2x pool as the `jnp.maximum` chain
(`max_pool_2x_chain`) and the decoders' upsample as `conv_transpose3d`.
That route launches none of B1, B2, B3, B4 and B15 and their backward
kernels.

Under tensor parallelism (`parallel/tp.py::model_parallel` sets `tp`, the
model's layout, on every module) a block's parameters are this rank's
shards and its convs run as the Megatron pairing places them: conv1 and
the shortcut column-parallel on the whole input (their channel shards'
statistics give the per-channel instance-norm affine), conv2 row-parallel
on conv1's shard (`conv3x3_row_op`: B1's partial instance, the f32
all-reduce, the finishing pass), the shortcut's output gathered, and the
finale on the whole tensors, the same on every rank. A transformer's
conv1 is row-parallel too: its whole input is sliced. A conv whose
weight is replicated runs whole.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fcd_tpu_torch.kernels.block_conv import (
    ConvOut,
    Prologue,
    conv3x3_op,
    conv3x3_partial_op,
    conv_finish_op,
)
from fcd_tpu_torch.kernels.finale import finale
from fcd_tpu_torch.kernels.finale_head import finale_head
from fcd_tpu_torch.kernels.pool2x import max_pool2x_op
from fcd_tpu_torch.kernels.upsample import upsample2x_op
from fcd_tpu_torch.ops.layers import (
    BatchNorm,
    Dense,
    DropoutRng,
    UpSample,
    conv1x1,
    conv3d,
    conv_transpose3d,
    dropout,
    gelu,
    instance_affine_from_sums,
    instance_norm,
    kaiming_normal_fan_out_,
    max_pool_2x_chain,
)
from fcd_tpu_torch.parallel.mesh import (
    Mesh,
    copy_to_model,
    gather_channels,
    reduce_from_model,
    slice_channels,
)

NEGATIVE_SLOPE = 0.01  # leaky-ReLU of every MS_DSA_NET block


def conv3x3_row_op(x: torch.Tensor, w: torch.Tensor, mesh: Mesh, *,
                   prologue: Optional[Prologue] = None) -> ConvOut:
    """The row-parallel 3x3x3 conv of tensor parallelism, with gradients:
    x and w are this rank's slices of the input channels (and prologue the
    affine of that slice), `mesh` the model axis. Returns the whole
    output, rounded, with its f32 statistics, the same on every rank:
    B1's partial instance, the f32 all-reduce, the finishing pass."""
    part = conv3x3_partial_op(x, w, prologue=prologue)
    return conv_finish_op(reduce_from_model(part, mesh), x.dtype)


class UnetResBlock(nn.Module):
    """conv-norm-act -> conv-norm (+ projected shortcut) -> act.

    Parameters keep the flax layouts: conv1 (3, 3, 3, Cin, Cout), conv2
    (3, 3, 3, Cout, Cout), conv3 (Cin, Cout) (the 1x1 shortcut, present
    when Cin != Cout)."""

    plain_route = False
    tp = None   # the model's TPLayout under tensor parallelism

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

    def _plain(self, parts, pool: bool, head):
        """The plain route: `fcd_tpu/ops/blocks.py:416-433` on the parts'
        concatenation."""
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

        def norm(module, t):
            return instance_norm(t) if module is None else module(t)

        def act(t):
            return F.leaky_relu(t, NEGATIVE_SLOPE)

        out = act(norm(self.norm1, conv3d(x, self.conv1)))
        out = norm(self.norm2, conv3d(out, self.conv2))
        res = (x if self.conv3 is None
               else norm(self.norm3, conv1x1(x, self.conv3)))
        out = act(out + res)
        if head is not None:
            return conv1x1(out, head[0], head[1])
        return (out, max_pool_2x_chain(out)) if pool else out

    def forward(self, parts: Sequence[torch.Tensor], pool: bool = False,
                tie: str = "even", pool_in_finale: bool = True,
                head: Optional[Tuple[torch.Tensor,
                                     Optional[torch.Tensor]]] = None):
        """parts: 1 or 2 (B, D, H, W, Ci) tensors whose channel concat is the
        block input. Returns out, or (out, pooled) with pool=True; `tie` is
        how the pool's gradient splits among tied maxima (`kernels/
        finale.py`: `even` at levels 1-2, `chain` at levels 3-5). With
        pool_in_finale=False the pool runs in a pass of its own after the
        finale (B3 forward, B9 backward: the even split only). With
        head=(w, bias) the finale and the 1x1 head run as one kernel (B15,
        eval) and the block returns the logits. On the plain route the block
        runs its plain branch and pools with the chain, whatever `tie`."""
        parts = list(parts)
        widths = [p.shape[-1] for p in parts]
        if sum(widths) != self.in_channels:
            raise ValueError(f"parts {widths} do not sum to "
                             f"{self.in_channels} input channels")
        if len(parts) > 1 and self.conv3 is None:
            raise ValueError("a multi-part input needs the 1x1 shortcut")
        if self.plain_route:
            return self._plain(parts, pool, head)
        b = parts[0].shape[0]
        n = parts[0].shape[1] * parts[0].shape[2] * parts[0].shape[3]
        one = len(parts) == 1   # (a row-parallel conv1 holds a cin shard)
        w1 = [self.conv1] if one else list(torch.split(self.conv1, widths,
                                                       dim=3))
        wr = (None if self.conv3 is None else [self.conv3] if one
              else list(torch.split(self.conv3, widths, dim=0)))
        stats = self.norm_name == "instance" or self.training
        if self.tp is None or self.tp.role(self.conv2) is None:
            o1 = conv3x3_op(parts, w1, shortcut=wr, want_stats=stats)
            scale1, shift1 = self._affine(self.norm1, o1.ysum, o1.ysq, b, n)
            o2 = conv3x3_op([o1.y], [self.conv2],
                            prologue=(scale1, shift1, NEGATIVE_SLOPE),
                            want_stats=stats)
        else:
            o1, o2 = self._convs_tp(parts, w1, wr, stats, b, n)
        scale2, shift2 = self._affine(self.norm2, o2.ysum, o2.ysq, b, n)
        if self.conv3 is not None:
            r = o1.r
            scale_r, shift_r = self._affine(self.norm3, o1.rsum, o1.rsq, b, n)
        else:
            r = parts[0]
            scale_r = torch.ones_like(scale2)
            shift_r = torch.zeros_like(shift2)
        aff = (scale2, shift2, scale_r, shift_r)
        if head is not None:
            return finale_head(o2.y, r, *aff, head[0], head[1],
                               NEGATIVE_SLOPE)
        if pool and not pool_in_finale:
            if tie != "even":
                raise ValueError("the pool's own pass splits ties evenly; "
                                 f"tie {tie!r} pools in the finale")
            out = finale(o2.y, r, *aff, NEGATIVE_SLOPE)
            return out, max_pool2x_op(out)
        return finale(o2.y, r, *aff, NEGATIVE_SLOPE, pool=pool, tie=tie)


    def _convs_tp(self, parts, w1, wr, stats: bool, b: int, n: int):
        """conv1 (+ shortcut) and the row-parallel conv2 under tensor
        parallelism (the module docstring). The rule splits conv1 as it
        splits conv2 (both by one width): column-parallel in an encoder or
        decoder (instance norm), row-parallel in a transformer (one part,
        no shortcut). Returns (o1, o2) with o1.r and its sums whole and o2
        whole, as the one-device path gives them."""
        mm = self.tp.mesh
        r1 = self.tp.role(self.conv1)
        if (r1 == "col") != (self.norm1 is None) or (
                self.conv3 is not None and self.tp.role(self.conv3) != r1):
            raise NotImplementedError(
                f"conv1 {r1}-parallel with {self.norm_name} norm")
        if r1 == "col":
            o1 = conv3x3_op([copy_to_model(x, mm) for x in parts], w1,
                            shortcut=wr, want_stats=stats)
            # instance norm is per channel: the shard's own statistics
            scale1, shift1 = instance_affine_from_sums(o1.ysum, o1.ysq, n)
            y1 = o1.y
            if o1.r is not None:
                o1 = o1._replace(r=gather_channels(o1.r, mm),
                                 rsum=gather_channels(o1.rsum, mm),
                                 rsq=gather_channels(o1.rsq, mm))
        else:
            o1 = conv3x3_row_op(slice_channels(parts[0], mm), w1[0], mm)
            scale1, shift1 = self._affine(self.norm1, o1.ysum, o1.ysq, b, n)
            y1, scale1, shift1 = (slice_channels(t, mm)
                                  for t in (o1.y, scale1, shift1))
        o2 = conv3x3_row_op(y1, self.conv2, mm,
                            prologue=(scale1, shift1, NEGATIVE_SLOPE))
        return o1, (o2 if stats else ConvOut(o2.y))


class UnetrBasicBlock(UnetResBlock):
    """The res-or-basic selector of `fcd_tpu/ops/blocks.py` with
    res_block=True, instance norm and leaky-ReLU 0.01: the only form the
    JAX factory's models build (MS_DSA_NET, BaseUNet, UNETR, SwinUNETR)."""


class UnetrUpBlock(nn.Module):
    """Transposed-conv (k2 s2, no bias) upsample through B4, then the res
    block over [upsampled, skip] (the concat is never materialised). On
    the plain route: `conv_transpose3d`, then the block's plain branch over
    the concatenation."""

    plain_route = False
    tp = None

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.transp = nn.Parameter(torch.empty(2, 2, 2, in_channels,
                                               out_channels))
        self.block = UnetResBlock(2 * out_channels, out_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.transp, generator)
        self.block.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                head=None) -> torch.Tensor:
        """head=(w, bias): the block's finale runs fused with the 1x1
        head (B15) and the block returns the logits."""
        if self.plain_route:
            up = conv_transpose3d(x, self.transp)
        elif self.tp is not None and self.tp.role(self.transp) == "col":
            mm = self.tp.mesh   # column-parallel, then gathered
            up = gather_channels(
                upsample2x_op(copy_to_model(x, mm), self.transp), mm)
        else:
            up = upsample2x_op(x, self.transp)
        return self.block([up, skip], head=head)


class GeneralUnetrUpBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::GeneralUnetrUpBlock` (:626-663) as
    MS_DSA_NET_PS builds it (res block, no bias, concat fuse, scale 2):
    `UpSample` in `upsample_mode` (pixelshuffle, deconv or nontrainable),
    then the res block over [upsampled, skip] through B1 (the concat is
    never materialised). `fast`: the pixelshuffle conv through B1
    (FCD_FAST_CONV=1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 upsample_mode: str = "pixelshuffle", fast: bool = False):
        super().__init__()
        self.up = UpSample(in_channels, out_channels, upsample_mode,
                           use_bias=False, fast=fast)
        self.block = UnetResBlock(2 * out_channels, out_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.up.reset_parameters(generator)
        self.block.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block([self.up(x).to(skip.dtype).contiguous(), skip])


class MLPBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::MLPBlock` (:776-790), MONAI's MLPBlock:
    Dense (dim -> mlp_dim), GELU (the tanh form, jax.nn.gelu's default),
    dropout, Dense (mlp_dim -> dim), dropout; in x's dtype (the caller casts
    a LayerNorm's f32 output to the compute type, as the JAX Dense does).
    The dropouts draw from `rng` in train mode."""

    def __init__(self, dim: int, mlp_dim: int, dropout_rate: float = 0.0,
                 rng: Optional[DropoutRng] = None):
        super().__init__()
        self.fc1 = Dense(dim, mlp_dim)
        self.fc2 = Dense(mlp_dim, dim)
        self.dropout_rate = dropout_rate
        self.rng = DropoutRng() if rng is None else rng

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.fc1.reset_parameters(generator)
        self.fc2.reset_parameters(generator)

    def _drop(self, t: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return t
        return dropout(t, self.dropout_rate, self.rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._drop(self.fc2(self._drop(gelu(self.fc1(x)))))
