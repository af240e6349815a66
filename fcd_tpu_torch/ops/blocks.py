"""U-Net blocks: UnetResBlock, UnetBasicBlock, UnetrBasicBlock,
UnetrUpBlock, GeneralUnetrUpBlock, the attention-gated AttentionBlock and
AgUpBlock, DsaUpBlock; and the transformers' MLPBlock.

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

`UnetBasicBlock` (conv-norm-act twice, no residual) runs the same
composition with no shortcut: B1, B1 with the prologue, and B2's finale
with its shortcut term zero (the block's own conv2 output as `rs`, scale
and shift 0, so t = (y s2 + b2) + 0 exactly). The blocks that no factory
model builds (ROADMAP A10: AttentionBlock, AgUpBlock, DsaUpBlock) upsample
with `conv_transpose3d`, as the JAX blocks call the dense
`lax.conv_transpose` there, not B4's s2d entry, and run their conv blocks
and transformers through the kernels above; the attention gate's 1x1
convs are plain PyTorch, as the JAX package leaves them to XLA.

Under tensor parallelism (`parallel/tp.py::model_parallel` sets `tp`, the
model's layout, on every module) a block's parameters are this rank's
shards and its convs run as the JAX rule's roles place them
(`tp_splits`): conv1 and the shortcut column-parallel on the whole input
(x's gradient the ranks' f32 shares summed and rounded once,
`conv3x3_op(..., grad_sum=)`), conv2 row-parallel on conv1's shard
(`conv3x3_row_op`: B1's partial instance, the f32 all-reduce, the
finishing pass), the shortcut's output gathered, and the finale on the
whole tensors, the same on every rank. Between conv1 and conv2 the norm is
per channel: instance norm takes the shard's own statistics, batch norm
(a transformer's conv block in UNETR++ or SegResNet_DSA) its affine from
the gathered statistics (running statistics the same on every rank),
sliced to the shard. A conv1 in a path that starts with TransformerBlock
(MS_DSA_NET's) is row-parallel: its whole input is sliced. A conv whose
weight is replicated (the rule's fallback) runs whole. The plain route
pairs its convs the same way (`_plain_tp`, `conv3x3_row_plain`: the
partial in f32, rounded once after the all-reduce), and the up-blocks'
`conv_transpose3d` is column-parallel and gathered as B4 is.
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
    Conv3d,
    ConvTranspose3d,
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
    column_parallel,
    gather_channels,
    model_sum,
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


def _conv3d_grads(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  need) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """(dx, dw) of `conv3d(x, w)` (stride 1, padding k // 2) for its output
    cotangent g, in their dtype, as autograd computes them for that call:
    aten's convolution_backward on the same permuted views (cuDNN's data
    and weight gradients on the card). `need`: which of the two."""
    pad = w.shape[0] // 2
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
        w.permute(4, 3, 0, 1, 2), None, [1] * 3, [pad] * 3, [1] * 3, False,
        [0] * 3, 1, [bool(need[0]), bool(need[1]), False])
    return (None if dx is None else dx.permute(0, 2, 3, 4, 1),
            None if dw is None else dw.permute(2, 3, 4, 1, 0))


class _RowPartial(torch.autograd.Function):
    """A row-parallel conv's partial: `conv3d` of this rank's input-channel
    slices x and w (x's dtype), taken in f32 from those values and never
    rounded; its gradients are the conv's own in x's dtype, as one device
    computes them (each rank's dx and dw slices are whole sums, not
    partials)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _conv3d_grads(g.to(x.dtype).contiguous(), x, w,
                             ctx.needs_input_grad)


def conv3x3_row_plain(x: torch.Tensor, w: torch.Tensor,
                      mesh: Mesh) -> torch.Tensor:
    """The plain route's row-parallel 3x3x3 conv, with gradients: x and w
    are this rank's slices of the input channels. Each rank's partial is
    taken in f32 from x's dtype's operands (at f16 the products are exact
    in f32, and in TF32 too), the partials are summed in f32, and the sum
    is rounded once to x's dtype, where one device rounds its f32
    accumulation: an f16 conv would round each rank's partial first. The
    backward is the conv's own in x's dtype (`_RowPartial`)."""
    part = _RowPartial.apply(x, w.to(x.dtype))
    return reduce_from_model(part, mesh).to(x.dtype)


def _norm(module, t):
    return instance_norm(t) if module is None else module(t)


def _act(t):
    return F.leaky_relu(t, NEGATIVE_SLOPE)


class UnetResBlock(nn.Module):
    """conv-norm-act -> conv-norm (+ projected shortcut) -> act.

    Parameters keep the flax layouts: conv1 (3, 3, 3, Cin, Cout), conv2
    (3, 3, 3, Cout, Cout), conv3 (Cin, Cout) (the 1x1 shortcut, present
    when Cin != Cout)."""

    plain_route = False
    tp = None   # the model's TPLayout under tensor parallelism
    tp_splits = {"conv1": ("col", "row"), "conv2": ("row",),
                 "conv3": ("col",)}

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
        concatenation (under tensor parallelism, `_plain_tp`)."""
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        if self._split():
            out, res = self._plain_tp(x)
        else:
            out = _act(_norm(self.norm1, conv3d(x, self.conv1)))
            out = _norm(self.norm2, conv3d(out, self.conv2))
            res = (x if self.conv3 is None
                   else _norm(self.norm3, conv1x1(x, self.conv3)))
        out = _act(out + res)
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
        if not self._split():
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
        parallelism (the module docstring; conv1's role `_conv1_role`).
        Returns (o1, o2) with o1.r and its sums whole and o2 whole, as the
        one-device path gives them."""
        mm = self.tp.mesh
        if self._conv1_role() == "col":
            o1 = conv3x3_op(parts, w1, shortcut=wr, want_stats=stats,
                            grad_sum=model_sum(mm))
            y1 = o1.y
            if self.norm1 is None:
                # instance norm is per channel: the shard's own statistics
                scale1, shift1 = instance_affine_from_sums(o1.ysum, o1.ysq,
                                                           n)
            else:
                # batch norm too, but its running statistics are whole
                s1, s2 = ((None, None) if o1.ysum is None else
                          (gather_channels(o1.ysum, mm),
                           gather_channels(o1.ysq, mm)))
                scale1, shift1 = (slice_channels(t, mm) for t in self._affine(
                    self.norm1, s1, s2, b, n))
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

    def _split(self) -> bool:
        """Whether the block runs split on the model axis: any of its convs
        sharded (then `_conv1_role` holds the pairing)."""
        return self.tp is not None and any(
            self.tp.role(t) is not None
            for t in (self.conv1, self.conv2, self.conv3))

    def _conv1_role(self) -> str:
        """conv1's role on the model axis. The rule splits conv1 as it
        splits conv2 and the shortcut (all by one width): column-parallel
        with the shortcut, or row-parallel (a transformer's: one part, no
        shortcut); anything else raises."""
        r1 = self.tp.role(self.conv1)
        r3 = None if self.conv3 is None else self.tp.role(self.conv3)
        if r1 is None or self.tp.role(self.conv2) != "row" or (
                self.conv3 is not None and r3 != r1) or (
                r1 == "row" and self.conv3 is not None):
            raise NotImplementedError(
                f"a res block with conv1 {r1}-parallel, conv2 "
                f"{self.tp.role(self.conv2)}-parallel and the shortcut "
                f"{r3}-parallel")
        return r1

    def _plain_tp(self, x):
        """The plain branch's convs and norms under tensor parallelism, as
        `_convs_tp` pairs the kernel route's (the module docstring), on
        the concatenated input x: (conv2's normed output, the shortcut),
        both whole. Column-parallel conv1 on the whole input and instance
        norm per channel on its shard, the shortcut column-parallel and
        gathered (`conv1x1`); or, in a transformer, a row-parallel conv1 on
        x's slice and its batch
        norm on the whole sum (the running statistics the same on every
        rank). conv2 row-parallel on the shard (`conv3x3_row_plain`), its
        norm on the whole sum. Each column-parallel op's input gradient is
        summed over the ranks in f32 and rounded once (`column_parallel`),
        and the branches' are added in x's dtype, as one device adds
        them. A batch norm after a column-parallel conv1 runs on the
        gathered tensor."""
        mm = self.tp.mesh
        if self._conv1_role() == "col":
            h = column_parallel(conv3d, x, self.conv1, mm)
            if self.norm1 is None:
                h = _act(instance_norm(h))
            else:   # batch norm on the whole tensor: whole statistics
                h = slice_channels(_act(self.norm1(gather_channels(h, mm))),
                                   mm)
            res = (x if self.conv3 is None else
                   _norm(self.norm3, conv1x1(x, self.conv3, tp=self.tp)))
        else:
            s1 = conv3x3_row_plain(slice_channels(x, mm), self.conv1, mm)
            h = slice_channels(_act(_norm(self.norm1, s1)), mm)
            res = x
        out = _norm(self.norm2, conv3x3_row_plain(h, self.conv2, mm))
        return out, res


class UnetBasicBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::UnetBasicBlock` (:437-460): conv, norm,
    act, conv, norm, act, with no residual path (k3 s1, no bias, leaky-ReLU
    0.01, instance or batch norm). Parameters keep the flax layouts: conv1
    (3, 3, 3, Cin, Cout), conv2 (3, 3, 3, Cout, Cout).

    Kernel route (the module docstring): conv1 through B1 over the input
    parts (one, or an up block's two, never concatenated) with its
    statistics, conv2 through B1 with norm1's affine and the activation in
    its prologue, and the last norm and act through B2 with a zero
    shortcut (K1, K2 and B1's data gradient in training). Plain route:
    library convs over the concatenated parts, `instance_norm` or
    `BatchNorm`."""

    plain_route = False

    def __init__(self, in_channels: int, out_channels: int,
                 norm_name: str = "instance"):
        super().__init__()
        if norm_name not in ("instance", "batch"):
            raise NotImplementedError(
                f"norm {norm_name!r}: the port has instance and batch norm")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm_name = norm_name
        co = out_channels
        self.conv1 = nn.Parameter(torch.empty(3, 3, 3, in_channels, co))
        self.conv2 = nn.Parameter(torch.empty(3, 3, 3, co, co))
        batch = norm_name == "batch"
        self.norm1 = BatchNorm(co) if batch else None
        self.norm2 = BatchNorm(co) if batch else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for w in (self.conv1, self.conv2):
            kaiming_normal_fan_out_(w, generator)
        for nm in (self.norm1, self.norm2):
            if nm is not None:
                nm.reset_parameters(generator)

    _affine = UnetResBlock._affine

    def forward(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """parts: 1 or 2 (B, D, H, W, Ci) tensors whose channel concat is
        the block input."""
        parts = list(parts)
        widths = [p.shape[-1] for p in parts]
        if sum(widths) != self.in_channels:
            raise ValueError(f"parts {widths} do not sum to "
                             f"{self.in_channels} input channels")
        if self.plain_route:
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            out = _act(_norm(self.norm1, conv3d(x, self.conv1)))
            return _act(_norm(self.norm2, conv3d(out, self.conv2)))
        b = parts[0].shape[0]
        n = parts[0].shape[1] * parts[0].shape[2] * parts[0].shape[3]
        w1 = ([self.conv1] if len(parts) == 1
              else list(torch.split(self.conv1, widths, dim=3)))
        stats = self.norm_name == "instance" or self.training
        o1 = conv3x3_op(parts, w1, want_stats=stats)
        scale1, shift1 = self._affine(self.norm1, o1.ysum, o1.ysq, b, n)
        o2 = conv3x3_op([o1.y], [self.conv2],
                        prologue=(scale1, shift1, NEGATIVE_SLOPE),
                        want_stats=stats)
        scale2, shift2 = self._affine(self.norm2, o2.ysum, o2.ysq, b, n)
        zero = torch.zeros_like(scale2)
        return finale(o2.y, o2.y, scale2, shift2, zero, zero, NEGATIVE_SLOPE)


class UnetrBasicBlock(UnetResBlock):
    """The res-or-basic selector of `fcd_tpu/ops/blocks.py` with
    res_block=True, instance norm and leaky-ReLU 0.01: the only form the
    JAX factory's models build (MS_DSA_NET, BaseUNet, UNETR, SwinUNETR).
    `unetr_basic_block` is the selector with both arms."""


def unetr_basic_block(in_channels: int, out_channels: int,
                      norm_name: str = "instance",
                      res_block: bool = True) -> nn.Module:
    """`fcd_tpu/ops/blocks.py::UnetrBasicBlock` (:463-493), both arms: an
    `UnetrBasicBlock` (its flax tree's UnetResBlock_0), or with
    res_block=False an `UnetBasicBlock` (its UnetBasicBlock_0)."""
    if res_block:
        return UnetrBasicBlock(in_channels, out_channels, norm_name)
    return UnetBasicBlock(in_channels, out_channels, norm_name)


class UnetrUpBlock(nn.Module):
    """Transposed-conv (k2 s2, no bias) upsample through B4, then the res
    block over [upsampled, skip] (the concat is never materialised); with
    res_block=False the basic block (`fcd_tpu/ops/blocks.py:522`). On
    the plain route: `conv_transpose3d`, then the block's plain branch over
    the concatenation."""

    plain_route = False
    tp = None
    tp_splits = {"transp": ("col",)}

    def __init__(self, in_channels: int, out_channels: int,
                 res_block: bool = True):
        super().__init__()
        self.transp = nn.Parameter(torch.empty(2, 2, 2, in_channels,
                                               out_channels))
        self.block = (UnetResBlock if res_block else UnetBasicBlock)(
            2 * out_channels, out_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.transp, generator)
        self.block.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                head=None) -> torch.Tensor:
        """head=(w, bias): the block's finale runs fused with the 1x1
        head (B15) and the block returns the logits."""
        if self.tp is not None and self.tp.role(self.transp) == "col":
            mm = self.tp.mesh   # column-parallel, then gathered
            up = gather_channels(
                column_parallel(conv_transpose3d, x, self.transp, mm)
                if self.plain_route else
                upsample2x_op(x, self.transp, grad_sum=model_sum(mm)),
                mm)
        elif self.plain_route:
            up = conv_transpose3d(x, self.transp)
        else:
            up = upsample2x_op(x, self.transp)
        if head is None:
            return self.block([up, skip])
        return self.block([up, skip], head=head)


class GeneralUnetrUpBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::GeneralUnetrUpBlock` (:626-663) as
    MS_DSA_NET_PS builds it (res block, no bias, concat fuse, scale 2):
    `UpSample` in `upsample_mode` (pixelshuffle, deconv or nontrainable),
    then the res block over [upsampled, skip] through B1 (the concat is
    never materialised). `fast`: the pixelshuffle conv through B1
    (FCD_FAST_CONV=1). res_block=False: the basic block (:654)."""

    def __init__(self, in_channels: int, out_channels: int,
                 upsample_mode: str = "pixelshuffle", fast: bool = False,
                 res_block: bool = True):
        super().__init__()
        self.up = UpSample(in_channels, out_channels, upsample_mode,
                           use_bias=False, fast=fast)
        self.block = (UnetResBlock if res_block else UnetBasicBlock)(
            2 * out_channels, out_channels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.up.reset_parameters(generator)
        self.block.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block([self.up(x).to(skip.dtype).contiguous(), skip])


class AttentionBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::AttentionBlock` (:666-683), the attention
    gate of conv_blocks.py:838-894 (reference):

        psi = sigmoid(BN_2(conv_2(relu(BN_0(conv_0(g)) + BN_1(conv_1(x))))))
        out = x * psi

    conv_0, conv_1: 1x1 to f_int channels (bias with use_bias), conv_2:
    1x1 to one channel with a bias; `Conv3d` at k = 1 is `conv1x1`, in the
    input's dtype. The JAX package runs these convs in XLA, so plain
    PyTorch is the port. The norms are the port's `BatchNorm` (C7: biased
    variance, momentum 0.9): the batch statistics in train mode, updating
    the running ones; the running ones at eval."""

    def __init__(self, g_channels: int, x_channels: int, f_int: int,
                 use_bias: bool = False):
        super().__init__()
        self.conv_g = Conv3d(g_channels, f_int, 1, use_bias=use_bias)
        self.norm_g = BatchNorm(f_int)
        self.conv_x = Conv3d(x_channels, f_int, 1, use_bias=use_bias)
        self.norm_x = BatchNorm(f_int)
        self.conv_psi = Conv3d(f_int, 1, 1, use_bias=True)
        self.norm_psi = BatchNorm(1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.conv_g, self.norm_g, self.conv_x, self.norm_x,
                  self.conv_psi, self.norm_psi):
            m.reset_parameters(generator)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        a = torch.relu(self.norm_g(self.conv_g(g))
                       + self.norm_x(self.conv_x(x)))
        return x * torch.sigmoid(self.norm_psi(self.conv_psi(a)))


def _check_fuse(fuse: str, allowed, skip_c: int, out_channels: int):
    if fuse not in allowed:
        raise ValueError(f"fuse must be one of {allowed}, got {fuse!r}")
    if fuse != "cat" and skip_c != out_channels:
        raise ValueError(f"fuse {fuse!r} takes a skip of {out_channels} "
                         f"channels, got {skip_c}")


class AgUpBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::AgUpBlock` (:686-721), the attention-gated
    up block (conv_blocks.py:897-967): the k2 s2 transposed conv
    (`ConvTranspose3d`, `conv_transpose3d`), the AttentionBlock (f_int = out
    // 2) gating the skip by the upsampled tensor, `fuse` 'sum' (up + gated
    skip) or 'cat' ([up, gated skip], never concatenated on the kernel
    route), then UnetResBlock (B1 + B2) or, res_block=False,
    UnetBasicBlock."""

    def __init__(self, in_channels: int, out_channels: int,
                 skip_channels: Optional[int] = None, fuse: str = "sum",
                 res_block: bool = True, norm_name: str = "instance",
                 use_bias: bool = False):
        super().__init__()
        skip_c = out_channels if skip_channels is None else skip_channels
        _check_fuse(fuse, ("sum", "cat"), skip_c, out_channels)
        self.fuse = fuse
        self.transp = ConvTranspose3d(in_channels, out_channels, 2,
                                      use_bias=use_bias)
        self.attention = AttentionBlock(out_channels, skip_c,
                                        out_channels // 2, use_bias)
        cin = out_channels + (skip_c if fuse == "cat" else 0)
        self.block = (UnetResBlock if res_block else UnetBasicBlock)(
            cin, out_channels, norm_name)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.transp, self.attention, self.block):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.transp(x)
        gated = self.attention(up, skip)
        return self.block([up + gated] if self.fuse == "sum"
                          else [up, gated])


class DsaUpBlock(nn.Module):
    """`fcd_tpu/ops/blocks.py::DsaUpBlock` (:724-773), conv_blocks.py:
    524-605: the k2 s2 transposed conv (`ConvTranspose3d`, no bias), then
    by `fuse`:
    - 'cat': UnetResBlock over [up, skip] (B1 + B2, never concatenated),
      then `depth` TransformerBlocks (B5's fused form at eval, pos-embed,
      sa_type 'parallel');
    - 'sum': the transformers on up + skip;
    - 'cross': CrossAttentionBlock(skip, up).
    `rng` is the dropout state the transformers share; transformer k salts
    the spatial-attention hash with `salt + k`, as the models' layers
    do."""

    def __init__(self, in_channels: int, out_channels: int, input_size: int,
                 fuse: str = "cat", proj_size: int = 64, num_heads: int = 4,
                 drop_rate: float = 0.0, depth: int = 3,
                 norm_name: str = "instance",
                 skip_channels: Optional[int] = None,
                 rng: Optional[DropoutRng] = None, salt: int = 0):
        super().__init__()
        from fcd_tpu_torch.ops.attention import (
            CrossAttentionBlock,
            TransformerBlock,
        )

        rng = DropoutRng() if rng is None else rng
        skip_c = out_channels if skip_channels is None else skip_channels
        _check_fuse(fuse, ("cat", "sum", "cross"), skip_c, out_channels)
        self.fuse = fuse
        c = out_channels
        self.transp = ConvTranspose3d(in_channels, c, 2, use_bias=False)
        self.block = (UnetResBlock(c + skip_c, c, norm_name)
                      if fuse == "cat" else None)
        self.cross = (CrossAttentionBlock(input_size, c, proj_size, num_heads,
                                          drop_rate=drop_rate, rng=rng)
                      if fuse == "cross" else None)
        self.transformers = nn.ModuleList(
            TransformerBlock(input_size, c, proj_size, num_heads, "parallel",
                             drop_rate, rng, salt + k)
            for k in range(0 if fuse == "cross" else depth))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.transp, self.block, self.cross, *self.transformers):
            if m is not None:
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.transp(x)
        if self.cross is not None:
            return self.cross(skip, up)
        out = self.block([up, skip]) if self.block is not None else up + skip
        for tb in self.transformers:
            out = tb(out)
        return out


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
