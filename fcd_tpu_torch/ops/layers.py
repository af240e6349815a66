"""Plain PyTorch layers, channels-last (B, D, H, W, C).

Counterparts of `fcd_tpu/ops/layers.py`: the 1x1 convolution (with and
without bias), GroupNorm, LayerNorm, InstanceNorm, BatchNorm (train and
eval), the instance-norm affine from kernel sums, the 2x max pool (torch's,
and the `jnp.maximum` chain with its tie rule), inverted dropout with an
explicit generator, the activations (relu, leakyrelu, `PReLU`, gelu),
and the model zoo's general layers: `Conv3d` (any kernel the zoo uses:
odd ones at stride 1 or 2, VNet's k2 s2 and 5^3, UNETR++'s k4 s4 stem,
UNETR's k16 s16 patch embed), `ConvTranspose3d` (kernel == stride, and
UNet's k3 s2 with lax's SAME padding), `GroupNorm`, `LayerNorm`, `Dense`
and `UpSample` (pixelshuffle, deconv, nontrainable), plus the flax
initialisers the port's seeded weights follow. The MS_DSA_NET blocks'
3x3x3 conv, the k2 s2 upsample of the decoders, the finale and the
attention live in `fcd_tpu_torch/kernels/`.

The zoo's plain convs are the ones the JAX package leaves to XLA at its
defaults (`FCD_FAST_CONV=0`): here `F.conv3d` and `F.conv_transpose3d`
(on the CPU below f32, in f32 on the values, rounded once: `_library_conv`).
With `fast=True` (the model built under `FCD_FAST_CONV=1`) a 3x3 stride-1
`Conv3d` runs B1's kernel instead (`kernels/block_conv.py::conv3x3_op`,
B14 by function), its bias added after.

The plain route (ROADMAP C18, C20). The JAX package chooses its kernels
by the compute type, and every Pallas gate of its blocks, its `Conv3d`
and its volume entry needs bf16 (`fcd_tpu/ops/blocks.py:49`,
`fcd_tpu/ops/layers.py:291-295`, `fcd_tpu/infer/sliding_window.py:274`):
at any other type (f32, f16) its blocks take their plain branch (XLA
convs, `make_norm` with f32 statistics, the `jnp.maximum` pool chain),
its `Conv3d` never takes the fast conv and its decoders upsample with
`lax.conv_transpose`; only the eval DSA (B5) and the train
spatial-attention tail (B10) stay Pallas kernels, dtype-generic.
`takes_plain_route(dtype)` is that one decision. A module with a
`plain_route` attribute has both branches; `use_plain_route(model)` sets
the attribute on every such module of a model (the factory does it for a
model built to compute at such a type on the card), and the model then
runs the counterpart of the plain branch: library convs here, and B5's
and K3/K4's instances of the compute type where the JAX package keeps
its kernels.

Tensor parallelism (`parallel/tp.py`). Under `model_parallel` every module
sees the model's layout as `tp`; a module that may hold a sharded
parameter names it, and the roles it runs, in `tp_splits`, and
`shard_state_tp` refuses a model with a sharded leaf that no module
splits. The general layers (`Conv3d`, `ConvTranspose3d`, `Dense`,
`UpSample`'s transposed conv, `conv1x1`) split by role through `split_op`
and hand on the whole output, the same on every rank: column-parallel on
the whole input, then gathered; row-parallel on the input's channel slice
in f32, summed over the ranks, rounded once; the bias added once, to the
whole output. So whatever follows (GroupNorm, BatchNorm, PReLU, pixel
shuffle, window attention) runs unchanged on whole tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fcd_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    column_parallel,
    gather_channels,
    model_sum,
    reduce_from_model,
    slice_channels,
)

__all__ = [
    "BatchNorm", "Conv3d", "ConvTranspose3d", "Dense", "DropoutRng",
    "GroupNorm", "LayerNorm", "PReLU", "UpSample", "blocks_2x", "conv1x1",
    "conv3d", "conv_transpose3d", "dropout", "gelu", "group_norm",
    "instance_affine_from_sums", "instance_norm", "interpolate_trilinear",
    "kaiming_normal_fan_out_", "layer_norm", "make_act", "max_pool_2x",
    "max_pool_2x_chain", "pad_pool_blur", "pixel_shuffle_3d",
    "takes_plain_route", "trunc_normal_", "unblocks_2x", "use_plain_route",
    "xavier_uniform_",
]


def takes_plain_route(dtype: torch.dtype) -> bool:
    """Whether a model computing in `dtype` takes the JAX package's plain
    route (the module docstring): at every type but bf16."""
    return dtype != torch.bfloat16


def use_plain_route(model: nn.Module) -> nn.Module:
    """Set `plain_route` on every module of `model` that has both branches
    (the module docstring); returns the model."""
    for m in model.modules():
        if hasattr(type(m), "plain_route"):
            m.plain_route = True
    return model


def _matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, kernel.to(x.dtype))


def conv1x1(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """1x1x1 conv: x (..., Cin) @ kernel (Cin, Cout) (+ bias), in x's dtype.
    `tp` (a module's tensor-parallel layout, `parallel/tp.py`) runs a
    sharded kernel on the model axis: column-parallel (`column_parallel`:
    x's gradient summed over the ranks in f32, then rounded), then the
    output gathered; row-parallel on x's channel slice, the f32 partials
    summed over the ranks and then rounded (where one device rounds its
    f32 accumulation); the bias added to the whole output (`split_op`)."""
    role = None if tp is None else tp.role(kernel)
    if role is None:
        out = torch.matmul(x, kernel.to(x.dtype))
    else:
        out = split_op(_matmul, x, kernel, role, tp.mesh)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def split_op(op, x: torch.Tensor, w: torch.Tensor, role: str,
             mesh) -> torch.Tensor:
    """`op(x, w)` (linear in x, computed in x's dtype) of a replicated x
    and this rank's shard w on the model axis `mesh`, whole on every rank.
    "col" (w's output channels sharded): `column_parallel`, then the
    output gathered. "row" (w's input channels sharded): op on x's
    channel slice in f32 from x's dtype's values, the partials summed over
    the ranks in f32 and rounded once, where one device rounds its f32
    accumulation; its backward is op's own in f32 (each rank's dx and dw
    are whole sums, rounded once)."""
    if role == "col":
        return gather_channels(column_parallel(op, x, w, mesh), mesh)
    if role == "row":
        xs = slice_channels(x, mesh)
        part = op(xs.float(), w.to(x.dtype).float())
        return reduce_from_model(part, mesh).to(x.dtype)
    raise ValueError(f"role {role!r}: a split is 'col' or 'row'")


def _role(module, t: Optional[torch.Tensor]) -> Optional[str]:
    """t's role on the model axis under `model_parallel` (None: whole)."""
    return None if module.tp is None else module.tp.role(t)


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """flax nn.GroupNorm on channels-last x: statistics over the spatial
    axes and each group's channels, var = E[x^2] - mean^2 clamped at 0
    (flax's fast variance), f32 result."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf.square().mean(dim=(1, 3), keepdim=True)
           - mean.square()).clamp_min(0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale.float() + bias.float()


class GroupNorm(nn.Module):
    """`fcd_tpu/ops/layers.py::GroupNorm` (flax nn.GroupNorm, eps 1e-5):
    the affine `scale` and `bias`, `group_norm`'s f32 result."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.scale, self.bias, self.eps)


def instance_affine_from_sums(s1: torch.Tensor, s2: torch.Tensor, n: int,
                              eps: float = 1e-5) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """Instance-norm (scale, shift), each (B, C), from per-(b, c) sums of x
    and x^2 over n voxels: var = E[x^2] - mean^2 clamped at 0, as
    fcd_tpu/ops/s2d_ops.py:991-1002 computes it from the kernel sums."""
    mean = s1 / n
    var = (s2 / n - mean.square()).clamp_min(0)
    scale = torch.rsqrt(var + eps)
    return scale, -mean * scale


def layer_norm(t: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """f32 LayerNorm over the last axis, var = E[x^2] - mean^2 clamped at 0
    (as the fused DSA kernels compute it)."""
    t = t.float()
    mu = t.mean(dim=-1, keepdim=True)
    var = (t.square().mean(dim=-1, keepdim=True) - mu.square()).clamp_min(0)
    return (t - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


class LayerNorm(nn.Module):
    """`fcd_tpu/ops/layers.py::LayerNorm` (:160-182): the affine `scale`
    and `bias` over the last axis and `layer_norm`'s f32 result, whatever
    x's dtype (the next Dense casts it to the compute type)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """`make_norm('instance')`: per-(b, c) statistics over the spatial
    axes, var = mean((x - mean)^2), no affine parameters (torch
    InstanceNorm3d's defaults, `fcd_tpu/ops/layers.py::InstanceNorm`);
    f32 math, x's dtype out."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class PReLU(nn.Module):
    """`fcd_tpu/ops/layers.py::PReLU` (:204-212): one slope `alpha` of
    shape (1,), initialised to `init`; where(x >= 0, x, alpha * x) with
    alpha cast to x's dtype before the product, as the JAX module casts
    it."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.init = float(init)
        self.alpha = nn.Parameter(torch.full((1,), self.init))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.alpha.fill_(self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` at its default, approximate=True: the tanh form (not
    torch's default erf form)."""
    return F.gelu(x, approximate="tanh")


def _act_name(name):
    if isinstance(name, (tuple, list)):
        return name[0].lower(), (name[1] if len(name) > 1 else {})
    return str(name).lower(), {}


def make_act(name):
    """`fcd_tpu/ops/layers.py::make_act` (:215-232) for the activations the
    model zoo uses: relu, leakyrelu with its negative_slope (0.01 by
    default; the DSA family and the UNETR blocks), prelu (a new `PReLU`
    module with its `init`, 0.25 by default: UNet, and VNet at 0.2) and
    gelu (the tanh form: the transformers' MLPBlock). `name` is a string
    or (name, kwargs)."""
    name, kw = _act_name(name)
    if name == "relu":
        return F.relu
    if name == "leakyrelu":
        slope = float(kw.get("negative_slope", 0.01))
        return lambda x: F.leaky_relu(x, slope)
    if name == "prelu":
        return PReLU(kw.get("init", 0.25))
    if name == "gelu":
        return gelu
    raise NotImplementedError(f"activation {name!r}: the port has relu, "
                              "leakyrelu, prelu and gelu, the ones the JAX "
                              "factory's models use")


def act_slope(name) -> float:
    """The negative slope of `make_act(name)` (0 for relu), as B1's
    prologue takes it: relu and leakyrelu only."""
    name, kw = _act_name(name)
    if name not in ("relu", "leakyrelu"):
        raise ValueError(f"B1's prologue takes relu or leakyrelu, not "
                         f"{name!r}")
    return 0.0 if name == "relu" else float(kw.get("negative_slope", 0.01))


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """torch max_pool3d(x, 2, 2) on channels-last x."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(
        0, 2, 3, 4, 1).contiguous()


def max_pool_2x_chain(x: torch.Tensor) -> torch.Tensor:
    """The 2x max pool as `fcd_tpu/ops/layers.py::max_pool_2x` computes it
    on the dense path: a `maximum` over W pairs, then D pairs, then H
    pairs. `torch.maximum`, like `jnp.maximum`, gives half the cotangent to
    each side of a tie, so the gradient splits ties as the JAX chain's does
    (never max_pool3d's one index)."""
    m = torch.maximum(x[:, :, :, 0::2], x[:, :, :, 1::2])
    m = torch.maximum(m[:, 0::2], m[:, 1::2])
    return torch.maximum(m[:, :, 0::2], m[:, :, 1::2])


class BatchNorm(nn.Module):
    """BatchNorm with `fcd_tpu/ops/layers.py:103-157`'s semantics and flax
    param/batch_stats names: scale, bias; mean, var. The blocks fuse it
    into their convs as an affine (`affine` at eval, `affine_from_sums` in
    train mode).

    In train mode the statistics are the batch's, over (B, D, H, W), with
    var = E[x^2] - mean^2 clamped at 0, and the running statistics move by
    flax momentum 0.9 towards the batch mean and this BIASED variance
    (torch.nn.BatchNorm3d would use the unbiased one, so it is not used).

    Under a data mesh (`mesh`, set by `parallel.dp.sharded` for the
    duration of a data-parallel step) the sums and the count are added
    over the ranks by a differentiable all-reduce, so the statistics are
    the global batch's, as GSPMD computes them over a sharded batch."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The norm of a (B, D, H, W, C) tensor itself (the plain branch of
        the plain route): the batch statistics in train mode (updating the
        running ones), the running ones at eval; f32 math, x's dtype out."""
        xf = x.float()
        if self.training:
            n = xf.numel() // xf.shape[-1]
            flat = xf.reshape(-1, xf.shape[-1])
            w, b = self.affine_from_sums(flat.sum(0)[None],
                                         flat.square().sum(0)[None], n)
            w, b = w[0], b[0]
        else:
            w, b = self.affine()
        return (xf * w + b).to(x.dtype)

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w, b) with norm(x) = x * w + b from the running statistics,
        f32 (C,)."""
        w = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        return w, self.bias.float() - self.mean.float() * w

    def affine_from_sums(self, s1: torch.Tensor, s2: torch.Tensor,
                         n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train mode: (w, b), each (B, C) f32, from the batch statistics
        of per-(b, c) sums of x and x^2 over n voxels each (a conv
        kernel's statistics); updates the running statistics."""
        b = s1.shape[0]
        t1, t2, count = s1.float().sum(0), s2.float().sum(0), b * n
        if self.mesh is not None:
            t1, t2 = all_reduce_sum(torch.stack([t1, t2]), self.mesh)
            count *= self.mesh.size
        mean = t1 / count
        var = (t2 / count - mean.square()).clamp_min(0)
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_((1.0 - m) * mean)
            self.var.mul_(m).add_((1.0 - m) * var)
        w = self.scale.float() * torch.rsqrt(var + self.eps)
        sh = self.bias.float() - mean * w
        return w.expand(b, -1), sh.expand(b, -1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)


class DropoutRng:
    """Where a model's dropout draws from in train mode: `generator` (a
    torch.Generator on the activations' device, or None for PyTorch's
    default) for the masks drawn in PyTorch, and `seed`, the step's seed
    of the spatial-attention kernels' counter hash. The trainer sets both
    before each step; the modules that drop out share one instance.

    `shard` is (offset, global batch) while a data-parallel step runs
    on this rank's rows of a larger batch (`parallel.dp.sharded`): every
    draw is then made for the global batch and this rank's rows taken,
    and the hash counts samples from `offset`, so each sample gets the
    mask the single-device step gives it."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        self.generator = generator
        self.seed = seed
        self.shard: Optional[Tuple[int, int]] = None

    @property
    def offset(self) -> int:
        """The global index of this rank's first sample (0 unsharded)."""
        return 0 if self.shard is None else self.shard[0]

    def _draw(self, draw, shape):
        if self.shard is None:
            return draw(tuple(shape))
        off, total = self.shard
        return draw((total, *shape[1:]))[off:off + shape[0]]

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        """Bernoulli(1 - rate) keep mask (bool) of `shape` (leading axis
        the batch)."""
        return self._draw(lambda s: torch.rand(
            s, generator=self.generator, device=device) >= rate, shape)

    def normal(self, shape, device) -> torch.Tensor:
        """A standard normal f32 draw of `shape` (leading axis the
        batch)."""
        return self._draw(lambda s: torch.randn(
            s, generator=self.generator, device=device), shape)


def dropout(x: torch.Tensor, rate: float, rng: DropoutRng,
            shape=None) -> torch.Tensor:
    """Inverted dropout of x with a keep mask of `shape` (broadcast to x;
    x's shape by default): where(keep, x / (1 - rate), 0)."""
    if rate <= 0.0:
        return x
    keep = rng.keep(x.shape if shape is None else shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def blocks_2x(t: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/2, H/2, W/2, 8, C): each 2x2x2 block's
    children in (z, y, x) parity order, child k = 4 pz + 2 py + px."""
    b, d, h, w, c = t.shape
    return t.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d // 2, h // 2, w // 2, 8, c)


def unblocks_2x(t: torch.Tensor) -> torch.Tensor:
    """The inverse of `blocks_2x`."""
    b, dp, hp, wp, _, c = t.shape
    return t.reshape(b, dp, hp, wp, 2, 2, 2, c).permute(
        0, 1, 4, 2, 5, 3, 6, 7).reshape(b, 2 * dp, 2 * hp, 2 * wp, c)


# -- flax initialisers (fcd_tpu/ops/layers.py:35-55) --------------------------

def kaiming_normal_fan_out_(t: torch.Tensor,
                            generator: Optional[torch.Generator]) -> None:
    """He-normal, fan_out = prod(kernel spatial) * out_channels, for flax
    (..., Cin, Cout) kernels."""
    receptive = 1
    for s in t.shape[:-2]:
        receptive *= s
    std = math.sqrt(2.0 / (receptive * t.shape[-1]))
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def trunc_normal_(t: torch.Tensor, stddev: float,
                  generator: Optional[torch.Generator]) -> None:
    """flax `initializers.truncated_normal(stddev)`: a standard normal
    truncated to [-2, 2], times `stddev` (no variance correction)."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                              generator=generator)


def xavier_uniform_(t: torch.Tensor,
                    generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (t.shape[-2] + t.shape[-1]))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


# -- the model zoo's general layers (fcd_tpu/ops/layers.py:249-510) ------------

def _library_conv(conv, x: torch.Tensor, w: torch.Tensor, **kw):
    """`conv` (F.conv3d or F.conv_transpose3d) of channels-first x and w.
    A CPU tensor below f32 is convolved in f32 on its values and the
    result rounded once to its dtype, as the kernels' plain versions
    compute (B1's `conv3x3_plain`): oneDNN's bf16 kernels on a CPU without
    AMX return a wrong weight gradient where the grid is not larger than
    the kernel's reach, as at UNet's 2^3 bottom (ROADMAP C24)."""
    if x.device.type == "cpu" and x.dtype in (torch.bfloat16, torch.float16):
        return conv(x.float(), w.float(), **kw).to(x.dtype)
    return conv(x, w, **kw)


def conv3d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           fast: bool = False) -> torch.Tensor:
    """`fcd_tpu/ops/layers.py::Conv3d` on channels-last x with a flax
    (k, k, k, Cin, Cout) kernel: padding int((k - s + 1) / 2) a side
    (:301-305), then the bias, in x's dtype. fast: a 3x3 stride-1 conv
    through B1 (`conv3x3_op`, the module docstring)."""
    k = kernel.shape[0]
    if fast and k == 3 and stride == 1:
        from fcd_tpu_torch.kernels.block_conv import conv3x3_op

        out = conv3x3_op([x.contiguous()], [kernel.to(x.dtype)]).y
    elif k == 1 and stride == 1:
        return conv1x1(x, kernel.reshape(kernel.shape[-2:]), bias)
    else:
        pad = int((k - stride + 1) / 2)
        w = kernel.to(x.dtype).permute(4, 3, 0, 1, 2)
        out = _library_conv(F.conv3d, x.permute(0, 4, 1, 2, 3), w,
                            stride=stride, padding=pad).permute(0, 2, 3, 4, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


class Conv3d(nn.Module):
    """The flax Conv3d's parameters (kernel (k, k, k, Cin, Cout), bias
    (Cout,) when use_bias) and `conv3d`. On the plain route `fast` is not
    taken: the JAX package's fast conv takes bf16 only
    (`fcd_tpu/ops/layers.py:291-295`). Under tensor parallelism a sharded
    kernel splits by its role (`split_op`); the fast conv as B1 on the
    output shard (column-parallel, x's gradient summed in f32 and rounded
    once) or as B1's partial instance, the all-reduce and the finishing
    pass (row-parallel, `ops/blocks.py::conv3x3_row_op`)."""

    plain_route = False
    tp = None
    tp_splits = {"kernel": ("col", "row")}

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, use_bias: bool = True,
                 fast: bool = False):
        super().__init__()
        k = kernel_size
        self.stride, self.fast = stride, fast
        self.kernel = nn.Parameter(torch.empty(k, k, k, in_channels,
                                               out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fast = self.fast and not self.plain_route
        role = _role(self, self.kernel)
        if role is None:
            return conv3d(x, self.kernel, self.bias, self.stride, fast)
        mm = self.tp.mesh
        if fast and self.kernel.shape[0] == 3 and self.stride == 1:
            from fcd_tpu_torch.kernels.block_conv import conv3x3_op
            from fcd_tpu_torch.ops.blocks import conv3x3_row_op

            w = self.kernel.to(x.dtype)
            if role == "col":
                out = gather_channels(conv3x3_op(
                    [x.contiguous()], [w], grad_sum=model_sum(mm)).y,
                    mm)
            else:
                out = conv3x3_row_op(slice_channels(x, mm), w, mm).y
        else:
            stride = self.stride
            out = split_op(lambda t, w: conv3d(t, w, None, stride), x,
                           self.kernel, role, mm)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.contiguous()


def _transpose_crop(k: int, s: int) -> int:
    """Where `lax.conv_transpose`'s output starts in `F.conv_transpose3d`'s
    (padding 0): k - 1 - pad_a, pad_a from lax's `_conv_transpose_padding`
    (VALID at k == s, SAME at k > s, as `fcd_tpu/ops/layers.py:388-391`
    chooses)."""
    if k == s:
        return 0                             # VALID: pad_a = k - 1
    pad_len = k + s - 2                      # SAME
    pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return k - 1 - pad_a


def conv_transpose3d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     stride: Optional[int] = None) -> torch.Tensor:
    """`fcd_tpu/ops/layers.py::ConvTranspose3d`'s `lax.conv_transpose` of
    channels-last x with a flax (k, k, k, Cin, Cout) kernel at `stride`
    (k by default): VALID at k == s, SAME at k > s (UNet's k3 s2), an
    output of n * s a side either way. `F.conv_transpose3d` with the
    kernel flipped (torch's transposed conv flips it, lax's does not),
    its (n - 1) s + k voxels a side cropped to lax's n s (k3 s2: the last
    one; MONAI's padding=1, output_padding=1 would be the window one
    voxel on, a different output), then the bias, in x's dtype."""
    k = kernel.shape[0]
    s = k if stride is None else int(stride)
    w = torch.flip(kernel.to(x.dtype), dims=(0, 1, 2)).permute(3, 4, 0, 1, 2)
    out = _library_conv(F.conv_transpose3d, x.permute(0, 4, 1, 2, 3), w,
                        stride=s).permute(0, 2, 3, 4, 1)
    if k != s:
        o = _transpose_crop(k, s)
        d, h, wd = (n * s for n in x.shape[1:4])
        out = out[:, o:o + d, o:o + h, o:o + wd]
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


class ConvTranspose3d(nn.Module):
    """The flax ConvTranspose3d's parameters (kernel (k, k, k, Cin, Cout),
    bias when use_bias) and `conv_transpose3d` at `stride` (k by default):
    the JAX package leaves these upsamples to XLA (UNETR++'s k2 s2 and k4
    s4, UNETR's PrUp stacks, VNet's k2 s2, UNet's k3 s2). Under tensor
    parallelism a sharded kernel splits by its role (`split_op`)."""

    tp = None
    tp_splits = {"kernel": ("col", "row")}

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 2, use_bias: bool = True,
                 stride: Optional[int] = None):
        super().__init__()
        k = kernel_size
        self.stride = k if stride is None else int(stride)
        self.kernel = nn.Parameter(torch.empty(k, k, k, in_channels,
                                               out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kaiming_normal_fan_out_(self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        role = _role(self, self.kernel)
        if role is None:
            return conv_transpose3d(x, self.kernel, self.bias, self.stride)
        stride = self.stride
        out = split_op(lambda t, w: conv_transpose3d(t, w, None, stride), x,
                       self.kernel, role, self.tp.mesh)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.contiguous()


class Dense(nn.Module):
    """`fcd_tpu/ops/layers.py::Dense`: x @ kernel (Cin, Cout) (+ bias), in
    x's dtype, xavier-uniform kernel, zero bias. The JAX Dense casts its
    input to the compute type; the port's callers hand it x in that type
    (a LayerNorm's f32 output cast first). Under tensor parallelism a
    sharded kernel splits by its role (`conv1x1`)."""

    tp = None
    tp_splits = {"kernel": ("col", "row")}

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if use_bias
                     else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        xavier_uniform_(self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x, self.kernel, self.bias, self.tp)


def pixel_shuffle_3d(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, D, H, W, C r^3) -> (B, rD, rH, rW, C) with MONAI's channel
    grouping c = oc r^3 + rd r^2 + rh r + rw
    (`fcd_tpu/ops/layers.py::pixel_shuffle_3d`)."""
    b, d, h, w, c = x.shape
    oc = c // r ** 3
    x = x.reshape(b, d, h, w, oc, r, r, r).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, d * r, h * r, w * r, oc)


def pad_pool_blur(y: torch.Tensor, r: int) -> torch.Tensor:
    """MONAI SubpixelUpsample's apply_pad_pool: zero-pad r - 1 on the low
    side of each spatial axis, then an r^3 average pool of stride 1 that
    always divides by r^3 (flax avg_pool counts the padding); f32 sums,
    y's dtype out."""
    b, d, h, w, c = y.shape
    yp = F.pad(y.float(), (0, 0, r - 1, 0, r - 1, 0, r - 1, 0))
    acc = None
    for dz in range(r):
        for dy in range(r):
            for dx in range(r):
                t = yp[:, dz:dz + d, dy:dy + h, dx:dx + w]
                acc = t if acc is None else acc + t
    return (acc / float(r ** 3)).to(y.dtype)


def interpolate_trilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """`jax.image.resize(..., 'linear')` upsampling by `scale`: half-pixel
    centres, edge samples renormalised, which is torch's trilinear
    interpolation with align_corners=False."""
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), scale_factor=scale,
                      mode="trilinear", align_corners=False)
    return y.permute(0, 2, 3, 4, 1).contiguous()


UPSAMPLE_MODES = ("pixelshuffle", "deconv", "nontrainable")


class UpSample(nn.Module):
    """`fcd_tpu/ops/layers.py::UpSample` (:445-489) at the scale every model
    of the family uses, 2:

    - pixelshuffle: a 3x3 conv to 8 Cout (`conv`), `pixel_shuffle_3d`,
      then `pad_pool_blur`;
    - deconv: the k2 s2 transposed conv (`transp`), B4's kernel
      (`kernels/upsample.py`), plus the bias; on the plain route
      `conv_transpose3d`;
    - nontrainable: `interpolate_trilinear`, then a 1x1 conv (`conv`)
      where the channels change.

    Under tensor parallelism the convs split as `Conv3d` does, and a
    column-parallel transposed conv runs B4 on its output shard (x's
    gradient summed over the ranks in f32, then rounded once), its bias
    sliced, then gathered; on the plain route `split_op`.
    """

    plain_route = False
    tp = None
    tp_splits = {"transp": ("col",)}

    def __init__(self, in_channels: int, out_channels: int,
                 mode: str = "pixelshuffle", use_bias: bool = True,
                 fast: bool = False):
        super().__init__()
        if mode not in UPSAMPLE_MODES:
            raise ValueError(f"Unsupported upsample mode: {mode}")
        self.mode = mode
        self.conv = self.transp = self.transp_bias = None
        if mode == "pixelshuffle":
            self.conv = Conv3d(in_channels, out_channels * 8, 3, 1, use_bias,
                               fast)
        elif mode == "deconv":
            self.transp = nn.Parameter(torch.empty(2, 2, 2, in_channels,
                                                   out_channels))
            self.transp_bias = (nn.Parameter(torch.zeros(out_channels))
                                if use_bias else None)
        elif in_channels != out_channels:
            self.conv = Conv3d(in_channels, out_channels, 1, 1, use_bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.conv is not None:
            self.conv.reset_parameters(generator)
        if self.transp is not None:
            kaiming_normal_fan_out_(self.transp, generator)
            if self.transp_bias is not None:
                with torch.no_grad():
                    self.transp_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "pixelshuffle":
            return pad_pool_blur(pixel_shuffle_3d(self.conv(x), 2), 2)
        role = _role(self, self.transp)
        if self.mode == "deconv" and self.plain_route:
            if role is None:
                return conv_transpose3d(x, self.transp, self.transp_bias)
            out = split_op(conv_transpose3d, x, self.transp, role,
                           self.tp.mesh)
            if self.transp_bias is not None:
                out = out + self.transp_bias.to(out.dtype)
            return out.contiguous()
        if self.mode == "deconv":
            from fcd_tpu_torch.kernels.upsample import upsample2x_op

            if role is None:
                return upsample2x_op(x.contiguous(), self.transp,
                                     self.transp_bias)
            mm = self.tp.mesh
            bias = (None if self.transp_bias is None
                    else slice_channels(self.transp_bias, mm))
            return gather_channels(upsample2x_op(
                x.contiguous(), self.transp, bias,
                grad_sum=model_sum(mm)), mm)
        y = interpolate_trilinear(x, 2)
        return y if self.conv is None else self.conv(y)
