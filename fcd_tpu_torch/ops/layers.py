"""Plain PyTorch layers, channels-last (B, D, H, W, C).

Counterparts of `fcd_tpu/ops/layers.py`: the 1x1 convolution (with and
without bias), GroupNorm, LayerNorm, BatchNorm (train and eval), the
instance-norm affine from kernel sums, the 2x max pool and inverted
dropout with an explicit generator, plus the flax initialisers the port's
seeded weights follow. Leaky-ReLU is
`torch.nn.functional.leaky_relu`. The 3x3x3 conv, the transposed conv, the
finale and the attention live in `fcd_tpu_torch/kernels/`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "BatchNorm", "DropoutRng", "blocks_2x", "conv1x1", "dropout",
    "group_norm", "instance_affine_from_sums", "kaiming_normal_fan_out_",
    "layer_norm", "max_pool_2x", "unblocks_2x", "xavier_uniform_",
]


def conv1x1(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1x1 conv: x (..., Cin) @ kernel (Cin, Cout) (+ bias), in x's dtype."""
    out = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


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


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """torch max_pool3d(x, 2, 2) on channels-last x."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(
        0, 2, 3, 4, 1).contiguous()


class BatchNorm(nn.Module):
    """BatchNorm with `fcd_tpu/ops/layers.py:103-157`'s semantics and flax
    param/batch_stats names: scale, bias; mean, var. The blocks fuse it
    into their convs as an affine (`affine` at eval, `affine_from_sums` in
    train mode).

    In train mode the statistics are the batch's, over (B, D, H, W), with
    var = E[x^2] - mean^2 clamped at 0, and the running statistics move by
    flax momentum 0.9 towards the batch mean and this BIASED variance
    (torch.nn.BatchNorm3d would use the unbiased one, so it is not used)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

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
        mean = s1.float().sum(0) / (b * n)
        var = (s2.float().sum(0) / (b * n) - mean.square()).clamp_min(0)
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
    before each step; the modules that drop out share one instance."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        self.generator = generator
        self.seed = seed

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        """Bernoulli(1 - rate) keep mask (bool) of `shape`."""
        return torch.rand(shape, generator=self.generator,
                          device=device) >= rate


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


def xavier_uniform_(t: torch.Tensor,
                    generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (t.shape[-2] + t.shape[-1]))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)
