"""Plain PyTorch layers of the eval path, channels-last (B, D, H, W, C).

Counterparts of `fcd_tpu/ops/layers.py`: the 1x1 convolution (with and
without bias), GroupNorm, LayerNorm, the eval BatchNorm affine, the
instance-norm affine from kernel sums and the 2x max pool, plus the flax
initialisers the port's seeded weights follow. Leaky-ReLU is
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
    "BatchNormEval", "conv1x1", "group_norm", "instance_affine_from_sums",
    "kaiming_normal_fan_out_", "layer_norm", "max_pool_2x", "xavier_uniform_",
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


class BatchNormEval(nn.Module):
    """Eval BatchNorm (running statistics), flax param/batch_stats names:
    scale, bias; mean, var."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w, b) with norm(x) = x * w + b, f32 (C,)."""
        w = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        return w, self.bias.float() - self.mean.float() * w

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)


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
