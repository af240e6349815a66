"""The regularising terms: total variation, boundary, cortical awareness.

Counterparts of `fcd_tpu/losses/extras.py` (`dilate_mask`,
`total_variation_loss`, `_gradient`, `boundary_loss`,
`cortical_boundary_loss`), the terms of the source paper's total-variation
regularised framework. Channels-last (B, D, H, W, C) tensors; differences
and shifts run over the three spatial axes. Plain PyTorch: no Pallas
kernel computes any of them, so the binary dilation is one library call
(`avg_pool3d` as a zero-padded window sum). Logits are cast to f32 before
any softmax (ROADMAP C14).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fcd_tpu_torch.losses.dice import masked_mean

_SPATIAL = (1, 2, 3)


def dilate_mask(mask: torch.Tensor, kernel_size: int = 3,
                iterations: int = 1) -> torch.Tensor:
    """Binary dilation: 1 where the k^3 window sum (zero padding) is above
    0. mask: (B, D, H, W, 1); returns f32 of its shape."""
    k = kernel_size
    out = mask.float().permute(0, 4, 1, 2, 3)
    for _ in range(iterations):
        summed = F.avg_pool3d(out, k, stride=1, padding=k // 2,
                              count_include_pad=True, divisor_override=1)
        out = (summed > 0).float()
    return out.permute(0, 2, 3, 4, 1)


def total_variation_loss(pred: torch.Tensor,
                         gt: Optional[torch.Tensor] = None, *, norm: int = 1,
                         sigmoid: bool = False, softmax: bool = True,
                         exclude_borders: bool = True,
                         sample_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """3D TV of the FCD channel's probability: the sum over the spatial
    axes of the mean |difference of neighbours| (norm 1) or the root of
    the mean squared difference (norm 2). exclude_borders: the band
    between the label dilated twice and eroded twice is zeroed first."""
    pred = pred.float()
    n_ch = pred.shape[-1]
    if sigmoid:
        pred = torch.sigmoid(pred)
    if softmax and n_ch > 1:
        pred = torch.softmax(pred, dim=-1)
    if n_ch > 1:
        pred = pred[..., 1:2]
    if exclude_borders and gt is not None:
        gt = gt.float()
        dilated = dilate_mask(gt, kernel_size=3, iterations=2)
        eroded = 1.0 - dilate_mask(1.0 - gt, kernel_size=3, iterations=2)
        border = ((dilated - eroded) > 0).float()
        pred = pred * (1.0 - border)

    def tv_axis(axis):
        n = pred.shape[axis]
        d = pred.narrow(axis, 1, n - 1) - pred.narrow(axis, 0, n - 1)
        if norm == 1:
            return masked_mean(d.abs(), sample_mask)
        return torch.sqrt(masked_mean(d.square(), sample_mask) + 1e-10)

    return tv_axis(1) + tv_axis(2) + tv_axis(3)


def _gradient(x: torch.Tensor, axis: int) -> torch.Tensor:
    """np.gradient with unit spacing: central differences inside, one-sided
    at the two ends."""
    n = x.shape[axis]
    interior = (x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)) * 0.5
    first = x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)


def boundary_loss(pred: torch.Tensor, target: torch.Tensor,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradient matching: the mean over the spatial axes of
    mean |grad(pred) - grad(target)| (target broadcast over pred's
    channels)."""
    pred, target = pred.float(), target.float()
    total = 0.0
    for ax in _SPATIAL:
        total = total + masked_mean(
            (_gradient(pred, ax) - _gradient(target, ax)).abs(), sample_mask)
    return total / 3.0


def cortical_boundary_loss(pred: torch.Tensor, thickness_map: torch.Tensor,
                           sample_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Cortical-thickness consistency: the mean over the spatial axes of
    mean |grad(pred) * grad(thickness)|."""
    pred, thickness_map = pred.float(), thickness_map.float()
    total = 0.0
    for ax in _SPATIAL:
        total = total + masked_mean(
            (_gradient(pred, ax) * _gradient(thickness_map, ax)).abs(),
            sample_mask)
    return total / 3.0
