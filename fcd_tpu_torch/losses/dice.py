"""Dice-family losses with MONAI semantics, in plain PyTorch.

Counterparts of `fcd_tpu/losses/dice.py`'s `one_hot`, `dice_loss` and
`cross_entropy_loss` (the terms of the DiceLoss and DiceCELoss the
trainer selects). Layout is channels-last: pred (B, D, H, W, C) logits,
target (B, D, H, W, 1) labels or (B, D, H, W, C) one-hot. Autograd
differentiates them; no kernel is involved.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, ..., 1) class indices -> (B, ..., num_classes) f32 one-hot."""
    idx = target.squeeze(-1).long()
    return F.one_hot(idx, num_classes).float()


def _prepare(pred, target, *, sigmoid, softmax, to_onehot_y,
             include_background):
    n_ch = pred.shape[-1]
    pred = pred.float()
    if sigmoid:
        pred = torch.sigmoid(pred)
    if softmax and n_ch > 1:
        pred = torch.softmax(pred, dim=-1)
    if to_onehot_y and n_ch > 1:
        target = one_hot(target, n_ch)
    if not include_background and n_ch > 1:
        pred = pred[..., 1:]
        target = target[..., 1:]
    return pred, target.float()


def dice_loss(pred: torch.Tensor, target: torch.Tensor, *,
              include_background: bool = False, sigmoid: bool = False,
              softmax: bool = True, to_onehot_y: bool = True,
              squared_pred: bool = False, jaccard: bool = False,
              batch: bool = True, smooth_nr: float = 1e-5,
              smooth_dr: float = 1e-5) -> torch.Tensor:
    """MONAI DiceLoss (the reference's default loss)."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    dims = tuple(range(1, pred.dim() - 1))
    if batch:
        dims = (0,) + dims
    intersection = (target * pred).sum(dim=dims)
    if squared_pred:
        ground_o = target.square().sum(dim=dims)
        pred_o = pred.square().sum(dim=dims)
    else:
        ground_o = target.sum(dim=dims)
        pred_o = pred.sum(dim=dims)
    denominator = ground_o + pred_o
    if jaccard:
        denominator = 2.0 * (denominator - intersection)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (denominator + smooth_dr)
    return f.mean()


def cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor, *,
                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss on channels-last logits: the weighted mean
    sum(w[y] * ce) / sum(w[y]) (the CE term of DiceCELoss)."""
    n_ch = pred.shape[-1]
    logp = torch.log_softmax(pred.float(), dim=-1)
    if target.shape[-1] == n_ch and n_ch > 1:
        idx = target.argmax(dim=-1)
    else:
        idx = target.squeeze(-1).long()
    picked = logp.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    if weight is None:
        return -picked.mean()
    w = weight.to(device=pred.device, dtype=torch.float32)[idx]
    return -(w * picked).sum() / w.sum().clamp_min(1e-12)
