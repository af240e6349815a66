"""Dice-family losses with MONAI semantics, in plain PyTorch.

Counterparts of `fcd_tpu/losses/dice.py`'s `one_hot`, `dice_loss`,
`cross_entropy_loss`, `focal_loss` and `generalized_dice_loss` (the terms
of the five main losses the trainer selects), each with the JAX package's
`sample_mask`: (B,) 0/1 validity weights that exclude padded samples of a
ragged batch exactly. Layout is channels-last: pred (B, D, H, W, C)
logits, target (B, D, H, W, 1) labels or (B, D, H, W, C) one-hot.
Logits are cast to f32 before any softmax (ROADMAP C14). Autograd
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


def mask_cols(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) validity mask -> broadcastable (B, 1, ..., 1) f32."""
    return mask.float().reshape(mask.shape[0], *([1] * (ndim - 1)))


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the valid samples: axis 0 weighted by mask, the other
    axes averaged (x.mean() when mask is None)."""
    if mask is None:
        return x.mean()
    m = mask_cols(mask.to(x.device), x.dim())
    n_other = x[0].numel()
    return (x * m).sum() / (m.sum().clamp_min(1.0) * n_other)


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


def _masked(pred, target, sample_mask, batch):
    """With batch=True the pooled sums leave out padded samples."""
    if sample_mask is not None and batch:
        m = mask_cols(sample_mask.to(pred.device), pred.dim())
        pred, target = pred * m, target * m
    dims = tuple(range(1, pred.dim() - 1))
    return pred, target, ((0,) + dims) if batch else dims


def dice_loss(pred: torch.Tensor, target: torch.Tensor, *,
              include_background: bool = False, sigmoid: bool = False,
              softmax: bool = True, to_onehot_y: bool = True,
              squared_pred: bool = False, jaccard: bool = False,
              batch: bool = True, smooth_nr: float = 1e-5,
              smooth_dr: float = 1e-5,
              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MONAI DiceLoss (the reference's default loss)."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    pred, target, dims = _masked(pred, target, sample_mask, batch)
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
    if not batch and sample_mask is not None:
        return masked_mean(f, sample_mask)
    return f.mean()


def cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor, *,
                       weight: Optional[torch.Tensor] = None,
                       sample_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss on channels-last logits: the weighted mean
    sum(w[y] * ce) / sum(w[y]) (the CE term of DiceCELoss); padded
    samples take weight 0."""
    n_ch = pred.shape[-1]
    logp = torch.log_softmax(pred.float(), dim=-1)
    if target.shape[-1] == n_ch and n_ch > 1:
        idx = target.argmax(dim=-1)
    else:
        idx = target.squeeze(-1).long()
    picked = logp.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    if weight is None:
        return -masked_mean(picked, sample_mask)
    w = weight.to(device=pred.device, dtype=torch.float32)[idx]
    if sample_mask is not None:
        w = w * mask_cols(sample_mask.to(pred.device), w.dim())
    return -(w * picked).sum() / w.sum().clamp_min(1e-12)


def focal_loss(pred: torch.Tensor, target: torch.Tensor, *,
               gamma: float = 2.0, include_background: bool = False,
               to_onehot_y: bool = True, use_softmax: bool = True,
               sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MONAI FocalLoss (the focal term of DiceFocalLoss). Softmax form: the
    mean over voxels and channels of -(1 - p_t)^gamma * t * log(p_t);
    otherwise the BCE-with-logits form."""
    n_ch = pred.shape[-1]
    predf = pred.float()
    if to_onehot_y and n_ch > 1:
        target = one_hot(target, n_ch)
    target = target.float()
    if use_softmax:
        logp = torch.log_softmax(predf, dim=-1)
        if not include_background and n_ch > 1:
            logp, target = logp[..., 1:], target[..., 1:]
        p = logp.exp()
        loss = -torch.pow(1.0 - p, gamma) * logp * target
    else:
        if not include_background and n_ch > 1:
            predf, target = predf[..., 1:], target[..., 1:]
        p = torch.sigmoid(predf)
        bce = (predf.clamp_min(0) - predf * target
               + torch.log1p(torch.exp(-predf.abs())))
        p_t = p * target + (1 - p) * (1 - target)
        loss = torch.pow(1.0 - p_t, gamma) * bce
    return masked_mean(loss, sample_mask)


def generalized_dice_loss(pred: torch.Tensor, target: torch.Tensor, *,
                          include_background: bool = True,
                          sigmoid: bool = False, softmax: bool = True,
                          to_onehot_y: bool = True, w_type: str = "square",
                          batch: bool = True, smooth_nr: float = 1e-5,
                          smooth_dr: float = 1e-5,
                          sample_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """MONAI GeneralizedDiceLoss; w_type `square`, `simple` or `uniform`
    (any other name is uniform, as in the JAX package)."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    pred, target, dims = _masked(pred, target, sample_mask, batch)
    intersection = (target * pred).sum(dim=dims)
    ground_o = target.sum(dim=dims)
    pred_o = pred.sum(dim=dims)
    denominator = ground_o + pred_o
    if w_type == "square":
        w = 1.0 / ground_o.square()
    elif w_type == "simple":
        w = 1.0 / ground_o
    else:
        w = torch.ones_like(ground_o)
    infs = torch.isinf(w)
    w = torch.where(infs, 0.0, w)
    if batch:
        w = w + infs.float() * w.max()
    else:
        w = w + infs.float() * w.amax(dim=1, keepdim=True)
    dim = 0 if batch else 1
    numer = 2.0 * (intersection * w).sum(dim=dim, keepdim=True) + smooth_nr
    denom = (denominator * w).sum(dim=dim, keepdim=True) + smooth_dr
    f = 1.0 - numer / denom
    if not batch and sample_mask is not None:
        return masked_mean(f, sample_mask)
    return f.mean()
