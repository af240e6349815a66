"""Voxel-level metrics: Dice, Precision, Sensitivity, F1, ROC-AUC, HD95.

Parity target: metrics.py:74-160 (_compute_metrics /
calculate_voxel_level_metrics), which rides MONAI's DiceMetric,
ConfusionMatrixMetric, ROCAUCMetric and HausdorffDistanceMetric(pct=95).
Per-sample metrics are nan-aware-averaged exactly like MONAI's
reduction="mean".

A copy of `fcd_tpu/metrics/voxel.py`, kept so that the port never imports
the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage


def _binarize(x) -> np.ndarray:
    return (np.asarray(x) > 0.5).astype(np.float32)


def _dice_sample(pred: np.ndarray, true: np.ndarray) -> float:
    denom = pred.sum() + true.sum()
    if denom == 0:
        return np.nan
    return float(2.0 * (pred * true).sum() / denom)


def _confusion_sample(pred: np.ndarray, true: np.ndarray):
    tp = float((pred * true).sum())
    fp = float((pred * (1 - true)).sum())
    fn = float(((1 - pred) * true).sum())
    tn = float(((1 - pred) * (1 - true)).sum())
    return tp, fp, tn, fn


def _safe_div(num, den):
    return num / den if den > 0 else np.nan


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUC (MONAI ROCAUCMetric parity, ties averaged)."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels, np.float64).ravel()
    order = np.argsort(scores, kind="mergesort")
    s, y = scores[order], labels[order]
    ranks = np.empty_like(s)
    i = 0
    n = len(s)
    while i < n:
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        ranks[i : j + 1] = (i + j) / 2.0 + 1.0
        i = j + 1
    n_pos = y.sum()
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return np.nan
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _mask_edges(mask: np.ndarray) -> np.ndarray:
    """Surface voxels: mask minus its erosion (MONAI get_mask_edges)."""
    if not mask.any():
        return np.zeros_like(mask, bool)
    eroded = ndimage.binary_erosion(mask, structure=ndimage.generate_binary_structure(3, 1))
    return mask & ~eroded


def hausdorff_distance_95(
    pred: np.ndarray, true: np.ndarray, percentile: float = 95.0,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> float:
    """MONAI HausdorffDistanceMetric parity: max of directed percentile
    distances between surface voxels (plain np.percentile, not
    area-weighted — the BraTS lesion HD95 in surface_distance.py is the
    area-weighted one)."""
    pred = np.asarray(pred).astype(bool)
    true = np.asarray(true).astype(bool)
    if not pred.any() or not true.any():
        return np.nan

    # crop to union bbox (+1 margin) for speed, like MONAI
    union = pred | true
    idx = np.nonzero(union)
    sl = tuple(
        slice(max(int(a.min()) - 1, 0), int(a.max()) + 2) for a in idx
    )
    pred, true = pred[sl], true[sl]

    edges_pred = _mask_edges(pred)
    edges_true = _mask_edges(true)

    from fcd_tpu_torch.metrics.surface_distance import _edt

    dt_true = _edt(~edges_true, spacing)
    dt_pred = _edt(~edges_pred, spacing)
    d_p2t = dt_true[edges_pred]
    d_t2p = dt_pred[edges_true]
    if d_p2t.size == 0 or d_t2p.size == 0:
        return np.nan
    return float(
        max(np.percentile(d_p2t, percentile), np.percentile(d_t2p, percentile))
    )


def compute_metrics(
    predictions: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    *,
    compute_roc_auc: bool = False,
    compute_hd95: bool = False,
) -> Dict[str, float]:
    """Per-sample metrics nan-averaged over the given volumes."""
    dices, precs, senss, specs, f1s, hd95s = [], [], [], [], [], []
    for p, t in zip(predictions, labels):
        pb, tb = _binarize(p), _binarize(t)
        dices.append(_dice_sample(pb, tb))
        tp, fp, tn, fn = _confusion_sample(pb, tb)
        precs.append(_safe_div(tp, tp + fp))
        senss.append(_safe_div(tp, tp + fn))
        specs.append(_safe_div(tn, tn + fp))
        f1s.append(_safe_div(2 * tp, 2 * tp + fp + fn))
        if compute_hd95:
            hd95s.append(hausdorff_distance_95(pb, tb))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        metrics = {
            "Prec": float(np.nanmean(precs)),
            "Sens": float(np.nanmean(senss)),
            "F1": float(np.nanmean(f1s)),
            "DC": float(np.nanmean(dices)),
        }
        if compute_roc_auc:
            all_p = np.concatenate([_binarize(p).ravel() for p in predictions])
            all_t = np.concatenate([_binarize(t).ravel() for t in labels])
            metrics["ROC_AUC"] = roc_auc(all_p, all_t)
        if compute_hd95:
            metrics["HD95"] = float(np.nanmean(hd95s))
    return metrics


def calculate_voxel_level_metrics(
    predictions: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    compute_roc_auc: bool = False,
    compute_hd95: bool = False,
    average_across_subjects: bool = False,
) -> Dict[str, float]:
    """metrics.py:128-160 parity. The 'global' path concatenates subjects
    into one batch, which for MONAI means per-subject metrics averaged —
    identical to the per-subject path plus optional pooled ROC-AUC."""
    if average_across_subjects:
        return compute_metrics(predictions, labels, compute_roc_auc=compute_roc_auc)
    return compute_metrics(
        predictions, labels, compute_roc_auc=compute_roc_auc, compute_hd95=compute_hd95
    )
