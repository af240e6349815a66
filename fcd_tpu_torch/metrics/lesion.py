"""BraTS-style lesion-wise metrics and subject-level sensitivity.

Parity targets: metrics.py:26-72 (calculate_subject_level_metrics) and
metrics.py:162-360 (calculate_lesion_wise_metrics), plus the helpers
brats/brats_metrics.py:11-37 (dice) and :100-132
(get_GTseg_combinedByDilation). Connected components / dilation run on the
native C++ ops (cc3d/scipy equivalents), surface distances on the
generated-marching-cubes engine.

A copy of `fcd_tpu/metrics/lesion.py`, kept so that the port never imports
the JAX package.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Dict, List, Sequence

import numpy as np

from fcd_tpu_torch.metrics.surface_distance import (
    compute_robust_hausdorff,
    compute_surface_distances,
)
from fcd_tpu_torch.postproc.morphology import (
    binary_dilation,
    connected_components,
    generate_binary_structure,
)
from fcd_tpu_torch.postproc.segment import evaluate_fp

LesionMetric = namedtuple(
    "LesionMetric", ["pred_ids", "gt_id", "gt_volume", "dice_score", "hd95"]
)


def dice(im1: np.ndarray, im2: np.ndarray) -> float:
    """brats_metrics.py:11-37 parity."""
    im1 = np.asarray(im1).astype(bool)
    im2 = np.asarray(im2).astype(bool)
    if im1.shape != im2.shape:
        raise ValueError("Shape mismatch: im1 and im2 must have the same shape.")
    return 2.0 * np.logical_and(im1, im2).sum() / (im1.sum() + im2.sum())


def get_gtseg_combined_by_dilation(gt_dilated_cc: np.ndarray, gt_cc: np.ndarray) -> np.ndarray:
    """Merge GT lesions that fall into the same dilated component
    (brats_metrics.py:100-132)."""
    combined = np.zeros_like(gt_dilated_cc)
    for comp in range(1, int(gt_dilated_cc.max()) + 1):
        sel = (gt_dilated_cc == comp) & (gt_cc > 0)
        combined[sel] = comp
    return combined


def calculate_lesion_wise_metrics(
    predictions: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    dilation_factor: int = 3,
    voxel_spacing=(1.0, 1.0, 1.0),
    lesion_volume_thresh: int = 0,
    penalty_distance: float = 374,
    extended: bool = False,
) -> Dict[str, float]:
    """metrics.py:162-360 parity: per-GT-lesion matching against 3x-dilated
    masks, lesion Dice + area-weighted HD95, FP counting, macro + micro
    aggregation, subject-level sensitivity.

    With extended=True the BraTS-style penalized aggregates the reference
    computes (metrics.py:274-287, 314-316, 339-343: FP lesions count as
    Dice 0 / HD95 `penalty_distance`, unmatched-GT NaNs corrected the same
    way) and the per-subject macro Prec/Sens/F1/Dice/HD95
    (metrics.py:263-269, 289-306) are added to the returned dict. The
    reference builds NaN-corrected micro lists (metrics.py:339, 342) but
    then averages the uncorrected ones — an evident slip; we average the
    corrected lists, which is the BraTS-defined penalized statistic.
    """
    results: List[Dict[str, float]] = []
    micro_tp = micro_fp = micro_fn = 0
    micro_dice_matched: List[float] = []
    micro_hd95_matched: List[float] = []
    micro_dice_penalized: List[float] = []
    micro_hd95_penalized: List[float] = []
    sx, sy, sz = voxel_spacing
    subject_tp_count = subject_fn_count = 0

    dil_struct = generate_binary_structure(3, 2)

    for pred_arr, gt_arr in zip(predictions, labels):
        pred = (np.asarray(pred_arr) > 0.5).astype(np.uint8)
        gt = (np.asarray(gt_arr) > 0.5).astype(np.uint8)

        gt_cc = connected_components(gt, connectivity=26)
        pred_cc = connected_components(pred, connectivity=26)

        gt_dil = binary_dilation(gt, structure=dil_struct, iterations=dilation_factor)
        gt_dil_cc = connected_components(gt_dil.astype(np.uint8), connectivity=26)
        gt_combined = get_gtseg_combined_by_dilation(gt_dil_cc, gt_cc)

        tp_ids: List[int] = []
        fn_ids: List[int] = []
        lesion_metrics: List[LesionMetric] = []

        for gtcomp in range(1, int(gt_combined.max()) + 1):
            gt_mask = (gt_combined == gtcomp).astype(np.uint8)
            if not gt_mask.any():
                continue
            gt_mask_dil = binary_dilation(gt_mask, structure=dil_struct,
                                          iterations=dilation_factor)
            gt_volume = float(gt_mask.sum()) * sx * sy * sz

            overlapping = np.unique(pred_cc * gt_mask_dil)
            overlapping = overlapping[overlapping != 0]

            if len(overlapping) > 0:
                tp_ids.extend(int(v) for v in overlapping)
                pred_iso = np.isin(pred_cc, overlapping).astype(np.uint8)
                dice_score = dice(pred_iso, gt_mask)
                sd = compute_surface_distances(gt_mask, pred_iso, (sx, sy, sz))
                hd95 = compute_robust_hausdorff(sd, 95)
            else:
                fn_ids.append(gtcomp)
                dice_score = np.nan
                hd95 = np.nan

            lesion_metrics.append(
                LesionMetric(
                    pred_ids=[int(v) for v in overlapping],
                    gt_id=gtcomp,
                    gt_volume=gt_volume,
                    dice_score=dice_score,
                    hd95=hd95,
                )
            )

        fp_ids = np.unique(pred_cc[np.isin(pred_cc, tp_ids + [0], invert=True)])

        if lesion_volume_thresh > 0:
            lesion_metrics = [m for m in lesion_metrics if m.gt_volume > lesion_volume_thresh]

        tp, fp, fn = len(tp_ids), len(fp_ids), len(fn_ids)

        row = {"Lesion_FP": fp, "Lesion_FN": fn}
        if extended:
            # per-subject matched-only means (metrics.py:263-269)
            matched = [m for m in lesion_metrics
                       if not np.isnan(m.dice_score) and not np.isnan(m.hd95)]
            dice_matched = float(np.mean([m.dice_score for m in matched])) if matched else np.nan
            hd95_matched = float(np.mean([m.hd95 for m in matched])) if matched else np.nan
            # per-subject penalized aggregates (metrics.py:271-287): FP
            # lesions score Dice 0 / HD95 penalty; unmatched-GT NaNs likewise
            fn_count = int(np.sum([1 for m in lesion_metrics if np.isnan(m.dice_score)]))
            denom = len(lesion_metrics) + fp + fn_count
            if denom > 0:
                dice_pen = (
                    float(np.sum([0.0 if np.isnan(m.dice_score) else m.dice_score
                                  for m in lesion_metrics])) / denom
                )
                hd95_pen = (
                    float(np.sum([penalty_distance if np.isnan(m.hd95) else m.hd95
                                  for m in lesion_metrics]))
                    + fp * penalty_distance
                ) / denom
            else:
                dice_pen, hd95_pen = 1.0, 0.0
            # per-subject detection rates (metrics.py:289-293)
            sens_s = tp / (tp + fn) if (tp + fn) > 0 else 1.0
            prec_s = tp / (tp + fp) if (tp + fp) > 0 else 1.0
            f1_s = 2 * sens_s * prec_s / (sens_s + prec_s) if (sens_s + prec_s) > 0 else 0.0
            row.update({
                "Lesion_Prec_macro": prec_s,
                "Lesion_Sens_macro": sens_s,
                "Lesion_F1_macro": f1_s,
                "Lesion_Dice_macro": dice_matched,
                "Lesion_Dice_penalized_macro": dice_pen,
                "Lesion_HD95_macro": hd95_matched,
                "Lesion_HD95_penalized_macro": hd95_pen,
            })
        results.append(row)

        micro_tp += tp
        micro_fp += fp
        micro_fn += fn
        micro_dice_matched.extend(m.dice_score for m in lesion_metrics)
        micro_hd95_matched.extend(m.hd95 for m in lesion_metrics)
        # penalized micro lists include one penalty entry per FP lesion
        # (metrics.py:314-316)
        micro_dice_penalized.extend(
            [m.dice_score for m in lesion_metrics] + [0.0] * fp
        )
        micro_hd95_penalized.extend(
            [m.hd95 for m in lesion_metrics] + [penalty_distance] * fp
        )

        if gt.sum() > 0:
            if tp > 0:
                subject_tp_count += 1
            else:
                subject_fn_count += 1

    macro = {k: float(np.nanmean([r[k] for r in results])) for k in results[0]} if results else {}

    sens = micro_tp / (micro_tp + micro_fn) if (micro_tp + micro_fn) > 0 else 1.0
    prec = micro_tp / (micro_tp + micro_fp) if (micro_tp + micro_fp) > 0 else 1.0
    f1 = 2 * sens * prec / (sens + prec) if (sens + prec) > 0 else 0.0

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        dice_micro = float(np.nanmean(micro_dice_matched)) if micro_dice_matched else np.nan
        hd95_micro = float(np.nanmean(micro_hd95_matched)) if micro_hd95_matched else np.nan

    s_sens = (
        subject_tp_count / (subject_tp_count + subject_fn_count)
        if (subject_tp_count + subject_fn_count) > 0
        else np.nan
    )

    out = {
        **macro,
        "Lesion_Prec": prec,
        "Lesion_Sens": sens,
        "Lesion_F1": f1,
        "Lesion_Dice": dice_micro,
    }
    if extended:
        # micro penalized means over the NaN-corrected lists
        # (metrics.py:339-343; see docstring on the reference's unused
        # corrected variables)
        dice_pen_corr = [0.0 if np.isnan(d) else d for d in micro_dice_penalized]
        hd95_pen_corr = [
            penalty_distance if np.isnan(d) else d for d in micro_hd95_penalized
        ]
        out["Lesion_Dice_penalized"] = (
            float(np.mean(dice_pen_corr)) if dice_pen_corr else 1.0
        )
    out["Lesion_HD95"] = hd95_micro
    if extended:
        out["Lesion_HD95_penalized"] = (
            float(np.mean(hd95_pen_corr)) if hd95_pen_corr else 0.0
        )
    out["sSens"] = s_sens
    return out


def calculate_subject_level_metrics(
    predictions: Sequence[np.ndarray], labels: Sequence[np.ndarray]
) -> Dict[str, float]:
    """metrics.py:26-72 parity: subject detection sensitivity + mean FP
    cluster count (6-connected scipy labeling, as the reference uses
    scipy.ndimage.label default structure there)."""
    from scipy import ndimage

    tps = fns = 0
    total_fpc = 0
    for pred, label in zip(predictions, labels):
        pred_b = (np.asarray(pred) > 0).astype(np.float32)
        label_b = (np.asarray(label) > 0).astype(np.float32)
        if label_b.sum() > 0:
            if np.logical_and(pred_b > 0, label_b > 0).sum() > 0:
                tps += 1
            else:
                fns += 1
        if pred_b.sum() > 0:
            labeled_pred, _ = ndimage.label(pred_b)
            total_fpc += evaluate_fp(labeled_pred, label_b)
    s_sens = tps / (tps + fns) if (tps + fns) > 0 else 0
    return {"sSens": s_sens, "nFPC": total_fpc / len(predictions)}
