"""Standalone BraTS-challenge lesion-wise scorer (file-pair API).

Counterpart of `fcd_tpu/metrics/brats_scorer.py` on the port's own
`metrics/lesion.py`, `metrics/surface_distance.py` and
`postproc/morphology.py`. The port imports no pandas, so
`get_lesion_wise_results` returns the report as a list of row dicts (one
per tissue, the JAX DataFrame's columns in its order, every number a
float, as the frame holds them) and writes the same CSV with the `csv`
module.

Parity target: brats/brats_metrics.py:11-408 — tissue isolation
(WT/TC/ET), per-challenge dilation/volume-threshold parameters, GaNDLF
sensitivity/specificity, legacy full-image Dice/HD95, per-lesion matching
via dilated components, 374mm FP penalties, and a CSV report.
Connected components / morphology run on the native C++ ops; surface
distances on the generated-marching-cubes engine.
"""

from __future__ import annotations

import csv
import math
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from fcd_tpu_torch.data import nifti
from fcd_tpu_torch.metrics.lesion import dice, get_gtseg_combined_by_dilation
from fcd_tpu_torch.metrics.surface_distance import (
    compute_robust_hausdorff,
    compute_surface_distances,
)
from fcd_tpu_torch.postproc.morphology import (
    binary_dilation,
    connected_components,
    generate_binary_structure,
)

CHALLENGE_PARAMS = {
    "BraTS-GLI": (3, 50),
    "BraTS-SSA": (3, 50),
    "BraTS-MEN": (1, 50),
    "BraTS-PED": (3, 50),
    "BraTS-MET": (1, 2),
}

PENALTY_HD95 = 374


def get_tissue_wise_seg(pred: np.ndarray, gt: np.ndarray, tissue_type: str):
    """Isolate a BraTS tissue type as binary masks
    (brats_metrics.py:39-78): WT = labels {1,2,3}, TC = {1,3}, ET = {3}."""
    keep = {"WT": (1, 2, 3), "TC": (1, 3), "ET": (3,)}[tissue_type]
    pred_b = np.isin(pred, keep).astype(pred.dtype)
    gt_b = np.isin(gt, keep).astype(gt.dtype)
    return pred_b, gt_b


def get_sensitivity_and_specificity(result_array: np.ndarray, target_array: np.ndarray):
    """GaNDLF voxel sensitivity/specificity (brats_metrics.py:259-287)."""
    i_c = np.sum(result_array)
    r_c = np.sum(target_array)
    overlap = np.where(result_array == target_array, 1, 0)
    tp = overlap[result_array == 1].sum()
    fp = i_c - tp
    fn = r_c - tp
    tn = np.count_nonzero((result_array != 1) & (target_array != 1))
    sens = 1.0 * tp / (tp + fn + sys.float_info.min)
    spec = 1.0 * tn / (tn + fp + sys.float_info.min)
    if i_c == 0 and r_c == 0:
        sens = 1.0
    return sens, spec


def get_lesion_wise_scores(
    prediction_seg: str, gt_seg: str, label_value: str, dil_factor: int
):
    """Per-tissue lesion matching and metrics for one file pair
    (brats_metrics.py:135-256)."""
    pred_img = nifti.load(prediction_seg)
    gt_img = nifti.load(gt_seg)
    pred_mat = pred_img.data
    gt_mat = gt_img.data
    sx, sy, sz = pred_img.spacing

    pred_mat, gt_mat = get_tissue_wise_seg(pred_mat, gt_mat, label_value)

    if np.all(gt_mat == 0) and np.all(pred_mat == 0):
        full_dice = 1.0
        full_hd95 = 0.0
    else:
        full_dice = dice(pred_mat, gt_mat)
        sd = compute_surface_distances(gt_mat.astype(bool), pred_mat.astype(bool),
                                       (sx, sy, sz))
        full_hd95 = compute_robust_hausdorff(sd, 95)

    full_sens, full_specs = get_sensitivity_and_specificity(pred_mat, gt_mat)
    full_gt_vol = float(np.sum(gt_mat)) * sx * sy * sz
    full_pred_vol = float(np.sum(pred_mat)) * sx * sy * sz

    dil_struct = generate_binary_structure(3, 2)
    gt_cc = connected_components(gt_mat.astype(np.uint8), connectivity=26)
    pred_cc = connected_components(pred_mat.astype(np.uint8), connectivity=26)
    gt_dil = binary_dilation(gt_mat.astype(np.uint8), structure=dil_struct,
                             iterations=dil_factor)
    gt_dil_cc = connected_components(gt_dil.astype(np.uint8), connectivity=26)
    gt_combined = get_gtseg_combined_by_dilation(gt_dil_cc, gt_cc)

    gt_tp: List[int] = []
    tp: List[int] = []
    fn: List[int] = []
    metric_pairs: List[Tuple] = []

    for gtcomp in range(1, int(np.max(gt_combined)) + 1):
        gt_tmp = (gt_combined == gtcomp).astype(np.uint8)
        if not gt_tmp.any():
            continue
        gt_tmp_dil = binary_dilation(gt_tmp, structure=dil_struct,
                                     iterations=dil_factor)
        gt_vol = float(np.sum(gt_tmp)) * sx * sy * sz

        intersecting = np.unique(pred_cc * gt_tmp_dil)
        intersecting = intersecting[intersecting != 0]
        tp.extend(int(v) for v in intersecting)

        pred_tmp = np.isin(pred_cc, intersecting).astype(np.uint8)
        dice_score = dice(pred_tmp, gt_tmp)
        sd = compute_surface_distances(gt_tmp.astype(bool), pred_tmp.astype(bool),
                                       (sx, sy, sz))
        hd = compute_robust_hausdorff(sd, 95)

        metric_pairs.append((list(map(int, intersecting)), gtcomp, gt_vol,
                             dice_score, hd))
        if len(intersecting) > 0:
            gt_tp.append(gtcomp)
        else:
            fn.append(gtcomp)

    fp = np.unique(pred_cc[np.isin(pred_cc, tp + [0], invert=True)])
    return (tp, fn, fp, gt_tp, metric_pairs, full_dice, full_hd95,
            full_gt_vol, full_pred_vol, full_sens, full_specs)


COLUMNS = ("Labels", "Num_TP", "Num_FP", "Num_FN", "Sensitivity",
           "Specificity", "Legacy_Dice", "Legacy_HD95", "GT_Complete_Volume",
           "LesionWise_Score_Dice", "LesionWise_Score_HD95")


def _sum(values) -> float:
    """A pandas column's sum: NaN skipped, 0 when empty."""
    return float(sum(v for v in values if not math.isnan(v)))


def _cell(v: float) -> str:
    """A float as pandas' to_csv writes it."""
    return repr(float(v))


def get_lesion_wise_results(
    pred_file: str, gt_file: str, challenge_name: str,
    output: Optional[str] = None,
) -> List[Dict[str, object]]:
    """Full per-challenge report (brats_metrics.py:289-408): WT/TC/ET rows of
    TP/FP/FN counts (small lesions excluded), voxel sens/spec, legacy
    Dice/HD95, and FP-penalized lesion-wise Dice/HD95."""
    dilation_factor, lesion_volume_thresh = CHALLENGE_PARAMS[challenge_name]

    rows: List[Dict[str, object]] = []
    for label in ("WT", "TC", "ET"):
        (tp, fn, fp, gt_tp, metric_pairs, full_dice, full_hd95, full_gt_vol,
         _full_pred_vol, full_sens, full_specs) = get_lesion_wise_scores(
            pred_file, gt_file, label_value=label, dil_factor=dilation_factor
        )

        # (number of predicted lesions, gt volume, dice, hd95) by gt lesion
        pairs = [(len(p), vol, d, PENALTY_HD95 if h == np.inf else h)
                 for p, _, vol, d, h in sorted(metric_pairs,
                                               key=lambda m: m[1])]
        fn_sub = sum(n == 0 and vol <= lesion_volume_thresh
                     for n, vol, _, _ in pairs)
        gt_tp_sub = sum(n != 0 and vol <= lesion_volume_thresh
                        for n, vol, _, _ in pairs)

        thresh = [(d, h) for _, vol, d, h in pairs
                  if vol > lesion_volume_thresh]
        denom = len(thresh) + len(fp)
        lesion_wise_dice = (
            _sum(d for d, _ in thresh) / denom if denom > 0 else np.nan
        )
        lesion_wise_hd95 = (
            (_sum(h for _, h in thresh) + len(fp) * PENALTY_HD95) / denom
            if denom > 0 else np.nan
        )
        if math.isnan(lesion_wise_dice):
            lesion_wise_dice = 1
        if math.isnan(lesion_wise_hd95):
            lesion_wise_hd95 = 0

        values = (len(gt_tp) - int(gt_tp_sub), len(fp),
                  len(fn) - int(fn_sub), full_sens, full_specs, full_dice,
                  full_hd95, full_gt_vol, lesion_wise_dice, lesion_wise_hd95)
        rows.append({"Labels": label, **{
            k: PENALTY_HD95 * 1.0 if v == np.inf else float(v)
            for k, v in zip(COLUMNS[1:], values)}})
    if output:
        with open(output, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(COLUMNS)
            for row in rows:
                w.writerow([row["Labels"]]
                           + [_cell(row[k]) for k in COLUMNS[1:]])
    return rows
