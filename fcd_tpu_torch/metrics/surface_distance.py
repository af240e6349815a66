"""Surface-distance measures: robust Hausdorff (HD95), average surface
distance, surface Dice/overlap at tolerance.

Independent implementation of the published surface-distance algorithm the
reference vendors (brats/sd_metrics.py:25-328, DeepMind surface-distance):
marching-cubes surfel areas per 2x2x2 neighbourhood code (generated, see
mc_tables.py), bounding-box crop, binary-pattern correlation, Euclidean
distance transforms, and area-weighted sorted distance lists. Verified
bit-level against the reference in tests/test_surface_distance.py.

A copy of `fcd_tpu/metrics/surface_distance.py`, kept so that the port never imports
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy import ndimage

from fcd_tpu_torch.metrics.mc_tables import create_table_neighbour_code_to_surface_area

# the 2x2x2 binary-pattern kernel; must match the bit convention of
# mc_tables._KERNEL
_CODE_KERNEL = np.array(
    [[[128, 64], [32, 16]], [[8, 4], [2, 1]]], dtype=np.uint8
)

_EMPTY = {
    "distances_gt_to_pred": np.array([]),
    "distances_pred_to_gt": np.array([]),
    "surfel_areas_gt": np.array([]),
    "surfel_areas_pred": np.array([]),
}


def _edt(nonzero: np.ndarray, spacing_mm) -> np.ndarray:
    """Native C++ Felzenszwalb EDT (fcdops.cpp::edt_3d) with scipy fallback."""
    from fcd_tpu_torch.postproc.native import native_edt

    out = native_edt(nonzero, spacing_mm)
    if out is not None:
        return out
    return ndimage.distance_transform_edt(nonzero, sampling=spacing_mm)


def _neighbour_code(crop: np.ndarray) -> np.ndarray:
    """Native 2x2x2 bit-code correlation with scipy fallback."""
    from fcd_tpu_torch.postproc.native import native_neighbour_code

    out = native_neighbour_code(crop)
    if out is not None:
        return out
    return ndimage.correlate(crop, _CODE_KERNEL, mode="constant", cval=0)


def compute_surface_distances(
    mask_gt: np.ndarray, mask_pred: np.ndarray, spacing_mm: Tuple[float, float, float]
) -> Dict[str, np.ndarray]:
    """Closest distances from every surfel of one mask to the other surface,
    with surfel areas, both sorted by distance."""
    mask_gt = np.asarray(mask_gt).astype(bool)
    mask_pred = np.asarray(mask_pred).astype(bool)

    areas_by_code = create_table_neighbour_code_to_surface_area(spacing_mm)

    mask_all = mask_gt | mask_pred
    if not mask_all.any():
        return dict(_EMPTY)

    # bounding box crop with 1-voxel zero pad at the high side of each axis
    idx = np.nonzero(mask_all)
    bbox_min = np.array([a.min() for a in idx])
    bbox_max = np.array([a.max() for a in idx])

    shape = bbox_max - bbox_min + 2
    crop_gt = np.zeros(shape, np.uint8)
    crop_pred = np.zeros(shape, np.uint8)
    sl = tuple(slice(lo, hi + 1) for lo, hi in zip(bbox_min, bbox_max))
    crop_gt[:-1, :-1, :-1] = mask_gt[sl]
    crop_pred[:-1, :-1, :-1] = mask_pred[sl]

    code_gt = _neighbour_code(crop_gt)
    code_pred = _neighbour_code(crop_pred)

    borders_gt = (code_gt != 0) & (code_gt != 255)
    borders_pred = (code_pred != 0) & (code_pred != 255)

    if borders_gt.any():
        distmap_gt = _edt(~borders_gt, spacing_mm)
    else:
        distmap_gt = np.full(borders_gt.shape, np.inf)
    if borders_pred.any():
        distmap_pred = _edt(~borders_pred, spacing_mm)
    else:
        distmap_pred = np.full(borders_pred.shape, np.inf)

    area_map_gt = areas_by_code[code_gt]
    area_map_pred = areas_by_code[code_pred]

    distances_gt_to_pred = distmap_pred[borders_gt]
    distances_pred_to_gt = distmap_gt[borders_pred]
    surfel_areas_gt = area_map_gt[borders_gt]
    surfel_areas_pred = area_map_pred[borders_pred]

    if distances_gt_to_pred.size:
        order = np.lexsort((surfel_areas_gt, distances_gt_to_pred))
        distances_gt_to_pred = distances_gt_to_pred[order]
        surfel_areas_gt = surfel_areas_gt[order]
    if distances_pred_to_gt.size:
        order = np.lexsort((surfel_areas_pred, distances_pred_to_gt))
        distances_pred_to_gt = distances_pred_to_gt[order]
        surfel_areas_pred = surfel_areas_pred[order]

    return {
        "distances_gt_to_pred": distances_gt_to_pred,
        "distances_pred_to_gt": distances_pred_to_gt,
        "surfel_areas_gt": surfel_areas_gt,
        "surfel_areas_pred": surfel_areas_pred,
    }


def compute_robust_hausdorff(surface_distances: Dict[str, np.ndarray], percent: float) -> float:
    """Area-weighted percentile Hausdorff distance (HD95 at percent=95)."""
    d_g2p = surface_distances["distances_gt_to_pred"]
    d_p2g = surface_distances["distances_pred_to_gt"]
    a_g = surface_distances["surfel_areas_gt"]
    a_p = surface_distances["surfel_areas_pred"]

    if len(d_g2p) > 0:
        cum = np.cumsum(a_g) / np.sum(a_g)
        i = np.searchsorted(cum, percent / 100.0)
        perc_g2p = d_g2p[min(i, len(d_g2p) - 1)]
    else:
        perc_g2p = np.inf
    if len(d_p2g) > 0:
        cum = np.cumsum(a_p) / np.sum(a_p)
        i = np.searchsorted(cum, percent / 100.0)
        perc_p2g = d_p2g[min(i, len(d_p2g) - 1)]
    else:
        perc_p2g = np.inf
    return max(perc_g2p, perc_p2g)


def compute_average_surface_distance(
    surface_distances: Dict[str, np.ndarray]
) -> Tuple[float, float]:
    """Area-weighted mean surface distance, both directions."""
    d_g2p = surface_distances["distances_gt_to_pred"]
    d_p2g = surface_distances["distances_pred_to_gt"]
    a_g = surface_distances["surfel_areas_gt"]
    a_p = surface_distances["surfel_areas_pred"]
    return (
        np.sum(d_g2p * a_g) / np.sum(a_g),
        np.sum(d_p2g * a_p) / np.sum(a_p),
    )


def compute_surface_overlap_at_tolerance(
    surface_distances: Dict[str, np.ndarray], tolerance_mm: float
) -> Tuple[float, float]:
    d_g2p = surface_distances["distances_gt_to_pred"]
    d_p2g = surface_distances["distances_pred_to_gt"]
    a_g = surface_distances["surfel_areas_gt"]
    a_p = surface_distances["surfel_areas_pred"]
    return (
        np.sum(a_g[d_g2p <= tolerance_mm]) / np.sum(a_g),
        np.sum(a_p[d_p2g <= tolerance_mm]) / np.sum(a_p),
    )


def compute_surface_dice_at_tolerance(
    surface_distances: Dict[str, np.ndarray], tolerance_mm: float
) -> float:
    d_g2p = surface_distances["distances_gt_to_pred"]
    d_p2g = surface_distances["distances_pred_to_gt"]
    a_g = surface_distances["surfel_areas_gt"]
    a_p = surface_distances["surfel_areas_pred"]
    overlap = np.sum(a_g[d_g2p <= tolerance_mm]) + np.sum(a_p[d_p2g <= tolerance_mm])
    return overlap / (np.sum(a_g) + np.sum(a_p))


def compute_dice_coefficient(mask_gt: np.ndarray, mask_pred: np.ndarray) -> float:
    """Volumetric Soerensen-Dice; NaN when both masks are empty."""
    mask_gt = np.asarray(mask_gt).astype(bool)
    mask_pred = np.asarray(mask_pred).astype(bool)
    volume_sum = mask_gt.sum() + mask_pred.sum()
    if volume_sum == 0:
        return float("nan")
    return 2.0 * (mask_gt & mask_pred).sum() / volume_sum
