"""Prediction post-processing: opening -> fill holes -> size filtering.

A copy of `fcd_tpu/postproc/segment.py` over the port's own morphology.

Parity target: utils/utils_common.py:10-33 (post_process_segment) and the
trainer hook train.py:167-182 (threshold the FCD channel, clean it up,
splice it back).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fcd_tpu_torch.postproc.morphology import (
    binary_fill_holes,
    binary_opening,
    connected_components,
)


def post_process_segment(mask: np.ndarray, l_min: int) -> Tuple[np.ndarray, np.ndarray]:
    """Binary opening (1 it, 6-conn cross) -> fill holes (5^3 structure) ->
    26-connected labeling (3^3 structure) -> drop components smaller than
    l_min voxels (l_min == -1 keeps only the largest). Returns
    (binary mask, relabeled components)."""
    mask = np.asarray(mask) > 0
    morphed = binary_opening(mask, iterations=1)
    morphed = binary_fill_holes(morphed, structure=np.ones((5, 5, 5), np.uint8))
    labels = connected_components(morphed, connectivity=26)
    n = int(labels.max())
    sizes = np.bincount(labels.ravel(), minlength=n + 1)
    sizes[0] = 0

    if l_min == -1:
        l_min = sizes.max() if n > 0 else 0

    output_msk = np.zeros(mask.shape, np.int64)
    output_lab = np.zeros(mask.shape, np.int64)
    count = 0
    for lab in range(1, n + 1):
        if sizes[lab] >= l_min and sizes[lab] > 0:
            count += 1
            sel = labels == lab
            output_msk[sel] = 1
            output_lab[sel] = count
    return output_msk, output_lab


def evaluate_fp(cc_labels: np.ndarray, label: np.ndarray) -> int:
    """Count predicted components with zero overlap with the ground truth
    (utils/utils_common.py:37-60)."""
    out = 0
    for lab in np.unique(cc_labels):
        if lab <= 0:
            continue
        if not np.logical_and(cc_labels == lab, label).any():
            out += 1
    return out


def post_process_prediction(predictions: np.ndarray, min_region_size: int,
                            threshold: float = 0.5) -> np.ndarray:
    """Threshold the FCD channel of (1, D, H, W, C) probabilities, clean it,
    splice back (train.py:167-182 semantics, channels-last)."""
    n_ch = predictions.shape[-1]
    fcd_idx = 0 if n_ch == 1 else 1
    binary = predictions[0, ..., fcd_idx] > threshold
    output_msk, _ = post_process_segment(binary, min_region_size)
    out = np.array(predictions, copy=True)
    out[0, ..., fcd_idx] = output_msk.astype(out.dtype)
    return out
