"""Host-side deterministic preprocessing.

A copy of `fcd_tpu/data/preprocess.py` (numpy and scipy.ndimage), kept so
that the port never imports the JAX package.

Functional equivalents of the reference's MONAI transform chain
(get_transforms.py:50-100, 123-139): NaN scrub, RAS orientation (in
nifti.py), label-to-image grid resampling, isotropic-spacing resampling,
and channel-wise percentile intensity scaling. All pure numpy/scipy —
this is the load path feeding device arrays.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage


def replace_nan(x: np.ndarray, value: float = 0.0) -> np.ndarray:
    """ReplaceNaNd parity (get_transforms.py:16-35)."""
    return np.nan_to_num(x, nan=value)


def percentile_scale(
    x: np.ndarray, lower: float = 0.5, upper: float = 99.5,
    b_min: float = 0.0, b_max: float = 1.0, clip: bool = True,
) -> np.ndarray:
    """ScaleIntensityRangePercentilesd parity (channel-wise caller's duty):
    map [p_lower, p_upper] -> [b_min, b_max], clipped."""
    a_min = np.percentile(x, lower)
    a_max = np.percentile(x, upper)
    if a_max - a_min == 0:
        out = np.full_like(x, b_min, dtype=np.float32)
        return out
    out = (x.astype(np.float32) - a_min) / (a_max - a_min)
    out = out * (b_max - b_min) + b_min
    if clip:
        out = np.clip(out, b_min, b_max)
    return out


def scale_channels(x: np.ndarray, **kwargs) -> np.ndarray:
    """Channel-wise percentile scaling for (..., C) volumes."""
    return np.stack([percentile_scale(x[..., c], **kwargs) for c in range(x.shape[-1])], axis=-1)


def resample_to_match(
    src: np.ndarray, src_affine: np.ndarray,
    dst_shape: Sequence[int], dst_affine: np.ndarray,
    order: int = 0,
) -> np.ndarray:
    """ResampleToMatchd parity: resample `src` onto the destination grid
    (nearest for labels, order=1 for images)."""
    # voxel mapping: dst index -> world -> src index
    m = np.linalg.inv(src_affine) @ dst_affine
    if np.allclose(m, np.eye(4), atol=1e-5) and tuple(src.shape[:3]) == tuple(dst_shape):
        return src
    return ndimage.affine_transform(
        src, m[:3, :3], offset=m[:3, 3], output_shape=tuple(dst_shape),
        order=order, mode="constant", cval=0.0, prefilter=False,
    )


def resample_spacing(
    data: np.ndarray, affine: np.ndarray,
    new_spacing: Sequence[float] = (1.0, 1.0, 1.0),
    order: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Spacingd parity (get_transforms.py:129): resample to a target voxel
    spacing, keeping the world frame. Returns (data, new_affine)."""
    old_spacing = np.array([np.linalg.norm(affine[:3, i]) for i in range(3)])
    new_spacing = np.asarray(new_spacing, np.float64)
    if np.allclose(old_spacing, new_spacing, atol=1e-5):
        return data, affine
    old_shape = np.array(data.shape[:3])
    # MONAI computes the new shape via ceil of the physical extent ratio
    new_shape = np.maximum(
        np.ceil(old_shape * old_spacing / new_spacing).astype(int), 1
    )
    scale = new_spacing / old_spacing
    new_affine = affine.copy()
    new_affine[:3, :3] = affine[:3, :3] @ np.diag(scale)
    m = np.linalg.inv(affine) @ new_affine
    out = ndimage.affine_transform(
        data, m[:3, :3], offset=m[:3, 3], output_shape=tuple(new_shape),
        order=order, mode="constant", cval=0.0, prefilter=False,
    )
    return out, new_affine


def invert_to_grid(
    pred: np.ndarray, cur_affine: np.ndarray,
    orig_shape: Sequence[int], orig_affine: np.ndarray,
    order: int = 1,
) -> np.ndarray:
    """Invertd-style inverse spatial resampling of channel-last predictions
    back onto the native grid (get_transforms.py:145-151 semantics)."""
    out_ch = pred.shape[-1]
    chans = [
        resample_to_match(pred[..., c], cur_affine, orig_shape, orig_affine, order=order)
        for c in range(out_ch)
    ]
    return np.stack(chans, axis=-1)
