"""Binary morphology + connected components with native-first dispatch.

A copy of `fcd_tpu/postproc/morphology.py` over the port's own
`postproc/native.py`.

API mirrors the scipy/cc3d calls on the reference's post-processing and
lesion-matching paths (utils/utils_common.py:10-33, metrics.py:208-215),
backed by the C++ ops in fcd_tpu_torch/cpp/fcdops.cpp with scipy fallback.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from fcd_tpu_torch.postproc import native


def generate_binary_structure(rank: int = 3, connectivity: int = 1) -> np.ndarray:
    return ndimage.generate_binary_structure(rank, connectivity)


def connected_components(mask: np.ndarray, connectivity: int = 26) -> np.ndarray:
    """cc3d.connected_components parity: int labels, raster-first numbering."""
    res = native.native_connected_components(mask, connectivity)
    if res is not None:
        return res[0]
    structure = {
        6: ndimage.generate_binary_structure(3, 1),
        18: ndimage.generate_binary_structure(3, 2),
        26: ndimage.generate_binary_structure(3, 3),
    }[connectivity]
    labels, _ = ndimage.label(np.asarray(mask) > 0, structure=structure)
    return labels.astype(np.int32)


def binary_dilation(mask: np.ndarray, structure: np.ndarray = None,
                    iterations: int = 1) -> np.ndarray:
    if structure is None:
        structure = generate_binary_structure(3, 1)
    out = native.native_morph(mask, structure, iterations, erosion=False)
    if out is not None:
        return out.astype(bool)
    return ndimage.binary_dilation(mask, structure=structure, iterations=iterations)


def binary_erosion(mask: np.ndarray, structure: np.ndarray = None,
                   iterations: int = 1) -> np.ndarray:
    if structure is None:
        structure = generate_binary_structure(3, 1)
    out = native.native_morph(mask, structure, iterations, erosion=True)
    if out is not None:
        return out.astype(bool)
    return ndimage.binary_erosion(mask, structure=structure, iterations=iterations)


def binary_opening(mask: np.ndarray, structure: np.ndarray = None,
                   iterations: int = 1) -> np.ndarray:
    eroded = binary_erosion(mask, structure, iterations)
    return binary_dilation(eroded, structure, iterations)


def binary_fill_holes(mask: np.ndarray, structure: np.ndarray = None) -> np.ndarray:
    if structure is None:
        structure = generate_binary_structure(3, 1)
    out = native.native_fill_holes(mask, structure)
    if out is not None:
        return out.astype(bool)
    return ndimage.binary_fill_holes(mask, structure=structure)


def label_with_sizes(mask: np.ndarray, connectivity: int = 26) -> Tuple[np.ndarray, np.ndarray]:
    """Labels + per-label voxel counts (index 0 = background)."""
    labels = connected_components(mask, connectivity)
    n = int(labels.max())
    sizes = np.bincount(labels.ravel(), minlength=n + 1).astype(np.int64)
    sizes[0] = 0
    return labels, sizes
