"""Metrics suite: voxel-level, lesion-wise, subject-level, surface distance.

A copy of `fcd_tpu/metrics/__init__.py`, kept so that the port never imports
the JAX package.
"""

from fcd_tpu_torch.metrics.lesion import (
    calculate_lesion_wise_metrics,
    calculate_subject_level_metrics,
    dice,
    get_gtseg_combined_by_dilation,
)
from fcd_tpu_torch.metrics.surface_distance import (
    compute_average_surface_distance,
    compute_dice_coefficient,
    compute_robust_hausdorff,
    compute_surface_dice_at_tolerance,
    compute_surface_distances,
    compute_surface_overlap_at_tolerance,
)
from fcd_tpu_torch.metrics.voxel import (
    calculate_voxel_level_metrics,
    hausdorff_distance_95,
    roc_auc,
)

__all__ = [
    "calculate_lesion_wise_metrics",
    "calculate_subject_level_metrics",
    "calculate_voxel_level_metrics",
    "compute_average_surface_distance",
    "compute_dice_coefficient",
    "compute_robust_hausdorff",
    "compute_surface_dice_at_tolerance",
    "compute_surface_distances",
    "compute_surface_overlap_at_tolerance",
    "dice",
    "get_gtseg_combined_by_dilation",
    "hausdorff_distance_95",
    "roc_auc",
]
