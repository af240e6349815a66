"""Pos/neg-balanced patch sampling on the host.

RandCropByPosNegLabeld parity (get_transforms.py:63-67: pos=1, neg=1,
num_samples=samples_per_case): each sample's crop center is a random
foreground voxel with probability pos/(pos+neg), else a random background
voxel; centers are clamped so the fixed-size patch lies inside the volume.
Center selection is data-dependent and stays on host; the fixed-shape crop
is a cheap numpy slice feeding the device batch.

A copy of `fcd_tpu/data/sampling.py`, kept so that the port never imports the
JAX package; one seed gives the JAX package's batches bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class PosNegCropSampler:
    def __init__(self, patch_size: Sequence[int], pos: float = 1.0, neg: float = 1.0):
        self.patch_size = tuple(int(p) for p in patch_size)
        self.pos_ratio = pos / (pos + neg)

    def precompute(self, label: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Foreground / background voxel index lists for a (D,H,W) label."""
        flat = (np.asarray(label) > 0).ravel()
        fg = np.flatnonzero(flat)
        bg = np.flatnonzero(~flat)
        return fg, bg

    def sample_centers(
        self,
        shape: Sequence[int],
        fg: np.ndarray,
        bg: np.ndarray,
        n_samples: int,
        rng: np.random.RandomState,
    ) -> np.ndarray:
        """(n_samples, 3) clamped crop start coordinates."""
        shape = np.asarray(shape[:3])
        patch = np.asarray(self.patch_size)
        starts = np.zeros((n_samples, 3), np.int64)
        for i in range(n_samples):
            use_fg = (rng.rand() < self.pos_ratio) and fg.size > 0
            pool = fg if use_fg else (bg if bg.size > 0 else fg)
            center = np.array(np.unravel_index(pool[rng.randint(pool.size)], shape))
            # clamp so the patch fits (MONAI correct_crop_centers semantics)
            half_lo = patch // 2
            center = np.minimum(np.maximum(center, half_lo), np.maximum(shape - (patch - half_lo), half_lo))
            starts[i] = center - half_lo
            starts[i] = np.clip(starts[i], 0, np.maximum(shape - patch, 0))
        return starts

    def crop(self, volume: np.ndarray, start: np.ndarray) -> np.ndarray:
        """Fixed-size crop (pads with zeros if the volume is smaller than
        the patch along an axis)."""
        patch = self.patch_size
        d, h, w = volume.shape[:3]
        pd, ph, pw = patch
        pad = [(0, max(pd - d, 0)), (0, max(ph - h, 0)), (0, max(pw - w, 0))]
        if volume.ndim > 3:
            pad += [(0, 0)] * (volume.ndim - 3)
        if any(p[1] for p in pad):
            volume = np.pad(volume, pad)
        s = start
        return volume[s[0]:s[0]+pd, s[1]:s[1]+ph, s[2]:s[2]+pw]
