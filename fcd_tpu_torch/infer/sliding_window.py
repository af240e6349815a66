"""Exact static sliding-window inference with constant or Gaussian blending.

Counterpart of `fcd_tpu/infer/sliding_window.py::sliding_window_inference`
(the static-grid engine, :526) for dense patches: symmetric padding up to
the roi, the MONAI-parity dense patch grid, patches run in batches of
`sw_batch`, each patch's logits weighted by the importance map and summed
in patch order, then multiplied by the reciprocal coverage and cropped
back. Blending is plain PyTorch, as the JAX package leaves it to XLA on
this path. The s2d patch/logit options of the JAX engine are TPU layout
and have no counterpart here.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def dense_patch_starts(image_size: Sequence[int], roi_size: Sequence[int],
                       overlap: float) -> np.ndarray:
    """Start coordinates of the dense patch grid (MONAI parity):
    interval = round(roi * (1 - overlap)); the last patch is clamped flush
    to the end."""
    starts_per_axis = []
    for dim, roi in zip(image_size, roi_size):
        if roi >= dim:
            starts_per_axis.append([0])
            continue
        interval = max(int(roi * (1.0 - overlap)), 1)
        n = int(math.ceil((dim - roi) / interval)) + 1
        starts = [min(i * interval, dim - roi) for i in range(n)]
        seen, uniq = set(), []
        for s in starts:
            if s not in seen:
                seen.add(s)
                uniq.append(s)
        starts_per_axis.append(uniq)
    grid = np.stack(np.meshgrid(*starts_per_axis, indexing="ij"),
                    axis=-1).reshape(-1, len(image_size))
    return grid.astype(np.int32)


def gaussian_importance(roi_size: Sequence[int],
                        sigma_scale: float = 0.125) -> np.ndarray:
    """MONAI-style Gaussian importance map: centred, sigma = sigma_scale *
    roi, normalised to max 1, floored at 1e-3."""
    grids = []
    for r in roi_size:
        center = (r - 1) / 2.0
        sigma = sigma_scale * r
        x = np.arange(r, dtype=np.float64)
        grids.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    imp = functools.reduce(np.multiply.outer, grids)
    imp = imp / imp.max()
    return np.maximum(imp, 1e-3).astype(np.float32)


def _importance(roi_size, blend: str, sigma_scale: float) -> np.ndarray:
    if blend == "gaussian":
        return gaussian_importance(roi_size, sigma_scale)
    if blend == "constant":
        return np.ones(roi_size, np.float32)
    raise ValueError(f"Unsupported blend: {blend}")


def inverse_coverage(padded_shape, roi_size, overlap: float, blend: str,
                     sigma_scale: float) -> np.ndarray:
    """Reciprocal blend coverage (D, H, W, 1) f32 of the patch grid."""
    starts = dense_patch_starts(padded_shape, roi_size, overlap)
    imp = _importance(roi_size, blend, sigma_scale)
    cnt = np.zeros(padded_shape, np.float32)
    for sd, sh, sw in starts:
        cnt[sd:sd + roi_size[0], sh:sh + roi_size[1], sw:sw + roi_size[2]] += imp
    return (1.0 / np.maximum(cnt, 1e-8))[..., None]


@torch.no_grad()
def sliding_window_inference(volume, predictor: Callable, *,
                             roi_size: Sequence[int], out_channels: int,
                             sw_batch: int = 1, overlap: float = 0.25,
                             blend: str = "constant",
                             sigma_scale: float = 0.125,
                             compute_dtype=torch.float32,
                             device=None) -> torch.Tensor:
    """Run `predictor` ((B, rd, rh, rw, C) -> (B, rd, rh, rw, out_channels))
    over a (D, H, W, C) volume in overlapping roi-size patches and blend
    the logits. Returns (D, H, W, out_channels) float32 on `device` (the
    volume's device when None)."""
    roi = tuple(int(r) for r in roi_size)
    vol = torch.as_tensor(volume)
    if device is not None:
        vol = vol.to(device)
    d, h, w, _ = vol.shape
    pad = [max(r - s, 0) for r, s in zip(roi, (d, h, w))]
    if any(pad):
        # symmetric padding (MONAI pads half before, half after)
        cfg = []
        for p in reversed(pad):
            cfg += [p // 2, p - p // 2]
        vol = F.pad(vol, [0, 0] + cfg)
    pd, ph, pw = vol.shape[:3]
    vol = vol.to(compute_dtype)
    starts = [tuple(int(v) for v in s)
              for s in dense_patch_starts((pd, ph, pw), roi, overlap)]
    imp = torch.from_numpy(_importance(roi, blend, sigma_scale)[..., None]
                           ).to(vol.device)
    inv_cnt = torch.from_numpy(inverse_coverage(
        (pd, ph, pw), roi, overlap, blend, sigma_scale)).to(vol.device)
    acc = torch.zeros((pd, ph, pw, out_channels), dtype=torch.float32,
                      device=vol.device)
    for i in range(0, len(starts), sw_batch):
        batch = starts[i:i + sw_batch]
        # the last batch is padded with repeats of its last patch, which
        # are run but not blended (the JAX engine's validity weights)
        run = batch + [batch[-1]] * (sw_batch - len(batch))
        patches = torch.stack([vol[s0:s0 + roi[0], s1:s1 + roi[1],
                                   s2:s2 + roi[2]] for s0, s1, s2 in run])
        logits = predictor(patches).float()
        for j, (s0, s1, s2) in enumerate(batch):
            acc[s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]] += \
                logits[j] * imp
    out = acc * inv_cnt
    if any(pad):
        out = out[pad[0] // 2:pad[0] // 2 + d, pad[1] // 2:pad[1] // 2 + h,
                  pad[2] // 2:pad[2] // 2 + w]
    return out
