"""Exact static sliding-window inference with constant or Gaussian blending.

Counterpart of `fcd_tpu/infer/sliding_window.py::sliding_window_inference`
(the static-grid engine, :526) for dense patches: symmetric padding up to
the roi, the MONAI-parity dense patch grid, patches run in batches of
`sw_batch`, each patch's logits weighted by the importance map and summed
in patch order, then multiplied by the reciprocal coverage and cropped
back. The volume enters through `kernels/sw_io.py::sw_entry` (pad + cast,
B17's function) and leaves through `sw_exit` (coverage multiply + crop,
B6's function), once per call each. `compute_dtype` is the JAX engine's
argument of that name, the dtype the volume enters in: the JAX trainer
passes bf16 whenever use_amp, whatever its model computes in, and f32
without (`fcd_tpu/train/trainer.py:282-284`; the port's trainer follows
it, `train/trainer.py::entry_dtype_for`), so an f16 model gets
bf16-rounded patches. B17 serves bf16, as the JAX engine's Pallas entry
does (`fcd_tpu/infer/sliding_window.py:274-278`); another dtype enters
padded with a cast (`F.pad`). The exit takes the f32 accumulator either
way.
The accumulation itself is plain PyTorch, as the JAX package leaves it to
XLA on this path. The reciprocal
coverage and the importance map stay on the device, cached per grid, as
`fcd_tpu/infer/sliding_window.py:429-457` caches them. The s2d patch/logit
options of the JAX engine are TPU layout and have no counterpart here;
`flat_output` returns the same bytes as a (D, H, W*O) view.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels.sw_io import (
    entry_pad,
    entry_pad_arg,
    sw_entry,
    sw_exit,
)


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


@functools.lru_cache(maxsize=8)
def _device_grid_constants(padded_shape, roi_size, overlap: float, blend: str,
                           sigma_scale: float, device: torch.device):
    """(importance map (rd, rh, rw, 1), reciprocal coverage (PD, PH, PW, 1))
    f32 on `device`, built once per grid: uploading the coverage costs
    ~29 MB per call at 182x218x182."""
    imp = _importance(roi_size, blend, sigma_scale)[..., None]
    inv = inverse_coverage(padded_shape, roi_size, overlap, blend, sigma_scale)
    return (torch.from_numpy(imp).to(device),
            torch.from_numpy(inv).to(device))


@torch.no_grad()
def sliding_window_inference(volume, predictor: Callable, *,
                             roi_size: Sequence[int], out_channels: int,
                             sw_batch: int = 1, overlap: float = 0.25,
                             blend: str = "constant",
                             sigma_scale: float = 0.125,
                             compute_dtype=torch.float32,
                             flat_output: bool = False,
                             device=None) -> torch.Tensor:
    """Run `predictor` ((B, rd, rh, rw, C) -> (B, rd, rh, rw, out_channels))
    over a (D, H, W, C) volume in overlapping roi-size patches and blend
    the logits. Returns (D, H, W, out_channels) float32 on `device` (the
    volume's device when None), or its (D, H, W * out_channels) view with
    `flat_output` (the JAX engine's flat return, C-order bytes of the same
    volume)."""
    roi = tuple(int(r) for r in roi_size)
    vol, (d, h, w) = enter_volume(volume, roi, compute_dtype, device)
    pd, ph, pw = vol.shape[:3]
    starts = [tuple(int(v) for v in s)
              for s in dense_patch_starts((pd, ph, pw), roi, overlap)]
    imp, inv_cnt = _device_grid_constants((pd, ph, pw), roi, float(overlap),
                                          blend, float(sigma_scale),
                                          vol.device)
    acc = torch.zeros((pd, ph, pw, out_channels), dtype=torch.float32,
                      device=vol.device)
    blend_patches(acc, vol, starts, len(starts), predictor, roi, sw_batch,
                  imp)
    start = [before for before, _ in entry_pad((d, h, w), roi)]
    out = sw_exit(acc, inv_cnt, start, (d, h, w))
    return out.view(d, h, w * out_channels) if flat_output else out


def enter_volume(volume, roi, compute_dtype, device=None):
    """(the padded volume in compute_dtype on `device`, the volume's
    (D, H, W)): B17 for bf16, a pad and a cast otherwise."""
    vol = torch.as_tensor(volume)
    if device is not None:
        vol = vol.to(device)
    vol = vol.to(torch.float32).contiguous()
    d, h, w, _ = vol.shape
    if compute_dtype == torch.bfloat16:
        vol = sw_entry(vol, roi, compute_dtype)
    else:
        vol = F.pad(vol, entry_pad_arg((d, h, w), roi)).to(compute_dtype)
    return vol, (d, h, w)


def blend_patches(acc: torch.Tensor, vol: torch.Tensor, starts, n_valid: int,
                  predictor: Callable, roi, sw_batch: int,
                  imp: torch.Tensor) -> None:
    """Run the patches at `starts` through `predictor` in batches of
    sw_batch and add the first n_valid patches' logits, weighted by `imp`,
    into `acc` in order. A short last batch is padded with repeats of its
    last patch, and patches past n_valid are run but not blended (the JAX
    engine's validity weights)."""
    for i in range(0, len(starts), sw_batch):
        batch = starts[i:i + sw_batch]
        run = batch + [batch[-1]] * (sw_batch - len(batch))
        patches = torch.stack([vol[s0:s0 + roi[0], s1:s1 + roi[1],
                                   s2:s2 + roi[2]] for s0, s1, s2 in run])
        logits = predictor(patches).float()
        for j, (s0, s1, s2) in enumerate(batch[:max(n_valid - i, 0)]):
            acc[s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]] += \
                logits[j] * imp
