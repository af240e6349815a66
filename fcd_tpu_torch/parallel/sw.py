"""Mesh-sharded sliding-window inference: the patch grid as a parallel axis.

Counterpart of `fcd_tpu/parallel/sw.py::sharded_sliding_window_inference`.
The volume is replicated: every rank enters it through B17 (`sw_entry`;
a pad and a cast for other dtypes), runs its contiguous share of the patch
grid through the model into a local f32 accumulator, and one all-reduce
(sum) merges the ranks' accumulators. Then B6 (`sw_exit`) multiplies by
the cached reciprocal coverage of the whole grid and crops, so every rank
returns the full logits, as `out_specs=P()` replicates them. The patch
assignment is the JAX one (`fcd_tpu/parallel/sw.py:50-69`): each rank takes
per_dev = ceil(n / (sw_batch * ranks)) * sw_batch consecutive starts, the
grid padded with repeats of its last start that are run but not blended.
Blending is dense, as the JAX trainer's sharded path is (no s2d logits).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fcd_tpu_torch.infer.sliding_window import (
    _device_grid_constants,
    blend_patches,
    dense_patch_starts,
    enter_volume,
)
from fcd_tpu_torch.kernels.sw_io import entry_pad, sw_exit
from fcd_tpu_torch.parallel.mesh import Mesh, all_reduce_


def patch_shares(n: int, sw_batch: int, ranks: int):
    """(per_dev, total): the starts a rank takes and the padded grid's
    length, per_dev a multiple of sw_batch."""
    per_dev = -(-n // (sw_batch * ranks)) * sw_batch
    return per_dev, per_dev * ranks


@torch.no_grad()
def sharded_sliding_window_inference(
        volume, predictor: Callable, mesh: Mesh, *,
        roi_size: Sequence[int], out_channels: int, sw_batch: int = 2,
        overlap: float = 0.25, blend: str = "constant",
        sigma_scale: float = 0.125, compute_dtype=torch.float32,
        device=None) -> torch.Tensor:
    """Like `infer.sliding_window_inference` with the patch grid sharded
    over the mesh's ranks; every rank must call it. Returns the blended
    (D, H, W, out_channels) f32 logits on `device` (the mesh's when None),
    the same on every rank."""
    roi = tuple(int(r) for r in roi_size)
    vol, (d, h, w) = enter_volume(volume, roi, compute_dtype,
                                  mesh.device if device is None else device)
    pd, ph, pw = vol.shape[:3]
    starts = [tuple(int(v) for v in s)
              for s in dense_patch_starts((pd, ph, pw), roi, overlap)]
    n = len(starts)
    per_dev, total = patch_shares(n, sw_batch, mesh.size)
    starts += [starts[-1]] * (total - n)
    lo = mesh.rank * per_dev
    imp, inv_cnt = _device_grid_constants((pd, ph, pw), roi, float(overlap),
                                          blend, float(sigma_scale),
                                          vol.device)
    acc = torch.zeros((pd, ph, pw, out_channels), dtype=torch.float32,
                      device=vol.device)
    blend_patches(acc, vol, starts[lo:lo + per_dev], n - lo, predictor, roi,
                  sw_batch, imp)
    all_reduce_(mesh, acc)
    start = [before for before, _ in entry_pad((d, h, w), roi)]
    return sw_exit(acc, inv_cnt, start, (d, h, w))
