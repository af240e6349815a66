"""In-memory dataset + prefetching patch loader.

Host-side replacement for the reference's MONAI Dataset/DataLoader stack
(train.py:71-96): volumes are loaded once (RAS, NaN-scrubbed, label
resampled onto the image grid, percentile-scaled — get_transforms.py:50-66),
cached in RAM, and a background thread assembles pos/neg-balanced patch
batches so the device never waits on NIfTI decode. Random augmentation
runs on device (fcd_tpu_torch.data.augment), not here.

A copy of `fcd_tpu/data/dataset.py`, kept so that the port never imports the
JAX package; one seed gives the JAX package's batches bit for bit.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fcd_tpu_torch.data import nifti
from fcd_tpu_torch.data.manifest import get_data
from fcd_tpu_torch.data.preprocess import replace_nan, resample_to_match, scale_channels
from fcd_tpu_torch.data.sampling import PosNegCropSampler


@dataclass
class Volume:
    subject: str
    image: np.ndarray           # (D, H, W, C) float32, scaled
    label: np.ndarray           # (D, H, W, 1) float32
    affine: np.ndarray
    fg_indices: np.ndarray = field(default=None)


def _triple(x) -> Tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x),) * 3


def load_volume(entry: Dict[str, Any], dtype=np.float32) -> Volume:
    """Load one manifest entry through the deterministic transform chain."""
    imgs = []
    ref_img = None
    for p in entry["image"]:
        img = nifti.load_ras(p)
        if ref_img is None:
            ref_img = img
        data = replace_nan(img.data)
        if img.data.shape != ref_img.data.shape:
            data = resample_to_match(data, img.affine, ref_img.data.shape,
                                     ref_img.affine, order=1)
        imgs.append(data)
    image = np.stack(imgs, axis=-1)
    image = scale_channels(image)

    lbl = nifti.load_ras(entry["label"])
    label = resample_to_match(lbl.data, lbl.affine, ref_img.data.shape,
                              ref_img.affine, order=0)
    label = (label > 0).astype(np.float32)[..., None]
    return Volume(
        subject=entry.get("subject", ""),
        image=image.astype(dtype),
        label=label,
        affine=ref_img.affine,
    )


class FCDDataset:
    """Cached dataset over a subject manifest."""

    def __init__(self, data_dir: str, params: Dict[str, Any],
                 subjects: Optional[Sequence[str]] = None, verbose: bool = True):
        self.params = params
        entries = get_data(data_dir, params, list(subjects) if subjects else None)
        self.volumes: List[Volume] = []
        for e in entries:
            v = load_volume(e)
            v.fg_indices = np.flatnonzero(v.label[..., 0].ravel() > 0)
            self.volumes.append(v)
        if verbose:
            print(f"FCDDataset: loaded {len(self.volumes)} subjects")

    def __len__(self):
        return len(self.volumes)

    def __getitem__(self, i) -> Volume:
        return self.volumes[i]


class PatchLoader:
    """Training loader: per step, `batch_size` subjects x `samples_per_case`
    pos/neg-balanced crops -> one (B, *patch, C) numpy batch, prefetched on a
    background thread (the process-pool-free analogue of DataLoader
    workers, train.py:77-84)."""

    def __init__(self, dataset: FCDDataset, params: Dict[str, Any], seed: int = 0):
        self.ds = dataset
        self.patch_size = _triple(params["patch_size"])
        self.batch_size = params.get("batch_size", 1)
        self.samples_per_case = params.get("samples_per_case", 4)
        self.sampler = PosNegCropSampler(self.patch_size, pos=1.0, neg=1.0)
        self.rng = np.random.RandomState(seed)
        self.prefetch = 2

    def steps_per_epoch(self) -> int:
        return max(1, (len(self.ds) + self.batch_size - 1) // self.batch_size)

    def _sample_neg_center(self, vol: Volume) -> np.ndarray:
        """Rejection-sample a background voxel (labels are sparse, so this
        converges immediately; avoids materializing huge bg index lists)."""
        shape = vol.label.shape[:3]
        for _ in range(64):
            c = np.array([self.rng.randint(s) for s in shape])
            if vol.label[c[0], c[1], c[2], 0] == 0:
                return c
        return np.array([s // 2 for s in shape])

    def _crops_for(self, vol: Volume, n: int):
        shape = np.asarray(vol.label.shape[:3])
        patch = np.asarray(self.patch_size)
        imgs, lbls = [], []
        for _ in range(n):
            if self.rng.rand() < self.sampler.pos_ratio and vol.fg_indices.size > 0:
                center = np.array(np.unravel_index(
                    vol.fg_indices[self.rng.randint(vol.fg_indices.size)], tuple(shape)))
            else:
                center = self._sample_neg_center(vol)
            half_lo = patch // 2
            start = np.clip(center - half_lo, 0, np.maximum(shape - patch, 0))
            imgs.append(self.sampler.crop(vol.image, start))
            lbls.append(self.sampler.crop(vol.label, start))
        return imgs, lbls

    def _epoch_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.ds))
        for i in range(0, len(order), self.batch_size):
            sel = order[i : i + self.batch_size]
            imgs, lbls = [], []
            for j in sel:
                a, b = self._crops_for(self.ds[j], self.samples_per_case)
                imgs += a
                lbls += b
            yield np.stack(imgs).astype(np.float32), np.stack(lbls).astype(np.float32)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for batch in self._epoch_batches():
                    q.put(batch)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


class VolumeLoader:
    """Validation/test loader: full volumes, one subject at a time
    (train.py:89-96: batch_size 1, no workers)."""

    def __init__(self, dataset: FCDDataset):
        self.ds = dataset

    def __iter__(self) -> Iterator[Volume]:
        for v in self.ds.volumes:
            yield v

    def __len__(self):
        return len(self.ds)
