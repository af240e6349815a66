"""The port's metrics (`fcd_tpu_torch.metrics`, numpy and scipy host code
copied from the JAX package) against `fcd_tpu.metrics` on the same seeded
masks: voxel metrics, HD95, ROC-AUC, the surface distances, the
lesion-wise and the subject-level metrics, on random blobs and on the
empty and perfect cases. Equal, NaN where the JAX package gives NaN (the
same code on the same inputs; the port's C++ EDT and neighbour code are
built from its own copy of fcdops.cpp).
"""

import math

import numpy as np
import pytest
from scipy import ndimage

import fcd_tpu.metrics as jm
import fcd_tpu_torch.metrics as tm


def _same(got, want):
    """Equal numbers (NaN with NaN), recursively through dicts, lists and
    arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(got, want, equal_nan=True)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want


def _blobs(seed, shape=(28, 24, 30), n=4):
    """A seeded mask of n smoothed random blobs."""
    rng = np.random.RandomState(seed)
    m = np.zeros(shape, np.float32)
    for _ in range(n):
        c = [rng.randint(4, s - 4) for s in shape]
        r = rng.randint(2, 5)
        zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
        m[((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) < r * r] = 1
    noise = ndimage.gaussian_filter(rng.rand(*shape), 1.0) > 0.62
    return np.clip(m + noise, 0, 1).astype(np.float32)


CASES = {
    "blobs": lambda s: (_blobs(s), _blobs(s + 100)),
    "perfect": lambda s: (_blobs(s), _blobs(s)),
    "empty_pred": lambda s: (np.zeros((20, 20, 20), np.float32), _blobs(s, (20, 20, 20))),
    "empty_gt": lambda s: (_blobs(s, (20, 20, 20)), np.zeros((20, 20, 20), np.float32)),
    "both_empty": lambda s: (np.zeros((16, 16, 16), np.float32),) * 2,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_voxel_metrics_match(case):
    preds, gts = zip(*(CASES[case](s) for s in range(3)))
    for roc in (False, True):
        for hd in (False, True):
            _same(tm.calculate_voxel_level_metrics(preds, gts, roc, hd),
                  jm.calculate_voxel_level_metrics(preds, gts, roc, hd))
    _same(tm.calculate_voxel_level_metrics(preds, gts, True, True, True),
          jm.calculate_voxel_level_metrics(preds, gts, True, True, True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hd95_and_roc_auc_match(case):
    pred, gt = CASES[case](1)
    _same(tm.hausdorff_distance_95(pred, gt), jm.hausdorff_distance_95(pred, gt))
    _same(tm.hausdorff_distance_95(pred, gt, spacing=(1.0, 0.9, 1.3)),
          jm.hausdorff_distance_95(pred, gt, spacing=(1.0, 0.9, 1.3)))
    rng = np.random.RandomState(2)
    scores = np.round(rng.rand(pred.size), 2)   # ties
    _same(tm.roc_auc(scores, gt.ravel()), jm.roc_auc(scores, gt.ravel()))


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (1.2, 0.8, 1.0)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_distances_match(case, spacing):
    pred, gt = (m.astype(bool) for m in CASES[case](3))
    got = tm.compute_surface_distances(gt, pred, spacing)
    want = jm.compute_surface_distances(gt, pred, spacing)
    _same(got, want)
    for fn in ("compute_average_surface_distance",):
        _same(getattr(tm, fn)(got), getattr(jm, fn)(want))
    _same(tm.compute_robust_hausdorff(got, 95), jm.compute_robust_hausdorff(want, 95))
    _same(tm.compute_surface_overlap_at_tolerance(got, 1.5),
          jm.compute_surface_overlap_at_tolerance(want, 1.5))
    _same(tm.compute_surface_dice_at_tolerance(got, 1.0),
          jm.compute_surface_dice_at_tolerance(want, 1.0))
    _same(tm.compute_dice_coefficient(gt, pred), jm.compute_dice_coefficient(gt, pred))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lesion_and_subject_metrics_match(case):
    preds, gts = zip(*(CASES[case](s) for s in (4, 5)))
    _same(tm.calculate_lesion_wise_metrics(list(preds), list(gts)),
          jm.calculate_lesion_wise_metrics(list(preds), list(gts)))
    _same(tm.calculate_subject_level_metrics(list(preds), list(gts)),
          jm.calculate_subject_level_metrics(list(preds), list(gts)))
    _same(tm.dice(preds[0], gts[0]), jm.dice(preds[0], gts[0]))


def test_public_names_match():
    assert tm.__all__ == jm.__all__
