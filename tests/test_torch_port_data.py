"""The port's data pipeline (CPU) against the JAX package, on the same
seeded numpy inputs.

* `PosNegCropSampler`: centres and crops equal.
* `load_volume`, `FCDDataset`, `VolumeLoader`: equal arrays from the same
  NIfTI files; `PatchLoader`: bit-equal batches over two epochs for one
  seed, on a set with a sparse label and an empty one (the RandomState
  stream is consumed in the JAX package's order).
* Augmentation: `draw_augment` draws on the host and `apply_augment`
  applies, so each transform is held to `fcd_tpu.data.augment` with the
  draws and the noise that JAX's own key splits give (the test repeats
  `_augment_one`'s jax.random calls to read them). Alone, with JAX's coin
  flips forced (jax.random.bernoulli patched to say which transform is
  on): flips, shift, noise and coarse dropout bit-equal, the rotation's
  image within rel 1e-5 (map_coordinates is one jitted program on the JAX
  side, its sums fused) and its labels equal, GridMask equal; then the
  whole chain against `augment_batch` at one key, and `scheduled_probs`
  over a grid of epochs.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.data import augment as ja
from fcd_tpu.data import dataset as jd
from fcd_tpu.data import nifti as jnifti
from fcd_tpu.data.sampling import PosNegCropSampler as JaxSampler
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.data import augment as ta
from fcd_tpu_torch.data import dataset as td
from fcd_tpu_torch.data.sampling import PosNegCropSampler

import torch_port_workers

torch_port_workers.share_cores()

SHAPE = (24, 20, 28)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Four subjects: T1 and FLAIR with a small lesion label, one with an
    empty label, one whose FLAIR lies on another grid (resampled)."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(0)
    for i, subj in enumerate(["s1", "s2", "s3", "s4"]):
        d = root / subj / "anat"
        os.makedirs(d)
        t1 = rng.rand(*SHAPE).astype(np.float32)
        gt = np.zeros(SHAPE, np.float32)
        if subj != "s3":
            c = rng.randint(4, 14, 3)
            gt[c[0]:c[0] + 5, c[1]:c[1] + 4, c[2]:c[2] + 6] = 1
        flair = t1 * 0.9 + gt
        aff = np.eye(4)
        if subj == "s4":
            flair = flair[::2]
            aff = np.diag([2.0, 1.0, 1.0, 1.0])
        jnifti.save(str(d / "t1_reg.nii.gz"), t1)
        jnifti.save(str(d / "flair_reg.nii.gz"), flair, aff)
        jnifti.save(str(d / "gt_reg.nii.gz"), gt)
    return str(root)


def _params(**kw):
    p = get_default_params()
    p.update(patch_size=8, batch_size=2, samples_per_case=3, **kw)
    return p


def test_sampler_centres_and_crops_match():
    rng = np.random.RandomState(1)
    label = (rng.rand(*SHAPE) > 0.97).astype(np.float32)
    vol = rng.rand(*SHAPE, 2).astype(np.float32)
    mine, theirs = PosNegCropSampler((8, 12, 32)), JaxSampler((8, 12, 32))
    fg, bg = mine.precompute(label)
    jfg, jbg = theirs.precompute(label)
    assert np.array_equal(fg, jfg) and np.array_equal(bg, jbg)
    a = mine.sample_centers(SHAPE, fg, bg, 9, np.random.RandomState(2))
    b = theirs.sample_centers(SHAPE, jfg, jbg, 9, np.random.RandomState(2))
    assert np.array_equal(a, b)
    for s in a:
        assert np.array_equal(mine.crop(vol, s), theirs.crop(vol, s))


def test_load_volume_and_volume_loader_match(data_dir):
    p = _params()
    mine = td.FCDDataset(data_dir, p, verbose=False)
    theirs = jd.FCDDataset(data_dir, p, verbose=False)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(td.VolumeLoader(mine), jd.VolumeLoader(theirs)):
        assert a.subject == b.subject
        for name in ("image", "label", "affine", "fg_indices"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    entry = {"image": [os.path.join(data_dir, "s4/anat/t1_reg.nii.gz"),
                       os.path.join(data_dir, "s4/anat/flair_reg.nii.gz")],
             "label": os.path.join(data_dir, "s4/anat/gt_reg.nii.gz"),
             "subject": "s4"}
    a, b = td.load_volume(entry), jd.load_volume(entry)
    assert np.array_equal(a.image, b.image) and np.array_equal(a.label,
                                                               b.label)


def test_patch_loader_batches_are_bit_equal(data_dir):
    """Two epochs from one seed: the same batches, in the same order."""
    p = _params()
    mine = td.PatchLoader(td.FCDDataset(data_dir, p, verbose=False), p, 7)
    theirs = jd.PatchLoader(jd.FCDDataset(data_dir, p, verbose=False), p, 7)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch() == 2
    n = 0
    for _ in range(2):
        for (xi, yi), (xj, yj) in zip(mine, theirs):
            assert xi.shape == (6, 8, 8, 8, 2) and yi.shape == (6, 8, 8, 8, 1)
            assert np.array_equal(xi, xj) and np.array_equal(yi, yj)
            n += 1
    assert n == 4


# -- augmentation ---------------------------------------------------------------

def _jax_draws(key, shape, coarse_prob, gridmask_prob):
    """The choices `_augment_one` draws from one sample's key
    (fcd_tpu/data/augment.py:78-133), read by repeating its jax.random
    calls: (flags, values, noise)."""
    keys = jax.random.split(key, 12)
    flags = {"flip": [bool(jax.random.bernoulli(k, 0.5)) for k in keys[:3]],
             "rotate": bool(jax.random.bernoulli(keys[3], 0.5)),
             "shift_on": bool(jax.random.bernoulli(keys[5], 0.5)),
             "noise_on": bool(jax.random.bernoulli(keys[7], 0.5)),
             "dropout_on": bool(jax.random.bernoulli(keys[10], coarse_prob))}
    angle = float(jax.random.uniform(keys[4], (), minval=-jnp.pi / 2,
                                     maxval=jnp.pi / 2))
    shift = float(jax.random.uniform(keys[6], (), minval=-0.1, maxval=0.1))
    std = float(jax.random.uniform(keys[8], (), minval=0.0, maxval=0.1))
    noise = np.array(jax.random.normal(keys[9], shape, jnp.float32))
    d, h, w = shape[:3]
    hole = (min(16, d), min(16, h), min(16, w))
    starts = np.asarray(jax.random.randint(
        keys[11], (5, 3), 0,
        jnp.array([max(d - hole[0], 1), max(h - hole[1], 1),
                   max(w - hole[2], 1)])))
    gm_key, apply_key = jax.random.split(keys[0])
    flags["gridmask_on"] = bool(jax.random.bernoulli(apply_key,
                                                     gridmask_prob))
    k_d, k_s = jax.random.split(gm_key)
    period = int(jax.random.randint(k_d, (), 16, 32))
    offsets = np.asarray(jax.random.randint(k_s, (3,), 0, period))
    values = dict(angle=angle, shift=shift, noise_std=std,
                  dropout_starts=starts, gridmask_period=period,
                  gridmask_offsets=offsets)
    return flags, values, noise


def _draws(samples):
    """The port's Draws from [(flags, values)] per sample."""
    col = lambda f: [f(fl, v) for fl, v in samples]  # noqa: E731
    f32, b = torch.float32, torch.bool
    return ta.Draws(
        flip=torch.tensor(col(lambda f, v: f["flip"]), dtype=b),
        rotate=torch.tensor(col(lambda f, v: f["rotate"]), dtype=b),
        angle=torch.tensor(col(lambda f, v: v["angle"]), dtype=f32),
        shift_on=torch.tensor(col(lambda f, v: f["shift_on"]), dtype=b),
        shift=torch.tensor(col(lambda f, v: v["shift"]), dtype=f32),
        noise_on=torch.tensor(col(lambda f, v: f["noise_on"]), dtype=b),
        noise_std=torch.tensor(col(lambda f, v: v["noise_std"]), dtype=f32),
        dropout_on=torch.tensor(col(lambda f, v: f["dropout_on"]), dtype=b),
        dropout_starts=torch.tensor(np.stack(col(
            lambda f, v: v["dropout_starts"])), dtype=torch.int64),
        gridmask_on=torch.tensor(col(lambda f, v: f["gridmask_on"]),
                                 dtype=b),
        gridmask_period=torch.tensor(col(lambda f, v: v["gridmask_period"]),
                                     dtype=torch.int64),
        gridmask_offsets=torch.tensor(np.stack(col(
            lambda f, v: v["gridmask_offsets"])), dtype=torch.int64))


def _sample(seed, shape=(20, 18, 26)):
    """A seeded image (two channels) and a label with blobs and edges."""
    rng = np.random.RandomState(seed)
    img = rng.randn(*shape, 2).astype(np.float32)
    lbl = np.zeros((*shape, 1), np.float32)
    lbl[4:12, 3:10, 6:20] = 1
    lbl[rng.rand(*shape, 1) < 0.05] = 1
    return img, lbl


# the coin flips of `_augment_one` in call order: three flips, then the
# rotation, shift, noise, coarse dropout and GridMask
COINS = ("flip0", "flip1", "flip2", "rotate", "shift_on", "noise_on",
         "dropout_on", "gridmask_on")


@pytest.mark.parametrize("on", [("flip0", "flip2"), ("flip1",), ("rotate",),
                                ("shift_on",), ("noise_on",),
                                ("dropout_on",), ("gridmask_on",)])
@pytest.mark.parametrize("seed", [0, 1])
def test_each_transform_matches_jax(monkeypatch, on, seed):
    """One transform (or flips) at a time: JAX's coin flips forced through
    a patched jax.random.bernoulli, its values from its key; the port fed
    the same values and noise."""
    img, lbl = _sample(seed)
    key = jax.random.PRNGKey(100 + seed)
    flags, values, noise = _jax_draws(key, img.shape, 1.0, 1.0)
    calls = []

    def coin(k, p=0.5, shape=None):
        calls.append(None)
        return jnp.asarray(COINS[len(calls) - 1] in on)

    monkeypatch.setattr(jax.random, "bernoulli", coin)
    want_i, want_l = ja._augment_one(jnp.asarray(img), jnp.asarray(lbl), key,
                                     jnp.float32(1.0), jnp.float32(1.0))
    monkeypatch.undo()
    assert len(calls) == len(COINS)
    forced = {"flip": [f"flip{i}" in on for i in range(3)],
              **{c: c in on for c in COINS[3:]}}
    draws = _draws([(forced, values)])
    got_i, got_l = ta.apply_augment(torch.from_numpy(img)[None],
                                    torch.from_numpy(lbl)[None], draws,
                                    torch.from_numpy(noise)[None])
    want_i, want_l = np.asarray(want_i), np.asarray(want_l)
    got_i, got_l = got_i[0].numpy(), got_l[0].numpy()
    assert np.array_equal(got_l, want_l)
    if "rotate" in on:
        assert abs(values["angle"]) > 1e-3
        rel = np.abs(got_i - want_i).max() / np.abs(want_i).max()
        assert rel <= 1e-5, rel
    else:
        assert np.array_equal(got_i, want_i)


@pytest.mark.parametrize("order", [0, 1])
def test_rotation_matches_map_coordinates(order):
    """rotate_y against fcd_tpu's _rotate_y at JAX-drawn angles: the label
    (order 0) equal, the image (order 1) within rel 1e-5."""
    for seed in range(4):
        img, lbl = _sample(10 + seed, (24, 10, 30))
        vol = lbl if order == 0 else img
        angle = jax.random.uniform(jax.random.PRNGKey(seed), (),
                                   minval=-jnp.pi / 2, maxval=jnp.pi / 2)
        want = np.asarray(ja._rotate_y(jnp.asarray(vol), angle, order))
        got = ta.rotate_y(torch.from_numpy(vol),
                          torch.tensor(float(angle)), order).numpy()
        if order == 0:
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_gridmask_matches_jax():
    for seed in range(6):
        img, _ = _sample(20 + seed, (18 + seed, 22, 16))
        key = jax.random.PRNGKey(seed)
        want = np.asarray(ja._gridmask(jnp.asarray(img), key, True))
        k_d, k_s = jax.random.split(key)
        period = int(jax.random.randint(k_d, (), 16, 32))
        offsets = np.asarray(jax.random.randint(k_s, (3,), 0, period))
        mask = ta.gridmask_mask(img.shape[:3], period, offsets.tolist())
        got = (torch.from_numpy(img) * mask[..., None]).numpy()
        assert np.array_equal(got, want)


def test_whole_chain_matches_augment_batch():
    """augment_batch at one key against apply_augment with its draws and
    noise: the labels equal, the images within rel 1e-5 (the rotation)."""
    imgs, lbls = zip(*(_sample(30 + i) for i in range(3)))
    imgs, lbls = np.stack(imgs), np.stack(lbls)
    key = jax.random.PRNGKey(7)
    want_i, want_l = ja.augment_batch(jnp.asarray(imgs), jnp.asarray(lbls),
                                      key, jnp.float32(0.6),
                                      jnp.float32(0.7))
    samples, noises = [], []
    for k in jax.random.split(key, 3):
        flags, values, noise = _jax_draws(k, imgs.shape[1:], 0.6, 0.7)
        samples.append((flags, values))
        noises.append(noise)
    draws = _draws(samples)
    got_i, got_l = ta.apply_augment(torch.from_numpy(imgs),
                                    torch.from_numpy(lbls), draws,
                                    torch.from_numpy(np.stack(noises)))
    want_i, want_l = np.asarray(want_i), np.asarray(want_l)
    assert np.array_equal(got_l.numpy(), want_l)
    assert (np.abs(got_i.numpy() - want_i).max()
            <= 1e-5 * np.abs(want_i).max())


def test_draw_augment_is_seeded_and_in_range():
    a = ta.draw_augment(6, (20, 40, 12), torch.Generator().manual_seed(3),
                        0.5, 0.5)
    b = ta.draw_augment(6, (20, 40, 12), torch.Generator().manual_seed(3),
                        0.5, 0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (a.angle.abs() <= math.pi / 2).all()
    assert (a.shift.abs() <= 0.1).all() and (a.noise_std >= 0).all()
    assert (a.noise_std <= 0.1).all()
    bound = torch.tensor([max(20 - 16, 1), max(40 - 16, 1), max(12 - 12, 1)])
    assert ((a.dropout_starts >= 0) & (a.dropout_starts < bound)).all()
    assert ((a.gridmask_period >= 16) & (a.gridmask_period < 32)).all()
    assert (a.gridmask_offsets < a.gridmask_period[:, None]).all()
    never = ta.draw_augment(6, (20, 40, 12), torch.Generator(), 0.0, 0.0)
    assert not never.dropout_on.any() and not never.gridmask_on.any()


def test_scheduled_probs_match():
    for max_epochs in (1, 2, 50):
        for cd, cd_start, gm, gm_start in ((0.0, 0, 0.0, 0), (0.5, 0, 0.3, 5),
                                           (0.8, 10, 1.0, 0)):
            p = dict(max_epochs=max_epochs, coarse_dropout_max_prob=cd,
                     coarse_dropout_start_epoch=cd_start,
                     gridmask_max_prob=gm, gridmask_start_epoch=gm_start)
            for epoch in range(0, 60, 3):
                assert ta.scheduled_probs(p, epoch) == ja.scheduled_probs(
                    p, epoch)
