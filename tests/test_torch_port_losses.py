"""The port's loss family (`fcd_tpu_torch/losses/`) against the JAX
package's (`fcd_tpu/losses/`), f32 on the CPU, from the same numpy
logits, labels, thickness maps and sample masks.

* `make_combined_loss`: each of the five main losses alone and with each
  regulariser (total variation l1 and l2, boundary, cortical), with and
  without a sample mask; TV alone (no main loss) with l1 and l2, with
  exclude_borders on and off, with and without a mask. The value to rel
  1e-5 and its gradient with respect to the logits (torch autograd
  against jax.grad) to 1e-4 of max |grad|.
* Each function on its own (dice, CE, focal, generalized Dice with each
  weighting, TV, boundary, cortical), with and without a mask, alike.
* `dilate_mask` bit-equal to the JAX dilation; `_gradient` equal to
  numpy's np.gradient.

Both sides compute in f32; what differs is the order of the sums.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses import dice as jdice
from fcd_tpu.losses import extras as jextras
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses import dice, extras
from fcd_tpu_torch.losses.combined import make_combined_loss

import torch_port_workers

torch_port_workers.share_cores()

SHAPE = (3, 6, 8, 10)   # B, D, H, W
MAIN = ["DiceLoss", "DiceCELoss", "DiceFocalLoss", "GeneralizedDiceLoss",
        "GeneralizedDiceFocalLoss"]
EXTRAS = {
    "none": {},
    "tv l1": {"tv_loss_weight": 0.1},
    "tv l2": {"tv_loss_weight": 0.1, "tv_loss_norm": "l2"},
    "boundary": {"boundaryloss_weight": 0.1},
    "cortical": {"caloss_weight": 0.1},
}
MASK = np.array([1.0, 0.0, 1.0], np.float32)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


def _inputs(seed=0, c=2):
    rng = np.random.RandomState(seed)
    pred = (rng.normal(size=SHAPE + (c,)) * 2).astype(np.float32)
    label = np.zeros(SHAPE + (1,), np.float32)
    label[:, 1:4, 2:6, 3:8] = 1.0            # a box, so borders exist
    label[rng.rand(*SHAPE, 1) > 0.93] = 1.0
    thick = rng.uniform(1.5, 3.5, size=SHAPE + (1,)).astype(np.float32)
    return pred, label, thick


def _both(jfn, tfn, pred):
    """(jax value, jax grad, torch value, torch grad) of fn(pred)."""
    val, grad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    pt = torch.tensor(pred, requires_grad=True)
    got = tfn(pt)
    got.backward()
    return float(val), np.asarray(grad), float(got.detach()), pt.grad.numpy()


def _close(jval, jgrad, tval, tgrad):
    assert abs(tval - jval) <= 1e-5 * max(abs(jval), 1e-6), (tval, jval)
    scale = max(float(np.abs(jgrad).max()), 1e-30)
    assert float(np.abs(tgrad - jgrad).max()) <= 1e-4 * scale


def _combined(update, masked, seed=0):
    pred, label, thick = _inputs(seed)
    jp, tp = jax_default_params(), get_default_params()
    jp.update(update)
    tp.update(update)
    jfn, tfn = jax_combined_loss(jp), make_combined_loss(tp)
    jm = jnp.asarray(MASK) if masked else None
    tm = torch.tensor(MASK) if masked else None
    lab, th = jnp.asarray(label), jnp.asarray(thick)
    _close(*_both(lambda p: jfn(p, lab, th, jm),
                  lambda p: tfn(p, torch.tensor(label), torch.tensor(thick),
                                tm), pred))


@pytest.mark.parametrize("masked", [False, True], ids=["", "mask"])
@pytest.mark.parametrize("extra", list(EXTRAS))
@pytest.mark.parametrize("loss", MAIN)
def test_combined_loss_matches_jax(loss, extra, masked):
    _combined({"loss": loss, **EXTRAS[extra]}, masked)


@pytest.mark.parametrize("masked", [False, True], ids=["", "mask"])
@pytest.mark.parametrize("exclude", [False, True], ids=["", "borders"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_tv_alone_matches_jax(norm, exclude, masked):
    """An unknown main loss gives no main term in both packages: the
    total is the TV term alone."""
    _combined({"loss": "none", "tv_loss_weight": 1.0, "tv_loss_norm": norm,
               "tvloss_exclude_borders": exclude}, masked, seed=1)


def _fns():
    """(name, jax fn, torch fn) of (pred, label, thick, mask) -> loss."""
    ce_w = [1.0, 3.0, 0.5]
    out = [
        ("dice squared jaccard",
         lambda p, y, t, m: jdice.dice_loss(p, y, squared_pred=True,
                                            jaccard=True, sample_mask=m),
         lambda p, y, t, m: dice.dice_loss(p, y, squared_pred=True,
                                           jaccard=True, sample_mask=m)),
        ("dice per sample",
         lambda p, y, t, m: jdice.dice_loss(p, y, batch=False, sample_mask=m),
         lambda p, y, t, m: dice.dice_loss(p, y, batch=False, sample_mask=m)),
        ("ce weighted",
         lambda p, y, t, m: jdice.cross_entropy_loss(
             p, y, weight=jnp.asarray(ce_w), sample_mask=m),
         lambda p, y, t, m: dice.cross_entropy_loss(
             p, y, weight=torch.tensor(ce_w), sample_mask=m)),
        ("ce",
         lambda p, y, t, m: jdice.cross_entropy_loss(p, y, sample_mask=m),
         lambda p, y, t, m: dice.cross_entropy_loss(p, y, sample_mask=m)),
        ("focal sigmoid",
         lambda p, y, t, m: jdice.focal_loss(p, y, use_softmax=False,
                                             sample_mask=m),
         lambda p, y, t, m: dice.focal_loss(p, y, use_softmax=False,
                                            sample_mask=m)),
        ("focal with background",
         lambda p, y, t, m: jdice.focal_loss(p, y, include_background=True,
                                             gamma=1.5, sample_mask=m),
         lambda p, y, t, m: dice.focal_loss(p, y, include_background=True,
                                            gamma=1.5, sample_mask=m)),
        ("boundary",
         lambda p, y, t, m: jextras.boundary_loss(p, y, sample_mask=m),
         lambda p, y, t, m: extras.boundary_loss(p, y, sample_mask=m)),
        ("cortical",
         lambda p, y, t, m: jextras.cortical_boundary_loss(p, t,
                                                           sample_mask=m),
         lambda p, y, t, m: extras.cortical_boundary_loss(p, t,
                                                          sample_mask=m)),
    ]
    for w in ("square", "simple", "uniform"):
        for batch in (True, False):
            out.append((
                f"generalized dice {w}{'' if batch else ' per sample'}",
                lambda p, y, t, m, w=w, b=batch: jdice.generalized_dice_loss(
                    p, y, w_type=w, batch=b, sample_mask=m),
                lambda p, y, t, m, w=w, b=batch: dice.generalized_dice_loss(
                    p, y, w_type=w, batch=b, sample_mask=m)))
    return out


FNS = _fns()


@pytest.mark.parametrize("masked", [False, True], ids=["", "mask"])
@pytest.mark.parametrize("case", range(len(FNS)),
                         ids=[name for name, _, _ in FNS])
def test_each_loss_function_matches_jax(case, masked):
    _, jfn, tfn = FNS[case]
    pred, label, thick = _inputs(2, c=3)
    label = label * 2        # classes 0 and 2: class 1 is absent
    jm = jnp.asarray(MASK) if masked else None
    tm = torch.tensor(MASK) if masked else None
    _close(*_both(
        lambda p: jfn(p, jnp.asarray(label), jnp.asarray(thick), jm),
        lambda p: tfn(p, torch.tensor(label), torch.tensor(thick), tm), pred))


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("kernel_size", [3, 5])
def test_dilate_mask_is_bit_equal(kernel_size, iterations):
    rng = np.random.RandomState(4)
    mask = (rng.rand(2, 7, 9, 11, 1) > 0.985).astype(np.float32)
    want = np.asarray(jextras.dilate_mask(jnp.asarray(mask), kernel_size,
                                          iterations))
    got = extras.dilate_mask(torch.tensor(mask), kernel_size,
                             iterations).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert 0 < got.mean() < 1


def test_gradient_is_numpys():
    x = np.random.RandomState(5).normal(size=(2, 5, 6, 7, 2)).astype(
        np.float32)
    for ax in (1, 2, 3):
        got = extras._gradient(torch.tensor(x), ax).numpy()
        np.testing.assert_allclose(got, np.gradient(x, axis=ax), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            got, np.asarray(jextras._gradient(jnp.asarray(x), ax)))
