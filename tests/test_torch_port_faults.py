"""Two faults against the reference, on the CPU (ROADMAP C13, C14).

* C13: the compute type follows the JAX package's model factory (f32 with
  use_amp=False, else params['compute_dtype']). The card's kernels take
  bf16 only, so on a CUDA device every other setting raises
  NotImplementedError naming C13 when the trainer is built, before
  anything reaches the card; the CPU computes in f32 as before. A
  `torch.device("cuda")` needs no card to be built.
* C14: the port's Dice loss casts bf16 logits to f32 before its softmax;
  the JAX loss takes the softmax in bf16 and casts after. The two stay
  within a stated gap (see the test's docstring); the f32 cast is kept by
  decision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.losses.dice import dice_loss as jax_dice_loss
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.dice import dice_loss
from fcd_tpu_torch.train.trainer import ModelTrainer, compute_dtype_for

CUDA = torch.device("cuda")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); the loss gradient needs it on."""
    with torch.enable_grad():
        yield


def _params(**kw):
    params = get_default_params()
    params.update(feature_size=4, project_size=16, patch_size=32, **kw)
    return params


@pytest.mark.parametrize("setting", [
    {"use_amp": False},
    {"use_amp": False, "compute_dtype": "bfloat16"},
    {"compute_dtype": "float16"},
    {"compute_dtype": "float32"}])
def test_the_card_refuses_compute_types_its_kernels_do_not_take(setting):
    with pytest.raises(NotImplementedError, match="C13"):
        compute_dtype_for(_params(**setting), CUDA)
    with pytest.raises(NotImplementedError, match="C13"):
        ModelTrainer(_params(**setting), device="cuda")


@pytest.mark.parametrize("setting", [{}, {"use_amp": False},
                                     {"compute_dtype": "float16"}])
def test_compute_types(setting):
    """bf16 on the card by default; f32 on the CPU whatever the setting."""
    params = _params(**setting)
    if not setting:
        assert compute_dtype_for(params, CUDA) == torch.bfloat16
    assert compute_dtype_for(params, CPU) == torch.float32


def test_cpu_trainer_with_use_amp_false_runs_in_f32():
    tr = ModelTrainer(_params(use_amp=False), device="cpu")
    assert tr.compute_dtype == tr.model.compute_dtype == torch.float32
    x = torch.zeros(1, 32, 32, 32, 2)
    assert tr.predict(x).dtype == torch.float32


def test_dice_loss_on_bf16_logits_stays_within_the_stated_gap():
    """Seeded 2 x 16^3 x 2 logits, N(0, 9), a fifth of the labels
    foreground, cast to bf16, through both packages' dice_loss (DiceLoss
    defaults: softmax, one-hot labels, background excluded). Measured on
    the CPU with this seed: the loss differs by 7.1e-6 and the logit
    gradient by 3.2e-2 of max |grad|; a copy of the port's loss that takes
    the softmax in bf16 first and casts after, as JAX does, differs by
    9.4e-6 and 3.4e-2. The gap is the two frameworks' bf16 softmax and its
    backward, not where the cast sits, so the port keeps the f32 cast
    (ROADMAP C14), and this test holds the gap to loss 1e-4 and gradient
    5e-2 of max |grad|."""
    rng = np.random.RandomState(14)
    logits = rng.normal(0.0, 3.0, (2, 16, 16, 16, 2)).astype(np.float32)
    labels = (rng.rand(2, 16, 16, 16, 1) < 0.2).astype(np.float32)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jax_dice_loss(p, jnp.asarray(labels)))(jl)
    tl = torch.tensor(np.asarray(jl.astype(jnp.float32))).to(torch.bfloat16)
    tl.requires_grad_(True)
    loss = dice_loss(tl, torch.tensor(labels))
    loss.backward()
    jg = np.asarray(jgrad.astype(jnp.float32))
    g = tl.grad.float().numpy()
    assert tl.grad.dtype == torch.bfloat16 and jgrad.dtype == jnp.bfloat16
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4
    assert np.abs(g - jg).max() <= 5e-2 * np.abs(jg).max()
