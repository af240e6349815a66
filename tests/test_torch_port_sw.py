"""The port's sliding-window engine and ModelTrainer against the JAX
package (CPU).

(c) the patch grid and the Gaussian importance map are equal to the JAX
ones, and the engine matches the JAX static engine (fp32) on a volume
smaller than the roi on one axis and larger on the others;
(d) ModelTrainer(params, device="cpu").inference runs end to end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcd_tpu.infer import sliding_window as jsw
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.infer import sliding_window as tsw
from fcd_tpu_torch.train.trainer import ModelTrainer

torch.set_grad_enabled(False)


@pytest.mark.parametrize("image,roi,overlap", [
    ((182, 218, 182), (128, 128, 128), 0.25),
    ((10, 40, 23), (16, 16, 16), 0.25),
    ((64, 70, 33), (32, 32, 32), 0.5),
])
def test_dense_patch_starts_equal_jax(image, roi, overlap):
    np.testing.assert_array_equal(
        tsw.dense_patch_starts(image, roi, overlap),
        jsw.dense_patch_starts(image, roi, overlap))


@pytest.mark.parametrize("roi,sigma", [((16, 16, 16), 0.125),
                                       ((8, 12, 20), 0.25)])
def test_gaussian_importance_equal_jax(roi, sigma):
    np.testing.assert_array_equal(tsw.gaussian_importance(roi, sigma),
                                  jsw.gaussian_importance(roi, sigma))


def _predictor_weights(cin, cout):
    rng = np.random.RandomState(9)
    return (rng.randn(cin, cout).astype(np.float32),
            rng.randn(cin, cout).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.mark.parametrize("blend,sw_batch", [("constant", 1), ("gaussian", 2)])
def test_sliding_window_matches_jax_engine(blend, sw_batch):
    """A patch-dependent predictor (per-voxel map plus the patch mean), so
    every overlap is blended from different values."""
    w1, w2, b = _predictor_weights(2, 3)
    vol = np.random.RandomState(4).randn(10, 40, 23, 2).astype(np.float32)
    roi = (16, 16, 16)

    def jax_predictor(p):
        return (p @ w1 + jnp.mean(p, axis=(1, 2, 3), keepdims=True) @ w2 + b)

    t1, t2, tb = (torch.from_numpy(a) for a in (w1, w2, b))

    def torch_predictor(p):
        return p @ t1 + p.mean(dim=(1, 2, 3), keepdim=True) @ t2 + tb

    want = np.asarray(jsw.sliding_window_inference(
        jnp.asarray(vol), jax_predictor, roi_size=roi, out_channels=3,
        sw_batch=sw_batch, overlap=0.25, blend=blend,
        compute_dtype=jnp.float32))
    got = tsw.sliding_window_inference(
        vol, torch_predictor, roi_size=roi, out_channels=3,
        sw_batch=sw_batch, overlap=0.25, blend=blend,
        compute_dtype=torch.float32, device="cpu")
    assert got.shape == want.shape == (10, 40, 23, 3)
    assert got.dtype == torch.float32
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-4, rel


def test_model_trainer_cpu_inference_runs():
    params = get_default_params()
    params.update(feature_size=4, patch_size=32, project_size=16,
                  sw_batch_size=2)
    trainer = ModelTrainer(params, device="cpu")
    assert trainer.device.type == "cpu"
    assert trainer.compute_dtype == torch.float32
    vol = np.random.RandomState(0).randn(40, 30, 36, 2).astype(np.float32)
    logits = trainer.inference(vol)
    assert logits.shape == (40, 30, 36, 2)
    assert logits.dtype == torch.float32 and logits.device.type == "cpu"
    assert torch.isfinite(logits).all()
    probs = trainer._activate(logits)
    assert isinstance(probs, np.ndarray)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
