"""The port's patch-sharded sliding window (`parallel/sw.py`) on two gloo
ranks against the JAX package's on the conftest's 8 virtual devices (CPU).

(a) tests/test_sharded_sw.py's three cases with the same linear
predictor, at its tolerances: constant blending with sw_batch 2 against
the JAX sharded engine and the single-device engines (atol 1e-5); Gaussian
blending, which for a linear predictor gives the predictor itself (atol
1e-4); and the JAX s2d-patch case, which the port blends densely
(atol 1e-5).
(b) A small MS_DSA_NET (fs 4, P 16, patch 32, f32) through
`ModelTrainer.inference` under the mesh against the JAX trainer's sharded
inference with the same weights: the logits within rel 1e-4 of their
largest magnitude, test_torch_port_sw.py's engine tolerance; against the
port's own single-device inference within rel 1e-6 (only the order of the
accumulation differs).
(c) `python -m fcd_tpu_torch.cli.infer --device cpu --kwargs mesh_data=2`
against mesh_data=1 on one synthetic subject: two ranks, and rank 0's
saved mask and Dice/IoU equal to the one-process run's.

The two ranks are spawned once for the module (`torch_port_mesh_ranks`),
and each test reads one of their results.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.infer.sliding_window import sliding_window_inference
from fcd_tpu.parallel.mesh import make_mesh
from fcd_tpu.parallel.sw import sharded_sliding_window_inference
from fcd_tpu.train.trainer import ModelTrainer as JaxTrainer
from fcd_tpu_torch.parallel.mesh import launch

import torch_port_mesh_ranks as ranks

import torch_port_workers

torch_port_workers.share_cores()

CASES = [((24, 30, 20, 2), 0, 2, "constant"),
         ((20, 20, 34, 2), 1, 1, "gaussian"),
         ((24, 32, 24, 2), 2, 2, "constant")]
TRAINER = dict(model_type="MS_DSA_NET", feature_size=4, project_size=16,
               patch_size=32, sw_batch_size=2)
VOLUME = (40, 36, 44, 2)      # 8 patches of 32^3


def _jax_predictor(patches):
    c0, c1 = patches[..., 0], patches[..., 1]
    return jnp.stack([2 * c0 - c1, c0 + c1], axis=-1)


def _volume(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_trainer():
    jp = jax_default_params()
    jp.update(chans_in=2, chans_out=2, use_amp=False, **TRAINER)
    return JaxTrainer(jp, verbose=False)


@pytest.fixture(scope="module")
def port(jax_trainer):
    variables = jax.tree_util.tree_map(np.asarray, jax_trainer.variables)
    volumes = [(_volume(shape, seed), sw, blend)
               for shape, seed, sw, blend in CASES]
    trainer_case = (TRAINER, variables, _volume(VOLUME, 3))
    return launch(ranks.sharded_sw_checks, 2, volumes, trainer_case,
                  device_type="cpu", threads=1)


def test_every_rank_returns_the_same_logits(port):
    assert [r["mesh"] for r in port] == [(0, 2), (1, 2)]
    for a, b in zip(port[0]["sw"] + [port[0]["trainer"]],
                    port[1]["sw"] + [port[1]["trainer"]]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sharded_engine_matches_jax(port, case):
    shape, seed, sw_batch, blend = CASES[case]
    vol = jnp.asarray(_volume(shape, seed))
    got = port[0]["sw"][case]
    kw = dict(roi_size=(16, 16, 16), out_channels=2, sw_batch=sw_batch,
              overlap=0.25, blend=blend)
    if case == 0:
        # tests/test_sharded_sw.py::test_sharded_matches_single_device
        want = sharded_sliding_window_inference(vol, _jax_predictor,
                                                make_mesh(8, ("data",)), **kw)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        single = sliding_window_inference(vol, _jax_predictor, **kw)
        np.testing.assert_allclose(got, np.asarray(single), atol=1e-5)
        np.testing.assert_allclose(got, port[0]["single"][case], atol=1e-5)
    elif case == 1:
        # ::test_sharded_gaussian_blend
        np.testing.assert_allclose(got, np.asarray(_jax_predictor(vol)),
                                   atol=1e-4)
    else:
        # ::test_sharded_patch_s2d_matches_dense: the port's dense patches
        from fcd_tpu.kernels.block_conv import depth_to_space

        def s2d_predictor(patches_s2d):
            return _jax_predictor(depth_to_space(patches_s2d, 2))

        want = sharded_sliding_window_inference(
            vol, s2d_predictor, make_mesh(8, ("data",)), patch_s2d=True,
            **kw)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(_jax_predictor(vol)),
                                   atol=1e-5)


def test_trainer_inference_under_the_mesh_matches_jax(port, jax_trainer):
    assert jax_trainer.mesh is not None and jax_trainer.mesh.shape["data"] \
        == 8
    want = np.asarray(jax_trainer.inference(_volume(VOLUME, 3)))
    got = port[0]["trainer"]
    assert got.shape == want.shape == VOLUME[:3] + (2,)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4
    alone = port[0]["trainer_single"]
    assert np.abs(got - alone).max() / np.abs(alone).max() < 1e-6


def test_cli_infer_on_two_ranks_matches_one(tmp_path, monkeypatch):
    from fcd_tpu_torch.cli import infer as tcli
    from fcd_tpu_torch.data import nifti

    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # each spawned rank's
    rng = np.random.RandomState(4)
    subj = tmp_path / "data" / "sub-01"
    subj.mkdir(parents=True)
    vol = rng.rand(40, 36, 44).astype(np.float32)
    gt = np.zeros_like(vol)
    gt[10:24, 8:20, 12:30] = 1
    for name, data in (("t1_reg", vol + gt), ("flair_reg", 0.9 * vol + gt),
                       ("gt_reg", gt)):
        nifti.save(str(subj / f"{name}.nii.gz"), data)
    out = {}
    for n in ("1", "2"):
        save = tmp_path / f"out{n}"
        out[n] = tcli.main([
            "--data_dir", str(tmp_path / "data"), "--save_dir", str(save),
            "--checkpoint_path", "", "--device", "cpu", "--kwargs",
            "feature_size=4", "project_size=16", "patch_size=32",
            "use_amp=False", "min_region_size=1", f"mesh_data={n}"])
    assert out["2"] == out["1"] and set(out["1"]) == {"sub-01"}
    masks = [nifti.load(str(tmp_path / f"out{n}" / "sub-01" /
                            "sub-01_seg.nii.gz")).data for n in ("1", "2")]
    np.testing.assert_array_equal(masks[1], masks[0])
