"""The port's data-parallel train step (`parallel/dp.py`) on gloo ranks
against the JAX package's on the conftest's 8 virtual devices, and the
training CLI on a mesh (CPU).

(a) BaseUNet fs 4, f32, DiceLoss, a batch of 8 over 2 ranks, one AdamW
step from the JAX initialisation, against `make_dp_train_step` on 8
devices at tests/test_parallel.py's tolerances: the loss within rel 1e-5,
the first parameter leaf within rtol 2e-5 / atol 1e-7 (the port's BaseUNet
needs 32^3 patches, where the JAX test takes 16^3).
(b) The ragged batch: 6 samples over 4 ranks, padded with cyclic repeats
to 8 and masked out of the DiceCE loss, against the JAX single-device
step on the 6 samples, as tests/test_parallel.py::
test_dp_ragged_batch_pad_and_mask holds the JAX mesh step, at its
tolerances.
(c) Batch norm (VNet) and dropout (MS_DSA_NET with its channel and
attention dropout on): the port's data-parallel step against the port's
single-device step from the same state and generator, which no JAX
stream can match (ROADMAP C2). The loss within rel 1e-5 (measured: equal
bits), which a wrong dropout mask would break; every gradient leaf within
rel-L2 1e-2 (C10's per-leaf rule: MS_DSA_NET's 1-voxel level 6 at 32^3
amplifies the changed order of the batch sums; measured at most 5.1e-3
there and 3.3e-4 in VNet), but for leaves whose norm is under 1e-4 of
the largest leaf's, sums that cancel (a bias feeding a norm: 1e-10 of
rounding noise), which must stay under it; the batch-norm running
statistics (VNet's, and those of MS_DSA_NET's transformer conv branches)
within rtol 1e-5 plus 1e-5 of the leaf's largest magnitude (a batch mean
that cancels to 1e-3 of its terms reads 8e-5 apart in relative terms).
(d) `python -m fcd_tpu_torch.cli.train --device cpu --devices 2` against
`--devices 1`: the per-epoch train loss within rtol 1e-4 (as
tests/test_parallel.py holds the JAX CLI), and rank 0's checkpoint
restores in fcd_tpu.

The port's four ranks are spawned once for the module
(`torch_port_mesh_ranks.parallel_checks`, the 2-rank cases on a subgroup),
in a thread beside the JAX side's compiles.
"""

import os
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss
from fcd_tpu.models.factory import get_model, init_model
from fcd_tpu.parallel.dp import make_dp_train_step, replicate_state
from fcd_tpu.parallel.mesh import make_mesh, shard_batch
from fcd_tpu.train import checkpoint as jckpt
from fcd_tpu.train.state import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from fcd_tpu_torch.cli import train as cli_train
from fcd_tpu_torch.parallel.mesh import launch

import torch_port_mesh_ranks as ranks

import torch_port_workers

torch_port_workers.share_cores()

BASE = dict(model_type="BASEUNET", patch_size=32, feature_size=4)
PATCH = 32
GRAD_REL = 1e-2     # rel-L2 per leaf (ROADMAP C10)
CANCELS = 1e-4      # of the largest leaf's norm: a sum that cancels


def _batch(n, seed, patch=PATCH):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, patch, patch, patch, 2).astype(np.float32)
    y = (rng.rand(n, patch, patch, patch, 1) > 0.7).astype(np.float32)
    return x, y


def _jax_setup(loss):
    params = jax_default_params()
    params.update(chans_in=2, chans_out=2, use_amp=False, loss=loss, **BASE)
    model, params = get_model(params)
    variables = init_model(model, params, seed=0)
    state = create_train_state(model, variables, params)
    return model, params, variables, state


def _cases(dp_vars, ragged_vars):
    """The port's cases: name -> (ranks, settings, variables, x, y, mask,
    with the single-device step)."""
    x, y = _batch(8, 0)
    xr, yr = _batch(6, 2)
    idx = np.arange(8) % 6
    mask = (np.arange(8) < 6).astype(np.float32)
    xb, yb = _batch(4, 4, 16)
    xd, yd = _batch(4, 5)
    t = np.ascontiguousarray
    return {
        "dp": (2, dict(BASE, loss="DiceLoss"), dp_vars, t(x), t(y), None,
               False),
        "ragged": (4, dict(BASE, loss="DiceCELoss"), ragged_vars,
                   t(xr[idx]), t(yr[idx]), t(mask), False),
        "batchnorm": (2, dict(model_type="VNET", patch_size=16,
                              loss="DiceCELoss"), None, t(xb), t(yb), None,
                      True),
        "dropout": (2, dict(model_type="MS_DSA_NET", patch_size=PATCH,
                            feature_size=4, project_size=16,
                            loss="DiceCELoss"), None, t(xd), t(yd), None,
                    True),
    }


@pytest.fixture(scope="module")
def results():
    """{"jax": the JAX steps' (loss, params), "port": rank 0's results}."""
    jmodel, jparams, jvars, jstate = _jax_setup("DiceLoss")
    rmodel, rparams, rvars, rstate = _jax_setup("DiceCELoss")
    np_tree = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    port = {}

    def run_port():
        try:
            port["out"] = launch(
                ranks.parallel_checks, 4, _cases(np_tree(jvars),
                                                 np_tree(rvars)),
                device_type="cpu", threads=1)
        except BaseException as e:        # re-raised in the test's thread
            port["error"] = e

    worker = threading.Thread(target=run_port)
    worker.start()
    try:
        mesh = make_mesh(8, ("data",))
        x, y = _batch(8, 0)
        tx = make_optimizer(jparams)
        dp_step = make_dp_train_step(jmodel, make_combined_loss(jparams), tx,
                                     mesh, donate=False)
        dstate, dloss = dp_step(replicate_state(jstate, mesh),
                                shard_batch(mesh, jnp.asarray(x)),
                                shard_batch(mesh, jnp.asarray(y)), 1e-3,
                                jax.random.PRNGKey(0))
        xr, yr = _batch(6, 2)
        step1 = make_train_step(rmodel, make_combined_loss(rparams),
                                make_optimizer(rparams), donate=False)
        sstate, sloss = step1(rstate, jnp.asarray(xr), jnp.asarray(yr),
                              1e-3, jax.random.PRNGKey(0))
        jax_out = {"dp": (float(dloss), np_tree(dstate.params)),
                   "ragged": (float(sloss), np_tree(sstate.params))}
    finally:
        worker.join()
    if "error" in port:
        raise port["error"]
    return {"jax": jax_out, "port": port["out"]}


def _first_leaf(params):
    return jax.tree_util.tree_leaves(params)[0]


@pytest.mark.parametrize("case", ["dp", "ragged"])
def test_dp_step_matches_jax(results, case):
    jloss, jparams = results["jax"][case]
    loss, variables, _ = results["port"][0][case]["dp"]
    assert loss == pytest.approx(jloss, rel=1e-5)
    np.testing.assert_allclose(_first_leaf(variables["params"]),
                               _first_leaf(jparams), rtol=2e-5, atol=1e-7)


def test_every_rank_holds_the_same_state(results):
    """The replicas stay bit-equal: every rank's loss and parameters after
    the step are rank 0's."""
    out = results["port"]
    for case in ("dp", "batchnorm", "dropout"):
        assert [r[case]["dp"][0] for r in out[:2]] == [out[0][case]["dp"][0]] * 2
        for a, b in zip(jax.tree_util.tree_leaves(out[0][case]["dp"][1]),
                        jax.tree_util.tree_leaves(out[1][case]["dp"][1])):
            np.testing.assert_array_equal(a, b)
    for r in out:
        np.testing.assert_array_equal(
            _first_leaf(r["ragged"]["dp"][1]["params"]),
            _first_leaf(out[0]["ragged"]["dp"][1]["params"]))


@pytest.mark.parametrize("case", ["batchnorm", "dropout"])
def test_dp_step_equals_the_single_device_step(results, case):
    loss, variables, grads = results["port"][0][case]["dp"]
    sloss, svariables, sgrads = results["port"][0][case]["single"]
    assert loss == pytest.approx(sloss, rel=1e-5)
    assert grads.keys() == sgrads.keys()
    top = max(np.linalg.norm(g) for g in sgrads.values())
    for k, want in sgrads.items():
        if np.linalg.norm(want) <= CANCELS * top:
            assert np.linalg.norm(grads[k]) <= CANCELS * top, k
        else:
            assert np.linalg.norm(grads[k] - want) <= \
                GRAD_REL * np.linalg.norm(want), k
    stats = jax.tree_util.tree_leaves(variables["batch_stats"])
    assert stats       # VNet's, and MS_DSA_NET's transformers' conv branches
    for a, b in zip(stats,
                    jax.tree_util.tree_leaves(svariables["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def _write_dataset(root):
    from fcd_tpu_torch.data import nifti

    rng = np.random.RandomState(0)
    for subj in ["sub-01", "sub-02"]:
        d = root / subj / "anat"
        os.makedirs(d)
        vol = rng.rand(24, 24, 24).astype(np.float32) * 0.2
        gt = np.zeros_like(vol)
        gt[8:16, 8:16, 8:16] = 1
        vol = vol + gt * 0.8
        nifti.save(str(d / "t1_reg.nii.gz"), vol)
        nifti.save(str(d / "flair_reg.nii.gz"), vol * 0.9)
        nifti.save(str(d / "gt_reg.nii.gz"), gt)
    split = root / "split.txt"
    split.write_text("sub-01 train\nsub-02 val\n")
    return split


def test_cli_train_on_two_ranks_matches_one(tmp_path, monkeypatch):
    """tests/test_parallel.py::test_cli_train_mesh_matches_single_device
    for the port: samples_per_case=2 gives a global batch of 2, one sample
    a rank."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # each spawned rank's
    split = _write_dataset(tmp_path)
    kwargs = ["patch_size=32", "feature_size=4", "max_epochs=2",
              "min_epochs=0", "warmup_epochs=1", "use_amp=False",
              "loss=DiceCELoss", "samples_per_case=2",
              "early_stopping_patience=50"]
    losses, run_dirs = {}, {}
    for dev in ("1", "2"):
        save = tmp_path / f"runs{dev}"
        out = cli_train.main([
            "--data_dir", str(tmp_path), "--split_file", str(split),
            "--splits", "train", "val", "--model_type", "BASEUNET",
            "--device", "cpu", "--devices", dev, "--save_dir", str(save),
            "--kwargs", *kwargs])
        run_dirs[dev] = next((save / "BASEUNET").iterdir())
        assert str(run_dirs[dev]) == out.save_dir
        rows = (run_dirs[dev] / "training_log.csv").read_text().strip() \
            .splitlines()
        li = rows[0].split(",").index("train_loss")
        losses[dev] = [float(r.split(",")[li]) for r in rows[1:]]
    assert len(losses["2"]) == 2
    np.testing.assert_allclose(losses["2"], losses["1"], rtol=1e-4)

    model, params, variables, _ = _jax_setup("DiceCELoss")
    template = create_train_state(model, variables, params)
    state, epoch, _ = jckpt.load_checkpoint(
        str(run_dirs["2"] / "best_model.msgpack"), template)
    assert epoch in (0, 1)
    leaves = jax.tree_util.tree_leaves(state.params)
    assert leaves and all(np.isfinite(np.asarray(a)).all() for a in leaves)
