"""The port's epoch loop (`ModelTrainer.train`, CPU) against the JAX
trainer's, and `python -m fcd_tpu_torch.cli.train` with --resume.

The same weights go into fcd_tpu's ModelTrainer and the port's:
MS_DSA_NET fs4 / P16, 32^3 patches, DiceCE, f32, a three-subject
synthetic set (one train, one val, one test subject), 2 epochs with
augmentation off and dropout off on both sides (their random streams
cannot match, ROADMAP C2: the attention dropout built at rate 0, the conv
branch's channel dropout made the identity on the JAX side and rate 0 on
the port's). The patch loader gives both the same batches (one seed).

The JAX trainer's sliding-window program takes the predictor as a static
argument, so its weights are the ones it was first traced with: from the
second validation of a volume shape on, fcd_tpu validates and tests the
first epoch's weights. The test hands the JAX trainer a fresh predictor
for each volume (its `_sw_pred_wrappers` cleared), so that both packages
evaluate their current weights.

Compared: the per-epoch train loss (measured rel 6e-7 and 1.5e-6) and
validation loss (3e-7) at test_torch_port_train.py's step tolerance (rel
1e-5), the validation metrics (measured rel up to 4.5e-5: a voxel or two
on the 0.5 threshold; rel 1e-3 here), the CSV header, the best-epoch and
early-stopping bookkeeping and the checkpoints, and `test`'s metric keys
and values without and with post-processing.
"""

import os

import numpy as np
import pytest
import torch

import jax

import fcd_tpu.models.factory as jfactory
import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.data import nifti as jnifti
from fcd_tpu.train.trainer import ModelTrainer as JaxTrainer
import fcd_tpu_torch.models.factory as tfactory
from fcd_tpu_torch.cli import train as cli_train
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.train.trainer import ModelTrainer

import torch_port_workers

torch_port_workers.share_cores()

SHAPE = (40, 36, 44)   # 8 patches of 32^3
SPLIT = {"train": ["sub-01"], "val": ["sub-02"], "test": ["sub-03"]}
SETTINGS = dict(patch_size=32, feature_size=4, project_size=16,
                max_epochs=2, min_epochs=0, warmup_epochs=1, use_amp=False,
                loss="DiceCELoss", min_region_size=1, samples_per_case=2,
                keep_latest_model=True, early_stopping_patience=50,
                augment=False)
STEP_REL = 1e-5      # test_torch_port_train.py's loss tolerance
METRIC_REL = 1e-3


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); the train steps need it on."""
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(0)
    for subj in ("sub-01", "sub-02", "sub-03"):
        d = root / subj / "anat"
        os.makedirs(d)
        vol = rng.rand(*SHAPE).astype(np.float32) * 0.2
        gt = np.zeros(SHAPE, np.float32)
        c = rng.randint(8, 24, 3)
        gt[c[0]:c[0] + 10, c[1]:c[1] + 9, c[2]:c[2] + 11] = 1
        vol = vol + gt * 0.8
        jnifti.save(str(d / "t1_reg.nii.gz"), vol)
        jnifti.save(str(d / "flair_reg.nii.gz"), vol * 0.9)
        jnifti.save(str(d / "gt_reg.nii.gz"), gt)
    (root / "split.txt").write_text("sub-01 train\nsub-02 val\nsub-03 test\n")
    return str(root)


def _csv(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    keys = lines[0].split(",")
    return keys, [dict(zip(keys, map(float, line.split(","))))
                  for line in lines[1:]]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    """Both trainers, each run once: 2 epochs, then the test twice."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WANDB_MODE", "disabled")
    mp.setattr(jattention, "ChannelDropout3d",
               lambda rate: (lambda x, train=False, s2d_channels=None: x))
    jax_net, port_net = jfactory.MS_DSA_NET, tfactory.MS_DSA_NET
    mp.setattr(jfactory, "MS_DSA_NET",
               lambda *a, **k: jax_net(*a, **{**k, "dropout_rate": 0.0}))
    mp.setattr(tfactory, "MS_DSA_NET",
               lambda *a, **k: port_net(*a, **{**k, "dropout_rate": 0.0}))
    inference = JaxTrainer.inference

    def fresh_inference(self, volume):
        self._sw_pred_wrappers.clear()
        return inference(self, volume)

    mp.setattr(JaxTrainer, "inference", fresh_inference)
    out = tmp_path_factory.mktemp("runs")
    try:
        jp = jax_default_params()
        jp.update(SETTINGS)
        jt = JaxTrainer(jp, verbose=False)
        jax_tests = {}
        jax_test = JaxTrainer.test
        mp.setattr(JaxTrainer, "test", lambda self, d, s, post_process=True:
                   jax_tests.setdefault(post_process,
                                        jax_test(self, d, s, post_process)))
        tp = get_default_params()
        tp.update(SETTINGS)
        tt = ModelTrainer(tp, device="cpu", verbose=False)
        for stack in tt.model.transformers:
            for blk in stack:
                blk.dropout.rate = 0.0
        tt.load_variables(jax.tree_util.tree_map(np.asarray, jt.variables))
        args = (data_dir, SPLIT["train"], SPLIT["val"])
        jt.train(*args, str(out / "jax"), SPLIT["test"])
        tt.train(*args, str(out / "port"), SPLIT["test"])
    finally:
        mp.undo()
    return dict(jax=jt, port=tt, jax_tests=jax_tests,
                jax_dir=out / "jax", port_dir=out / "port")


def test_losses_match_jax(runs):
    _, jrows = _csv(runs["jax_dir"] / "training_log.csv")
    _, trows = _csv(runs["port_dir"] / "training_log.csv")
    assert [r["epoch"] for r in trows] == [r["epoch"] for r in jrows] == [1, 2]
    for j, t in zip(jrows, trows):
        for k in ("train_loss", "val_loss", "ema_val_loss"):
            assert _rel(t[k], j[k]) <= STEP_REL, (k, t[k], j[k])
        assert t["learning_rate"] == j["learning_rate"]
    # training moved the weights: the second validation differs
    assert trows[1]["val_loss"] != trows[0]["val_loss"]


def test_validation_metrics_match_jax(runs):
    jkeys, jrows = _csv(runs["jax_dir"] / "training_log.csv")
    tkeys, trows = _csv(runs["port_dir"] / "training_log.csv")
    assert tkeys == jkeys
    assert jkeys[:4] == ["epoch", "train_loss", "val_loss", "ema_val_loss"]
    for j, t in zip(jrows, trows):
        for k in jkeys:
            if k.startswith("val_") and k != "val_loss":
                assert _rel(t[k], j[k]) <= METRIC_REL, (k, t[k], j[k])


def test_bookkeeping_matches_jax(runs):
    jt, tt = runs["jax"], runs["port"]
    for name in ("best_val_loss_epoch", "best_ema_val_loss_epoch",
                 "early_stopping_counter"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert _rel(tt.best_val_loss, jt.best_val_loss) <= STEP_REL
    assert _rel(tt.ema_val_loss, jt.ema_val_loss) <= STEP_REL
    for d in (runs["jax_dir"], runs["port_dir"]):
        assert (d / "best_model.msgpack").exists()
        assert (d / "latest_model.msgpack").exists()


@pytest.mark.parametrize("post_process", [False, True])
def test_test_metrics_match_jax(runs, post_process):
    want = runs["jax_tests"][post_process]
    got = runs["port"].test_metrics[post_process]
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if np.isnan(w):
            assert np.isnan(g), k
        else:
            assert _rel(g, w) <= METRIC_REL or abs(g - w) <= 1e-12, (k, g, w)


def test_cli_trains_and_resume_appends_an_epoch(data_dir, tmp_path,
                                                monkeypatch):
    """python -m fcd_tpu_torch.cli.train --device cpu: 2 epochs (the best
    and latest checkpoints, the CSV), then --resume with max_epochs=3 runs
    epoch 3 (tests/test_trainer_e2e.py:39-71 checks the same for JAX; as
    there, the resumed run writes its CSV anew)."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    kwargs = [f"{k}={v}" for k, v in SETTINGS.items() if k != "augment"]
    common = ["--data_dir", data_dir, "--split_file",
              os.path.join(data_dir, "split.txt"), "--device", "cpu"]
    tr = cli_train.main(common + ["--splits", "train", "val", "--save_dir",
                                  str(tmp_path / "runs"), "--kwargs",
                                  *kwargs])
    run_dirs = list((tmp_path / "runs" / "MS_DSA_NET").iterdir())
    assert len(run_dirs) == 1 and str(run_dirs[0]) == tr.save_dir
    run_dir = run_dirs[0]
    assert (run_dir / "best_model.msgpack").exists()
    assert (run_dir / "latest_model.msgpack").exists()
    keys, rows = _csv(run_dir / "training_log.csv")
    assert keys[:4] == ["epoch", "train_loss", "val_loss", "ema_val_loss"]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    cli_train.main(common + ["--splits", "train", "val", "--save_dir",
                             str(run_dir), "--resume", "--kwargs",
                             *[k if not k.startswith("max_epochs")
                               else "max_epochs=3" for k in kwargs]])
    _, rows = _csv(run_dir / "training_log.csv")
    assert rows[-1]["epoch"] == 3


def test_cli_refuses_what_is_not_ported(data_dir, tmp_path, monkeypatch):
    """--emission_tracking (ROADMAP A6) and a model type the factory does
    not know (its ValueError: every type of the JAX factory is ported)
    raise before any training; `mesh_size` resolves --devices as the JAX
    trainer does (the visible cards at most; on the CPU N gloo ranks, -1
    one process); and a data mesh that cannot start raises instead of
    training on one card: four cards asked for where none can be used,
    and a trainer of mesh_data 2 outside a process group."""
    common = ["--data_dir", data_dir, "--split_file",
              os.path.join(data_dir, "split.txt"), "--splits", "train",
              "val", "--save_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="A6"):
        cli_train.main(common + ["--device", "cpu", "--emission_tracking"])
    with pytest.raises(ValueError, match="Unknown model_type"):
        cli_train.main(common + ["--device", "cpu", "--model_type",
                                 "NOT_A_MODEL"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli_train.mesh_size(-1, torch.device("cuda")) == 4
    assert cli_train.mesh_size(1, torch.device("cuda")) == 1
    assert cli_train.mesh_size(-1, torch.device("cpu")) == 1
    assert cli_train.mesh_size(3, torch.device("cpu")) == 3
    with pytest.raises(RuntimeError):
        cli_train.main(common)
    with pytest.raises(RuntimeError):
        cli_train.main(common + ["--devices", "2"])
    monkeypatch.undo()
    params = get_default_params()
    params.update(SETTINGS, mesh_data=2)
    with pytest.raises(RuntimeError, match="process group"):
        ModelTrainer(params, device="cpu", verbose=False)
