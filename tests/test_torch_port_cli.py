"""The segmentation CLI's path in the port against the JAX package (CPU).

(a) NIfTI I/O, RAS reorientation, resampling, percentile scaling, the
manifest and the post-processing are equal to the JAX package's;
(b) the msgpack checkpoint reader and writer agree with flax's;
(c) the engine's volume entry (B17) and blend exit (B6): their plain
versions against the Pallas kernels in interpret mode, and the engine with
`flat_output` against the JAX engine's fused-exit path;
(d) `run_inference` of the port and of the JAX package on one synthetic
subject and one JAX-written checkpoint give the same masks and Dice/IoU;
(e) ROADMAP C8: the max-pool tie gradient at encoder levels 3-5 splits as
the JAX package's `jnp.maximum` chain does.
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import flax.serialization
import jax
import jax.numpy as jnp

import fcd_tpu.cli.infer as jcli
import fcd_tpu.postproc.native as jnative
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.data import manifest as jmanifest
from fcd_tpu.data import nifti as jnifti
from fcd_tpu.data import preprocess as jpre
from fcd_tpu.infer import sliding_window as jsw
from fcd_tpu.kernels.block_conv import space_to_depth
from fcd_tpu.kernels.d2s_exit import d2s_exit_flat
from fcd_tpu.kernels.s2d_entry import s2d_entry
from fcd_tpu.ops.blocks import UnetResBlock as FlaxUnetResBlock
from fcd_tpu.ops.layers import max_pool_2x
from fcd_tpu.postproc.segment import post_process_prediction as j_postproc
from fcd_tpu.train import checkpoint as jckpt
from fcd_tpu.train.trainer import ModelTrainer as JaxModelTrainer
from fcd_tpu_torch import weights
from fcd_tpu_torch.cli import infer as tcli
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.data import manifest as tmanifest
from fcd_tpu_torch.data import nifti as tnifti
from fcd_tpu_torch.data import preprocess as tpre
from fcd_tpu_torch.infer import sliding_window as tsw
from fcd_tpu_torch.kernels.sw_io import sw_entry_plain, sw_exit_plain
from fcd_tpu_torch.ops.blocks import UnetResBlock
from fcd_tpu_torch.postproc import native as tnative
from fcd_tpu_torch.postproc.segment import post_process_prediction as t_postproc
from fcd_tpu_torch.train import checkpoint as tckpt

import torch_port_workers

torch_port_workers.share_cores()

torch.set_grad_enabled(False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _s2d(a: np.ndarray) -> np.ndarray:
    """(D, H, W, C) -> (D/2, H/2, W/2, 8C), lane (4 pz + 2 py + px) * C + c:
    the JAX package's space-to-depth layout."""
    d, h, w, c = a.shape
    return (a.reshape(d // 2, 2, h // 2, 2, w // 2, 2, c)
            .transpose(0, 2, 4, 1, 3, 5, 6).reshape(d // 2, h // 2, w // 2, 8 * c))


def _bits(a) -> np.ndarray:
    """The bit patterns of a bf16 array (torch or jax), as uint16."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _affine(codes: str, spacing=(1.0, 0.9375, 0.9375)) -> np.ndarray:
    """A voxel-to-world affine whose axes point along `codes` (e.g. "LAS":
    axis 0 towards L, 1 towards A, 2 towards S)."""
    world = {"R": (0, 1), "L": (0, -1), "A": (1, 1), "P": (1, -1),
             "S": (2, 1), "I": (2, -1)}
    aff = np.eye(4)
    aff[:3, :3] = 0
    for i, code in enumerate(codes):
        row, sign = world[code]
        aff[row, i] = sign * spacing[i]
    aff[:3, 3] = (-20.5, 31.25, -12.0)
    return aff


# -- (a) host modules ------------------------------------------------------------

@pytest.mark.parametrize("codes", ["RAS", "LAS", "LPI", "PIR", "ASL"])
def test_nifti_round_trip_and_ras_equal_jax(tmp_path, codes):
    rng = np.random.RandomState(0)
    data = rng.normal(size=(7, 9, 5)).astype(np.float32)
    aff = _affine(codes)
    for i, (save, load) in enumerate([(tnifti.save, jnifti.load),
                                      (jnifti.save, tnifti.load)]):
        path = str(tmp_path / f"v{i}.nii.gz")
        save(path, data, aff)
        got, want = tnifti.load(path), jnifti.load(path)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.affine, want.affine)
        np.testing.assert_array_equal(load(path).data, data)
        td, ta = tnifti.to_ras(got.data, got.affine)
        jd, ja = jnifti.to_ras(want.data, want.affine)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tnifti.load_ras(path).data,
                                      jnifti.load_ras(path).data)


def test_resampling_and_scaling_equal_jax():
    rng = np.random.RandomState(1)
    vol = ndimage.gaussian_filter(rng.normal(size=(12, 16, 14)), 1.5)
    vol = vol.astype(np.float32)
    aff = _affine("LAS")
    td, ta = tpre.resample_spacing(vol, aff, (1.0, 1.0, 1.0), order=1)
    jd, ja = jpre.resample_spacing(vol, aff, (1.0, 1.0, 1.0), order=1)
    assert td.shape == jd.shape == (12, 15, 14)
    assert _rel(td, jd) <= 1e-6
    np.testing.assert_array_equal(ta, ja)
    img = np.stack([td, 2 * td + 1], axis=-1)
    assert _rel(tpre.scale_channels(img), jpre.scale_channels(img)) <= 1e-6
    probs = np.stack([td, 1 - td], axis=-1)
    assert _rel(tpre.invert_to_grid(probs, ta, vol.shape, aff),
                jpre.invert_to_grid(probs, ja, vol.shape, aff)) <= 1e-6
    np.testing.assert_array_equal(tpre.replace_nan(np.array([np.nan, 1.0])),
                                  jpre.replace_nan(np.array([np.nan, 1.0])))


def test_get_data_equal_jax(tmp_path):
    for subj, files in [("s1", ["t1_reg", "flair_reg", "gt_reg"]),
                        ("s2", ["t1_reg", "flair_reg"]),          # no label
                        ("s3", ["t1_reg", "gt_reg"]),             # no flair
                        ("s4/nested", ["t1_reg", "flair_reg", "gt_reg"])]:
        d = tmp_path / subj
        d.mkdir(parents=True)
        for f in files:
            (d / f"{f}.nii.gz").write_bytes(b"")
    (tmp_path / "split.txt").write_text("s1 test\ns4 TEST\ns2 train\n")
    params = get_default_params()
    for subjects in (None, ["s1", "missing"]):
        assert tmanifest.get_data(str(tmp_path), params, subjects) == \
            jmanifest.get_data(str(tmp_path), jax_default_params(), subjects)
    assert tmanifest.get_split_data(str(tmp_path), str(tmp_path / "split.txt"),
                                    "test", params) == \
        jmanifest.get_split_data(str(tmp_path), str(tmp_path / "split.txt"),
                                 "test", jax_default_params())


@pytest.mark.parametrize("path", ["native", "scipy"])
def test_post_process_prediction_equal_jax(monkeypatch, path):
    if path == "scipy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert tnative.backend() == ("g++" if path == "native" else "scipy")
    rng = np.random.RandomState(2)
    prob = ndimage.gaussian_filter(rng.rand(24, 20, 22), 1.2)
    pred = (prob > np.percentile(prob, 85)).astype(np.float32)
    onehot = np.stack([1 - pred, pred], axis=-1)[None]
    for l_min in (20, -1):
        got = t_postproc(onehot, l_min)
        np.testing.assert_array_equal(got, j_postproc(onehot, l_min))
        assert 0 < got[..., 1].sum() < pred.sum()


# -- (b) checkpoints -------------------------------------------------------------

def _assert_trees_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        got = np.asarray(got)
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_codec_round_trips_with_flax(monkeypatch):
    """Every type flax writes, both ways, the chunked form included."""
    rng = np.random.RandomState(3)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "big": rng.normal(size=(40,)).astype(np.float64),
            "b": {"i": np.arange(5, dtype=np.int32), "bf": jnp.asarray(
                rng.normal(size=(2, 3)), jnp.bfloat16),
                  "s": np.float32(2.5), "u8": np.uint8(7)},
            "ints": {"0": 0, "1": -1, "2": 127, "3": -33, "4": 300,
                     "5": -40000, "6": 2 ** 40, "7": -(2 ** 40)},
            "f": 1.5, "inf": float("inf"), "c": 1 + 2j, "t": True,
            "n": None, "str": "x" * 40, "e": {}, "step": np.asarray(3)}
    for mod in (flax.serialization, tckpt):
        monkeypatch.setattr(mod, "MAX_CHUNK_SIZE", 64)
    from_flax = flax.serialization.msgpack_serialize(tree)
    _assert_trees_equal(tckpt.msgpack_restore(from_flax), tree)
    from_port = tckpt.msgpack_serialize(
        {k: v for k, v in tree.items() if k != "b"}
        | {"b": {k: v for k, v in tree["b"].items() if k != "bf"}})
    back = flax.serialization.msgpack_restore(from_port)
    assert back["big"].shape == (40,) and back["str"] == "x" * 40
    _assert_trees_equal(tckpt.msgpack_restore(from_port), back)
    _assert_trees_equal(back, tckpt.msgpack_restore(from_flax) | {
        "b": {k: v for k, v in tree["b"].items() if k != "bf"}})


# -- the JAX-written checkpoint and subject of the CLI tests ---------------------

CLI_UPDATES = dict(feature_size=4, project_size=16, patch_size=(32, 64, 64),
                   use_amp=False, sw_batch_size=1, min_region_size=20)


def _write_subject(root, name="sub01", shape=(40, 64, 60), seed=5):
    """A seeded synthetic subject in native space: smooth T1 and FLAIR and a
    spherical lesion, on a (1.0, 0.9375, 0.9375) mm LAS grid (so the RAS
    flip, the 1 mm resampling and its inverse all do work)."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    aff = _affine("LAS")
    for seq in ("t1_reg", "flair_reg"):
        img = ndimage.gaussian_filter(rng.normal(size=shape), 2.0) * 50 + 100
        tnifti.save(os.path.join(d, f"{seq}.nii.gz"), img.astype(np.float32),
                    aff)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    gt = ((zz - 20) ** 2 + (yy - 30) ** 2 + (xx - 28) ** 2) < 81
    tnifti.save(os.path.join(d, "gt_reg.nii.gz"), gt.astype(np.uint8), aff)
    return aff


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A small MS_DSA_NET written by the JAX package's trainer (params,
    batch_stats, opt_state, step, epoch, extra)."""
    root = tmp_path_factory.mktemp("ckpt")
    params = jax_default_params()
    params.update(CLI_UPDATES)
    trainer = JaxModelTrainer(params, verbose=False)
    path = str(root / "model.msgpack")
    trainer.save_model(path, epoch=7)
    return path, trainer


def test_checkpoint_reader_equals_flax(jax_checkpoint):
    path, _ = jax_checkpoint
    data = open(path, "rb").read()
    want = flax.serialization.msgpack_restore(data)
    assert "opt_state" in want
    _assert_trees_equal(tckpt.msgpack_restore(data), want)
    variables, epoch, extra = tckpt.load_checkpoint(path)
    assert epoch == 7 and extra == want["extra"]
    _assert_trees_equal(variables, {"params": want["params"],
                                    "batch_stats": want["batch_stats"]})


def test_checkpoint_writer_read_by_flax(jax_checkpoint, tmp_path):
    path, jtrainer = jax_checkpoint
    variables, _, _ = tckpt.load_checkpoint(path)
    out = str(tmp_path / "port.msgpack")
    tckpt.save_checkpoint(out, variables, epoch=3, extra={"best_val_loss": 0.5},
                          step=11)
    raw = flax.serialization.msgpack_restore(open(out, "rb").read())
    _assert_trees_equal({"params": raw["params"],
                         "batch_stats": raw["batch_stats"]}, variables)
    assert raw["epoch"] == 3 and raw["extra"] == {"best_val_loss": 0.5}
    assert int(raw["step"]) == 11
    # the JAX package restores its train state from the port's file
    state, epoch, extra = jckpt.load_checkpoint(out, jtrainer.state)
    assert epoch == 3 and int(state.step) == 11
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, state.params),
                        variables["params"])
    # and a params-only file loads into the port's trainer
    bare = str(tmp_path / "bare.msgpack")
    open(bare, "wb").write(tckpt.msgpack_serialize(variables["params"]))
    params = get_default_params()
    params.update(CLI_UPDATES)
    trainer = tcli.ModelTrainer(params, device="cpu")
    assert trainer.load_model(bare) is None
    np.testing.assert_array_equal(
        trainer.model.head.detach().numpy(),
        variables["params"]["Conv3d_4"]["kernel"].reshape(4, 2))


# -- (c) the engine's entry (B17) and exit (B6) ----------------------------------

@pytest.mark.parametrize("shape,roi", [((10, 16, 8, 2), (8, 16, 8)),
                                       ((10, 12, 6, 2), (8, 16, 8))])
def test_sw_entry_plain_equals_s2d_entry(shape, roi):
    """The port's entry (pad + bf16 cast), in the s2d layout, against the
    Pallas entry (interpret mode) of the JAX engine's padded volume."""
    vol = np.random.RandomState(4).normal(size=shape).astype(np.float32) * 3
    got = sw_entry_plain(torch.from_numpy(vol), roi, torch.bfloat16)
    pad = [(max(r - s, 0) // 2, max(r - s, 0) - max(r - s, 0) // 2)
           for r, s in zip(roi, shape[:3])]
    padded = jnp.pad(jnp.asarray(vol), pad + [(0, 0)])
    want = s2d_entry(padded, out_dtype=jnp.bfloat16, interpret=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape[:3]) == padded.shape[:3]
    np.testing.assert_array_equal(_s2d(_bits(got)), _bits(want))


def test_sw_exit_plain_equals_d2s_exit_flat():
    """The port's exit (acc * inv, uncropped) flattened, against the Pallas
    exit (interpret mode) on the s2d transpose of the same accumulator."""
    rng = np.random.RandomState(6)
    o = 2
    acc = rng.normal(size=(6, 8, 10, o)).astype(np.float32)
    inv = (1.0 / rng.randint(1, 9, size=(6, 8, 10, 1))).astype(np.float32)
    got = sw_exit_plain(torch.from_numpy(acc), torch.from_numpy(inv),
                        (0, 0, 0), (6, 8, 10))
    acc_t = _s2d(acc).transpose(0, 1, 3, 2)
    inv_t = np.repeat(_s2d(inv), o, axis=-1).transpose(0, 1, 3, 2)
    want = d2s_exit_flat(jnp.asarray(acc_t), jnp.asarray(np.ascontiguousarray(
        inv_t)), o, interpret=True)
    np.testing.assert_array_equal(got.reshape(6, 8, 10 * o).numpy(),
                                  np.asarray(want))
    crop = sw_exit_plain(torch.from_numpy(acc), torch.from_numpy(inv),
                         (1, 2, 3), (4, 5, 6))
    np.testing.assert_array_equal(crop.numpy(), (acc * inv)[1:5, 2:7, 3:9])


def test_engine_flat_output_matches_jax_fused_exit():
    """The port's engine with flat_output against the JAX engine's s2d-logit
    path with flat_output, which exits through B6 (interpret mode)."""
    rng = np.random.RandomState(9)
    w1, w2 = rng.randn(2, 3).astype(np.float32), rng.randn(2, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    vol = rng.randn(20, 28, 24, 2).astype(np.float32)
    roi = (16, 16, 16)

    def jax_predictor(p):
        dense = p @ w1 + jnp.mean(p, axis=(1, 2, 3), keepdims=True) @ w2 + b
        return space_to_depth(dense)

    t1, t2, tb = (torch.from_numpy(a) for a in (w1, w2, b))

    def torch_predictor(p):
        return p @ t1 + p.mean(dim=(1, 2, 3), keepdim=True) @ t2 + tb

    want = np.asarray(jsw.sliding_window_inference(
        jnp.asarray(vol), jax_predictor, roi_size=roi, out_channels=3,
        sw_batch=1, overlap=0.25, s2d_logits=True, flat_output=True,
        compute_dtype=jnp.float32))
    got = tsw.sliding_window_inference(
        vol, torch_predictor, roi_size=roi, out_channels=3, sw_batch=1,
        overlap=0.25, compute_dtype=torch.float32, flat_output=True,
        device="cpu")
    assert got.shape == want.shape == (20, 28, 24 * 3)
    assert _rel(got.numpy(), want) < 1e-4


# -- (d) the whole CLI -------------------------------------------------------------

def test_run_inference_matches_jax(jax_checkpoint, tmp_path):
    """fcd_tpu.cli.infer.run_inference and the port's, device="cpu", on one
    synthetic subject and one JAX-written checkpoint (fp32 both)."""
    path, _ = jax_checkpoint
    data = str(tmp_path / "data")
    aff = _write_subject(data)
    jp = jax_default_params()
    jp.update(CLI_UPDATES)
    tp = get_default_params()
    tp.update(CLI_UPDATES)
    want = jcli.run_inference(data, str(tmp_path / "jax"), path, jp)
    timings = {}
    got = tcli.run_inference(data, str(tmp_path / "port"), path, tp,
                             device="cpu", timings=timings)
    assert set(got) == set(want) == {"sub01"}
    for k in ("dice", "iou"):
        assert abs(got["sub01"][k] - want["sub01"][k]) <= 1e-3
    seg = [tnifti.load(str(tmp_path / d / "sub01" / "sub01_seg.nii.gz"))
           for d in ("port", "jax")]
    assert seg[0].shape == (40, 64, 60)
    np.testing.assert_array_equal(seg[0].affine, aff)
    assert set(np.unique(seg[0].data)) <= {0.0, 1.0}
    assert float((seg[0].data == seg[1].data).mean()) >= 0.999
    assert set(timings["sub01"]) == {"load_preprocess", "inference",
                                     "softmax_invert", "postprocess", "save"}


def test_cli_main_runs_and_refuses_preprocess(tmp_path, monkeypatch):
    """The CLI end to end, and with --preprocess (once refused, now
    ported): the FSL stage runs first, with `_run` replaced by a stand-in
    that writes each image command's output as a copy of its input (the
    binaries are absent), and the CLI segments the registered subject
    under save_dir/preprocessed."""
    import shlex
    import shutil

    from fcd_tpu_torch.data import fsl as tfsl

    data = str(tmp_path / "data")
    _write_subject(data, shape=(24, 32, 30))
    kwargs = ["feature_size=4", "project_size=16", "patch_size=32",
              "use_amp=False"]
    tcli.main(["--data_dir", data, "--save_dir", str(tmp_path / "out"),
               "--checkpoint_path", str(tmp_path / "none.msgpack"),
               "--device", "cpu", "--kwargs", *kwargs])
    assert os.path.exists(tmp_path / "out" / "sub01" / "sub01_seg.nii.gz")
    cmds = []

    def flirt(cmd):
        cmds.append(cmd)
        words = shlex.split(cmd)
        def arg(flag):
            return words[words.index(flag) + 1]

        if words[0] == "fslreorient2std":
            shutil.copyfile(words[-2], words[-1])
        elif words[0] == "robustfov":
            shutil.copyfile(arg("-i"), arg("-r"))
        elif words[0] == "flirt":
            shutil.copyfile(arg("-in"), arg("-out"))
        return 0

    monkeypatch.setattr(tfsl, "_run", flirt)
    tcli.main(["--data_dir", data, "--save_dir", str(tmp_path / "pre"),
               "--checkpoint_path", str(tmp_path / "none.msgpack"),
               "--device", "cpu", "--preprocess", "--kwargs", *kwargs])
    reg = tmp_path / "pre" / "preprocessed" / "sub01"
    assert sorted(os.listdir(reg)) == ["flair_reg.nii.gz", "gt_reg.nii.gz",
                                       "t1_reg.nii.gz"]
    assert cmds[0].startswith("fslreorient2std")
    assert sum(c.startswith("flirt") for c in cmds) == 5   # no thickness
    assert os.path.exists(tmp_path / "pre" / "sub01" / "sub01_seg.nii.gz")


# -- (e) ROADMAP C8: the tie gradient of the level 3-5 pools ---------------------

def _diagonal_ties(rng, shape, cin):
    """x[b, d, h, w, c] = F[c, d + h + w] with small integers F: every
    2x2x2 block holds 1, 3, 3, 1 voxels on its four diagonals, so a block's
    maximum is often a 3-way exact tie, where the `jnp.maximum` chain
    (W pairs, then D, then H) gives 1/4, 1/4, 1/2 and the even split 1/3."""
    b, d, h, w = shape
    f = rng.randint(-3, 4, size=(cin, d + h + w)).astype(np.float32)
    s = (np.arange(d)[:, None, None] + np.arange(h)[None, :, None]
         + np.arange(w)[None, None, :])
    return np.broadcast_to(np.moveaxis(f[:, s], 0, -1)[None],
                           (b, d, h, w, cin)).copy()


def test_level3_pool_tie_gradient_matches_jax_chain():
    """A level-3 encoder block (Cin = 2 fs, Cout = 4 fs at fs 4) and its
    2x max pool, input gradient against jax.grad through the JAX block and
    `max_pool_2x`. conv2 is zero and the shortcut's weights are dyadic, so
    the block's output is a function of d + h + w computed exactly in both
    frameworks and the ties are the same ties in both. The two frameworks'
    f32 instance norms round differently (the block outputs differ by
    1.9e-6 of their maximum), which sets the 1e-5 tolerance; the even split
    is off by 0.22 here."""
    rng = np.random.RandomState(11)
    cin, cout = 8, 16
    x = _diagonal_ties(rng, (1, 8, 8, 8), cin)
    cot = rng.normal(size=(1, 4, 4, 4, cout)).astype(np.float32)
    fm = FlaxUnetResBlock(out_channels=cout, kernel_size=3, stride=1,
                          norm_name="instance")
    v = jax.tree_util.tree_map(np.asarray, fm.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    p = v["params"]
    p["Conv3d_1"]["kernel"] = np.zeros_like(p["Conv3d_1"]["kernel"])
    p["Conv3d_2"]["kernel"] = (rng.randint(-4, 5, size=p["Conv3d_2"]["kernel"]
                                           .shape) / 4).astype(np.float32)

    def loss(xx):
        return jnp.sum(max_pool_2x(fm.apply({"params": p}, xx)) * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))

    tm = UnetResBlock(cin, cout).eval()
    weights.load_resblock(tm, p)
    with torch.enable_grad():
        xt = torch.tensor(x, requires_grad=True)
        _, pooled = tm([xt], pool=True, tie="chain")
        (pooled * torch.tensor(cot)).sum().backward()
        assert _rel(xt.grad.numpy(), want) < 1e-5
        # the even split, right at levels 1-2, differs here
        xe = torch.tensor(x, requires_grad=True)
        _, pooled = tm([xe], pool=True, tie="even")
        (pooled * torch.tensor(cot)).sum().backward()
    assert _rel(xe.grad.numpy(), want) > 1e-2
