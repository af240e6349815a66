"""The port's dataset tooling and BraTS scorer against the JAX package's, on
the same inputs (CPU, host code).

(a) `data/organize.py` and `cli/organize.py`: organize (by ratios and
from an assignments file), de-organize, k-fold and the split files give
the same trees and the same bytes as `fcd_tpu`'s on mirrored datasets.
(b) `data/misc.py`: the thickness copy and the folder cleanup.
(c) `cli/inspect.py`: the same dict, and the `--plot` PNG (matplotlib
imported only there).
(d) `data/fsl.py` and `cli/preprocess.py`: with `_run` patched in both
packages, the shell commands of every subject, layout and option are
equal string for string, a finished subject runs none, and the CLI
raises the same error where `flirt` is missing.
(e) `metrics/brats_scorer.py`: the report, cell for cell, against the
JAX DataFrame on seeded multi-label blobs for each challenge's dilation
and volume threshold, and the same CSV bytes.
"""

import os

import numpy as np
import pytest

from fcd_tpu.cli import inspect as jinspect
from fcd_tpu.cli import organize as jorg_cli
from fcd_tpu.cli import preprocess as jpre_cli
from fcd_tpu.data import fsl as jfsl
from fcd_tpu.data import misc as jmisc
from fcd_tpu.data import organize as jorg
from fcd_tpu.metrics import brats_scorer as jbrats
from fcd_tpu_torch.cli import inspect as tinspect
from fcd_tpu_torch.cli import organize as torg_cli
from fcd_tpu_torch.cli import preprocess as tpre_cli
from fcd_tpu_torch.data import fsl as tfsl
from fcd_tpu_torch.data import misc as tmisc
from fcd_tpu_torch.data import nifti
from fcd_tpu_torch.data import organize as torg
from fcd_tpu_torch.metrics import brats_scorer as tbrats

import torch_port_workers

torch_port_workers.share_cores()

PKGS = (("jax", jorg, jorg_cli), ("port", torg, torg_cli))


def _dataset(root, n=9, seed=0):
    """n subjects: most with a non-empty gt_reg, one with an empty one and
    one without (both 'unlabeled')."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        d = root / f"sub-{i:02d}"
        os.makedirs(d)
        vol = rng.rand(4, 4, 4).astype(np.float32)
        nifti.save(str(d / "t1_reg.nii.gz"), vol)
        if i == n - 1:
            continue
        gt = np.zeros_like(vol)
        if i != n - 2:
            gt[1:3, 1:3, 1:3] = 1
        nifti.save(str(d / "gt_reg.nii.gz"), gt)


def _tree(root):
    """Every file under root, relative, with its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _mirrored(tmp_path, **kw):
    roots = {}
    for name, _, _ in PKGS:
        roots[name] = tmp_path / name
        _dataset(roots[name], **kw)
    return roots


@pytest.mark.parametrize("seed", [0, 42])
def test_organize_and_deorganize_match_jax(tmp_path, seed):
    roots = _mirrored(tmp_path)
    out = {}
    for name, org, _ in PKGS:
        out[name] = org.organize_data_splits(str(roots[name]), seed=seed)
    for k in ("total_subjects", "labeled_subjects", "unlabeled_subjects",
              "train_subjects", "val_subjects", "test_subjects"):
        assert out["port"][k] == out["jax"][k]
    assert _tree(roots["port"]) == _tree(roots["jax"])
    for name, org, _ in PKGS:
        org.deorganize_data(str(roots[name]))
    assert _tree(roots["port"]) == _tree(roots["jax"])


def test_organize_from_assignments_matches_jax(tmp_path):
    roots = _mirrored(tmp_path)
    assign = tmp_path / "assign.txt"
    jorg.save_split_assignments({"train": ["sub-03", "sub-00"],
                                 "val": ["sub-05"], "test": ["sub-01"]},
                                str(assign))
    for name, org, _ in PKGS:
        org.organize_data_splits(str(roots[name]),
                                 assignments_file=str(assign))
    assert _tree(roots["port"]) == _tree(roots["jax"])
    assert torg.load_split_assignments(str(assign)) == \
        jorg.load_split_assignments(str(assign))
    with pytest.raises(FileNotFoundError):
        torg.load_split_assignments(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("k,n", [(3, 7), (5, 12), (5, 4)])
def test_kfold_matches_jax(tmp_path, k, n):
    roots = _mirrored(tmp_path, n=n)
    assert torg.create_kfold_splits(str(roots["port"]), k=k) == \
        jorg.create_kfold_splits(str(roots["jax"]), k=k)
    for name, org, _ in PKGS:
        org.save_kfold_splits(str(roots[name]), str(tmp_path / f"f_{name}"),
                              k=k)
    assert _tree(tmp_path / "f_port") == _tree(tmp_path / "f_jax")


@pytest.mark.parametrize("argv", [
    ["--organize", "--seed", "3"],
    ["--organize", "--deorganize"],
    ["--kfold", "3", "--output_dir", "{out}"],
    ["--organize", "--save_split_only", "--assignments_file", "{out}"],
    ["--deorganize"],
])
def test_organize_cli_matches_jax(tmp_path, argv):
    roots = _mirrored(tmp_path)
    outs = {}
    for name, _, cli in PKGS:
        outs[name] = tmp_path / f"out_{name}"
        if argv == ["--deorganize"]:
            cli.main(["--data_dir", str(roots[name]), "--organize"])
        cli.main(["--data_dir", str(roots[name])]
                 + [a.format(out=outs[name]) for a in argv])
    assert _tree(roots["port"]) == _tree(roots["jax"])
    if outs["jax"].is_dir():
        assert _tree(outs["port"]) == _tree(outs["jax"])
    elif outs["jax"].exists():
        assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    else:
        assert not outs["port"].exists()


def test_misc_matches_jax(tmp_path):
    for name, misc in (("jax", jmisc), ("port", tmisc)):
        src, dst = tmp_path / name / "src", tmp_path / name / "dst"
        for s in ("sub-01", "sub-02", "sub-03"):
            os.makedirs(src / s)
            if s != "sub-02":
                nifti.save(str(src / s / "thickness.nii.gz"),
                           np.full((4, 4, 4), float(s[-1]), np.float32))
        copied = misc.copy_thickness_maps(str(src), str(dst))
        assert [os.path.relpath(p, dst) for p in copied] == \
            ["sub-01/anat/thickness.nii.gz", "sub-03/anat/thickness.nii.gz"]
        names = tmp_path / name / "names.txt"
        names.write_text("sub-01\n\nsub-09\nsub-03\n")
        assert misc.delete_folders(str(src), str(names)) == 2
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_inspect_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    vol = rng.normal(size=(12, 10, 8)).astype(np.float32)
    vol[0, 0, :3] = np.nan
    vol[5:7] = 0
    aff = np.diag([1.2, 0.9, 2.0, 1.0])
    aff[:3, 3] = (-10, 5, 3)
    path = str(tmp_path / "v.nii.gz")
    nifti.save(path, vol, aff)
    want = jinspect.inspect_nifti(path)
    got = tinspect.inspect_nifti(path, plot=str(tmp_path / "p.png"))
    assert got == want
    assert (tmp_path / "p.png").stat().st_size > 0
    tinspect.main([path])


# -- (d) FSL ---------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """Each package's `_run` replaced by a recorder: {package: [cmd]}."""
    log = {"jax": [], "port": []}
    monkeypatch.setattr(jfsl, "_run", lambda c: log["jax"].append(c) or 0)
    monkeypatch.setattr(tfsl, "_run", lambda c: log["port"].append(c) or 0)
    return log


def _raw_subject(d, gt=True, thickness=True):
    os.makedirs(d / "anat")
    for name in ["sub_T1w", "sub_FLAIR"] + (["sub_FLAIR_roi"] if gt else []):
        nifti.save(str(d / "anat" / f"{name}.nii.gz"),
                   np.zeros((2, 2, 2), np.float32))
    if thickness:
        nifti.save(str(d / "thickness.nii.gz"), np.zeros((2, 2, 2), np.float32))


@pytest.mark.parametrize("robust_fov", [True, False])
@pytest.mark.parametrize("gt,thickness", [(True, True), (False, False)])
def test_fsl_subject_commands_match_jax(tmp_path, recorded, robust_fov, gt,
                                        thickness):
    _raw_subject(tmp_path / "raw", gt, thickness)
    a = tmp_path / "raw" / "anat"
    args = (str(a / "sub_T1w.nii.gz"), str(a / "sub_FLAIR.nii.gz"),
            str(a / "sub_FLAIR_roi.nii.gz") if gt else None,
            str(tmp_path / "raw" / "thickness.nii.gz") if thickness else None,
            str(tmp_path / "out"))
    for fsl in (jfsl, tfsl):
        fsl.preprocess_subject_fsl(*args, apply_robust_fov=robust_fov,
                                   mni152_path="/tpl/MNI152.nii.gz")
    assert recorded["port"] == recorded["jax"]
    assert len(recorded["port"]) >= 7
    # a finished subject runs nothing
    for f in ("t1_reg", "flair_reg") + (("gt_reg",) if gt else ()) \
            + (("thickness_reg",) if thickness else ()):
        nifti.save(str(tmp_path / "out" / f"{f}.nii.gz"),
                   np.zeros((2, 2, 2), np.float32))
    n = len(recorded["port"])
    tfsl.preprocess_subject_fsl(*args, apply_robust_fov=robust_fov)
    assert len(recorded["port"]) == n


@pytest.mark.parametrize("layout", ["bids", "ideas"])
def test_fsl_dataset_commands_match_jax(tmp_path, recorded, layout):
    raw = tmp_path / "raw"
    if layout == "bids":
        _raw_subject(raw / "sub-01")
        _raw_subject(raw / "sub-02", gt=False)
        os.makedirs(raw / "sub-03")          # no images: skipped
        fns = (jfsl.preprocess_dataset_fsl, tfsl.preprocess_dataset_fsl)
    else:
        for sid in ("01", "02"):
            anat = raw / "bids" / f"sub-{sid}" / "anat"
            os.makedirs(anat)
            for m in ("T1w", "FLAIR"):
                nifti.save(str(anat / f"sub-{sid}_{m}.nii.gz"),
                           np.zeros((2, 2, 2), np.float32))
        os.makedirs(raw / "masks" / "01")
        nifti.save(str(raw / "masks" / "01" / "01_MaskInRawData.nii.gz"),
                   np.zeros((2, 2, 2), np.float32))
        fns = (jfsl.preprocess_ideas_dataset_fsl,
               tfsl.preprocess_ideas_dataset_fsl)
    for fn in fns:
        fn(str(raw), str(tmp_path / "out"), num_workers=1,
           mni152_path="/tpl/MNI152.nii.gz")
    assert recorded["port"] == recorded["jax"]
    assert any("sub-02" in c for c in recorded["port"])


def test_fsl_template_default_and_missing_flirt(tmp_path, monkeypatch):
    assert tfsl.MNI152_PATH == jfsl.MNI152_PATH
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not tfsl.fsl_available()
    errors = []
    for cli in (jpre_cli, tpre_cli):
        with pytest.raises(RuntimeError) as e:
            cli.main(["-d", str(tmp_path), "-s", str(tmp_path / "o")])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- (e) BraTS ---------------------------------------------------------------------

def _blobs(rng, shape=(28, 28, 28), n=4):
    """A label volume of n cuboid lesions, each an edema shell (2) around
    a core (1) with an enhancing centre (3), some of them small."""
    vol = np.zeros(shape, np.float32)
    for _ in range(n):
        size = rng.randint(2, 7, size=3)
        lo = [rng.randint(0, s - z) for s, z in zip(shape, size)]
        sl = tuple(slice(a, a + z) for a, z in zip(lo, size))
        vol[sl] = 2
        inner = tuple(slice(a + 1, a + z - 1) for a, z in zip(lo, size))
        vol[inner] = 1
        if rng.rand() < 0.7:
            vol[tuple(slice(a + z // 2, a + z // 2 + 1)
                      for a, z in zip(lo, size))] = 3
    return vol


@pytest.mark.parametrize("challenge", ["BraTS-GLI", "BraTS-MEN", "BraTS-MET"])
@pytest.mark.parametrize("seed", [0, 1])
def test_brats_report_matches_jax(tmp_path, challenge, seed):
    rng = np.random.RandomState(seed)
    gt = _blobs(rng)
    pred = gt.copy()
    pred[np.roll(gt > 0, 1, axis=0) & (rng.rand(*gt.shape) < 0.3)] = 2
    pred[rng.rand(*gt.shape) < 0.01] = 3         # scattered false positives
    pred[:, :, :4] = 0                           # a missed lesion, maybe
    paths = [str(tmp_path / f) for f in ("pred.nii.gz", "gt.nii.gz")]
    nifti.save(paths[0], pred, np.diag([1.0, 1.2, 0.9, 1.0]))
    nifti.save(paths[1], gt, np.diag([1.0, 1.2, 0.9, 1.0]))
    df = jbrats.get_lesion_wise_results(*paths, challenge,
                                        output=str(tmp_path / "jax.csv"))
    rows = tbrats.get_lesion_wise_results(*paths, challenge,
                                          output=str(tmp_path / "port.csv"))
    assert list(df.columns) == list(tbrats.COLUMNS)
    assert [list(r) for r in rows] == [list(tbrats.COLUMNS)] * 3
    for row, (_, want) in zip(rows, df.iterrows()):
        for k in tbrats.COLUMNS:
            assert row[k] == want[k], (row["Labels"], k, row[k], want[k])
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_brats_helpers_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.randint(0, 5, size=(6, 6, 6))
    gt = rng.randint(0, 5, size=(6, 6, 6))
    for t in ("WT", "TC", "ET"):
        for a, b in zip(tbrats.get_tissue_wise_seg(pred, gt, t),
                        jbrats.get_tissue_wise_seg(pred, gt, t)):
            np.testing.assert_array_equal(a, b)
        p, g = tbrats.get_tissue_wise_seg(pred, gt, t)
        assert tbrats.get_sensitivity_and_specificity(p, g) == \
            jbrats.get_sensitivity_and_specificity(p, g)
    assert tbrats.CHALLENGE_PARAMS == jbrats.CHALLENGE_PARAMS
