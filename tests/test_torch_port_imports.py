"""Package rules of the port (CPU).

(e) importing every module of fcd_tpu_torch loads none of jax, flax,
optax, msgpack, pandas, wandb, fcd_tpu or triton, and no file of the port
(nor chip_smoke.py) has an import statement naming them (the card's
machine has none of them but triton);
(f) entry points run on CUDA unless the caller asks for the CPU: without a
card, ModelTrainer(), the inference CLI's run_inference and the training
CLI's main raise instead of falling back.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fcd_tpu_torch

import torch_port_workers

torch_port_workers.share_cores()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "pandas", "wandb", "fcd_tpu",
             "triton")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        fcd_tpu_torch.__path__, prefix="fcd_tpu_torch."))


def test_import_leaves_jax_and_triton_out():
    mods = ["fcd_tpu_torch"] + _port_modules()
    for m in ("kernels.block_conv", "kernels.sw_io", "cli.infer", "cli.args",
              "data.nifti", "data.preprocess", "data.manifest",
              "postproc.native", "postproc.morphology", "postproc.segment",
              "train.checkpoint", "flags", "kernels.pool2x",
              "kernels.finale_head", "kernels.pool_sweep", "losses.extras",
              "train.state", "data.sampling", "data.dataset", "data.augment",
              "metrics", "metrics.voxel", "metrics.lesion",
              "metrics.surface_distance", "metrics.mc_tables",
              "metrics._mc_tri_table", "cli.train", "models.unetr_pp",
              "parallel", "parallel.mesh", "parallel.dp", "parallel.sw"):
        assert f"fcd_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_forbidden_import_statements():
    files = sorted((ROOT / "fcd_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in ("jax", "flax", "optax", "msgpack", "pandas", "wandb",
                      "fcd_tpu")]
    assert bad == []


def test_triton_imported_only_inside_the_launcher():
    """Top-level `import triton` anywhere in the port would break the
    CPU-only import; the B2 launcher imports it inside a function."""
    for f in sorted((ROOT / "fcd_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(n.split(".")[0] == "triton" for n in names), f


def test_model_trainer_raises_without_cuda(monkeypatch):
    from fcd_tpu_torch.train.trainer import ModelTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelTrainer(device="cuda")


def test_run_inference_raises_without_cuda(monkeypatch, tmp_path):
    from fcd_tpu_torch.cli.infer import main, run_inference
    from fcd_tpu_torch.config import get_default_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference(str(tmp_path), str(tmp_path / "out"), "",
                      get_default_params())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data_dir", str(tmp_path), "--save_dir", str(tmp_path),
              "--checkpoint_path", ""])


def test_train_cli_raises_without_cuda(monkeypatch, tmp_path):
    """python -m fcd_tpu_torch.cli.train without --device cpu needs a
    card: it raises before any training."""
    from fcd_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    split = tmp_path / "split.txt"
    split.write_text("a train\nb val\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--data_dir", str(tmp_path), "--split_file", str(split),
              "--splits", "train", "val", "--save_dir", str(tmp_path)])


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """A tensor on another device is refused, never silently run plain."""
    from fcd_tpu_torch.kernels.upsample import upsample2x

    x = torch.zeros(1, 2, 2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        upsample2x(x, torch.zeros(2, 2, 2, 4, 4, device="meta"))


def test_train_kernel_wrappers_refuse_other_devices():
    """K1-K4 take their plain versions only for CPU tensors: a tensor on
    another device is refused (on CUDA they launch the kernel or raise,
    tests/test_torch_port_cuda.py)."""
    from fcd_tpu_torch.kernels import spatial_attn as sa
    from fcd_tpu_torch.kernels.conv_wgrad import conv3d_wgrad
    from fcd_tpu_torch.kernels.finale import finale_bwd

    m = torch.zeros(1, 2, 2, 2, 4, device="meta")
    aff = torch.zeros(1, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d_wgrad(m, m)
    with pytest.raises(ValueError, match="unsupported device"):
        finale_bwd(m, m, aff, aff, aff, aff, m, None, 0.01)
    q = torch.zeros(1, 8, 4, device="meta")
    k = torch.zeros(1, 4, 8, device="meta")
    v = torch.zeros(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sa.spatial_attn_fwd(q, k, v, 2, 0, 0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        sa.spatial_attn_bwd(q, k, v, q, 2, 0, 0.0)
    from fcd_tpu_torch.kernels.sw_io import sw_entry, sw_exit

    vol = torch.zeros(2, 2, 2, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sw_entry(vol, (4, 4, 4), torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        sw_exit(vol, vol[..., :1], (0, 0, 0), (2, 2, 2))
    # on the CPU the plain versions run
    x = torch.randn(1, 2, 2, 2, 4)
    assert conv3d_wgrad(x, x).shape == (27, 4, 4)
