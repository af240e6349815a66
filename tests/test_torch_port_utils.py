"""The port's profiling and energy utilities against the JAX package's
(CPU).

(a) `utils/profiling.py`: `compiled_cost` counts a matmul's 2mnk FLOPs
(as tests/test_utils.py holds the JAX one) and a conv's, and the bytes of
each op's operands; `StepTimer`'s MFU against the device's peak (the CPU's
1 TFLOP/s, an H100's 989); `get_model_flops` on BaseUNet: the JAX
package's parameter count, and a FLOP count within 2x of XLA's (the port
counts products only, every tap of a padded conv; XLA every op, the
in-volume taps only: both differences shown on one conv).
(b) `utils/energy.py`: the emissions CSV has the JAX columns; the RAPL
helpers read the same counters from a powercap tree and give the same
wraparound-corrected deltas; a CUDA device's envelope is its power limit
from `nvidia-smi` (here a stand-in answers), named in the CSV.
(c) `python -m fcd_tpu_torch.cli.train --emission_tracking --device cpu`
end to end: the run's `train_emission.csv`.
"""

import csv
import os
import subprocess
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.models.factory import count_params as jax_count_params
from fcd_tpu.models.factory import get_model as jax_get_model
from fcd_tpu.models.factory import init_model
from fcd_tpu.utils import energy as jenergy
from fcd_tpu.utils import profiling as jprof
from fcd_tpu_torch.cli import train as cli_train
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.utils import energy as tenergy
from fcd_tpu_torch.utils import profiling as tprof

import torch_port_workers

torch_port_workers.share_cores()


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (16, 48, 80)])
def test_compiled_cost_counts_matmul_flops(m, n, k):
    a, b = torch.rand(m, k), torch.rand(k, n)
    cost = tprof.compiled_cost(lambda x, y: x @ y, a, b)
    assert cost["flops"] == 2 * m * n * k
    assert cost["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    want = jprof.compiled_cost(lambda x, y: x @ y,
                               jax.ShapeDtypeStruct((m, k), jnp.float32),
                               jax.ShapeDtypeStruct((k, n), jnp.float32))
    assert want["flops"] == cost["flops"]


@pytest.mark.parametrize("n", [1, 8])
def test_compiled_cost_counts_conv_flops(n):
    """Every tap of the padded conv; XLA counts the in-volume taps."""
    x, w = torch.rand(1, 4, n, n, n), torch.rand(4, 4, 3, 3, 3)
    cost = tprof.compiled_cost(
        lambda a, b: torch.nn.functional.conv3d(a, b, padding=1), x, w)
    assert cost["flops"] == 2 * n ** 3 * 16 * 27
    want = jprof.compiled_cost(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC")),
        jax.ShapeDtypeStruct((1, n, n, n, 4), jnp.float32),
        jax.ShapeDtypeStruct((3, 3, 3, 4, 4), jnp.float32))
    taps = sum(min(n, i + 2) - max(0, i - 1) for i in range(n)) ** 3
    assert want["flops"] == 2 * 16 * taps


def test_step_timer_mfu():
    t = tprof.StepTimer(flops_per_step=1e9, device="cpu")
    for _ in range(3):
        t.start()
        time.sleep(0.01)
        t.stop()
    s = t.summary()
    assert s["mean_step_s"] >= 0.01
    assert s["mfu"] == pytest.approx(1e9 / s["mean_step_s"] / 1e12)
    assert 0 < s["mfu"] < 1
    assert tprof.StepTimer().summary() == {}


def test_device_peak_flops(monkeypatch):
    assert tprof.device_peak_flops("cpu") == 1e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tprof.device_peak_flops("cuda") == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Card")
    with pytest.raises(ValueError, match="peak"):
        tprof.device_peak_flops("cuda")
    assert not any("tpu" in k for k in tprof.PEAK_FLOPS)


def test_get_model_flops_matches_jax_params():
    settings = dict(model_type="BASEUNET", patch_size=32, feature_size=4,
                    chans_in=2, chans_out=2, use_amp=False)
    p = get_default_params()
    p.update(settings)
    model, p = get_model(p)
    flops, n_params = tprof.get_model_flops(model, p)
    jp = jax_default_params()
    jp.update(settings)
    jmodel, jp = jax_get_model(jp)
    variables = init_model(jmodel, jp)
    jflops, jn = jprof.get_model_flops(jmodel, jp, variables)
    assert n_params == jn == jax_count_params(variables)
    assert 0.5 * jflops < flops < 2 * jflops


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as d:
        torch.rand(32, 32) @ torch.rand(32, 32)
    assert d == str(tmp_path)
    assert (tmp_path / "trace.json").stat().st_size > 0


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_emissions_csv_has_the_jax_columns(tmp_path):
    rows = {}
    for name, energy in (("jax", jenergy), ("port", tenergy)):
        with energy.EmissionsTracker(output_dir=str(tmp_path),
                                     output_file=f"{name}.csv",
                                     power_w=100.0) as tr:
            time.sleep(0.02)
        assert tr.final_emissions > 0
        rows[name] = _csv_rows(tmp_path / f"{name}.csv")
    assert rows["port"][0] == rows["jax"][0]
    assert len(rows["port"]) == 2
    got, want = rows["port"][1], rows["jax"][1]
    assert got[1] == want[1] and got[3] == want[3] == "100.0"
    assert got[6] == want[6]                   # host_measurement
    assert "100.0W envelope" in got[-1]


def test_cpu_and_cuda_envelopes(tmp_path, monkeypatch):
    assert tenergy.device_envelope("cpu") == ("cpu envelope", 65.0)
    assert tenergy.DEVICE_POWER_W == {"cpu": 65.0}
    seen = []

    def smi(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00\n", stderr="")

    monkeypatch.setattr(tenergy.subprocess, "run", smi)
    assert tenergy.device_envelope("cuda:1") == (
        "power.limit of NVIDIA H100 80GB HBM3", 700.0)
    assert seen[-1][:2] == ["nvidia-smi", "--id=1"]
    with tenergy.EmissionsTracker(output_dir=str(tmp_path),
                                  output_file="e.csv", device="cuda"):
        pass
    row = _csv_rows(tmp_path / "e.csv")[1]
    assert row[3] == "700.0"
    assert "700.0W envelope (power.limit of NVIDIA H100 80GB HBM3)" in row[-1]

    def missing(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(tenergy.subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="power limit"):
        tenergy.EmissionsTracker(device="cuda")


@pytest.mark.parametrize("wrap", [False, True])
def test_rapl_helpers_match_jax(tmp_path, monkeypatch, wrap):
    """A powercap tree with two packages and a subzone, read by both."""
    for zone, uj, top in (("intel-rapl:0", 1000, 10 ** 6),
                          ("intel-rapl:1", 5000, 10 ** 6),
                          ("intel-rapl:0:0", 7, 10 ** 6)):
        os.makedirs(tmp_path / zone)
        (tmp_path / zone / "energy_uj").write_text(f"{uj}\n")
        (tmp_path / zone / "max_energy_range_uj").write_text(f"{top}\n")
    glob_ = str(tmp_path / "intel-rapl:*")
    monkeypatch.setattr(jenergy, "_RAPL_GLOB", glob_)
    monkeypatch.setattr(tenergy, "_RAPL_GLOB", glob_)
    before = tenergy.read_rapl_uj()
    assert before == jenergy.read_rapl_uj() == {"intel-rapl:0": 1000,
                                                "intel-rapl:1": 5000}
    after = {"intel-rapl:0": 500 if wrap else 4000, "intel-rapl:1": 6000}
    got = tenergy.rapl_delta_joules(before, after)
    assert got == jenergy.rapl_delta_joules(before, after)
    assert got == pytest.approx(((10 ** 6 - 500) if wrap else 3000) * 1e-6
                                + 1000e-6)
    monkeypatch.setattr(tenergy, "_RAPL_GLOB", str(tmp_path / "none:*"))
    assert tenergy.read_rapl_uj() is None


def test_cli_train_emission_tracking(tmp_path, monkeypatch):
    """--emission_tracking on the CPU: the run's train_emission.csv, with
    the JAX columns and the CPU's envelope."""
    from fcd_tpu_torch.data import nifti

    monkeypatch.setenv("WANDB_MODE", "disabled")
    rng = np.random.RandomState(0)
    for subj in ("sub-01", "sub-02"):
        d = tmp_path / "data" / subj / "anat"
        os.makedirs(d)
        vol = rng.rand(24, 24, 24).astype(np.float32) * 0.2
        gt = np.zeros_like(vol)
        gt[8:16, 8:16, 8:16] = 1
        nifti.save(str(d / "t1_reg.nii.gz"), vol + gt * 0.8)
        nifti.save(str(d / "flair_reg.nii.gz"), (vol + gt * 0.8) * 0.9)
        nifti.save(str(d / "gt_reg.nii.gz"), gt)
    split = tmp_path / "split.txt"
    split.write_text("sub-01 train\nsub-02 val\n")
    tr = cli_train.main([
        "--data_dir", str(tmp_path / "data"), "--split_file", str(split),
        "--splits", "train", "val", "--model_type", "BASEUNET",
        "--device", "cpu", "--save_dir", str(tmp_path / "runs"),
        "--emission_tracking", "--kwargs", "patch_size=32", "feature_size=4",
        "max_epochs=1", "min_epochs=0", "warmup_epochs=1", "use_amp=False",
        "samples_per_case=1"])
    rows = _csv_rows(os.path.join(tr.save_dir, "train_emission.csv"))
    with jenergy.EmissionsTracker(output_dir=str(tmp_path),
                                  output_file="j.csv", power_w=1.0):
        pass
    assert rows[0] == _csv_rows(tmp_path / "j.csv")[0]
    assert len(rows) == 2 and rows[1][3] == "65.0"
    assert "(cpu envelope)" in rows[1][-1]
