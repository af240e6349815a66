"""Energy / carbon tracking (CodeCarbon-equivalent capability).

Counterpart of `fcd_tpu/utils/energy.py` (host code, copied): the same CSV
columns and RAPL helpers. The accelerator's envelope is the card's own:
for a CUDA device, its `power.limit` as `nvidia-smi` reports it (a card
may be set below its maximum); the CPU keeps the JAX table's 65 W. The
table holds no TPU envelope.

The reference wraps training in a CodeCarbon EmissionsTracker and writes
an emissions CSV (train.py:470-485); CodeCarbon MEASURES host-CPU power
via RAPL and GPU power via NVML. CodeCarbon is not available in this
environment, so this tracker:

- MEASURES host-CPU package energy via the Linux powercap RAPL sysfs
  (`/sys/class/powercap/intel-rapl:*/energy_uj`) when present — the same
  counter CodeCarbon reads — with wraparound correction; and
- ESTIMATES accelerator energy from wall-clock time x the device's power
  envelope (the card's power limit: an upper bound on its draw).

The CSV labels each component `rapl_measured` or `estimated` so measured
and assumed numbers are never conflated.
"""

from __future__ import annotations

import csv
import glob
import os
import subprocess
import time
from typing import Dict, Optional, Tuple

# conservative board-level power envelopes (watts); a CUDA card's is read
# from the card (`cuda_power_limit`)
DEVICE_POWER_W = {
    "cpu": 65.0,
}
# world-average grid carbon intensity, kg CO2eq per kWh
CARBON_INTENSITY_KG_PER_KWH = 0.475

_RAPL_GLOB = "/sys/class/powercap/intel-rapl:*"


def _rapl_zones() -> Dict[str, str]:
    """Top-level RAPL package zones (intel-rapl:N, not subzones :N:M)."""
    zones = {}
    for path in glob.glob(_RAPL_GLOB):
        base = os.path.basename(path)
        if base.count(":") != 1:          # skip subzones like intel-rapl:0:1
            continue
        if os.path.exists(os.path.join(path, "energy_uj")):
            zones[base] = path
    return zones


def read_rapl_uj() -> Optional[Dict[str, int]]:
    """Current per-package energy counters in microjoules, or None if the
    powercap interface is absent/unreadable (containers often deny it)."""
    zones = _rapl_zones()
    if not zones:
        return None
    out = {}
    try:
        for name, path in zones.items():
            with open(os.path.join(path, "energy_uj")) as f:
                out[name] = int(f.read().strip())
    except OSError:
        return None
    return out


def _rapl_max_uj(name: str) -> int:
    try:
        with open(os.path.join(os.path.dirname(_RAPL_GLOB), name,
                               "max_energy_range_uj")) as f:
            return int(f.read().strip())
    except OSError:
        return 0


def rapl_delta_joules(before: Dict[str, int],
                      after: Dict[str, int]) -> float:
    """Summed per-package energy delta in joules, wraparound-corrected."""
    total_uj = 0
    for name, a in after.items():
        b = before.get(name)
        if b is None:
            continue
        d = a - b
        if d < 0:  # counter wrapped
            d += _rapl_max_uj(name) or 0
            if d < 0:
                continue
        total_uj += d
    return total_uj / 1e6


def cuda_power_limit(index: int = 0) -> Tuple[str, float]:
    """(name, power limit in watts) of CUDA card `index`, from
    `nvidia-smi --query-gpu=name,power.limit`. Raises when nvidia-smi is
    absent or does not report the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30).stdout
        name, watts = out.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(watts)
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        raise RuntimeError(f"the power limit of CUDA card {index} is not "
                           f"readable through nvidia-smi: {e}") from e


def device_envelope(device: str) -> Tuple[str, float]:
    """(what the envelope is, watts) of a device string: 'cpu', or 'cuda'
    / 'cuda:N' (that card's power limit)."""
    if device.startswith("cuda"):
        index = int(device.split(":")[1]) if ":" in device else 0
        name, watts = cuda_power_limit(index)
        return f"power.limit of {name}", watts
    if device not in DEVICE_POWER_W:
        raise ValueError(f"no power envelope for device {device!r}: "
                         f"{sorted(DEVICE_POWER_W)} or cuda[:N]")
    return f"{device} envelope", DEVICE_POWER_W[device]


class EmissionsTracker:
    """Context manager mirroring the reference's tracker contract:
    .final_emissions (kg CO2eq) after exit, CSV written to output_dir.

    Host-CPU energy is RAPL-measured when the powercap sysfs is readable;
    accelerator energy is always a wall-clock x envelope estimate."""

    def __init__(
        self,
        project_name: str = "fcd_detection",
        output_dir: str = ".",
        output_file: str = "emissions.csv",
        device: str = "cuda",
        power_w: Optional[float] = None,
        save_to_file: bool = True,
    ):
        self.project_name = project_name
        self.output_dir = output_dir
        self.output_file = output_file
        if power_w is None:
            self.envelope, self.power_w = device_envelope(device)
        else:
            self.envelope, self.power_w = "given", float(power_w)
        self.save_to_file = save_to_file
        self.final_emissions: Optional[float] = None
        self.final_energy_kwh: Optional[float] = None
        self.host_energy_kwh: Optional[float] = None
        self.host_method: str = "estimated"
        self._t0: Optional[float] = None
        self._rapl0: Optional[Dict[str, int]] = None

    def __enter__(self):
        self._t0 = time.time()
        self._rapl0 = read_rapl_uj()
        return self

    def __exit__(self, *exc):
        duration_s = time.time() - self._t0
        # accelerator: wall time x its envelope
        device_kwh = self.power_w * duration_s / 3600.0 / 1000.0
        # host CPU: RAPL measurement when available
        rapl1 = read_rapl_uj() if self._rapl0 is not None else None
        if self._rapl0 is not None and rapl1 is not None:
            self.host_energy_kwh = (
                rapl_delta_joules(self._rapl0, rapl1) / 3.6e6)
            self.host_method = "rapl_measured"
        else:
            self.host_energy_kwh = (
                DEVICE_POWER_W["cpu"] * duration_s / 3600.0 / 1000.0)
            self.host_method = "estimated"
        self.final_energy_kwh = device_kwh + self.host_energy_kwh
        self.final_emissions = self.final_energy_kwh * CARBON_INTENSITY_KG_PER_KWH
        if self.save_to_file:
            os.makedirs(self.output_dir, exist_ok=True)
            path = os.path.join(self.output_dir, self.output_file)
            exists = os.path.exists(path)
            with open(path, "a", newline="") as f:
                w = csv.writer(f)
                if not exists:
                    w.writerow(
                        ["timestamp", "project_name", "duration_s",
                         "assumed_device_power_w",
                         "device_energy_kwh_estimated",
                         "host_energy_kwh", "host_measurement",
                         "total_energy_kwh", "emissions_kg",
                         "estimation_method"]
                    )
                w.writerow(
                    [time.strftime("%Y-%m-%dT%H:%M:%S"), self.project_name,
                     f"{duration_s:.2f}", self.power_w,
                     f"{device_kwh:.6f}",
                     f"{self.host_energy_kwh:.6f}", self.host_method,
                     f"{self.final_energy_kwh:.6f}",
                     f"{self.final_emissions:.6f}",
                     f"device: wall_time x {self.power_w}W envelope "
                     f"({self.envelope}); "
                     f"host: {self.host_method}; grid "
                     f"{CARBON_INTENSITY_KG_PER_KWH} kgCO2eq/kWh world-avg"]
                )
        return False
