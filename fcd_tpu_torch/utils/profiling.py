"""Profiling utilities: FLOPs counting, step timing, MFU, device traces.

Counterpart of `fcd_tpu/utils/profiling.py` (the reference's thop/fvcore
counters, get_model.py:251-271, and its per-epoch wall times): the JAX
package reads XLA's cost analysis of the compiled computation; the port
counts while it runs the function once:

- FLOPs from `torch.utils.flop_counter.FlopCounterMode`, which counts the
  products (matmuls, convolutions, attention) at 2 per multiply-add, a
  padded conv's every tap included (what the kernels compute). XLA's
  count differs both ways: it also counts every elementwise op (norms,
  activations, softmax), and it leaves out the taps that fall on a
  "SAME" conv's zero padding (a 3x3x3 conv on a 1^3 grid: 1 tap of 27),
  so on the small grids of a U-Net's deep levels the port counts more;
- bytes as the sum, over the aten ops the function runs, of each op's
  tensor inputs and outputs (a `TorchDispatchMode`): what the ops would
  move if nothing stayed in a cache or were fused.

`StepTimer` reports MFU against the device's dense peak: 989 TFLOP/s of
bf16 for an H100 (the peak PERF.md's bounds use), 1 TFLOP/s for the CPU.
`trace` writes a `torch.profiler` Chrome trace.
"""

from __future__ import annotations

import contextlib
import copy
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# dense peak per device (bf16 on the cards) for MFU accounting
PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 1e12,
}


def device_peak_flops(device=None) -> float:
    """The dense peak of `device` (default: the current card, or the CPU
    without one). Raises for a card the table does not hold."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cpu":
        return PEAK_FLOPS["cpu"]
    kind = torch.cuda.get_device_name(dev).lower()
    for key, val in PEAK_FLOPS.items():
        if key in kind:
            return val
    raise ValueError(f"no peak FLOP rate for {kind!r}: {sorted(PEAK_FLOPS)}")


class _BytesMode(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def compiled_cost(fn, *example_args) -> Dict[str, float]:
    """FLOPs / bytes accessed of one call of fn(*example_args) (the module
    docstring says what each counts)."""
    counter = FlopCounterMode(display=False)
    moved = _BytesMode()
    with torch.no_grad(), counter, moved:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(moved.bytes)}


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def get_model_flops(model: torch.nn.Module, params: Dict[str, Any],
                    device="cpu") -> Tuple[float, int]:
    """(forward FLOPs at the training patch size, parameter count), as
    `fcd_tpu/utils/profiling.py::get_model_flops`: the eval forward of a
    copy of `model` on `device` (the CPU by default, where the kernels
    run their plain versions), in f32, on zeros of (batch_size, *patch,
    chans_in)."""
    m = copy.deepcopy(model).to(device).float().eval().requires_grad_(False)
    if hasattr(m, "compute_dtype"):
        m.compute_dtype = torch.float32
    patch = params["patch_size"]
    patch = tuple(patch) if isinstance(patch, (tuple, list)) else (patch,) * 3
    x = torch.zeros((params.get("batch_size", 1), *patch, params["chans_in"]),
                    device=device)
    cost = compiled_cost(m, x)
    n_params = count_params(m)
    print(f"FLOPs: {cost['flops']:.3e}, Parameters: {n_params}")
    return cost["flops"], n_params


class StepTimer:
    """Accumulates step wall times and reports throughput + MFU. On a card
    it synchronises the device at start and stop, so a step's time is its
    device work's."""

    def __init__(self, flops_per_step: Optional[float] = None, device=None):
        self.flops_per_step = flops_per_step
        self.device = None if device is None else torch.device(device)
        self.times = []
        self._t0 = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        mean = sum(self.times) / len(self.times)
        out = {"mean_step_s": mean, "steps_per_s": 1.0 / mean}
        if self.flops_per_step:
            out["mfu"] = (self.flops_per_step / mean
                          / device_peak_flops(self.device))
        return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A torch.profiler trace of the block (the CPU and, when there is one,
    the card), written as a Chrome trace (`trace.json`, open in Perfetto)
    under log_dir (default: a directory in the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "fcd_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
