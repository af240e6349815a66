"""Build the CUDA sources in `fcd_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so one file takes seconds), written
to `build/fcd_tpu_torch/` under the repository root, and loaded with
ctypes. The library name carries a hash of the source, so an edited source
is rebuilt and a stale library is never loaded. `build_all()` starts one
`nvcc` per source at once and waits for all of them. nvcc runs with
`-Xptxas -v`; its log (each kernel's registers, shared memory and spills)
is kept beside the library as `lib<name>-<hash>.log` (`build_log`).

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fcd_tpu_torch"
SOURCES = ("conv3d", "conv3d_wgrad", "upsample", "dsa", "spatial_attn",
           "sw_io", "finale_head")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of fcd_tpu_torch "
                           "are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, all at once.
    Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = [], {}
    for name in names:
        lib = _lib_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log.decode()}")
        else:
            lib.with_suffix(".log").write_bytes(log)
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v) for the current library of
    `csrc/<name>.cu`, built on first use."""
    return build_all([name])[name].with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL) for a ctypes call."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on the current device. The raw handle,
    without building a `torch.cuda.Stream` (about 25 us of host time per
    launch on the card's host)."""
    import torch

    return ctypes.c_void_p(
        torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
