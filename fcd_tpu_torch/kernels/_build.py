"""Build the CUDA sources in `fcd_tpu_torch/csrc/` and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so one file takes seconds), written
to `build/fcd_tpu_torch/` under the repository root, and loaded with
ctypes. The library name carries a hash of the source, so an edited source
is rebuilt and a stale library is never loaded. `build_all()` starts one
`nvcc` per source at once and waits for all of them. nvcc runs with
`-Xptxas -v`; its log (each kernel's registers, shared memory and spills)
is kept beside the library as `lib<name>-<hash>.log` (`build_log`).
`dsa_f16` and `spatial_attn_f16` (`VARIANTS`) are `dsa.cu` and
`spatial_attn.cu` built again with `-DFCD_F16`: the same kernels on f16
operands (`csrc/h16.cuh`, ROADMAP C20). A library's hash covers its
source, the shared headers and its flags.

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
SOURCES = ("conv3d", "conv3d_wgrad", "upsample", "dsa", "dsa_f16", "dsa_f32",
           "spatial_attn", "spatial_attn_f16", "sw_io", "finale_head",
           "finale_bwd", "pool2x_bwd", "conv_finish")
# a library built from another library's source with flags of its own:
# name -> (source, flags)
VARIANTS = {"dsa_f16": ("dsa", ("-DFCD_F16",)),
            "spatial_attn_f16": ("spatial_attn", ("-DFCD_F16",))}
# included by the sources, part of every hash
HEADERS = ("h16.cuh", "tf32x3.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the end of a bf16-only kernel's refusal of another dtype
BF16_ONLY = (": it takes bf16 only, as its Pallas counterpart does; a model "
             "that computes in f32 or f16 takes the JAX package's route for "
             "those types, which launches no such kernel (ROADMAP C18, C20)")

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


def _source(name: str):
    """(the .cu file, its extra nvcc flags) of library `name`."""
    src, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", flags


def _lib_path(name: str) -> Path:
    src, flags = _source(name)
    data = src.read_bytes() + b"".join(
        (CSRC / h).read_bytes() for h in HEADERS)
    digest = hashlib.sha256(
        data + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()
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
        src, flags = _source(name)
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed:\n{log.decode()}")
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


class Launches:
    """A launch count of its own, for a wrapper that counts the instances
    of each operand type apart (`launches`, as on the wrappers)."""

    def __init__(self) -> None:
        self.launches = 0
