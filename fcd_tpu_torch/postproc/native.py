"""ctypes binding for the native post-processing ops
(fcd_tpu_torch/cpp/fcdops.cpp, a copy of fcd_tpu/cpp/fcdops.cpp), compiled
on first use with g++ into build/fcd_tpu_torch/ under the repository root,
named by a hash of the source. Every entry point has the scipy path of
fcd_tpu_torch.postproc.morphology for when g++ or the library is absent,
as in the JAX package; `backend()` says which of the two runs."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from fcd_tpu_torch.kernels._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[1] / "cpp" / "fcdops.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()
    return BUILD_DIR / f"libfcdops-{digest[:12]}.so"


def _build(lib: Path) -> bool:
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
           str(tmp)]
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        lib_path = _lib_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None

        i64, i32, u8p, i32p, i64p = (
            ctypes.c_int64,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        )
        lib.connected_components_3d.restype = i64
        lib.connected_components_3d.argtypes = [u8p, i64, i64, i64, i32, i32p]
        lib.binary_morph.restype = None
        lib.binary_morph.argtypes = [u8p, i64, i64, i64, u8p, i32, i32, i32, i32, i32, u8p]
        lib.binary_fill_holes.restype = None
        lib.binary_fill_holes.argtypes = [u8p, i64, i64, i64, u8p, i32, i32, i32, u8p]
        lib.component_sizes.restype = None
        lib.component_sizes.argtypes = [i32p, i64, i64, i64p]
        f64, f64p = ctypes.c_double, np.ctypeslib.ndpointer(
            np.float64, flags="C_CONTIGUOUS")
        lib.edt_3d.restype = i32
        lib.edt_3d.argtypes = [u8p, i64, i64, i64, f64, f64, f64, f64p]
        lib.neighbour_code_3d.restype = None
        lib.neighbour_code_3d.argtypes = [u8p, i64, i64, i64, u8p]
        _LIB = lib
        return _LIB


def backend() -> str:
    """Which post-processing path runs: "g++" (the native library) or
    "scipy" (the library could not be built or loaded)."""
    return "g++" if get_lib() is not None else "scipy"


def native_connected_components(mask: np.ndarray, connectivity: int = 26):
    """int32 labels + count, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    labels = np.zeros(mask.shape, np.int32)
    n = lib.connected_components_3d(
        mask, mask.shape[0], mask.shape[1], mask.shape[2], connectivity, labels
    )
    return labels, int(n)


def native_morph(mask: np.ndarray, structure: np.ndarray, iterations: int,
                 erosion: bool):
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    structure = np.ascontiguousarray(structure.astype(np.uint8))
    rz, ry, rx = (s // 2 for s in structure.shape)
    out = np.zeros(mask.shape, np.uint8)
    lib.binary_morph(
        mask, mask.shape[0], mask.shape[1], mask.shape[2],
        structure, rz, ry, rx, iterations, int(erosion), out,
    )
    return out


def native_edt(mask: np.ndarray, sampling) -> Optional[np.ndarray]:
    """Exact EDT with scipy.ndimage.distance_transform_edt semantics: for
    every nonzero voxel the distance to the nearest zero voxel (per-axis
    `sampling` pitch). None if the native lib is unavailable. A mask with no
    zero voxel returns +inf everywhere (scipy returns large finite values
    there; our only callers guard that case)."""
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if mask.ndim != 3:
        return None
    sz, sy, sx = (float(s) for s in np.broadcast_to(np.asarray(sampling, np.float64), (3,)))
    out = np.zeros(mask.shape, np.float64)
    no_zero = lib.edt_3d(mask, mask.shape[0], mask.shape[1], mask.shape[2],
                         sz, sy, sx, out)
    if no_zero:
        out[:] = np.inf
    return out


def native_neighbour_code(mask: np.ndarray) -> Optional[np.ndarray]:
    """2x2x2 surface-distance bit-code correlation (constant-0 padding),
    equal to scipy.ndimage.correlate(mask, KERNEL, mode='constant')."""
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if mask.ndim != 3:
        return None
    out = np.zeros(mask.shape, np.uint8)
    lib.neighbour_code_3d(mask, mask.shape[0], mask.shape[1], mask.shape[2], out)
    return out


def native_fill_holes(mask: np.ndarray, structure: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    structure = np.ascontiguousarray(structure.astype(np.uint8))
    rz, ry, rx = (s // 2 for s in structure.shape)
    out = np.zeros(mask.shape, np.uint8)
    lib.binary_fill_holes(
        mask, mask.shape[0], mask.shape[1], mask.shape[2], structure, rz, ry, rx, out
    )
    return out
