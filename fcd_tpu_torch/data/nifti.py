"""Minimal, dependency-free NIfTI-1 I/O with affine/orientation handling.

A copy of `fcd_tpu/data/nifti.py` (pure numpy and gzip), kept so that the
port never imports the JAX package.

The reference pipeline leans on nibabel for NIfTI loading and MONAI's
``Orientationd(axcodes="RAS")`` for canonical orientation
(reference: get_transforms.py:52-55). This module provides the same
capability for the host-side data path: parse NIfTI-1 headers (.nii /
.nii.gz), produce the sform/qform affine, reorient volumes to RAS, and
write predictions back to disk in the native grid.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume: data array + voxel-to-world affine."""

    data: np.ndarray
    affine: np.ndarray                      # 4x4 voxel -> world (mm)
    header: dict = field(default_factory=dict)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def spacing(self) -> Tuple[float, float, float]:
        """Voxel spacing in mm along each of the 3 spatial axes."""
        return tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _quaternion_to_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = hdr["pixdim"][0]
    if qfac == 0:
        qfac = 1.0
    zooms = np.array([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * zooms[None, :]
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < 348:
        raise ValueError("Not a NIfTI-1 file: header too short")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr_be = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr_be == 348:
            endian = ">"
        else:
            raise ValueError("Not a NIfTI-1 file (sizeof_hdr != 348)")

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    hdr = {}
    hdr["endian"] = endian
    hdr["dim"] = u("8h", 40)
    hdr["datatype"] = u("h", 70)[0]
    hdr["bitpix"] = u("h", 72)[0]
    hdr["pixdim"] = u("8f", 76)
    hdr["vox_offset"] = u("f", 108)[0]
    hdr["scl_slope"] = u("f", 112)[0]
    hdr["scl_inter"] = u("f", 116)[0]
    hdr["qform_code"] = u("h", 252)[0]
    hdr["sform_code"] = u("h", 254)[0]
    hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"] = u("3f", 256)
    hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"] = u("3f", 268)
    hdr["srow_x"] = u("4f", 280)
    hdr["srow_y"] = u("4f", 296)
    hdr["srow_z"] = u("4f", 312)
    hdr["magic"] = raw[344:348]
    return hdr


def _affine_from_header(hdr: dict) -> np.ndarray:
    if hdr["sform_code"] > 0:
        aff = np.eye(4)
        aff[0, :] = hdr["srow_x"]
        aff[1, :] = hdr["srow_y"]
        aff[2, :] = hdr["srow_z"]
        return aff
    if hdr["qform_code"] > 0:
        return _quaternion_to_affine(hdr)
    # fall back to scaled identity
    aff = np.diag([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3], 1.0])
    return aff


def load(path: str, dtype=np.float32) -> NiftiImage:
    """Load a .nii / .nii.gz file. Volumes are returned in on-disk axis order
    (Fortran layout, like nibabel's get_fdata)."""
    raw = _read_bytes(path)
    hdr = _parse_header(raw)
    ndim = hdr["dim"][0]
    shape = tuple(int(s) for s in hdr["dim"][1 : 1 + ndim])
    # squeeze trailing singleton dims (common for 3D volumes stored as 4D)
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr['datatype']} in {path}")
    offset = int(hdr["vox_offset"]) if hdr["vox_offset"] else 352
    count = int(np.prod(shape))
    arr = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(hdr["endian"]), count=count, offset=offset
    )
    arr = arr.reshape(shape, order="F")
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if dtype is not None:
        arr = arr.astype(dtype)
    if slope not in (0.0, 1.0) or inter != 0.0:
        if slope == 0.0:
            slope = 1.0
        arr = arr * slope + inter
        if dtype is not None:
            arr = arr.astype(dtype)
    return NiftiImage(data=np.ascontiguousarray(arr), affine=_affine_from_header(hdr), header=hdr)


def save(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None) -> None:
    """Write a 3D volume as NIfTI-1 (.nii or .nii.gz) with an sform affine."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    zooms = [float(np.linalg.norm(affine[:3, i])) for i in range(min(3, data.ndim))]
    pixdim = [1.0] + zooms + [1.0] * (7 - len(zooms))
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)           # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)             # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)             # scl_inter
    struct.pack_into("<h", hdr, 252, 0)               # qform_code
    struct.pack_into("<h", hdr, 254, 1)               # sform_code (scanner anat)
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = b"n+1\x00"

    body = np.asfortranarray(data).tobytes(order="F")
    blob = bytes(hdr) + body
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


# ---------------------------------------------------------------------------
# Orientation: reorient any volume+affine to RAS+ (MONAI Orientationd parity)
# ---------------------------------------------------------------------------

def io_orientation(affine: np.ndarray) -> np.ndarray:
    """Return (3, 2) array mapping input axes -> (output axis, flip).

    Row i gives, for input axis i, the world axis it most aligns with
    (0=L/R, 1=P/A, 2=I/S) and +1/-1 for direction — same contract as
    nibabel.io_orientation, implemented independently via greedy argmax
    on the normalized rotation part.
    """
    R = affine[:3, :3].astype(np.float64).copy()
    # normalize columns
    lengths = np.sqrt((R ** 2).sum(axis=0))
    lengths[lengths == 0] = 1.0
    Q = R / lengths[None, :]
    ornt = np.zeros((3, 2))
    remaining_rows = [0, 1, 2]
    remaining_cols = [0, 1, 2]
    # greedy assignment by largest |cosine|
    for _ in range(3):
        sub = np.abs(Q[np.ix_(remaining_rows, remaining_cols)])
        r_i, c_i = np.unravel_index(np.argmax(sub), sub.shape)
        row = remaining_rows[r_i]
        col = remaining_cols[c_i]
        ornt[col, 0] = row
        ornt[col, 1] = 1.0 if Q[row, col] >= 0 else -1.0
        remaining_rows.remove(row)
        remaining_cols.remove(col)
    return ornt


def to_ras(data: np.ndarray, affine: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient a 3D volume to RAS+ axis order; returns (data, new_affine)."""
    ornt = io_orientation(affine)
    # flip axes pointing in negative world direction
    out = data
    aff = affine.copy()
    for axis in range(3):
        if ornt[axis, 1] < 0:
            out = np.flip(out, axis=axis)
            # affine update: x' = (n-1) - x on that axis
            n = data.shape[axis]
            flip = np.eye(4)
            flip[axis, axis] = -1
            flip[axis, 3] = n - 1
            aff = aff @ flip
    # transpose so input axis i sits at world position ornt[i, 0]
    perm = np.argsort(ornt[:, 0]).astype(int)
    if not np.array_equal(perm, [0, 1, 2]):
        out = np.transpose(out, axes=tuple(perm) + tuple(range(3, out.ndim)))
        P = np.eye(4)
        P3 = np.zeros((3, 3))
        for new_ax, old_ax in enumerate(perm):
            P3[old_ax, new_ax] = 1
        P[:3, :3] = P3
        aff = aff @ P
    return np.ascontiguousarray(out), aff


def load_ras(path: str, dtype=np.float32) -> NiftiImage:
    """Load and reorient to RAS+ in one step."""
    img = load(path, dtype=dtype)
    data, aff = to_ras(img.data, img.affine)
    return NiftiImage(data=data, affine=aff, header=img.header)
