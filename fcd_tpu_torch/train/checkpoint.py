"""Checkpoints in the JAX package's file format, without msgpack or flax.

`fcd_tpu/train/checkpoint.py` writes `flax.serialization.to_bytes` of
{params, batch_stats, opt_state, step, epoch, extra}: msgpack whose array
leaves are msgpack extension types (`flax.serialization._MsgpackExtType`):

- ext 1, `ndarray`: the msgpack of (shape, dtype name, C-order bytes);
- ext 2, `native_complex`: the msgpack of (real, imag);
- ext 3, `npscalar`: a 0-d `ndarray` payload, read back as a numpy scalar.

Arrays over `MAX_CHUNK_SIZE` bytes are split by flax into
{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
..., ...}}; both directions here handle that form too.

This module carries its own msgpack decoder and encoder for what flax
emits (maps, arrays, str, bin, ints, floats, bool, nil and the three
extension types), so the card's machine, which has no `msgpack`, reads and
writes the same files. bfloat16 leaves are widened to float32 on load
(exactly), since numpy has no bfloat16. The optimizer state is neither
read nor written yet (ROADMAP Queue A2).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# -- msgpack decoding --------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(payload)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(payload)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(payload)
        return complex(re, im)
    raise ValueError(f"unknown msgpack extension type {code}")


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode()
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack("BHI"[b - 0xC4])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack("BHI"[b - 0xC7])
        code = r.unpack("b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack("f")
    if b == 0xCB:
        return r.unpack("d")
    if 0xCC <= b <= 0xCF:
        return r.unpack("BHIQ"[b - 0xCC])
    if 0xD0 <= b <= 0xD3:
        return r.unpack("bhiq"[b - 0xD0])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack("b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if b in (0xD9, 0xDA, 0xDB):
        return bytes(r.take(r.unpack("BHI"[b - 0xD9]))).decode()
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.unpack("HI"[b - 0xDC]))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack("HI"[b - 0xDE]))
    raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _unchunk(tree):
    """flax's chunked-array dicts back into arrays, recursively."""
    if isinstance(tree, dict):
        if tree.get(_CHUNKED):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """One msgpack object from `data` (flax's extension types decoded)."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def msgpack_restore(data: bytes):
    """`flax.serialization.msgpack_restore`: the tree of a flax file."""
    return _unchunk(unpackb(data))


# -- msgpack encoding --------------------------------------------------------

def _length(out: bytearray, n: int, codes) -> None:
    """The narrowest of the (type byte, struct format) length headers."""
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


_STR = ((0xD9, "B"), (0xDA, "H"), (0xDB, "I"))
_BIN = ((0xC4, "B"), (0xC5, "H"), (0xC6, "I"))
_EXT = ((0xC7, "B"), (0xC8, "H"), (0xC9, "I"))
_ARRAY = ((0xDC, "H"), (0xDD, "I"))
_MAP = ((0xDE, "H"), (0xDF, "I"))


def _write_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                                 (0xCE, "I", 0xFFFFFFFF),
                                 (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise ValueError(f"integer {v} too large for msgpack")
    else:
        for code, fmt, bits in ((0xD0, "b", 7), (0xD1, "h", 15), (0xD2, "i", 31),
                                (0xD3, "q", 63)):
            if v >= -(1 << bits):
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise ValueError(f"integer {v} too small for msgpack")


def _write_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _length(out, n, _EXT)
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(a: np.ndarray) -> bytes:
    return packb([list(a.shape), a.dtype.name,
                  np.ascontiguousarray(a).tobytes("C")])


def _write(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise ValueError("object arrays cannot be written")
        _write_ext(out, EXT_NDARRAY, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _write_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
    elif isinstance(v, int):
        _write_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, complex):
        _write_ext(out, EXT_COMPLEX, packb([v.real, v.imag]))
    elif isinstance(v, str):
        b = v.encode()
        if len(b) <= 31:
            out.append(0xA0 | len(b))
        else:
            _length(out, len(b), _STR)
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _length(out, len(b), _BIN)
        out += b
    elif isinstance(v, (list, tuple)):
        if len(v) <= 15:
            out.append(0x90 | len(v))
        else:
            _length(out, len(v), _ARRAY)
        for x in v:
            _write(out, x)
    elif isinstance(v, dict):
        if len(v) <= 15:
            out.append(0x80 | len(v))
        else:
            _length(out, len(v), _MAP)
        for k, x in v.items():
            _write(out, k)
            _write(out, x)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def packb(obj) -> bytes:
    out = bytearray()
    _write(out, obj)
    return bytes(out)


def _chunk(tree):
    """Arrays over MAX_CHUNK_SIZE bytes in flax's chunked form."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        n = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + n] for i in range(0, flat.size, n)]
        return {_CHUNKED: True,
                "shape": {str(i): s for i, s in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """`flax.serialization.msgpack_serialize` of a tree of dicts, numbers
    and numpy arrays."""
    return packb(_chunk(tree))


# -- checkpoints --------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_checkpoint(path: str, variables, *, epoch: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    step: int = 0) -> None:
    """Write {params, batch_stats, step, epoch, extra} as the JAX package's
    `save_checkpoint` does (no opt_state yet: ROADMAP Queue A2). variables:
    the `{"params", "batch_stats"}` tree of numpy arrays
    (`weights.export_flax_variables`)."""
    payload = {
        "params": _numpy_tree(variables["params"]),
        "batch_stats": _numpy_tree(variables.get("batch_stats", {})),
        "step": np.asarray(step, np.int32),
        "epoch": -1 if epoch is None else int(epoch),
        "extra": dict(extra or {}),
    }
    data = msgpack_serialize(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Read a checkpoint of the JAX package (or of `save_checkpoint`).
    Returns (variables, epoch, extra): variables is {"params",
    "batch_stats"} of numpy arrays; a params-only file (a bare params
    tree, which `fcd_tpu/train/checkpoint.py:53-57` accepts) gives
    {"params": tree}, epoch None and extra {}."""
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    if "params" not in raw:
        return {"params": raw}, None, {}
    variables = {"params": raw["params"],
                 "batch_stats": raw.get("batch_stats", {})}
    epoch = int(raw.get("epoch", -1))
    return variables, (None if epoch < 0 else epoch), raw.get("extra", {})
