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
(exactly), since numpy has no bfloat16.

The optimizer state. The JAX trainer's `opt_state` is flax's
`serialization.to_state_dict` of `optax.inject_hyperparams(optax.adamw)`'s
state (`fcd_tpu/train/state.py:31-40`); with optax 0.2.6:

    {count: int32,
     hyperparams: {learning_rate, b1, b2, eps, eps_root, weight_decay}: f32,
     hyperparams_states: {},
     inner_state: {"0": {count: int32, mu: <params tree>, nu: <params tree>},
                   "1": {}, "2": {}}}

(inner_state "0" is scale_by_adam's state, "1" add_decayed_weights', "2"
scale_by_learning_rate's), and with gradient_accumulation_steps > 1
`optax.MultiSteps` around it:

    {mini_step: int32, gradient_step: int32, inner_opt_state: <the above>,
     acc_grads: <params tree>, skip_state: {}}

`export_opt_state` and `load_opt_state` map it to the port's optimizer
(`train/state.py`) without optax: both counts <-> torch AdamW's `step`,
mu <-> `exp_avg`, nu <-> `exp_avg_sq`, the hyperparameters <-> the
parameter group's lr, betas, eps and weight_decay (eps_root must be 0),
and MultiSteps' mini_step, gradient_step and acc_grads <-> its own.
Parameters are matched by their flax paths (`weights.param_entries`). An
opt_state of any other structure raises, naming what it found.
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
                    step: int = 0, opt_state=None) -> None:
    """Write {params, batch_stats, opt_state, step, epoch, extra} as the
    JAX package's `save_checkpoint` does. variables: the `{"params",
    "batch_stats"}` tree of numpy arrays (`weights.export_flax_variables`);
    opt_state: `export_opt_state`'s tree, or None to write none."""
    payload = {
        "params": _numpy_tree(variables["params"]),
        "batch_stats": _numpy_tree(variables.get("batch_stats", {})),
        **({} if opt_state is None else {"opt_state": _numpy_tree(opt_state)}),
        "step": np.asarray(step, np.int32),
        "epoch": -1 if epoch is None else int(epoch),
        "extra": dict(extra or {}),
    }
    data = msgpack_serialize(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def read_checkpoint(path: str) -> dict:
    """The tree of a checkpoint of the JAX package (or of
    `save_checkpoint`): {params, batch_stats, opt_state, step, epoch,
    extra}, opt_state where there is one; a params-only file is a bare
    params tree (no "params" key), which `fcd_tpu/train/checkpoint.py:
    53-56` accepts."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_checkpoint(path: str):
    """Read a checkpoint's weights. Returns (variables, epoch, extra):
    variables is {"params", "batch_stats"} of numpy arrays; a params-only
    file gives {"params": tree}, epoch None and extra {}."""
    raw = read_checkpoint(path)
    if "params" not in raw:
        return {"params": raw}, None, {}
    variables = {"params": raw["params"],
                 "batch_stats": raw.get("batch_stats", {})}
    epoch = int(raw.get("epoch", -1))
    return variables, (None if epoch < 0 else epoch), raw.get("extra", {})


# -- the optimizer state ---------------------------------------------------------

HYPERPARAMS = ("learning_rate", "b1", "b2", "eps", "eps_root", "weight_decay")
_INJECT_KEYS = {"count", "hyperparams", "hyperparams_states", "inner_state"}
_MULTI_KEYS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
               "skip_state"}


def _params_tree(entries, value) -> dict:
    """{flax path: value(parameter)} as a nested dict of f32 numpy arrays,
    1x1 conv kernels with their (1, 1, 1) axes."""
    out: dict = {}
    for path, t, is_1x1 in entries:
        a = value(t).detach().float().cpu().numpy()
        if is_1x1:
            a = a.reshape((1, 1, 1) + a.shape)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out


def _leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(v) for v in tree.values())
    return 1


def _read_params_tree(entries, tree, what: str):
    """[(parameter, f32 tensor of its shape)] from a flax-path tree that
    holds one leaf for each parameter and no other."""
    import torch

    from fcd_tpu_torch.weights import lookup

    found = _leaves(tree) if isinstance(tree, dict) else type(tree).__name__
    if found != len(entries):
        raise ValueError(f"opt_state {what}: expected a tree of "
                         f"{len(entries)} parameters, found {found}")
    out = []
    for path, t, _ in entries:
        try:
            a = np.asarray(lookup(tree, path), np.float32)
        except (KeyError, TypeError, IndexError):
            raise ValueError(f"opt_state {what}: no leaf at "
                             f"{'/'.join(path)}") from None
        if a.size != t.numel():
            raise ValueError(f"opt_state {what}/{'/'.join(path)}: shape "
                             f"{a.shape} does not fit {tuple(t.shape)}")
        out.append((t, torch.tensor(a.reshape(t.shape), device=t.device)))
    return out


def _adamw(optimizer, entries):
    """(the torch AdamW, the MultiSteps around it or None); raises unless
    `entries` name exactly the optimizer's parameters."""
    inner = getattr(optimizer, "inner", None)
    adamw, multi = (optimizer, None) if inner is None else (inner, optimizer)
    held = {id(p) for group in adamw.param_groups for p in group["params"]}
    if held != {id(t) for _, t, _ in entries}:
        raise ValueError("the flax paths do not name exactly the "
                         "optimizer's parameters")
    return adamw, multi


def export_opt_state(optimizer, entries) -> dict:
    """The optimizer's state in the JAX layout (the module docstring).
    entries: (flax path, parameter, is 1x1) of every parameter the
    optimizer holds (`weights.param_entries(model)`)."""
    import torch

    adamw, multi = _adamw(optimizer, entries)
    group = adamw.param_groups[0]
    steps = {int(adamw.state[t]["step"]) for _, t, _ in entries
             if adamw.state.get(t)}
    if len(steps) > 1:
        raise ValueError(f"the parameters' AdamW steps differ: {steps}")
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moment(name):
        return lambda t: (adamw.state[t][name] if adamw.state.get(t)
                          else torch.zeros_like(t))

    hyper = dict(zip(HYPERPARAMS, (group["lr"], *group["betas"],
                                   group["eps"], 0.0, group["weight_decay"])))
    inner = {
        "count": count,
        "hyperparams": {k: np.asarray(v, np.float32) for k, v in hyper.items()},
        "hyperparams_states": {},
        "inner_state": {"0": {"count": count,
                              "mu": _params_tree(entries, moment("exp_avg")),
                              "nu": _params_tree(entries,
                                                 moment("exp_avg_sq"))},
                        "1": {}, "2": {}},
    }
    if multi is None:
        return inner
    return {"mini_step": np.asarray(multi.mini_step, np.int32),
            "gradient_step": np.asarray(multi.gradient_step, np.int32),
            "inner_opt_state": inner,
            "acc_grads": _params_tree(entries, lambda t: multi.acc_grads[t]),
            "skip_state": {}}


def _keys(tree, want, what: str) -> None:
    found = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
    if not isinstance(tree, dict) or set(tree) != set(want):
        raise ValueError(f"opt_state {what}: expected keys {sorted(want)}, "
                         f"found {found}")


def load_opt_state(optimizer, entries, tree) -> None:
    """Set the optimizer's state from a JAX-layout opt_state tree (the
    module docstring); raises ValueError, naming what it found, on any
    other structure, or where the tree's kind (with or without MultiSteps)
    is not the optimizer's."""
    import torch

    adamw, multi = _adamw(optimizer, entries)
    if not isinstance(tree, dict):
        raise ValueError(f"opt_state: expected a dict, found "
                         f"{type(tree).__name__}")
    if set(tree) == _MULTI_KEYS:
        if multi is None:
            raise ValueError("opt_state holds optax.MultiSteps' state, but "
                             "gradient_accumulation_steps is 1")
        _keys(tree["skip_state"], (), "skip_state")
        inner = tree["inner_opt_state"]
    elif multi is not None:
        raise ValueError(f"opt_state: expected optax.MultiSteps' keys "
                         f"{sorted(_MULTI_KEYS)} (gradient_accumulation_steps"
                         f" {multi.k}), found {sorted(tree)}")
    else:
        inner = tree
    _keys(inner, _INJECT_KEYS, "")
    _keys(inner["hyperparams"], HYPERPARAMS, "hyperparams")
    _keys(inner["hyperparams_states"], (), "hyperparams_states")
    _keys(inner["inner_state"], ("0", "1", "2"), "inner_state")
    _keys(inner["inner_state"]["0"], ("count", "mu", "nu"), "inner_state/0")
    _keys(inner["inner_state"]["1"], (), "inner_state/1")
    _keys(inner["inner_state"]["2"], (), "inner_state/2")
    count = int(np.asarray(inner["inner_state"]["0"]["count"]))
    if int(np.asarray(inner["count"])) != count:
        raise ValueError(f"opt_state: count {int(np.asarray(inner['count']))}"
                         f" differs from scale_by_adam's {count}")
    hp = {k: float(np.asarray(v)) for k, v in inner["hyperparams"].items()}
    if hp["eps_root"] != 0.0:
        raise ValueError(f"opt_state: eps_root {hp['eps_root']}, torch AdamW "
                         "has none")
    mu = _read_params_tree(entries, inner["inner_state"]["0"]["mu"], "mu")
    nu = _read_params_tree(entries, inner["inner_state"]["0"]["nu"], "nu")
    if multi is not None:
        mini = int(np.asarray(tree["mini_step"]))
        if not 0 <= mini < multi.k:
            raise ValueError(f"opt_state: mini_step {mini} outside 0.."
                             f"{multi.k - 1}")
        acc = _read_params_tree(entries, tree["acc_grads"], "acc_grads")
        multi.mini_step = mini
        multi.gradient_step = int(np.asarray(tree["gradient_step"]))
        multi.acc_grads = {t: a for t, a in acc}
    for group in adamw.param_groups:
        group.update(lr=hp["learning_rate"], betas=(hp["b1"], hp["b2"]),
                     eps=hp["eps"], weight_decay=hp["weight_decay"])
    for (t, m), (_, v) in zip(mu, nu):
        adamw.state[t] = {"step": torch.tensor(float(count)), "exp_avg": m,
                          "exp_avg_sq": v}
