"""Every flax module class of the JAX package's `ops/` has a counterpart in
the port.

The JAX package's `fcd_tpu/ops/blocks.py`, `ops/attention.py` and
`ops/layers.py` are read with `ast` (nothing of `fcd_tpu` is imported).
Every class there that derives from `nn.Module` must be a class of the
same name in `fcd_tpu_torch/ops/` (`blocks.py`, `attention.py`,
`layers.py`), or have an entry in `COUNTERPARTS`, which names the port's
counterpart of another form, or says why none is needed. An entry for a
class that the JAX package no longer has, or that the port now has under
its own name, fails too. `fcd_tpu/ops/s2d_ops.py` has no module class:
its functions are the TPU's space-to-depth forms, which the port runs as
the ops they serve (ROADMAP's ground rules).
"""

import ast
import importlib
from pathlib import Path

import pytest

import torch_port_workers

torch_port_workers.share_cores()

ROOT = Path(__file__).resolve().parents[1]
JAX_FILES = ("blocks.py", "attention.py", "layers.py")
PORT_MODULES = ("fcd_tpu_torch.ops.blocks", "fcd_tpu_torch.ops.attention",
                "fcd_tpu_torch.ops.layers")

# JAX class -> (port module, its counterpart, why it takes that form)
COUNTERPARTS = {
    "InstanceNorm": ("fcd_tpu_torch.ops.layers", "instance_norm",
                     "no parameters (torch InstanceNorm3d's defaults): a "
                     "function; the blocks take its affine from B1's sums"),
}


def _module_classes(path: Path):
    """Names of the classes in `path` with `nn.Module` among their bases."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and any(
                isinstance(b, ast.Attribute) and b.attr == "Module"
                and isinstance(b.value, ast.Name) and b.value.id == "nn"
                for b in node.bases):
            out.append(node.name)
    return out


JAX_CLASSES = [name for f in JAX_FILES
               for name in _module_classes(ROOT / "fcd_tpu" / "ops" / f)]


def _port_class(name):
    for mod in PORT_MODULES:
        obj = getattr(importlib.import_module(mod), name, None)
        if isinstance(obj, type):
            return obj
    return None


def test_the_jax_files_hold_module_classes():
    assert len(JAX_CLASSES) >= 20
    assert {"DsaUpBlock", "AgUpBlock", "TransformerBlockDSA",
            "CrossAttentionBlock", "UnetBasicBlock"} <= set(JAX_CLASSES)


@pytest.mark.parametrize("name", JAX_CLASSES)
def test_jax_module_class_has_a_counterpart(name):
    import torch.nn as tnn

    cls = _port_class(name)
    if name in COUNTERPARTS:
        assert cls is None, f"{name} is ported under its own name: drop " \
                            "its COUNTERPARTS entry"
        mod, attr, _ = COUNTERPARTS[name]
        assert callable(getattr(importlib.import_module(mod), attr))
        return
    assert cls is not None, f"fcd_tpu/ops' {name} has no port class"
    assert issubclass(cls, tnn.Module), name


def test_counterparts_table_has_no_stale_entry():
    assert set(COUNTERPARTS) <= set(JAX_CLASSES)
