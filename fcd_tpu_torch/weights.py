"""The port's modules and the JAX package's flax variables, both ways.

`variables` is the `{"params": ..., "batch_stats": ...}` tree of
`fcd_tpu` as nested dicts of numpy arrays (or anything `np.asarray`
takes). The port keeps the flax layouts, so conv kernels, the transposed
conv kernel, `qkvv` (C, 4C), `EF` (N, P), `pos_embed` (1, N, C) and
`gamma` are copied as they are; `temperature` stays (h, 1, 1); 1x1 conv
kernels drop their (1, 1, 1) spatial axes. The transposed conv is not
flipped here: `kernels/upsample.py` applies the kernel the way
`lax.conv_transpose` does. BatchNorm running statistics come from
`batch_stats` (`mean`, `var`).

Flax module names follow `fcd_tpu/models/ms_dsa_net.py`'s creation order:
UnetrBasicBlock_0..5 (encoders), Conv3d_0..3 + GroupNorm_0..3 (the patch
embeds), TransformerBlock_{level * num_layers + k}, UnetrUpBlock_0..4
(decoders 5..1) and Conv3d_4 (the head).

`load_flax_variables` copies such a tree into a model;
`export_flax_variables` is its inverse and `export_flax_grads` maps each
parameter's `.grad` into the same tree, so tests compare the port's
gradients, updated parameters and running statistics with JAX's leaf by
leaf. All three walk one table of (collection, path, tensor, 1x1) entries.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from fcd_tpu_torch.ops.attention import TransformerBlock
from fcd_tpu_torch.ops.blocks import UnetResBlock, UnetrUpBlock

Tree = Mapping[str, Any]
# (collection, path, tensor, is a 1x1 conv kernel)
Entry = Tuple[str, Tuple[str, ...], torch.Tensor, bool]


def _resblock_entries(blk: UnetResBlock, path) -> Iterator[Entry]:
    """flax UnetResBlock: Conv3d_0 (conv1), Conv3d_1 (conv2), Conv3d_2 (the
    1x1 shortcut) and, for batch norm, BatchNorm_0..2."""
    yield "params", path + ("Conv3d_0", "kernel"), blk.conv1, False
    yield "params", path + ("Conv3d_1", "kernel"), blk.conv2, False
    if blk.conv3 is not None:
        yield "params", path + ("Conv3d_2", "kernel"), blk.conv3, True
    for i, nm in enumerate((blk.norm1, blk.norm2, blk.norm3)):
        if nm is not None:
            name = f"BatchNorm_{i}"
            yield "params", path + (name, "scale"), nm.scale, False
            yield "params", path + (name, "bias"), nm.bias, False
            yield "batch_stats", path + (name, "mean"), nm.mean, False
            yield "batch_stats", path + (name, "var"), nm.var, False


def _up_block_entries(up: UnetrUpBlock, path) -> Iterator[Entry]:
    yield "params", path + ("ConvTranspose3d_0", "kernel"), up.transp, False
    yield from _resblock_entries(up.block, path + ("UnetResBlock_0",))


def _transformer_entries(tb: TransformerBlock, path) -> Iterator[Entry]:
    yield "params", path + ("pos_embed",), tb.pos_embed, False
    yield "params", path + ("gamma",), tb.gamma, False
    yield "params", path + ("LayerNorm_0", "scale"), tb.ln_scale, False
    yield "params", path + ("LayerNorm_0", "bias"), tb.ln_bias, False
    d = path + ("DSA_0",)
    yield "params", d + ("qkvv",), tb.dsa.qkvv, False
    yield "params", d + ("temperature",), tb.dsa.temperature, False
    yield "params", d + ("temperature2",), tb.dsa.temperature2, False
    yield "params", d + ("EF",), tb.dsa.EF, False
    yield from _resblock_entries(tb.conv_block, path + ("UnetResBlock_0",))
    yield "params", path + ("Conv3d_0", "kernel"), tb.conv8, True
    yield "params", path + ("Conv3d_0", "bias"), tb.conv8_bias, False


def model_entries(model) -> Iterator[Entry]:
    """Every parameter and running statistic of an MS_DSA_NET under its
    flax path."""
    for i, enc in enumerate(model.encoders):
        yield from _resblock_entries(
            enc, (f"UnetrBasicBlock_{i}", "UnetResBlock_0"))
    num_layers = len(model.transformers[0])
    for li, (emb, stack) in enumerate(zip(model.embeds, model.transformers)):
        yield "params", (f"Conv3d_{li}", "kernel"), emb.kernel, True
        gn = (f"GroupNorm_{li}", "GroupNorm_0")  # fcd_tpu.GroupNorm wraps flax's
        yield "params", gn + ("scale",), emb.gn_scale, False
        yield "params", gn + ("bias",), emb.gn_bias, False
        for k, tb in enumerate(stack):
            yield from _transformer_entries(
                tb, (f"TransformerBlock_{li * num_layers + k}",))
    for di, dec in enumerate(model.decoders):
        yield from _up_block_entries(dec, (f"UnetrUpBlock_{di}",))
    yield "params", ("Conv3d_4", "kernel"), model.head, True
    yield "params", ("Conv3d_4", "bias"), model.head_bias, False


def _lookup(tree: Tree, path) -> Any:
    node = tree
    for i, key in enumerate(path):
        if key not in node and key == "GroupNorm_0" and i == len(path) - 2:
            continue  # a tree with flax's GroupNorm directly under the name
        node = node[key]
    return node


def _load(entries, variables: Tree) -> None:
    for coll, path, dst, is_1x1 in entries:
        a = np.asarray(_lookup(variables[coll], path), dtype=np.float32)
        if is_1x1:
            a = a.reshape(a.shape[-2:])
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} does not "
                             f"fit {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.tensor(a))


def _export(entries, value) -> Dict[str, Any]:
    """{collection: nested dict} of value(tensor) as numpy, with 1x1
    kernels given back their (1, 1, 1) axes; None values are left out."""
    out: Dict[str, Any] = {}
    for coll, path, t, is_1x1 in entries:
        v = value(t)
        if v is None:
            continue
        a = v.detach().float().cpu().numpy()
        if is_1x1:
            a = a.reshape((1, 1, 1) + a.shape)
        node = out.setdefault(coll, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out


def load_resblock(blk: UnetResBlock, p: Tree, bs: Optional[Tree] = None):
    _load(_resblock_entries(blk, ()), {"params": p, "batch_stats": bs or {}})


def load_up_block(up: UnetrUpBlock, p: Tree, bs: Optional[Tree] = None):
    _load(_up_block_entries(up, ()), {"params": p, "batch_stats": bs or {}})


def load_transformer_block(tb: TransformerBlock, p: Tree, bs: Tree):
    _load(_transformer_entries(tb, ()), {"params": p, "batch_stats": bs})


def load_flax_variables(model, variables: Tree) -> None:
    """Copy a fcd_tpu MS_DSA_NET variables tree into the port's model. A
    tree without batch_stats (a params-only checkpoint) leaves the running
    statistics as they are."""
    entries = model_entries(model)
    if not variables.get("batch_stats"):
        entries = (e for e in entries if e[0] == "params")
    _load(entries, {"params": variables["params"],
                    "batch_stats": variables.get("batch_stats", {})})


def export_flax_variables(model) -> Dict[str, Any]:
    """The model's {"params", "batch_stats"} as a fcd_tpu numpy tree."""
    return _export(model_entries(model), lambda t: t)


def export_flax_grads(model) -> Dict[str, Any]:
    """Each parameter's `.grad` under its flax name (the "params" tree of
    a JAX gradient); parameters without a gradient are left out."""
    return _export((e for e in model_entries(model) if e[0] == "params"),
                   lambda t: t.grad).get("params", {})


def _block_entries(module) -> Iterator[Entry]:
    if isinstance(module, TransformerBlock):
        return _transformer_entries(module, ())
    return _resblock_entries(module, ())


def export_block_variables(module) -> Dict[str, Any]:
    """`export_flax_variables` for a lone UnetResBlock or TransformerBlock."""
    return _export(_block_entries(module), lambda t: t)


def export_block_grads(module) -> Dict[str, Any]:
    """`export_flax_grads` for a lone UnetResBlock or TransformerBlock."""
    return _export((e for e in _block_entries(module) if e[0] == "params"),
                   lambda t: t.grad).get("params", {})
