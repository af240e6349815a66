"""Load the JAX package's flax variables into the port's modules.

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
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from fcd_tpu_torch.ops.attention import TransformerBlock
from fcd_tpu_torch.ops.blocks import UnetResBlock, UnetrUpBlock
from fcd_tpu_torch.ops.layers import BatchNormEval

Tree = Mapping[str, Any]


def _copy(dst: torch.Tensor, src, squeeze_1x1: bool = False) -> None:
    a = np.asarray(src, dtype=np.float32)
    if squeeze_1x1:
        a = a.reshape(a.shape[-2:])
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"shape {a.shape} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(a))


def _load_bn(nm: BatchNormEval, p: Tree, bs: Tree) -> None:
    _copy(nm.scale, p["scale"])
    _copy(nm.bias, p["bias"])
    _copy(nm.mean, bs["mean"])
    _copy(nm.var, bs["var"])


def load_resblock(blk: UnetResBlock, p: Tree, bs: Optional[Tree] = None):
    """flax UnetResBlock: Conv3d_0 (conv1), Conv3d_1 (conv2), Conv3d_2 (the
    1x1 shortcut) and, for batch norm, BatchNorm_0..2."""
    _copy(blk.conv1, p["Conv3d_0"]["kernel"])
    _copy(blk.conv2, p["Conv3d_1"]["kernel"])
    if blk.conv3 is not None:
        _copy(blk.conv3, p["Conv3d_2"]["kernel"], squeeze_1x1=True)
    for i, nm in enumerate((blk.norm1, blk.norm2, blk.norm3)):
        if nm is not None:
            _load_bn(nm, p[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"])


def load_up_block(up: UnetrUpBlock, p: Tree, bs: Optional[Tree] = None):
    _copy(up.transp, p["ConvTranspose3d_0"]["kernel"])
    load_resblock(up.block, p["UnetResBlock_0"],
                  None if bs is None else bs.get("UnetResBlock_0"))


def load_transformer_block(tb: TransformerBlock, p: Tree, bs: Tree):
    _copy(tb.pos_embed, p["pos_embed"])
    _copy(tb.gamma, p["gamma"])
    _copy(tb.ln_scale, p["LayerNorm_0"]["scale"])
    _copy(tb.ln_bias, p["LayerNorm_0"]["bias"])
    d = p["DSA_0"]
    _copy(tb.dsa.qkvv, d["qkvv"])
    _copy(tb.dsa.temperature, d["temperature"])
    _copy(tb.dsa.temperature2, d["temperature2"])
    _copy(tb.dsa.EF, d["EF"])
    load_resblock(tb.conv_block, p["UnetResBlock_0"], bs["UnetResBlock_0"])
    _copy(tb.conv8, p["Conv3d_0"]["kernel"], squeeze_1x1=True)
    _copy(tb.conv8_bias, p["Conv3d_0"]["bias"])


def load_flax_variables(model, variables: Tree) -> None:
    """Copy a fcd_tpu MS_DSA_NET variables tree into the port's model."""
    p = variables["params"]
    bs = variables.get("batch_stats", {})
    for i, enc in enumerate(model.encoders):
        name = f"UnetrBasicBlock_{i}"
        load_resblock(enc, p[name]["UnetResBlock_0"],
                      bs.get(name, {}).get("UnetResBlock_0"))
    num_layers = len(model.transformers[0])
    for li, (emb, stack) in enumerate(zip(model.embeds, model.transformers)):
        _copy(emb.kernel, p[f"Conv3d_{li}"]["kernel"], squeeze_1x1=True)
        gp = p[f"GroupNorm_{li}"]
        if "scale" not in gp:  # fcd_tpu.GroupNorm wraps flax nn.GroupNorm
            gp = gp["GroupNorm_0"]
        _copy(emb.gn_scale, gp["scale"])
        _copy(emb.gn_bias, gp["bias"])
        for k, tb in enumerate(stack):
            name = f"TransformerBlock_{li * num_layers + k}"
            load_transformer_block(tb, p[name], bs[name])
    for di, dec in enumerate(model.decoders):
        name = f"UnetrUpBlock_{di}"
        load_up_block(dec, p[name], bs.get(name))
    _copy(model.head, p["Conv3d_4"]["kernel"], squeeze_1x1=True)
    _copy(model.head_bias, p["Conv3d_4"]["bias"])
