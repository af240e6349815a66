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

Flax module names follow each JAX model's creation order. MS_DSA_NET
(`fcd_tpu/models/ms_dsa_net.py`): UnetrBasicBlock_0..5 (encoders),
Conv3d_0..3 + GroupNorm_0..3 (the patch embeds), TransformerBlock_{level *
num_layers + k}, UnetrUpBlock_0..4 (decoders 5..1; MS_DSA_NET_PS:
GeneralUnetrUpBlock_0..4, each UpSample_0 and UnetResBlock_0) and Conv3d_4
(the head). BaseUNet: UnetrBasicBlock_0..5, UnetrUpBlock_0..4, Conv3d_0.
UNETR++ (`fcd_tpu/models/unetr_pp.py`): Conv3d_0..3 and GroupNorm_0..3
(the stem and the downsampling convs), EPABlock_0..11 (the encoder's
stages), UnetResBlock_0 (the full-resolution block), ConvTranspose3d_0..2
and EPABlock_12..20 (the decoders), ConvTranspose3d_3, UnetResBlock_1,
Conv3d_4 (the head) and, with do_ds, Conv3d_5..6.
UNet (`fcd_tpu/models/unet.py`): ResidualUnit_0..n-1 (the down units by
level), ResidualUnit_n (the bottom), then per level from the deepest up
ConvTranspose3d_k, PReLU_k and ResidualUnit_{n + 1 + k}; a unit holds
Conv3d_0.. (its subunits, then the residual conv) and PReLU_0.. (a sorted
list of names puts ResidualUnit_10 before _2: the table is built from the
creation order, not by sorting). VNet (`fcd_tpu/models/vnet.py`):
_InputTransition_0, _DownTransition_0..3, _UpTransition_0..3, then
Conv3d_0, BatchNorm_0, PReLU_0 and Conv3d_1 (the head); each `_LUConv_k`
and each transition's first layer hold Conv3d_0 (ConvTranspose3d_0 in an
up transition), BatchNorm_0 and PReLU_0, a transition's closing PReLU is
its PReLU_1. UNETR (`fcd_tpu/models/unetr.py`): Conv3d_0 (the patch
embed), pos_embed, _ViTBlock_0..11 (LayerNorm_0, _SelfAttention_0 with
Dense_0 (qkv) and Dense_1, LayerNorm_1, MLPBlock_0 with Dense_0 and
Dense_1), UnetrBasicBlock_0 (the image's), the PrUp stacks' transposed
convs ConvTranspose3d_0..5 and blocks UnetrBasicBlock_1..3 in creation
order, UnetrUpBlock_0..3 and Conv3d_1 (the head). SwinUNETR
(`fcd_tpu/models/swin_unetr.py`): Conv3d_0 (the patch embed),
CheckpointSwinBlock_0..7 (the remat'ed blocks: LayerNorm_0,
WindowAttention_0 with Dense_0, Dense_1 and rel_pos_bias, LayerNorm_1,
MLPBlock_0), PatchMerging_0..3 (LayerNorm_0, Dense_0),
UnetrBasicBlock_0..4, UnetrUpBlock_0..4 and Conv3d_1 (the head). A Dense
is flax's nn.Dense inside the JAX package's, so its leaves sit under
Dense_0 a second time.
The SegResNet family (`fcd_tpu/models/segresnet.py`, setup names):
convInit, down_pre_i, down_blocks_i_j, transformer_levels_l_k,
up_samples_i_0 (the 1x1 conv), up_samples_i_1 (UpSample), up_layers_i_j,
final_conv and the vae_* layers; its ResBlocks hold Conv3d_0 and Conv3d_1
and, like its instance norms, nothing else. The zoo's `Conv3d` layers keep
the flax (k, k, k, Cin, Cout) kernel, 1x1 ones included.

The blocks no factory model builds (ROADMAP A10), each a lone module
(`load_block_variables`, `export_block_variables`): UnetBasicBlock
(Conv3d_0, Conv3d_1, BatchNorm_0..1 for batch norm; nested as
UnetBasicBlock_0 where the JAX selectors' res_block=False arm builds it);
AttentionBlock (Conv3d_0 and BatchNorm_0 on g, Conv3d_1 and BatchNorm_1
on x, Conv3d_2 with its bias and BatchNorm_2 on psi); AgUpBlock
(ConvTranspose3d_0, AttentionBlock_0, UnetResBlock_0 or
UnetBasicBlock_0); TransformerBlockDSA (pos_embed, DSA_0, LayerNorm_0,
LayerNorm_1, MLPBlock_0); CrossAttentionBlock (Dense_0 (q), Dense_1
(kv), EF, temperature, LayerNorm_0, MLPBlock_0); DsaUpBlock
(ConvTranspose3d_0, then UnetResBlock_0 ('cat') and TransformerBlock_0..
depth-1 ('cat', 'sum'), or CrossAttentionBlock_0 ('cross')).

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

from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET, BaseUNet
from fcd_tpu_torch.models.segresnet import ResBlock, SegResNetCore
from fcd_tpu_torch.models.swin_unetr import (
    SwinBlock,
    SwinUNETR,
    WindowAttention,
)
from fcd_tpu_torch.models.unet import ResidualUnit, UNet
from fcd_tpu_torch.models.unetr import UNETR, ViTBlock
from fcd_tpu_torch.models.unetr_pp import UNETR_PP
from fcd_tpu_torch.models.vnet import VNet
from fcd_tpu_torch.ops.attention import (
    DSA,
    CrossAttentionBlock,
    TransformerBlock,
    TransformerBlockDSA,
)
from fcd_tpu_torch.ops.blocks import (
    AgUpBlock,
    AttentionBlock,
    DsaUpBlock,
    GeneralUnetrUpBlock,
    MLPBlock,
    UnetBasicBlock,
    UnetResBlock,
    UnetrUpBlock,
)
from fcd_tpu_torch.ops.layers import (
    BatchNorm,
    Conv3d,
    ConvTranspose3d,
    Dense,
    GroupNorm,
    LayerNorm,
    PReLU,
    UpSample,
)

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


def _basic_entries(blk: UnetBasicBlock, path) -> Iterator[Entry]:
    """flax UnetBasicBlock: Conv3d_0, Conv3d_1 and, for batch norm,
    BatchNorm_0..1."""
    yield "params", path + ("Conv3d_0", "kernel"), blk.conv1, False
    yield "params", path + ("Conv3d_1", "kernel"), blk.conv2, False
    for i, nm in enumerate((blk.norm1, blk.norm2)):
        if nm is not None:
            yield from _batch_norm_entries(nm, path + (f"BatchNorm_{i}",))


def _conv_block_entries(blk, path) -> Iterator[Entry]:
    """A selector's conv block under the flax name of its class:
    UnetResBlock_0, or UnetBasicBlock_0 (res_block=False)."""
    if isinstance(blk, UnetBasicBlock):
        yield from _basic_entries(blk, path + ("UnetBasicBlock_0",))
    else:
        yield from _resblock_entries(blk, path + ("UnetResBlock_0",))


def _up_block_entries(up: UnetrUpBlock, path) -> Iterator[Entry]:
    if isinstance(up, GeneralUnetrUpBlock):
        yield from _upsample_entries(up.up, path + ("UpSample_0",))
    else:
        yield "params", path + ("ConvTranspose3d_0", "kernel"), up.transp, \
            False
    yield from _conv_block_entries(up.block, path)


def _conv_entries(conv: Conv3d, path) -> Iterator[Entry]:
    yield "params", path + ("kernel",), conv.kernel, False
    if conv.bias is not None:
        yield "params", path + ("bias",), conv.bias, False


def _group_norm_entries(gn: GroupNorm, path) -> Iterator[Entry]:
    path = path + ("GroupNorm_0",)   # fcd_tpu.GroupNorm wraps flax's
    yield "params", path + ("scale",), gn.scale, False
    yield "params", path + ("bias",), gn.bias, False


def _dense_entries(dense: Dense, path) -> Iterator[Entry]:
    yield "params", path + ("Dense_0", "kernel"), dense.kernel, False
    if dense.bias is not None:
        yield "params", path + ("Dense_0", "bias"), dense.bias, False


def _upsample_entries(up: UpSample, path) -> Iterator[Entry]:
    if up.conv is not None:
        yield from _conv_entries(up.conv, path + ("Conv3d_0",))
    if up.transp is not None:
        t = path + ("ConvTranspose3d_0",)
        yield "params", t + ("kernel",), up.transp, False
        if up.transp_bias is not None:
            yield "params", t + ("bias",), up.transp_bias, False


def _segres_block_entries(blk: ResBlock, path) -> Iterator[Entry]:
    yield "params", path + ("Conv3d_0", "kernel"), blk.conv1, False
    yield "params", path + ("Conv3d_1", "kernel"), blk.conv2, False


def _dsa_entries(dsa: DSA, path) -> Iterator[Entry]:
    d = path + ("DSA_0",)
    yield "params", d + ("qkvv",), dsa.qkvv, False
    yield "params", d + ("temperature",), dsa.temperature, False
    yield "params", d + ("temperature2",), dsa.temperature2, False
    if dsa.EF is not None:   # sa_type 'channel' has none
        yield "params", d + ("EF",), dsa.EF, False


def _transformer_entries(tb: TransformerBlock, path) -> Iterator[Entry]:
    yield "params", path + ("pos_embed",), tb.pos_embed, False
    yield "params", path + ("gamma",), tb.gamma, False
    yield "params", path + ("LayerNorm_0", "scale"), tb.ln_scale, False
    yield "params", path + ("LayerNorm_0", "bias"), tb.ln_bias, False
    yield from _dsa_entries(tb.dsa, path)
    yield from _resblock_entries(tb.conv_block, path + ("UnetResBlock_0",))
    yield "params", path + ("Conv3d_0", "kernel"), tb.conv8, True
    yield "params", path + ("Conv3d_0", "bias"), tb.conv8_bias, False


def _segresnet_entries(model: SegResNetCore) -> Iterator[Entry]:
    yield from _conv_entries(model.conv_init, ("convInit",))
    for i, conv in enumerate(model.down_pre, start=1):
        yield from _conv_entries(conv, (f"down_pre_{i}",))
    for i, blocks in enumerate(model.down_blocks):
        for j, blk in enumerate(blocks):
            yield from _segres_block_entries(blk, (f"down_blocks_{i}_{j}",))
    for li, stack in enumerate(model.transformer_levels):
        for k, tb in enumerate(stack):
            yield from _transformer_entries(
                tb, (f"transformer_levels_{li}_{k}",))
    for i, (conv, up) in enumerate(zip(model.up_convs, model.up_samples)):
        yield from _conv_entries(conv, (f"up_samples_{i}_0",))
        yield from _upsample_entries(up, (f"up_samples_{i}_1",))
    for i, blocks in enumerate(model.up_layers):
        for j, blk in enumerate(blocks):
            yield from _segres_block_entries(blk, (f"up_layers_{i}_{j}",))
    yield from _conv_entries(model.final_conv, ("final_conv",))
    if model.vae:
        yield from _conv_entries(model.vae_down_conv, ("vae_down_conv",))
        yield from _dense_entries(model.vae_fc1, ("vae_fc1",))
        yield from _dense_entries(model.vae_fc3, ("vae_fc3",))
        yield from _conv_entries(model.vae_up_conv, ("vae_up_conv",))
        yield from _upsample_entries(model.vae_up_sample, ("vae_up_sample",))
        yield from _conv_entries(model.vae_final_conv, ("vae_final_conv",))


def _baseunet_entries(model: BaseUNet) -> Iterator[Entry]:
    for i, enc in enumerate(model.encoders):
        yield from _resblock_entries(
            enc, (f"UnetrBasicBlock_{i}", "UnetResBlock_0"))
    for di, dec in enumerate(model.decoders):
        yield from _up_block_entries(dec, (f"UnetrUpBlock_{di}",))
    yield "params", ("Conv3d_0", "kernel"), model.head, True
    yield "params", ("Conv3d_0", "bias"), model.head_bias, False


def _unetrpp_entries(model: UNETR_PP) -> Iterator[Entry]:
    blocks = [blk for stage in (*model.stages, *model.up_stages)
              for blk in stage]
    for i, (down, gn) in enumerate(zip(model.downs, model.down_norms)):
        yield from _conv_entries(down, (f"Conv3d_{i}",))
        yield from _group_norm_entries(gn, (f"GroupNorm_{i}",))
    for i, blk in enumerate(blocks):
        yield from _transformer_entries(blk, (f"EPABlock_{i}",))
    yield from _resblock_entries(model.conv_block, ("UnetResBlock_0",))
    for i, up in enumerate((*model.up_convs, model.out_up)):
        yield from _conv_entries(up, (f"ConvTranspose3d_{i}",))
    yield from _resblock_entries(model.out_block, ("UnetResBlock_1",))
    heads = [model.head] + list(model.ds_heads or ())
    for i, head in enumerate(heads, start=4):
        yield from _conv_entries(head, (f"Conv3d_{i}",))


def _prelu_entries(act: PReLU, path) -> Iterator[Entry]:
    yield "params", path + ("alpha",), act.alpha, False


def _batch_norm_entries(nm: BatchNorm, path) -> Iterator[Entry]:
    yield "params", path + ("scale",), nm.scale, False
    yield "params", path + ("bias",), nm.bias, False
    yield "batch_stats", path + ("mean",), nm.mean, False
    yield "batch_stats", path + ("var",), nm.var, False


def _layer_norm_entries(ln: LayerNorm, path) -> Iterator[Entry]:
    yield "params", path + ("scale",), ln.scale, False
    yield "params", path + ("bias",), ln.bias, False


def _residual_unit_entries(unit: ResidualUnit, path) -> Iterator[Entry]:
    convs = list(unit.convs) + ([] if unit.residual is None
                                else [unit.residual])
    for i, conv in enumerate(convs):
        yield from _conv_entries(conv, path + (f"Conv3d_{i}",))
    for i, act in enumerate(unit.acts):
        yield from _prelu_entries(act, path + (f"PReLU_{i}",))


def _unet_entries(model: UNet) -> Iterator[Entry]:
    n = len(model.downs)
    for i, unit in enumerate(model.downs):
        yield from _residual_unit_entries(unit, (f"ResidualUnit_{i}",))
    yield from _residual_unit_entries(model.bottom, (f"ResidualUnit_{n}",))
    for k, lv in enumerate(reversed(range(n))):   # the deepest level first
        yield from _conv_entries(model.up_convs[lv],
                                 (f"ConvTranspose3d_{k}",))
        yield from _prelu_entries(model.up_acts[lv], (f"PReLU_{k}",))
        yield from _residual_unit_entries(model.up_units[lv],
                                          (f"ResidualUnit_{n + 1 + k}",))


def _conv_bn_act_entries(layer, path, conv="Conv3d_0") -> Iterator[Entry]:
    yield from _conv_entries(layer.conv, path + (conv,))
    yield from _batch_norm_entries(layer.norm, path + ("BatchNorm_0",))
    yield from _prelu_entries(layer.act, path + ("PReLU_0",))


def _vnet_entries(model: VNet) -> Iterator[Entry]:
    yield from _conv_bn_act_entries(model.stem.layer, ("_InputTransition_0",))
    for kind, trans in (("_DownTransition", model.downs),
                        ("_UpTransition", model.ups)):
        for i, t in enumerate(trans):
            path = (f"{kind}_{i}",)
            first = t.down if kind == "_DownTransition" else t.up
            yield from _conv_bn_act_entries(
                first, path, "Conv3d_0" if kind == "_DownTransition"
                else "ConvTranspose3d_0")
            for j, lu in enumerate(t.convs):
                yield from _conv_bn_act_entries(lu, path + (f"_LUConv_{j}",))
            yield from _prelu_entries(t.act, path + ("PReLU_1",))
    yield from _conv_bn_act_entries(model.out, ())
    yield from _conv_entries(model.head, ("Conv3d_1",))


def _mlp_entries(mlp: MLPBlock, path) -> Iterator[Entry]:
    yield from _dense_entries(mlp.fc1, path + ("Dense_0",))
    yield from _dense_entries(mlp.fc2, path + ("Dense_1",))


def _vit_entries(blk: ViTBlock, path) -> Iterator[Entry]:
    yield from _layer_norm_entries(blk.ln1, path + ("LayerNorm_0",))
    a = path + ("_SelfAttention_0",)
    yield from _dense_entries(blk.attn.qkv, a + ("Dense_0",))
    yield from _dense_entries(blk.attn.proj, a + ("Dense_1",))
    yield from _layer_norm_entries(blk.ln2, path + ("LayerNorm_1",))
    yield from _mlp_entries(blk.mlp, path + ("MLPBlock_0",))


def _basic_block_entries(blk: UnetResBlock, k: int) -> Iterator[Entry]:
    yield from _resblock_entries(blk, (f"UnetrBasicBlock_{k}",
                                       "UnetResBlock_0"))


def _unetr_entries(model: UNETR) -> Iterator[Entry]:
    yield from _conv_entries(model.patch_embed, ("Conv3d_0",))
    yield "params", ("pos_embed",), model.pos_embed, False
    for i, blk in enumerate(model.blocks):
        yield from _vit_entries(blk, (f"_ViTBlock_{i}",))
    yield from _basic_block_entries(model.enc1, 0)
    ups = [u for stack in model.stacks for u in stack.ups]
    blocks = [b for stack in model.stacks for b in stack.blocks]
    for i, up in enumerate(ups):
        yield from _conv_entries(up, (f"ConvTranspose3d_{i}",))
    for i, blk in enumerate(blocks, start=1):
        yield from _basic_block_entries(blk, i)
    for i, dec in enumerate(model.decoders):
        yield from _up_block_entries(dec, (f"UnetrUpBlock_{i}",))
    yield from _conv_entries(model.head, ("Conv3d_1",))


def _window_attention_entries(attn: WindowAttention, path
                              ) -> Iterator[Entry]:
    yield from _dense_entries(attn.qkv, path + ("Dense_0",))
    yield from _dense_entries(attn.proj, path + ("Dense_1",))
    yield "params", path + ("rel_pos_bias",), attn.rel_pos_bias, False


def _swin_block_entries(blk: SwinBlock, path) -> Iterator[Entry]:
    yield from _layer_norm_entries(blk.ln1, path + ("LayerNorm_0",))
    yield from _window_attention_entries(blk.attn,
                                         path + ("WindowAttention_0",))
    yield from _layer_norm_entries(blk.ln2, path + ("LayerNorm_1",))
    yield from _mlp_entries(blk.mlp, path + ("MLPBlock_0",))


def _swin_unetr_entries(model: SwinUNETR) -> Iterator[Entry]:
    yield from _conv_entries(model.patch_embed, ("Conv3d_0",))
    blocks = [blk for stage in model.stages for blk in stage]
    for i, blk in enumerate(blocks):
        yield from _swin_block_entries(blk, (f"CheckpointSwinBlock_{i}",))
    for i, merge in enumerate(model.merges):
        path = (f"PatchMerging_{i}",)
        yield from _layer_norm_entries(merge.norm, path + ("LayerNorm_0",))
        yield from _dense_entries(merge.reduction, path + ("Dense_0",))
    for i, enc in enumerate(model.encoders):
        yield from _basic_block_entries(enc, i)
    for i, dec in enumerate(model.decoders):
        yield from _up_block_entries(dec, (f"UnetrUpBlock_{i}",))
    yield from _conv_entries(model.head, ("Conv3d_1",))


_TABLES = ((UNETR_PP, _unetrpp_entries), (SegResNetCore, _segresnet_entries),
           (BaseUNet, _baseunet_entries), (UNet, _unet_entries),
           (VNet, _vnet_entries), (UNETR, _unetr_entries),
           (SwinUNETR, _swin_unetr_entries))


def model_entries(model) -> Iterator[Entry]:
    """Every parameter and running statistic of a port model under its
    flax path."""
    for cls, table in _TABLES:
        if isinstance(model, cls):
            yield from table(model)
            return
    if not isinstance(model, MS_DSA_NET):
        raise TypeError(f"no weight table for {type(model).__name__}")
    for i, enc in enumerate(model.encoders):
        yield from _resblock_entries(
            enc, (f"UnetrBasicBlock_{i}", "UnetResBlock_0"))
    num_layers = len(model.transformers[0])
    for li, (emb, stack) in enumerate(zip(model.embeds, model.transformers)):
        yield "params", (f"Conv3d_{li}", "kernel"), emb.kernel, True
        yield from _group_norm_entries(emb.gn, (f"GroupNorm_{li}",))
        for k, tb in enumerate(stack):
            yield from _transformer_entries(
                tb, (f"TransformerBlock_{li * num_layers + k}",))
    up_name = ("UnetrUpBlock" if model.upsample_mode is None
               else "GeneralUnetrUpBlock")
    for di, dec in enumerate(model.decoders):
        yield from _up_block_entries(dec, (f"{up_name}_{di}",))
    yield "params", ("Conv3d_4", "kernel"), model.head, True
    yield "params", ("Conv3d_4", "bias"), model.head_bias, False


def param_entries(model):
    """(flax path, parameter, is a 1x1 conv kernel) of every parameter of
    a port model: the table the optimizer state is written and read by
    (`train/checkpoint.py`)."""
    return [(path, t, is_1x1) for coll, path, t, is_1x1 in model_entries(model)
            if coll == "params"]


def lookup(tree: Tree, path) -> Any:
    """The leaf of a flax tree at `path` (flax's GroupNorm may sit directly
    under the name or one level down)."""
    node = tree
    for i, key in enumerate(path):
        if key not in node and key == "GroupNorm_0" and i == len(path) - 2:
            continue  # a tree with flax's GroupNorm directly under the name
        node = node[key]
    return node


def _load(entries, variables: Tree) -> None:
    for coll, path, dst, is_1x1 in entries:
        a = np.asarray(lookup(variables[coll], path), dtype=np.float32)
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
    """Copy a fcd_tpu variables tree into the port's model of the same
    type. A tree without batch_stats (a params-only checkpoint) leaves the
    running statistics as they are."""
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


def _attention_block_entries(ab: AttentionBlock, path) -> Iterator[Entry]:
    for i, (conv, nm) in enumerate(((ab.conv_g, ab.norm_g),
                                    (ab.conv_x, ab.norm_x),
                                    (ab.conv_psi, ab.norm_psi))):
        yield from _conv_entries(conv, path + (f"Conv3d_{i}",))
        yield from _batch_norm_entries(nm, path + (f"BatchNorm_{i}",))


def _ag_up_entries(up: AgUpBlock, path) -> Iterator[Entry]:
    yield from _conv_entries(up.transp, path + ("ConvTranspose3d_0",))
    yield from _attention_block_entries(up.attention,
                                        path + ("AttentionBlock_0",))
    yield from _conv_block_entries(up.block, path)


def _tb_dsa_entries(tb: TransformerBlockDSA, path) -> Iterator[Entry]:
    if tb.pos_embed is not None:
        yield "params", path + ("pos_embed",), tb.pos_embed, False
    yield from _dsa_entries(tb.dsa, path)
    yield from _layer_norm_entries(tb.ln1, path + ("LayerNorm_0",))
    yield from _layer_norm_entries(tb.ln2, path + ("LayerNorm_1",))
    yield from _mlp_entries(tb.mlp, path + ("MLPBlock_0",))


def _cross_entries(ca: CrossAttentionBlock, path) -> Iterator[Entry]:
    yield from _dense_entries(ca.q, path + ("Dense_0",))
    yield from _dense_entries(ca.kv, path + ("Dense_1",))
    yield "params", path + ("EF",), ca.EF, False
    yield "params", path + ("temperature",), ca.temperature, False
    yield from _layer_norm_entries(ca.ln, path + ("LayerNorm_0",))
    yield from _mlp_entries(ca.mlp, path + ("MLPBlock_0",))


def _dsa_up_entries(up: DsaUpBlock, path) -> Iterator[Entry]:
    yield from _conv_entries(up.transp, path + ("ConvTranspose3d_0",))
    if up.cross is not None:
        yield from _cross_entries(up.cross, path + ("CrossAttentionBlock_0",))
    if up.block is not None:
        yield from _resblock_entries(up.block, path + ("UnetResBlock_0",))
    for k, tb in enumerate(up.transformers):
        yield from _transformer_entries(tb, path + (f"TransformerBlock_{k}",))


# a lone block's table, the first class it is an instance of
_BLOCK_TABLES = (
    (TransformerBlock, _transformer_entries),
    (TransformerBlockDSA, _tb_dsa_entries),
    (CrossAttentionBlock, _cross_entries),
    (DsaUpBlock, _dsa_up_entries),
    (AgUpBlock, _ag_up_entries),
    (AttentionBlock, _attention_block_entries),
    (UnetrUpBlock, _up_block_entries),
    (GeneralUnetrUpBlock, _up_block_entries),
    (UnetBasicBlock, _basic_entries),
    (UnetResBlock, _resblock_entries),
)


def _block_entries(module) -> Iterator[Entry]:
    for cls, table in _BLOCK_TABLES:
        if isinstance(module, cls):
            return table(module, ())
    raise TypeError(f"no weight table for a lone {type(module).__name__}")


def load_block_variables(module, variables: Tree) -> None:
    """`load_flax_variables` for a lone block of `_BLOCK_TABLES`: the
    variables tree of the JAX block's `init` ({"params"} and, with batch
    norms, {"batch_stats"})."""
    _load(_block_entries(module),
          {"params": variables["params"],
           "batch_stats": variables.get("batch_stats", {})})


def export_block_variables(module) -> Dict[str, Any]:
    """`export_flax_variables` for a lone block: a UnetResBlock,
    UnetBasicBlock, the selectors and up blocks, a TransformerBlock, or one
    of the A10 blocks (the module docstring)."""
    return _export(_block_entries(module), lambda t: t)


def export_block_grads(module) -> Dict[str, Any]:
    """`export_flax_grads` for a lone block (`export_block_variables`)."""
    return _export((e for e in _block_entries(module) if e[0] == "params"),
                   lambda t: t.grad).get("params", {})
