"""The blocks no factory model builds (ROADMAP A10) and UnetBasicBlock, as
cases shared by `test_torch_port_a10.py` (eval, weights) and
`test_torch_port_a10_train.py` (gradients): each case is the JAX block,
the port's block with the same variables, and its seeded numpy inputs, at
small sizes (grids 4^3-8^3, C 6-16, P 8-16, N <= 512).

`make(name, rng)` returns a `Case`: `fm` the flax module, `v` its
variables (random, well scaled, running statistics random), `tm` the
port's module with `v` loaded through `weights.py`, `inputs` the numpy
arrays `fm.apply` takes, `call(tm, tensors)` the port's call on them.
`sub` names the part of the JAX tree the port's module holds (the
`UnetrBasicBlock` selector's UnetBasicBlock_0), or None for all of it.
"""

from typing import Callable, List, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

import fcd_tpu.ops.attention as jattention
import fcd_tpu.ops.blocks as jblocks
from fcd_tpu_torch import weights
from fcd_tpu_torch.ops import attention as tattention
from fcd_tpu_torch.ops import blocks as tblocks
from tests.test_torch_parity import randomize_batch_stats, randomize_params


class Case(NamedTuple):
    fm: object
    v: dict
    tm: object
    inputs: List[np.ndarray]
    call: Callable
    sub: Optional[str] = None


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(fm, inputs, rng):
    shapes = jax.eval_shape(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *[jnp.asarray(a) for a in inputs], train=False))
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return _numpy_tree(randomize_batch_stats(randomize_params(v, rng), rng))


def _parts(widths):
    def call(tm, t):
        return tm(list(t[0].split(widths, dim=-1)))
    return call


def _one(tm, t):
    return tm(*t)


def _build(fm, tm, inputs, rng, call=_one, sub=None):
    v = _variables(fm, inputs, rng)
    loaded = v if sub is None else {
        coll: tree[sub] for coll, tree in v.items() if sub in tree}
    weights.load_block_variables(tm, loaded)
    return Case(fm, v, tm, inputs, call, sub)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _basic(rng, norm, cin, cout, widths):
    x = _randn(rng, 2, 4, 6, 4, cin)
    fm = jblocks.UnetBasicBlock(out_channels=cout, norm_name=norm)
    return _build(fm, tblocks.UnetBasicBlock(cin, cout, norm), [x], rng,
                  _parts(widths))


def _selector(rng):
    x = _randn(rng, 2, 4, 4, 4, 8)
    fm = jblocks.UnetrBasicBlock(out_channels=12, res_block=False)
    tm = tblocks.unetr_basic_block(8, 12, res_block=False)
    return _build(fm, tm, [x], rng, _parts([8]), sub="UnetBasicBlock_0")


def _unetr_up(rng):
    x, skip = _randn(rng, 1, 4, 4, 4, 16), _randn(rng, 1, 8, 8, 8, 8)
    fm = jblocks.UnetrUpBlock(out_channels=8, res_block=False)
    return _build(fm, tblocks.UnetrUpBlock(16, 8, res_block=False),
                  [x, skip], rng)


def _general_up(rng):
    x, skip = _randn(rng, 1, 4, 4, 4, 16), _randn(rng, 1, 8, 8, 8, 8)
    fm = jblocks.GeneralUnetrUpBlock(out_channels=8, res_block=False)
    return _build(fm, tblocks.GeneralUnetrUpBlock(16, 8, res_block=False),
                  [x, skip], rng)


def _attention(rng):
    g, x = _randn(rng, 2, 4, 4, 4, 8), _randn(rng, 2, 4, 4, 4, 6)
    fm = jblocks.AttentionBlock(f_int=4)
    return _build(fm, tblocks.AttentionBlock(8, 6, 4), [g, x], rng)


def _ag_up(rng, fuse, res_block):
    skip_c = 8 if fuse == "sum" else 6
    x, skip = _randn(rng, 2, 4, 4, 4, 16), _randn(rng, 2, 8, 8, 8, skip_c)
    fm = jblocks.AgUpBlock(out_channels=8, fuse=fuse, res_block=res_block)
    tm = tblocks.AgUpBlock(16, 8, skip_c, fuse=fuse, res_block=res_block)
    return _build(fm, tm, [x, skip], rng)


def _tb_dsa(rng, sa_type, pos_embed=True):
    x = _randn(rng, 2, 4, 4, 4, 16)
    kw = dict(input_size=64, hidden_size=16, proj_size=16, num_heads=4,
              pos_embed=pos_embed, sa_type=sa_type, dropout_rate=0.0)
    fm = jattention.TransformerBlockDSA(**kw)
    return _build(fm, tattention.TransformerBlockDSA(**kw), [x], rng)


def _cross(rng):
    x, y = _randn(rng, 2, 4, 4, 4, 16), _randn(rng, 2, 4, 4, 4, 16)
    kw = dict(input_size=64, hidden_size=16, proj_size=8, num_heads=4,
              drop_rate=0.0)
    fm = jattention.CrossAttentionBlock(**kw)
    return _build(fm, tattention.CrossAttentionBlock(**kw), [x, y], rng)


def _dsa_up(rng, fuse):
    x, skip = _randn(rng, 1, 4, 4, 4, 16), _randn(rng, 1, 8, 8, 8, 8)
    kw = dict(input_size=512, fuse=fuse, proj_size=16, num_heads=4, depth=2)
    fm = jblocks.DsaUpBlock(out_channels=8, **kw)
    return _build(fm, tblocks.DsaUpBlock(16, 8, **kw), [x, skip], rng)


BUILDERS = {
    "UnetBasicBlock instance": lambda r: _basic(r, "instance", 8, 12, [8]),
    "UnetBasicBlock batch two parts": lambda r: _basic(r, "batch", 16, 8,
                                                       [10, 6]),
    "UnetrBasicBlock res_block=False": _selector,
    "UnetrUpBlock res_block=False": _unetr_up,
    "GeneralUnetrUpBlock res_block=False": _general_up,
    "AttentionBlock": _attention,
    "AgUpBlock sum res": lambda r: _ag_up(r, "sum", True),
    "AgUpBlock sum basic": lambda r: _ag_up(r, "sum", False),
    "AgUpBlock cat res": lambda r: _ag_up(r, "cat", True),
    "AgUpBlock cat basic": lambda r: _ag_up(r, "cat", False),
    "TransformerBlockDSA parallel": lambda r: _tb_dsa(r, "parallel"),
    "TransformerBlockDSA serial": lambda r: _tb_dsa(r, "serial"),
    "TransformerBlockDSA spatial": lambda r: _tb_dsa(r, "spatial"),
    "TransformerBlockDSA channel": lambda r: _tb_dsa(r, "channel"),
    "TransformerBlockDSA no pos_embed": lambda r: _tb_dsa(r, "parallel",
                                                          False),
    "CrossAttentionBlock": _cross,
    "DsaUpBlock cat": lambda r: _dsa_up(r, "cat"),
    "DsaUpBlock sum": lambda r: _dsa_up(r, "sum"),
    "DsaUpBlock cross": lambda r: _dsa_up(r, "cross"),
}
NAMES = list(BUILDERS)


def make(name: str, seed: int = 0) -> Case:
    return BUILDERS[name](np.random.RandomState(seed))


def rel_l2(got, want) -> float:
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def leaves(tree):
    """{path string: numpy leaf} of a nested dict."""
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
