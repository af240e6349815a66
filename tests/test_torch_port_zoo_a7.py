"""The rest of the model zoo (UNet, VNet, UNETR, SwinUNETR) of the port
(CPU) against the JAX package with the same weights and inputs:

- the layers: PReLU (both inits; bf16 and f32, the slope cast to x's
  dtype before the product), GELU (the tanh form), `conv_transpose3d` at
  k3 s2 against `lax.conv_transpose` SAME (odd and even grids, max abs
  1e-5), `MLPBlock`, SwinUNETR's `rel_pos_index` and `shift_attn_mask`
  (equal), `PatchMerging` (its channel order) and `WindowAttention`
  (with and without the mask), rel 1e-5;
- each model narrowed (UNet channels 4-128, VNet as built, UNETR hidden 48,
  MLP 64, 4 heads, feature size 4, its 12 layers kept, SwinUNETR feature
  size 12, whose 3/6/12/24 heads divide 12/24/48/96) on a 64^3 patch: the
  forward on the kernel route (the kernels' plain versions) and on the f32
  route, rel 1e-4 against the JAX logits; the weight table both ways (the
  train step against jax.grad is test_torch_port_zoo_a7_train.py's);
- each model in the factory's own configuration (get_model of both
  packages from the same params), forward only.

Weights are the flax variables randomised with tests/test_torch_parity.py's
helpers; inputs come from np.random.RandomState. Both sides run f32 on the
CPU (the JAX models with dtype None, as use_amp=False builds them).
"""

from typing import Any

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.models.factory import get_model as jax_get_model
from fcd_tpu.models.swin_unetr import PatchMerging as FlaxPatchMerging
from fcd_tpu.models.swin_unetr import SwinUNETR as FlaxSwinUNETR
from fcd_tpu.models.swin_unetr import WindowAttention as FlaxWindowAttention
from fcd_tpu.models.swin_unetr import _rel_pos_index, _shift_attn_mask
from fcd_tpu.models.unet import UNet as FlaxUNet
from fcd_tpu.models.unetr import UNETR as FlaxUNETR
from fcd_tpu.models.vnet import VNet as FlaxVNet
from fcd_tpu.ops.blocks import MLPBlock as FlaxMLPBlock
from fcd_tpu.ops.layers import make_act as jax_make_act
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.models.swin_unetr import (
    PatchMerging,
    SwinUNETR,
    WindowAttention,
    rel_pos_index,
    shift_attn_mask,
)
from fcd_tpu_torch.models.unet import UNet
from fcd_tpu_torch.models.unetr import UNETR
from fcd_tpu_torch.models.vnet import VNet
from fcd_tpu_torch.ops.blocks import MLPBlock
from fcd_tpu_torch.ops.layers import (
    PReLU,
    conv_transpose3d,
    gelu,
    make_act,
    use_plain_route,
)
from tests.test_torch_parity import randomize_batch_stats, randomize_params

import torch_port_workers

torch_port_workers.share_cores()

PATCH = 64
MODELS = ("UNet", "VNet", "UNETR", "SwinUNETR")
UNET_CHANNELS = (4, 8, 16, 32, 64, 128)
UNETR_KW = dict(feature_size=4, hidden_size=48, mlp_dim=64, num_heads=4)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_variables(init_fn, rng):
    shapes = jax.eval_shape(init_fn)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    v = randomize_params(v, rng)
    if "batch_stats" in v:
        v = randomize_batch_stats(v, rng)
    return _numpy_tree(v)


def _model_variables(fm, rng, size=PATCH):
    return _random_variables(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size, size, size, 2)), train=False), rng)


def _narrow(name, dropout=True):
    """(flax module, port module) of `name` narrowed (the module
    docstring); dropout False: every dropout rate 0 on both sides."""
    if name == "UNet":
        return (FlaxUNet(channels=UNET_CHANNELS,
                         dropout=0.1 if dropout else 0.0),
                UNet(channels=UNET_CHANNELS, dropout=0.1 if dropout else 0.0))
    if name == "VNet":
        return (FlaxVNet(dropout_prob=0.5 if dropout else 0.0),
                VNet(dropout_prob=0.5 if dropout else 0.0))
    if name == "UNETR":
        rate = 0.1 if dropout else 0.0
        return (FlaxUNETR(img_size=(PATCH,) * 3, dropout_rate=rate,
                          **UNETR_KW),
                UNETR(img_size=(PATCH,) * 3, dropout_rate=rate, **UNETR_KW))
    return FlaxSwinUNETR(feature_size=12), SwinUNETR(feature_size=12)


_FORWARD = {}


def _jax_forward(name):
    """(variables, input, JAX logits) of the narrowed model, once a
    module."""
    if name not in _FORWARD:
        fm, _ = _narrow(name)
        rng = np.random.RandomState(31 + MODELS.index(name))
        v = _model_variables(fm, rng)
        x = rng.normal(size=(1,) + (PATCH,) * 3 + (2,)).astype(np.float32)
        want = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
            v, jnp.asarray(x))
        _FORWARD[name] = (v, x, np.asarray(want))
    return _FORWARD[name]


# -- the layers ------------------------------------------------------------------

class _FlaxAct(flax_nn.Module):
    """fcd_tpu's make_act inside a parent (the PReLU module's `init` field
    shadows flax's Module.init)."""
    act: Any

    @flax_nn.compact
    def __call__(self, x):
        return jax_make_act(self.act)(x)


@pytest.mark.parametrize("init", [0.25, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prelu_matches_jax(init, dtype):
    """One shared slope, initialised to `init`, cast to x's dtype before the
    product: bit-equal at bf16 and f32 (a drawn slope as well)."""
    x = np.random.RandomState(1).normal(size=(2, 3, 4, 5, 6)).astype(
        np.float32)
    fm = _FlaxAct(("prelu", {"init": init}))
    v = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert float(v["params"]["PReLU_0"]["alpha"][0]) == np.float32(init)
    tm = make_act(("prelu", {"init": init}))
    assert isinstance(tm, PReLU) and float(tm.alpha.detach()) == np.float32(init)
    for alpha in (init, 0.3173):
        v = {"params": {"PReLU_0": {"alpha": jnp.full((1,), alpha,
                                                      jnp.float32)}}}
        with torch.no_grad():
            tm.alpha.fill_(alpha)
        want = np.asarray(fm.apply(v, jnp.asarray(x, dtype=dtype)),
                          np.float32)
        got = tm(torch.from_numpy(x).to(getattr(torch, dtype))).float()
        np.testing.assert_array_equal(got.detach().numpy(), want)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default (approximate=True) is the tanh form, not
    torch's default erf form."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4
    assert make_act("gelu") is gelu


@pytest.mark.parametrize("shape", [(1, 5, 6, 7, 3), (2, 4, 4, 8, 2)])
def test_conv_transpose_k3s2_matches_lax_same(shape):
    """UNet's k3 s2 transposed conv: lax.conv_transpose with SAME padding
    (the JAX ConvTranspose3d at k > s), n * 2 voxels a side, at odd and
    even sizes."""
    rng = np.random.RandomState(2)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, shape[-1], 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), (2, 2, 2), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))) + b
    got = conv_transpose3d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), stride=2).numpy()
    assert got.shape == want.shape == (shape[0], *(2 * s for s in shape[1:4]),
                                       4)
    assert np.abs(got - want).max() <= 1e-5


def test_mlp_block_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 10, 12)).astype(np.float32)
    fm = FlaxMLPBlock(mlp_dim=20)
    v = _random_variables(lambda: fm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = MLPBlock(12, 20).eval()
    weights._load(weights._mlp_entries(tm, ()), v)
    assert _rel(tm(torch.from_numpy(x)).detach().numpy(), want) < 1e-5


@pytest.mark.parametrize("dims,shift", [((14, 14, 14), 3), ((21, 14, 7), 3),
                                        ((14, 21, 28), 2)])
def test_window_index_and_mask_equal_jax(dims, shift):
    ws = 7
    np.testing.assert_array_equal(rel_pos_index(ws), _rel_pos_index(ws))
    np.testing.assert_array_equal(shift_attn_mask(dims, ws, shift),
                                  _shift_attn_mask(dims, ws, shift))


@pytest.mark.parametrize("grid", [(4, 6, 8), (5, 6, 3)])
def test_patch_merging_matches_jax(grid):
    """JAX's concat order (the transpose (0, 1, 3, 5, 2, 4, 6, 7)), odd axes
    padded first."""
    rng = np.random.RandomState(4)
    x = rng.normal(size=(2, *grid, 6)).astype(np.float32)
    fm = FlaxPatchMerging(dim=6)
    v = _random_variables(lambda: fm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = PatchMerging(6)
    weights._load(weights._dense_entries(tm.reduction, ("Dense_0",)), v)
    weights._load(weights._layer_norm_entries(tm.norm, ("LayerNorm_0",)), v)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, *((s + 1) // 2 for s in grid), 12)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(masked):
    rng = np.random.RandomState(5)
    ws, dim, heads, nw = 3, 12, 3, 8
    x = rng.normal(size=(2 * nw, ws ** 3, dim)).astype(np.float32)
    mask = (shift_attn_mask((6, 6, 6), ws, 1) if masked else None)
    fm = FlaxWindowAttention(dim=dim, num_heads=heads, window_size=ws)
    v = _random_variables(lambda: fm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x), None if mask is None
                               else jnp.asarray(mask)))
    tm = WindowAttention(dim, heads, ws).eval()
    weights._load(weights._window_attention_entries(tm, ()), v)
    got = tm(torch.from_numpy(x), None if mask is None
             else torch.from_numpy(mask)).detach().numpy()
    assert _rel(got, want) < 1e-5


# -- the models ------------------------------------------------------------------

@pytest.mark.parametrize("route", ["kernels", "f32"])
@pytest.mark.parametrize("name", MODELS)
def test_model_forward_matches_jax(name, route):
    """The narrowed model on the kernel route (B1, B2, B4's plain versions
    where the model has res blocks) and on the f32 route, against the JAX
    logits."""
    v, x, want = _jax_forward(name)
    _, tm = _narrow(name)
    if route == "f32":
        use_plain_route(tm)
    tm.eval()
    weights.load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, PATCH, PATCH, PATCH, 2)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("name", MODELS)
def test_weight_table_round_trip(name):
    """Every JAX leaf is used once and every port parameter and running
    statistic gets one leaf; export gives back the JAX tree."""
    v, _, _ = _jax_forward(name)
    _, tm = _narrow(name)
    weights.load_flax_variables(tm, v)
    entries = list(weights.model_entries(tm))
    ids = [id(e[2]) for e in entries]
    assert len(ids) == len(set(ids))
    owned = {id(t) for t in tm.state_dict(keep_vars=True).values()}
    assert set(ids) == owned
    back = weights.export_flax_variables(tm)
    for coll in v:
        flat_v = jax.tree_util.tree_flatten_with_path(v[coll])[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back.get(coll, {}))[0]
        assert len(flat_v) == len(flat_b), coll
        for (pv, a), (pb, b) in zip(sorted(flat_v, key=lambda t: str(t[0])),
                                    sorted(flat_b, key=lambda t: str(t[0]))):
            assert jax.tree_util.keystr(pv) == jax.tree_util.keystr(pb)
            np.testing.assert_array_equal(np.asarray(a), b)


def _factory_params(model_type, patch):
    out = []
    for p in (jax_default_params(), get_default_params()):
        p.update(model_type=model_type, feature_size=16, patch_size=patch,
                 chans_in=2, chans_out=2, use_amp=False)
        out.append(p)
    return out


@pytest.mark.parametrize("model_type,patch", [
    ("UNET", 32), ("VNET", 32), ("UNETR", 32), ("SWINUNETR", 64)])
def test_factory_model_matches_jax(model_type, patch):
    """get_model of both packages from the same params (the JAX factory's
    settings at full width: UNet 16-512, VNet, UNETR hidden 768 / 12 heads /
    MLP 1024 at feature size 16, SwinUNETR at 24), forward only."""
    jp, tp = _factory_params(model_type, patch)
    fm, _ = jax_get_model(jp)
    tm, tp = get_model(tp)
    assert not tp["model_returns_vaeloss"]
    rng = np.random.RandomState(41)
    v = _model_variables(fm, rng, patch)
    x = rng.normal(size=(1,) + (patch,) * 3 + (2,)).astype(np.float32)
    want = np.asarray(jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    tm.eval()
    weights.load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4
