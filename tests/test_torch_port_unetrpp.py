"""UNETR++ (`model_type='unetrpp'`) of the port (CPU) against the JAX
package's UNETR_PP with the same weights, at feature size 4 on a 64^3
patch (the stages' grids 16^3 .. 2^3; projections 64, 64, 64, 32):

- the factory's model (kernel route: B1, B2, B5's plain versions) and the
  f32 route, each against the JAX logits, rel 1e-4;
- do_ds: the three heads, held to the JAX triple (one JAX compile serves
  these forward tests);
- the weight table both ways (every leaf once, export gives back the JAX
  tree);
- one train step against jax.grad with dropout off (DiceCE): the loss
  (rel 1e-5) and every parameter's gradient (rel-L2 1e-2 per leaf, the
  slice test's tolerance, test_torch_port_train.py), with one EPA block
  an encoder stage (the decoders keep their three): every module kind's
  backward at a third of the XLA compile.

Weights are the flax variables randomised with tests/test_torch_parity.py's
helpers (gamma and the pos-embeds drawn so that the attention counts);
inputs come from np.random.RandomState. Both sides run f32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fcd_tpu.models.unetr_pp as junetrpp
import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.unetr_pp import UNETR_PP as FlaxUNETRPP
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.models.unetr_pp import UNETR_PP
from fcd_tpu_torch.ops.attention import ChannelDropout3d, EPABlock
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from tests.test_torch_parity import randomize_batch_stats, randomize_params

import torch_port_workers

torch_port_workers.share_cores()

PATCH = 64
FS = 4


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


def _flax(do_ds=False, dropout_rate=0.1, depths=(3, 3, 3, 3)):
    fs = FS
    return FlaxUNETRPP(out_channels=2, in_channels_hint=2, feature_size=fs,
                       hidden_size=fs * 16, num_heads=4, depths=depths,
                       dims=(fs * 2, fs * 4, fs * 8, fs * 16),
                       patch_size=(PATCH,) * 3, norm_name="instance",
                       do_ds=do_ds, dropout_rate=dropout_rate)


def _variables(fm, rng):
    """Random weights and running statistics, the attention's gamma and
    pos-embed drawn at 0.1 so that it contributes."""
    shapes = jax.eval_shape(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + (PATCH,) * 3 + (2,)), train=False))
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    v = randomize_batch_stats(randomize_params(v, rng), rng)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "gamma" in key or "pos_embed" in key:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        return leaf

    return _numpy_tree({"params": jax.tree_util.tree_map_with_path(
        draw, v["params"]), "batch_stats": v["batch_stats"]})


def _port(do_ds=False, f32_route=False, depths=None):
    if do_ds or depths is not None:
        return UNETR_PP(out_channels=2, in_channels=2, feature_size=FS,
                        depths=depths or (3, 3, 3, 3),
                        dims=(FS * 2, FS * 4, FS * 8, FS * 16),
                        patch_size=(PATCH,) * 3, do_ds=do_ds)
    params = get_default_params()
    params.update(model_type="unetrpp", feature_size=FS, patch_size=PATCH,
                  chans_in=2, chans_out=2)
    model, params = get_model(params, compute_dtype=(
        torch.float32 if f32_route else None))
    assert not params["model_returns_vaeloss"]
    return model


@pytest.fixture(scope="module")
def jax_forward():
    """(variables, input, the JAX triple [logits, ds2, ds3]) at fs 4 on the
    64^3 patch: UNETR_PP as the JAX factory builds it (fcd_tpu/models/
    factory.py:180-197) but with do_ds, one XLA compile for the module's
    forward tests; the logits are the factory model's (do_ds only adds the
    two heads, Conv3d_5 and Conv3d_6)."""
    fm = _flax(do_ds=True)
    rng = np.random.RandomState(21)
    v = _variables(fm, rng)
    x = rng.normal(size=(1,) + (PATCH,) * 3 + (2,)).astype(np.float32)
    want = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    return v, x, [np.asarray(w) for w in want]


@pytest.mark.parametrize("route", ["kernels", "f32"])
def test_unetrpp_forward_matches_jax(jax_forward, route):
    """The factory's model (get_model, model_type 'unetrpp'), kernel route
    and f32 route, against the JAX logits."""
    v, x, want = jax_forward
    tm = _port(f32_route=route == "f32").eval()
    weights.load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want[0].shape == (1, PATCH, PATCH, PATCH, 2)
    assert _rel(got, want[0]) < 1e-4


def test_unetrpp_deep_supervision_matches_jax(jax_forward):
    v, x, want = jax_forward
    tm = _port(do_ds=True).eval()
    weights.load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert isinstance(got, list) and len(got) == 3
    shapes = [(1, PATCH, PATCH, PATCH, 2), (1, 16, 16, 16, 2),
              (1, 8, 8, 8, 2)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == w.shape == shape
        assert _rel(g.numpy(), w) < 1e-4


def test_unetrpp_weight_table_round_trip(jax_forward):
    """Every JAX leaf is used once and every port parameter and buffer gets
    one leaf; export gives back the JAX tree, EPA blocks under their own
    names."""
    v, _, _ = jax_forward
    tm = _port(do_ds=True)
    weights.load_flax_variables(tm, v)
    entries = list(weights.model_entries(tm))
    ids = [id(e[2]) for e in entries]
    assert len(ids) == len(set(ids))
    assert set(ids) == {id(t) for t in list(tm.parameters())
                        + list(tm.buffers())}
    assert sum(isinstance(m, EPABlock) for m in tm.modules()) == 21
    assert {e[1][0] for e in entries} >= {f"EPABlock_{i}" for i in range(21)}
    back = weights.export_flax_variables(tm)
    for coll in v:
        flat_v = jax.tree_util.tree_flatten_with_path(v[coll])[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back[coll])[0]
        assert len(flat_v) == len(flat_b), coll
        for (pv, a), (pb, b) in zip(sorted(flat_v, key=lambda t: str(t[0])),
                                    sorted(flat_b, key=lambda t: str(t[0]))):
            assert jax.tree_util.keystr(pv) == jax.tree_util.keystr(pb)
            np.testing.assert_array_equal(np.asarray(a), b)


def test_unetrpp_train_step_matches_jax(monkeypatch):
    """One DiceCE step of the factory's model (kernel route: B1, B2, K1,
    K2 and K3/K4's plain versions) against jax.grad of the JAX model,
    dropout off on both sides (the attention's rate 0, the conv branch's
    ChannelDropout3d the identity)."""
    monkeypatch.setattr(
        jattention, "ChannelDropout3d",
        lambda rate: (lambda x, train=False, s2d_channels=None: x))
    # the JAX decoders build their EPA blocks at attention dropout 0.1
    # whatever the model's rate (fcd_tpu/models/unetr_pp.py:91-99): a
    # subclass of the same name (so the same parameter names) runs them at 0
    base = jattention.EPABlock

    class EPABlockNoDropout(base):
        def __post_init__(self):
            object.__setattr__(self, "dropout_rate", 0.0)
            super().__post_init__()

    EPABlockNoDropout.__name__ = "EPABlock"
    monkeypatch.setattr(junetrpp, "EPABlock", EPABlockNoDropout)
    rng = np.random.RandomState(23)
    depths = (1, 1, 1, 1)
    fm = _flax(dropout_rate=0.0, depths=depths)
    v = _variables(fm, rng)
    x = rng.normal(size=(1,) + (PATCH,) * 3 + (2,)).astype(np.float32)
    y = (rng.rand(1, PATCH, PATCH, PATCH, 1) > 0.9).astype(np.float32)
    jp = jax_default_params()
    jp.update(loss="DiceCELoss", chans_out=2)
    jloss = jax_combined_loss(jp)

    def loss_of(params):
        out, _ = fm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        return jloss(out, jnp.asarray(y))

    jl, jg = jax.jit(jax.value_and_grad(loss_of))(v["params"])
    jg = _numpy_tree(jg)

    tm = _port(depths=depths)
    for m in tm.modules():
        if isinstance(m, EPABlock):
            m.dsa.dropout_rate = 0.0
        if isinstance(m, ChannelDropout3d):
            m.rate = 0.0
    weights.load_flax_variables(tm, v)
    params = get_default_params()
    params.update(loss="DiceCELoss", chans_out=2)
    step = make_train_step(tm, make_combined_loss(params),
                           make_optimizer(params, tm))
    loss = step(torch.from_numpy(x), torch.from_numpy(y), 1e-4)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    got = weights.export_flax_grads(tm)
    worst = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = got
        for k in path:
            node = node[k.key]
        worst.append((_rel_l2(node, leaf), jax.tree_util.keystr(path)))
    bad = [w for w in worst if w[0] > 1e-2]
    assert not bad, sorted(bad)
