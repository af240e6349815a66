"""The port's optimizer options and its TV-regularised train step against
the JAX package, f32 on the CPU, from the same numpy weights, gradients
and inputs.

* AdamW inside MultiSteps (gradient_accumulation_steps 2) over 8
  micro-steps (4 updates), gradients fed in from numpy, each with its own
  learning rate, against optax.MultiSteps(inject_hyperparams(adamw)):
  the parameters after every micro-step and the state in the JAX layout
  (`checkpoint.export_opt_state` against flax's to_state_dict) to rel
  1e-6; the counts exactly.
* `group_norms` of the same gradients against fcd_tpu's (rel 1e-5: f32
  sums in another order).
* One MS_DSA_NET train step (fs4, 32x64x64 so that level 6 is 1x2x2,
  ROADMAP C4; one layer a level) with DiceCE + total variation (l1,
  exclude_borders, weight 0.1, as README's training example) against
  fcd_tpu's make_train_step with grad_norms: the loss (rel 1e-5), every
  gradient (rel-L2 1e-2 per leaf), the per-group norms (rel 1e-2), the
  running statistics (rel-L2 1e-4) and the parameters after AdamW (1e-3
  of lr where the gradient is above 1e-2 of its leaf's largest), the
  tolerances of test_torch_port_train.py. Dropout is off on both sides.

`small_variables`, `flax_model` and `identity_channel_dropout` also serve
tests/test_torch_port_faults.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.ms_dsa_net import MS_DSA_NET as FlaxMSDSANet
from fcd_tpu.train.state import create_train_state
from fcd_tpu.train.state import group_norms as jax_group_norms
from fcd_tpu.train.state import make_optimizer as jax_make_optimizer
from fcd_tpu.train.state import make_train_step as jax_make_train_step
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET
from fcd_tpu_torch.train.checkpoint import export_opt_state
from fcd_tpu_torch.train.state import (
    MultiSteps,
    group_norms,
    make_optimizer,
    make_train_step,
    set_lr,
)
from tests.test_torch_parity import randomize_batch_stats

import torch_port_workers

torch_port_workers.share_cores()

IMG = (32, 64, 64)
TV = {"loss": "DiceCELoss", "tv_loss_weight": 0.1,
      "tvloss_exclude_borders": True}


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tree_rel(got, want, tol, what, metric=_rel):
    """Every leaf of `want` has a leaf of `got` at the same path within
    `tol`; the two trees have the same paths."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), f"{what}: {sorted(set(g) ^ set(w))[:5]}"
    bad = [(metric(g[k], w[k]), k) for k in w if metric(g[k], w[k]) > tol]
    assert not bad, f"{what}: {sorted(bad)[-5:]}"


def identity_channel_dropout(monkeypatch):
    monkeypatch.setattr(
        jattention, "ChannelDropout3d",
        lambda rate: (lambda x, train=False, s2d_channels=None: x))


def flax_model(num_layers):
    return FlaxMSDSANet(out_channels=2, img_size=IMG, feature_size=4,
                        project_size=16, num_layers=num_layers,
                        dropout_rate=0.0)


def small_variables(seed, num_layers):
    """The port's seeded initialisation of the fs4 model as a fcd_tpu numpy
    tree (flax's own init takes a minute here), with gamma and the
    pos-embed drawn so that the attention contributes, and random running
    statistics."""
    tm = MS_DSA_NET(2, IMG, in_channels=2, feature_size=4, project_size=16,
                    num_layers=num_layers, dropout_rate=0.0)
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    v = weights.export_flax_variables(tm)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "gamma" in key or "pos_embed" in key:
            return rng.normal(size=leaf.shape).astype(np.float32) * 0.1
        return leaf

    v["params"] = jax.tree_util.tree_map_with_path(draw, v["params"])
    return jax.tree_util.tree_map(np.asarray, randomize_batch_stats(v, rng))


def batch(seed, n=2):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n,) + IMG + (2,)).astype(np.float32)
    y = np.zeros((n,) + IMG + (1,), np.float32)
    y[:, 8:20, 16:40, 20:44] = 1.0
    y[rng.rand(n, *IMG, 1) > 0.97] = 1.0
    return x, y


# -- the optimizer on a small parameter tree ----------------------------------------

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3)}}


def _small_tree(rng, scale=1.0):
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s) * scale).astype(np.float32), SHAPES,
        is_leaf=lambda s: isinstance(s, tuple))


def _entries(module):
    return [(("a",), module["a"], False), (("b", "c"), module["b_c"], False),
            (("b", "d"), module["b_d"], False)]


def _module(tree):
    flat = {"a": tree["a"], "b_c": tree["b"]["c"], "b_d": tree["b"]["d"]}
    return torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.tensor(v)) for k, v in flat.items()})


def test_multisteps_adamw_matches_optax():
    rng = np.random.RandomState(1)
    p0 = _small_tree(rng)
    grads = [_small_tree(rng, 10.0 ** -(i % 3)) for i in range(8)]
    lrs = [1e-3, 5e-4, 2e-3, 1e-3, 3e-4, 1e-3, 2e-3, 7e-4]
    cfg = get_default_params()
    cfg["gradient_accumulation_steps"] = 2
    tx = jax_make_optimizer(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jparams)
    module = _module(p0)
    opt = make_optimizer(cfg, module)
    assert isinstance(opt, MultiSteps) and opt.k == 2
    entries = _entries(module)
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        state.inner_opt_state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jparams)
        jparams = optax.apply_updates(jparams, upd)
        for (_, prm, _), leaf in zip(entries, (g["a"], g["b"]["c"],
                                               g["b"]["d"])):
            prm.grad = torch.tensor(leaf)
        set_lr(opt, lr)
        opt.step()
        got = {"a": module["a"], "b": {"c": module["b_c"],
                                       "d": module["b_d"]}}
        _tree_rel(jax.tree_util.tree_map(lambda t: t.detach().numpy(), got),
                  jparams, 1e-6, f"params after micro-step {i}")
        want = serialization.to_state_dict(state)
        mine = export_opt_state(opt, entries)
        _tree_rel(mine, want, 1e-6, f"state after micro-step {i}")
        assert int(mine["mini_step"]) == int(state.mini_step) == (i + 1) % 2
        assert int(mine["gradient_step"]) == int(state.gradient_step)
        assert int(mine["inner_opt_state"]["count"]) == (i + 1) // 2


def test_group_norms_match_jax():
    rng = np.random.RandomState(2)
    tm = MS_DSA_NET(2, IMG, in_channels=2, feature_size=4, project_size=16,
                    num_layers=1)
    for _, t, _ in weights.param_entries(tm):
        t.grad = torch.tensor(rng.normal(size=tuple(t.shape)).astype(
            np.float32))
    want = jax_group_norms(jax.tree_util.tree_map(
        jnp.asarray, weights.export_flax_grads(tm)))
    got = group_norms(tm)
    assert set(got) == set(want) and len(got) > 10
    for k in want:
        assert _rel(float(got[k]), float(want[k])) < 1e-5, k


# -- the TV-regularised train step ----------------------------------------------------

def test_tv_train_step_matches_jax(monkeypatch):
    identity_channel_dropout(monkeypatch)
    jp, tp = jax_default_params(), get_default_params()
    jp.update(TV)
    tp.update(TV)
    lr = 1e-4
    fm = flax_model(1)
    v = small_variables(5, 1)
    x, y = batch(6)
    jloss = jax_combined_loss(jp)
    state = create_train_state(fm, v, jp)
    jstep = jax_make_train_step(fm, jloss, jax_make_optimizer(jp),
                                donate=False, wrap_jit=False,
                                grad_norms=True)
    key = jax.random.PRNGKey(2)

    @jax.jit
    def run(state, xx, yy):
        def loss_of(params):
            out, _ = fm.apply({"params": params,
                               "batch_stats": state.batch_stats}, xx,
                              train=True, rngs={"dropout": key},
                              mutable=["batch_stats"])
            return jloss(out, yy)

        return jax.grad(loss_of)(state.params), jstep(state, xx, yy, lr, key)

    jgrads, (jstate, jl, jnorms) = run(state, jnp.asarray(x), jnp.asarray(y))

    tm = MS_DSA_NET(2, IMG, in_channels=2, feature_size=4, project_size=16,
                    num_layers=1, dropout_rate=0.0)
    for stack in tm.transformers:
        for blk in stack:
            blk.dropout.rate = 0.0
    weights.load_flax_variables(tm, v)
    step = make_train_step(tm, make_combined_loss(tp),
                           make_optimizer(tp, tm), grad_norms=True)
    loss, norms = step(torch.tensor(x), torch.tensor(y), lr)

    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    jg = jax.tree_util.tree_map(np.asarray, jgrads)
    _tree_rel(weights.export_flax_grads(tm), jg, 1e-2, "grads", _rel_l2)
    assert set(norms) == set(jnorms)
    for k in jnorms:
        assert _rel(float(norms[k]), float(jnorms[k])) < 1e-2, k
    new_vars = weights.export_flax_variables(tm)
    _tree_rel(new_vars["batch_stats"], jstate.batch_stats, 1e-4,
              "running stats", _rel_l2)
    # AdamW's first step moves each parameter by lr * g / (|g| + 1e-8):
    # compare where the gradient is above 1e-2 of its leaf's largest and
    # above 1e-6 (test_torch_port_train.py says why)
    mine, want, g0 = (_leaves(t) for t in (new_vars["params"], jstate.params,
                                           jg))
    p0 = _leaves(v["params"])
    n_strict = 0
    for k in want:
        strict = np.abs(g0[k]) > max(1e-2 * np.abs(g0[k]).max(), 1e-6)
        err = np.abs(np.asarray(mine[k], np.float64) - want[k])
        assert (err[strict] <= 1e-3 * lr + 1e-6 * np.abs(p0[k][strict])).all(), k
        assert (err <= 2.0 * lr + 1e-6 * np.abs(p0[k])).all(), k
        n_strict += int(strict.sum())
    assert n_strict > 0.3 * sum(a.size for a in g0.values())
