"""Tensor parallelism (`fcd_tpu_torch/parallel/tp.py`) for the model zoo
on gloo ranks against the JAX package on the CPU: MS_DSA_NET_PS (also
under FCD_FAST_CONV=1) and UNETR++ here; UNETR and SwinUNETR in
`test_torch_port_tp_zoo_vit.py`, the SegResNet family in
`test_torch_port_tp_zoo_segres.py`, UNet and VNet in
`test_torch_port_tp_zoo_unet.py`, and a model axis of 4 in
`test_torch_port_tp_zoo_axis4.py`, each file one spawn of ranks through
this module's `run_cases` (so that xdist's --dist loadfile spreads them).

Each model is narrowed (`CASES` of each file: feature size 4, one
transformer layer a level where it has levels, UNETR at hidden 48,
SwinUNETR at feature size 12, a 32^3 patch) and runs with dropout off on both sides (ROADMAP C2: no
JAX stream can be matched), with the flax variables randomised by
tests/test_torch_parity.py's helpers (gamma and the pos-embeds drawn at
0.1, so that the attention counts). On a (1, 2) ("data", "model") mesh of
gloo ranks, on the kernel route (the kernels' plain versions here) and
the plain route (`use_plain_route`, the route of f32 and f16 on the
card):

(a) the port's spec of every parameter leaf, from `weights.py`'s flax
paths, equals `fcd_tpu.parallel.tp.tp_spec_for`'s on the JAX variables,
over a model axis of 2 and of 4, and the port shards what the rule
shards;
(b) the TP eval forward against `model.apply` (rel 1e-4, as the zoo's
single-device forward tests hold it), bit-equal on every rank;
(c) one TP step (DiceCE) against the single-device step of the JAX
package: the loss and the gradients of `jax.value_and_grad` of the loss
`make_train_step` differentiates, at the same weights and batch (as the
zoo's single-device step tests take them). The loss within rel 1e-4;
every gathered gradient leaf within GRAD_MARGIN times the JAX gradient's
own largest distance under N_NUDGES inputs times (1 + NUDGE N(0, 1)),
plus GRAD_FLOOR, in rel-L2 (`test_torch_port_tp.py`'s rule: the models
are chaotic at these sizes, and a gradient scaled by k reads |k - 1|).
Two kinds of leaf lie outside that control in the port's single-device
step as well, and `test_torch_port_zoo_a7_train.py` holds them there: a
gradient that is 0 up to rounding (a conv bias just before a norm that
removes its mean: UNet's, VNet's, the VAE's down conv), held as that test
holds it, both sides under ZERO_SHARE of the whole gradient's norm; and
the leaves where the port's single-device gradient itself misses the
control (VNet's batch-norm biases, sums whose terms cancel), where the TP
gradient is held to the single-device step of the port on the same rank
within rel-L2 GRAD_FLOOR (TP changes the order of sums only).

The ranks are spawned once a module (`torch_port_mesh_ranks.
zoo_tp_checks`), in a thread beside the JAX side's compiles.
"""

import functools
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fcd_tpu.models.unet as junet
import fcd_tpu.models.unetr_pp as junetrpp
import fcd_tpu.models.vnet as jvnet
import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.ms_dsa_net import MS_DSA_NET_PS as FlaxMSDSANetPS
from fcd_tpu.models.unetr_pp import UNETR_PP as FlaxUNETRPP
from fcd_tpu.parallel.tp import _path_names, tp_spec_for as jax_spec_for
from fcd_tpu_torch.parallel.mesh import launch
from fcd_tpu_torch.parallel.tp import tp_tree_shardings
from tests.test_torch_parity import randomize_batch_stats, randomize_params

import torch_port_mesh_ranks as ranks

import torch_port_workers

torch_port_workers.share_cores()

PATCH = 32
IMG = (PATCH,) * 3
FS = 4
LR = 1e-3
SHAPE = (1, 2)
NUDGE = 1e-6
N_NUDGES = 3
GRAD_MARGIN = 2.0
GRAD_FLOOR = 1e-4
ZERO_SHARE = 1e-5
ROUTES = ("kernel", "plain")
LEAKY = ("leakyrelu", {"negative_slope": 0.01})
UNETRPP_DIMS = (FS * 2, FS * 4, FS * 8, FS * 16)


class _EPABlockNoDropout(jattention.EPABlock):
    """The JAX decoders build their EPA blocks at attention dropout 0.1
    whatever the model's rate (fcd_tpu/models/unetr_pp.py:91-99): under
    the EPABlock name (the same parameter paths) they run at 0."""

    def __post_init__(self):
        object.__setattr__(self, "dropout_rate", 0.0)
        super().__post_init__()


_EPABlockNoDropout.__name__ = "EPABlock"


def _identity_dropout(rate):
    return lambda x, train=False, s2d_channels=None: x


# {name: (flax module, port (module, class, kwargs), routes, VAE)}, the
# factory's configuration of each model type narrowed, dropout off
CASES = {
    "MS_DSA_NET_PS": (
        lambda: FlaxMSDSANetPS(
            out_channels=2, img_size=IMG, feature_size=FS, project_size=16,
            pos_embed=True, sa_type="parallel", norm_name="instance",
            act_name=LEAKY, res_block=True, use_bias=False, num_layers=1,
            dropout_rate=0.0, upsample_mode="pixelshuffle"),
        ("fcd_tpu_torch.models.ms_dsa_net", "MS_DSA_NET_PS",
         dict(out_channels=2, img_size=IMG, in_channels=2, feature_size=FS,
              project_size=16, num_layers=1, dropout_rate=0.0)),
        ROUTES, False),
    # FCD_FAST_CONV=1: the pixelshuffle convs through B1 on the kernel route
    # (column-parallel, its data gradient on the partial instance); the
    # JAX package takes its fast conv at bf16 only, so at f32 it runs the
    # same function as without
    "MS_DSA_NET_PS fast": (
        lambda: FlaxMSDSANetPS(
            out_channels=2, img_size=IMG, feature_size=FS, project_size=16,
            pos_embed=True, sa_type="parallel", norm_name="instance",
            act_name=LEAKY, res_block=True, use_bias=False, num_layers=1,
            dropout_rate=0.0, upsample_mode="pixelshuffle"),
        ("fcd_tpu_torch.models.ms_dsa_net", "MS_DSA_NET_PS",
         dict(out_channels=2, img_size=IMG, in_channels=2, feature_size=FS,
              project_size=16, num_layers=1, dropout_rate=0.0, fast=True)),
        ("kernel",), False),
    "UNETR_PP": (
        lambda: FlaxUNETRPP(
            out_channels=2, in_channels_hint=2, feature_size=FS,
            hidden_size=FS * 16, num_heads=4, depths=(1, 1, 1, 1),
            dims=UNETRPP_DIMS, patch_size=IMG, norm_name="instance",
            do_ds=False, dropout_rate=0.0),
        ("fcd_tpu_torch.models.unetr_pp", "UNETR_PP",
         dict(out_channels=2, in_channels=2, feature_size=FS,
              depths=(1, 1, 1, 1), dims=UNETRPP_DIMS, patch_size=IMG,
              dropout_rate=0.0)),
        ROUTES, False),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _patched(mp, noise=None):
    """Dropout off in the JAX modules (C2); a VAE's normal draw `noise`."""
    for mod in (jattention, junet, jvnet):
        mp.setattr(mod, "ChannelDropout3d", _identity_dropout)
    mp.setattr(junetrpp, "EPABlock", _EPABlockNoDropout)
    if noise is not None:
        normal = jax.random.normal

        def fed_normal(key, shape=(), dtype=jnp.float32):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise, dtype)
            return normal(key, shape, dtype)

        mp.setattr(jax.random, "normal", fed_normal)


@functools.lru_cache(maxsize=None)
def _shapes(make):
    with pytest.MonkeyPatch.context() as mp:
        _patched(mp)
        fm = make()
        return fm, jax.eval_shape(lambda: fm.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1,) + IMG + (2,)), train=False))


def _case_data(name, cases, seed):
    """(flax module, variables, x, y, VAE noise or None) of a case."""
    make, _, _, vae = cases[name]
    fm, shapes = _shapes(make)
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    v = randomize_params(v, rng)
    if "batch_stats" in v:
        v = randomize_batch_stats(v, rng)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "gamma" in key or "pos_embed" in key:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        return leaf

    v = dict(v, params=jax.tree_util.tree_map_with_path(draw, v["params"]))
    x = rng.normal(size=(1,) + IMG + (2,)).astype(np.float32)
    y = (rng.rand(1, *IMG, 1) > 0.8).astype(np.float32)
    noise = (rng.normal(size=(1, 256)).astype(np.float32) if vae else None)
    return fm, _numpy_tree(v), x, y, noise


def _jax_side(fm, v, x, y, noise, seed):
    """The JAX eval forward, the loss and gradients at x, and the
    gradients at N_NUDGES nudged inputs."""
    jp = jax_default_params()
    jp.update(loss="DiceCELoss", chans_out=2)
    jloss = jax_combined_loss(jp)
    vae = noise is not None
    stats = v.get("batch_stats", {})

    def loss_of(params, xx):
        out, _ = fm.apply({"params": params, "batch_stats": stats}, xx,
                          train=True, rngs={"dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        if vae:
            out, vae_loss = out
            return jloss(out, jnp.asarray(y)) + 0.2 * vae_loss
        return jloss(out, jnp.asarray(y))

    with pytest.MonkeyPatch.context() as mp:
        _patched(mp, noise)
        fwd = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
            v, jnp.asarray(x))
        value_and_grad = jax.jit(jax.value_and_grad(loss_of))
        loss, grads = value_and_grad(v["params"], jnp.asarray(x))
        rng = np.random.RandomState(seed)
        nudged = [_numpy_tree(value_and_grad(v["params"], jnp.asarray(
            x * (1 + NUDGE * rng.normal(size=x.shape)).astype(np.float32)))[1])
            for _ in range(N_NUDGES)]
    return {"forward": np.asarray(fwd[0] if vae else fwd),
            "loss": float(loss), "grads": _numpy_tree(grads),
            "nudged": nudged}


def run_cases(cases, shape, seed):
    """Every case of `cases` on the ranks of `shape` (spawned once, in a
    thread) and on the JAX side meanwhile: {"port": rank results, "jax":
    {name: JAX results}}."""
    data = {name: _case_data(name, cases, seed + i)
            for i, name in enumerate(cases)}
    rank_cases = {name: {"spec": cases[name][1], "variables": d[1],
                         "x": d[2], "y": d[3], "noise": d[4],
                         "routes": cases[name][2]}
                  for name, d in data.items()}
    port = {}

    def run_port():
        try:
            port["out"] = launch(ranks.zoo_tp_checks, shape[0] * shape[1],
                                 rank_cases, shape, LR, device_type="cpu",
                                 threads=1)
        except BaseException as e:        # re-raised in the test's thread
            port["error"] = e

    worker = threading.Thread(target=run_port)
    worker.start()
    try:
        jx = {name: _jax_side(d[0], d[1], d[2], d[3], d[4], seed + 100 + i)
              for i, (name, d) in enumerate(data.items())}
    finally:
        worker.join()
    if "error" in port:
        raise port["error"]
    return {"port": port["out"], "jax": jx}


def spec_check(make, spec, n_model):
    """(a): the port's specs against the JAX rule's on the flax leaves."""
    import importlib

    _, shapes = _shapes(make)
    want = {_path_names(p): tuple(jax_spec_for(_path_names(p), leaf.shape,
                                               n_model))
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                shapes["params"])[0]}
    module, cls, kwargs = spec
    model = getattr(importlib.import_module(module), cls)(**kwargs)
    got = tp_tree_shardings(model, n_model)
    assert got == want
    assert any("model" in s for s in got.values())


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree, np.float64)


def loss_check(results, name, route):
    want = results["jax"][name]["loss"]
    for out in results["port"]:
        assert out[(name, route)]["loss"] == pytest.approx(want, rel=1e-4)


def forward_check(results, name, route):
    """(b), and each rank's forward the same bits."""
    want = results["jax"][name]["forward"]
    got = results["port"][0][(name, route)]["forward"]
    assert got.shape == want.shape == (1,) + IMG + (2,)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    for out in results["port"][1:]:
        np.testing.assert_array_equal(out[(name, route)]["forward"], got)
    assert "col" in results["port"][0][(name, route)]["roles"]


def grads_check(results, name, route):
    """(c): every gathered gradient leaf within GRAD_MARGIN times the JAX
    gradient's own largest distance under the nudged inputs, plus
    GRAD_FLOOR, in rel-L2; a gradient 0 up to rounding under ZERO_SHARE of
    the whole on both sides; where the port's single-device gradient
    misses the control too, within GRAD_FLOOR of it (the module
    docstring)."""
    jx = results["jax"][name]
    out = results["port"][0][(name, route)]
    got, single = out["grads"], out["single_grads"]
    leaves = jax.tree_util.tree_flatten_with_path(jx["grads"])[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    total = np.sqrt(sum(np.square(np.asarray(w, np.float64)).sum()
                        for _, w in leaves))
    bad = []
    for path, want in leaves:
        want = np.asarray(want, np.float64)
        mine = _leaf(got, path)
        rel = _rel_l2(mine, want)
        limit = GRAD_MARGIN * max(_rel_l2(_leaf(n, path), want)
                                  for n in jx["nudged"]) + GRAD_FLOOR
        if rel <= limit:
            continue
        if max(np.linalg.norm(want), np.linalg.norm(mine)) <= \
                ZERO_SHARE * total:
            continue
        alone = _leaf(single, path)
        if _rel_l2(alone, want) > limit and \
                _rel_l2(mine, alone) <= GRAD_FLOOR:
            continue
        bad.append((jax.tree_util.keystr(path), rel, limit,
                    _rel_l2(mine, alone)))
    assert not bad, bad


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES, SHAPE, 41)


CASE_ROUTES = [(name, route) for name, case in CASES.items()
               for route in case[2]]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_zoo_specs_match_jax(name, n_model):
    spec_check(CASES[name][0], CASES[name][1], n_model)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_tp_zoo_forward_matches_jax(results, name, route):
    forward_check(results, name, route)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_tp_zoo_loss_matches_jax(results, name, route):
    loss_check(results, name, route)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_tp_zoo_grads_match_jax(results, name, route):
    grads_check(results, name, route)
