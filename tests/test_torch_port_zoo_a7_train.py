"""One DiceCE train step of each of UNet, VNet, UNETR and SwinUNETR of the
port (CPU, the models narrowed as test_torch_port_zoo_a7.py narrows them,
on a 64^3 patch) against jax.grad of the JAX model with the same weights,
dropout off on both sides (C2): the loss (rel 1e-5) and every parameter's
gradient, rel-L2 1e-2 per leaf (C10), but for two kinds of leaf:

- a conv bias whose output goes straight into a norm that removes its
  mean (UNet's instance norms, VNet's batch norms on the batch's
  statistics) has the gradient 0: both sides are held to under 1e-5 of
  the whole gradient's norm there;
- VNet's PReLU slopes and batch-norm affines are each one sum over the
  batch and grid of terms (x g over x < 0 for a slope, xhat g and g per
  channel for a batch norm's scale and bias, g the gradient at the
  module's output), and where the terms cancel, the two packages' f32
  differences in g are a large part of the sum. Such a leaf past rel-L2
  1e-2 must be a sum that cancels to under 1e-2 of the sum of its terms'
  absolute values (measured in the port's step, `_TermSums`; six leaves,
  3e-4 to 4e-3), and is held value by value to 1e-3 of that sum
  (measured up to 1.4e-4).

The kernel route runs B1, K1, B2, K2 and B4's plain versions where the
model has res blocks; SwinUNETR's blocks run under checkpoint.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fcd_tpu.models.unet as junet
import fcd_tpu.models.vnet as jvnet
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.unet import UNet
from fcd_tpu_torch.models.vnet import VNet
from fcd_tpu_torch.ops.attention import ChannelDropout3d
from fcd_tpu_torch.ops.layers import BatchNorm, PReLU
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from tests.test_torch_port_zoo_a7 import (
    MODELS,
    PATCH,
    _model_variables,
    _narrow,
    _numpy_tree,
    _rel_l2,
)

import torch_port_workers

torch_port_workers.share_cores()


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(name, monkeypatch):
    """One DiceCE step of the narrowed model (kernel route: B1, K1, B2, K2,
    B4's plain versions where it has res blocks; VNet's batch norms on the
    batch's statistics; SwinUNETR's blocks under checkpoint) against
    jax.grad, dropout off on both sides."""
    identity = (lambda rate: (lambda x, train=False, s2d_channels=None: x))
    monkeypatch.setattr(junet, "ChannelDropout3d", identity)
    monkeypatch.setattr(jvnet, "ChannelDropout3d", identity)
    fm, tm = _narrow(name, dropout=False)
    rng = np.random.RandomState(51 + MODELS.index(name))
    v = _model_variables(fm, rng)
    x = rng.normal(size=(1,) + (PATCH,) * 3 + (2,)).astype(np.float32)
    y = (rng.rand(1, PATCH, PATCH, PATCH, 1) > 0.9).astype(np.float32)
    jp = jax_default_params()
    jp.update(loss="DiceCELoss", chans_out=2)
    jloss = jax_combined_loss(jp)

    def loss_of(params, xx):
        out, _ = fm.apply({"params": params,
                           "batch_stats": v.get("batch_stats", {})},
                          xx, train=True,
                          rngs={"dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        return jloss(out, jnp.asarray(y))

    jl, jg = jax.jit(jax.value_and_grad(loss_of))(v["params"],
                                                  jnp.asarray(x))
    jg = _numpy_tree(jg)
    for m in tm.modules():
        assert not isinstance(m, ChannelDropout3d) or m.rate == 0.0
    weights.load_flax_variables(tm, v)
    params = get_default_params()
    params.update(loss="DiceCELoss", chans_out=2)
    step = make_train_step(tm, make_combined_loss(params),
                           make_optimizer(params, tm))
    with _TermSums(tm if isinstance(tm, VNet) else None) as sums:
        loss = step(torch.from_numpy(x), torch.from_numpy(y), 1e-4)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    got = weights.export_flax_grads(tm)
    zero = set()
    by_path = {}
    for _, path, t, _ in weights.model_entries(tm):
        if id(t) in _normed_biases(tm):
            zero.add(path)
        if id(t) in sums.sums:
            by_path[path] = sums.sums[id(t)]
    total = np.sqrt(sum(np.square(np.asarray(leaf, np.float64)).sum()
                        for leaf in jax.tree_util.tree_leaves(jg)))
    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = tuple(k.key for k in path)
        node = got
        for k in key:
            node = node[k]
        name = jax.tree_util.keystr(path)
        if key in zero:
            # a bias just before a norm that removes its mean: its gradient
            # is 0, and both sides' rounding stays near it
            for g in (node, leaf):
                assert np.linalg.norm(g) <= 1e-5 * total, name
            continue
        rel = _rel_l2(node, leaf)
        if key in by_path:
            terms = by_path[key]
            want = np.asarray(leaf, np.float64)
            err = np.abs(np.asarray(node, np.float64) - want)
            ok = rel <= 1e-2 or (
                np.linalg.norm(want) <= 1e-2 * np.linalg.norm(terms)
                and bool((err <= 1e-3 * terms).all()))
            if not ok:
                bad.append((name, rel, float((err / terms).max()),
                            float(np.linalg.norm(want)
                                  / np.linalg.norm(terms))))
        elif rel > 1e-2:
            bad.append((name, rel))
    assert not bad, bad


class _TermSums:
    """Within the context, one forward and backward of `model` (None:
    nothing) records, for each PReLU slope and batch-norm scale and bias,
    the sum of the absolute values of the terms its gradient sums (f64):
    |x g| over x < 0, and per channel |xhat g| and |g| (xhat from the
    batch's statistics), g the gradient at the module's output. `sums`:
    {id(parameter): array of the parameter's shape}."""

    def __init__(self, model):
        self.model, self.sums, self.handles = model, {}, []

    def __enter__(self):
        if self.model is not None:
            self.handles = [m.register_forward_hook(self._hook)
                            for m in self.model.modules()
                            if isinstance(m, (PReLU, BatchNorm))]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def _add(self, prm, value):
        value = value.numpy()
        self.sums[id(prm)] = self.sums.get(id(prm), 0.0) + value

    def _hook(self, mod, inputs, out):
        x = inputs[0].detach().double()

        def on_grad(g):
            g = g.detach().double()
            if isinstance(mod, PReLU):
                self._add(mod.alpha, torch.where(
                    x < 0, (x * g).abs(), 0.0).sum().reshape(1))
                return
            xf, gf = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
            mean = xf.mean(0)
            var = (xf.square().mean(0) - mean.square()).clamp_min(0)
            xhat = (xf - mean) * torch.rsqrt(var + mod.eps)
            self._add(mod.scale, (xhat * gf).abs().sum(0))
            self._add(mod.bias, gf.abs().sum(0))

        out.register_hook(on_grad)


def _normed_biases(tm):
    """ids of the conv biases whose output goes straight into a norm that
    removes its mean (UNet's instance norms, VNet's batch norms in train
    mode): their gradient is 0."""
    if isinstance(tm, UNet):
        convs = [u.convs[i] for u in (*tm.downs, tm.bottom, *tm.up_units)
                 if u is not None for i in range(u.n_act)]
        convs += list(tm.up_convs)
    elif isinstance(tm, VNet):
        convs = [m.conv for m in tm.modules() if hasattr(m, "norm")
                 and hasattr(m, "conv")]
    else:
        convs = []
    return {id(c.bias) for c in convs if c.bias is not None}
