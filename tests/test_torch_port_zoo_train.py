"""One train step of SegResNet_DSA (fp32, CPU; SegResNetVAE_DSA's is in
test_torch_port_zoo_vae.py, through `check_train_step`)
against jax.grad of the JAX model with the same weights: the loss (DiceCE,
plus 0.2 times the VAE loss) and every parameter's gradient, rel-L2 1e-2
per leaf (ROADMAP C10), at feature size 4 and projection 16: SegResNet_DSA
with a batch of 2 at patch 32, SegResNetVAE_DSA with a batch of 1 at
patch 64 (VAE_IMG).

Dropout is off on both sides (dropout_prob None, attention rate 0, the
conv branch's ChannelDropout3d the identity: the two packages draw from
different streams, C2), and the VAE's normal draw is fed in: JAX's
`jax.random.normal` returns the test's array for the (B, 256) draw, and
the port's model takes the same array as `vae_noise`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.segresnet_dsa import SegResNet_DSA as FlaxSegResNetDSA
from fcd_tpu.models.segresnet_dsa import (
    SegResNetVAE_DSA as FlaxSegResNetVAEDSA,
)
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.segresnet_dsa import SegResNet_DSA, SegResNetVAE_DSA
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from tests.test_torch_parity import randomize_batch_stats

import torch_port_workers

torch_port_workers.share_cores()

IMG = (32, 32, 32)
# the VAE branch's instance norms run on the grid of patch / 16: 2^3 at
# 32^3 amplifies f32 rounding in the gradients (ROADMAP C10), 4^3 at 64^3
# does not
VAE_IMG = (64, 64, 64)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _kwargs(vae: bool, img):
    kw = dict(out_channels=2, in_channels=2, init_filters=4,
              dropout_prob=None, upsample_mode="pixelshuffle",
              blocks_down=(1, 2, 2, 4), blocks_up=(1, 1, 1),
              dsa_img_size=img, dsa_project_size=16, dsa_num_heads=4,
              dsa_dropout_rate=0.0, dsa_sa_type="parallel",
              dsa_num_layers=3, dsa_start_level=2)
    if vae:
        kw.update(input_image_size=img, vae_default_std=0.3, vae_nz=256)
    return kw


def check_train_step(monkeypatch, vae: bool):
    monkeypatch.setattr(
        jattention, "ChannelDropout3d",
        lambda rate: (lambda x, train=False, s2d_channels=None: x))
    rng = np.random.RandomState(31)
    img, batch = (VAE_IMG, 1) if vae else (IMG, 2)
    x = rng.normal(size=(batch,) + img + (2,)).astype(np.float32)
    y = (rng.rand(batch, *img, 1) > 0.9).astype(np.float32)
    z = rng.normal(size=(batch, 256)).astype(np.float32)
    normal = jax.random.normal

    def fed_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == z.shape:
            return jnp.asarray(z, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fed_normal)

    jkw = dict(_kwargs(vae, img), norm="instance", dsa_pos_embed=True)
    fm = (FlaxSegResNetVAEDSA if vae else FlaxSegResNetDSA)(**jkw)
    v = fm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)},
                jnp.zeros((1,) + img + (2,)), train=False)

    def draw(path, leaf):  # the attention contributes
        key = jax.tree_util.keystr(path)
        if "gamma" in key or "pos_embed" in key:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        return leaf

    v = {"params": jax.tree_util.tree_map_with_path(draw, v["params"]),
         "batch_stats": v["batch_stats"]}
    v = jax.tree_util.tree_map(np.asarray, randomize_batch_stats(v, rng))
    jp = jax_default_params()
    jp.update(loss="DiceCELoss", chans_out=2)
    jloss = jax_combined_loss(jp)

    def loss_of(params, xx):
        out, _ = fm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xx, train=True,
                          rngs={"dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        if vae:
            out, vae_loss = out
            return jloss(out, jnp.asarray(y)) + 0.2 * vae_loss
        return jloss(out, jnp.asarray(y))

    value_and_grad = jax.jit(jax.value_and_grad(loss_of))
    jl, jg = value_and_grad(v["params"], jnp.asarray(x))
    jg = jax.tree_util.tree_map(np.asarray, jg)
    # C10: where the JAX gradient of a leaf itself moves by more than half
    # the tolerance when x moves by 1e-5 of itself (the VAE branch's ReLUs
    # and instance norms on 4^3 grids; a bias just before an instance norm,
    # whose gradient is 0 but for rounding), that leaf is held to twice
    # that movement instead
    moved = {}
    if vae:
        xn = x * (1 + 1e-5 * rng.normal(size=x.shape)).astype(np.float32)
        _, jg2 = value_and_grad(v["params"], jnp.asarray(xn))
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(jg)[0],
                jax.tree_util.tree_leaves_with_path(jg2)):
            moved[jax.tree_util.keystr(path)] = _rel_l2(b, a)

    tm = (SegResNetVAE_DSA if vae else SegResNet_DSA)(**_kwargs(vae, img))
    for stack in tm.transformer_levels:
        for blk in stack:
            blk.dropout.rate = 0.0
    weights.load_flax_variables(tm, v)
    params = get_default_params()
    params.update(loss="DiceCELoss", chans_out=2)
    noise = torch.from_numpy(z)
    model = (lambda img: tm(img, vae_noise=noise)) if vae else tm
    model_fwd = _Bound(tm, model)
    step = make_train_step(model_fwd, make_combined_loss(params),
                           make_optimizer(params, tm),
                           model_returns_vaeloss=vae, loss_vae_weight=0.2)
    loss = step(torch.from_numpy(x), torch.from_numpy(y), 1e-4)
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    got = weights.export_flax_grads(tm)
    worst = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = got
        for k in path:
            node = node[k.key]
        name = jax.tree_util.keystr(path)
        tol = max(1e-2, 2.0 * moved.get(name, 0.0))
        worst.append((_rel_l2(node, leaf), tol, name))
    bad = [w for w in worst if w[0] > w[1]]
    assert not bad, sorted(bad)
    # and nine leaves in ten hold to 1e-2 whatever their conditioning
    assert sum(w[0] <= 1e-2 for w in worst) >= 0.9 * len(worst)


def test_segresnet_dsa_train_step_matches_jax(monkeypatch):
    check_train_step(monkeypatch, vae=False)


class _Bound(torch.nn.Module):
    """The model with its VAE draw bound: make_train_step calls
    model(image) and model.train()."""

    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn
        self.dropout_rng = model.dropout_rng

    def forward(self, image):
        return self.fn(image)
