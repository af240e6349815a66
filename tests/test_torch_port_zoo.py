"""The DSA model family of the port (fp32, CPU) against the JAX package's
CPU forward with the same weights: MS_DSA_NET_PS, BaseUNet, SegResNet,
SegResNetVAE, SegResNet_DSA and SegResNetVAE_DSA at feature size 4, patch
32, projection 16, built by both factories; the weight table both ways;
the three UpSample modes; a model under FCD_FAST_CONV=1 (its plain convs
through B1's kernel, B14 by function); BaseUNet's pool and its tie rule
against jax.grad.

Weights are the flax variables with randomised values
(tests/test_torch_parity.py's helpers), carried over by
`fcd_tpu_torch.weights`; inputs come from np.random.RandomState. Both
sides run fp32 on the CPU: rel < 1e-4, as test_torch_port_model.py holds
MS_DSA_NET.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.models.factory import get_model as jax_get_model
from fcd_tpu.ops.layers import UpSample as FlaxUpSample
from fcd_tpu.ops.layers import max_pool_2x as jax_max_pool_2x
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.ops.layers import UpSample, max_pool_2x_chain
from tests.test_torch_parity import randomize_batch_stats, randomize_params

import torch_port_workers

torch_port_workers.share_cores()

torch.set_grad_enabled(False)

PATCH = 32
MODELS = ["MS_DSA_NET_PS", "BaseUNet", "SegResNet", "SegResNetVAE",
          "SegResNet_DSA", "SegResNetVAE_DSA"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _random_variables(init_fn, rng):
    shapes = jax.eval_shape(init_fn)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return randomize_batch_stats(randomize_params(v, rng), rng)


def _params(model_type, **kw):
    """The same settings for both factories (fs 4, patch 32, P 16, f32)."""
    out = []
    for p in (jax_default_params(), get_default_params()):
        p.update(model_type=model_type, feature_size=4, project_size=16,
                 patch_size=PATCH, chans_in=2, chans_out=2, use_amp=False)
        p.update(kw)
        out.append(p)
    return out


def _pair(model_type, seed, **kw):
    """(flax module, its numpy variables, the port model with them)."""
    jp, tp = _params(model_type, **kw)
    fm, _ = jax_get_model(jp)
    x0 = jnp.zeros((1, PATCH, PATCH, PATCH, 2))
    v = _numpy_tree(_random_variables(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x0, train=False), np.random.RandomState(seed)))
    tm, _ = get_model(tp)
    tm.eval()
    weights.load_flax_variables(tm, v)
    return fm, v, tm, jp


def _jax_forward(fm, v, x, vae):
    """The flax eval forward, jitted (one XLA program: 3.6 s instead of
    29 s op by op for MS_DSA_NET_PS)."""
    out = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    return np.asarray(out[0] if vae else out)


@pytest.mark.parametrize("model_type", MODELS)
def test_new_model_forward_matches_jax(model_type):
    fm, v, tm, jp = _pair(model_type, 11)
    x = np.random.RandomState(12).normal(
        size=(1, PATCH, PATCH, PATCH, 2)).astype(np.float32)
    vae = jp["model_returns_vaeloss"]
    want = _jax_forward(fm, v, x, vae)
    got = tm(torch.from_numpy(x))
    if vae:
        assert got[1] is None
        got = got[0]
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("model_type", MODELS)
def test_weight_table_round_trip(model_type):
    """Every JAX leaf is used exactly once and every port parameter and
    buffer gets exactly one leaf: loading then exporting gives back the
    JAX tree, and the table names each tensor once."""
    _, v, tm, _ = _pair(model_type, 13)
    entries = list(weights.model_entries(tm))
    ids = [id(e[2]) for e in entries]
    assert len(ids) == len(set(ids))
    owned = {id(t) for t in list(tm.parameters()) + list(tm.buffers())}
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


@pytest.mark.parametrize("mode", ["pixelshuffle", "deconv", "nontrainable"])
def test_upsample_modes_match_jax(mode):
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 4, 6, 5, 8)).astype(np.float32)
    fm = FlaxUpSample(features=4, scale=2, mode=mode, use_bias=True)
    v = _numpy_tree(_random_variables(
        lambda: fm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng))
    want = np.asarray(fm.apply(v, jnp.asarray(x)))
    tm = UpSample(8, 4, mode, use_bias=True)
    weights._load(weights._upsample_entries(tm, ()), v)
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 12, 10, 4)
    assert _rel(got, want) < 1e-5


def test_fast_conv_model_matches_jax():
    """FCD_FAST_CONV=1: SegResNet_DSA's convInit and pixelshuffle convs
    (3x3, stride 1) go through B1's kernel (its plain version here) and
    the model still matches the JAX forward, which keeps XLA convs on the
    CPU."""
    fm, v, _, jp = _pair("SegResNet_DSA", 21)
    _, tp = _params("SegResNet_DSA", perf_flags={"FCD_FAST_CONV": "1"})
    tm, _ = get_model(tp)
    tm.eval()
    assert tm.conv_init.fast and tm.up_samples[0].conv.fast
    weights.load_flax_variables(tm, v)
    x = np.random.RandomState(22).normal(
        size=(1, PATCH, PATCH, PATCH, 2)).astype(np.float32)
    assert _rel(tm(torch.from_numpy(x)).numpy(),
                _jax_forward(fm, v, x, False)) < 1e-4


def test_baseunet_pool_ties_match_jax_grad():
    """BaseUNet's pool is the jnp.maximum chain: on tied inputs its
    gradient splits as jax.grad of fcd_tpu's max_pool_2x does (halves at
    each tied pair), never max_pool3d's one index (ROADMAP C1, C8)."""
    rng = np.random.RandomState(4)
    x = rng.randint(0, 3, size=(2, 4, 6, 8, 3)).astype(np.float32)
    cot = rng.normal(size=(2, 2, 3, 4, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_max_pool_2x(t) * cot))(jnp.asarray(x)))
    with torch.enable_grad():
        t = torch.from_numpy(x).requires_grad_(True)
        (max_pool_2x_chain(t) * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(max_pool_2x_chain(torch.from_numpy(x)),
                       torch.from_numpy(np.array(jax_max_pool_2x(
                           jnp.asarray(x)))))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-6)
    assert len(np.unique(want[want != 0])) > len(np.unique(cot))
