"""The library-only blocks (ROADMAP A10) and UnetBasicBlock in train mode
(CPU) against jax.grad, dropout 0 (ROADMAP C2).

Each case of `tests/torch_port_a10_cases.py` in train mode, f32, on the
kernel route (B1's, B2's, K1's, K2's and K3/K4's plain versions here):
the loss sum(out * cot) within 1e-4 of the absolute sum of its terms
(the sum cancels: it can lie far under its terms), every input's gradient
and every parameter's gradient within rel-L2 1e-4 of jax.grad's, and the
running statistics after the step within 1e-5 of flax's. A parameter the
block's sa_type does not read has no gradient in the port and a zero one
in JAX. A bias that feeds a batch norm in
train mode has the gradient 0 (the norm subtracts the batch mean): both
sides read rounding noise there, so such a leaf is held near 0 instead,
within 1e-5 of the largest gradient's norm. The transformers' channel
dropout (a fixed 0.1 in both packages) is the identity on the JAX side and
at rate 0 in the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fcd_tpu.ops.attention as jattention
from fcd_tpu_torch import weights
from fcd_tpu_torch.ops.attention import ChannelDropout3d

import torch_port_a10_cases as cases
import torch_port_workers

torch_port_workers.share_cores()

GRAD_REL = 1e-4
STATS_REL = 1e-5
ZERO_GRAD = 1e-5    # of the largest gradient norm: a leaf whose JAX gradient
                    # lies under 1e-6 of it is held under this


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


def _jax_step(case, cot):
    v = case.v

    def f(params, *xs):
        out, mut = case.fm.apply(
            {"params": params, "batch_stats": v.get("batch_stats", {})}, *xs,
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        return jnp.sum(out * cot), mut

    n = len(case.inputs)
    (val, mut), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(n + 1)), has_aux=True))(
            v["params"], *[jnp.asarray(a) for a in case.inputs])
    return float(val), grads[0], grads[1:], mut.get("batch_stats", {})


def _sub(tree, case):
    return tree if case.sub is None else tree.get(case.sub, {})


@pytest.mark.parametrize("name", cases.NAMES)
def test_block_grads_match_jax(monkeypatch, name):
    monkeypatch.setattr(
        jattention, "ChannelDropout3d",
        lambda rate: (lambda x, train=False, s2d_channels=None: x))
    case = cases.make(name, seed=1)
    out_shape = jax.eval_shape(
        lambda *xs: case.fm.apply(case.v, *xs, train=False),
        *[jnp.asarray(a) for a in case.inputs]).shape
    cot = np.random.RandomState(5).normal(size=out_shape).astype(np.float32)
    val, gp, gx, new_bs = _jax_step(case, cot)

    tm = case.tm.train()
    for m in tm.modules():
        if isinstance(m, ChannelDropout3d):
            m.rate = 0.0
    xs = [torch.tensor(a, requires_grad=True) for a in case.inputs]
    terms = case.call(tm, xs) * torch.from_numpy(cot)
    loss = terms.sum()
    loss.backward()
    terms_abs = float(terms.detach().abs().sum())
    assert abs(float(loss.detach()) - val) <= GRAD_REL * terms_abs
    for x, g in zip(xs, gx):
        assert cases.rel_l2(x.grad.numpy(), g) < GRAD_REL
    got = cases.leaves(weights.export_block_grads(tm))
    want = cases.leaves(_sub(cases._numpy_tree(gp), case))
    assert set(got) <= set(want)
    scale = max(np.linalg.norm(w) for w in want.values())
    for path, w in want.items():
        if path not in got:   # a parameter the sa_type does not read
            assert not np.any(w), path
        elif np.linalg.norm(w) < 1e-6 * scale:
            assert np.linalg.norm(got[path]) < ZERO_GRAD * scale, path
        else:
            assert cases.rel_l2(got[path], w) < GRAD_REL, path
    stats = cases.leaves(_sub(cases._numpy_tree(new_bs), case))
    got_stats = cases.leaves(weights.export_block_variables(tm).get(
        "batch_stats", {}))
    assert sorted(got_stats) == sorted(stats)
    for path, w in stats.items():
        assert cases.rel_l2(got_stats[path], w) < STATS_REL, path
