"""The training slice's kernels, plain versions on the CPU, against the
JAX package's Pallas kernels run in interpret mode (as
tests/test_s2d_blocks.py, tests/test_finale_train.py and
tests/test_spatial_attn.py run them).

* K1 and the conv backward: jax.vjp through conv8_a2o_stats ->
  conv8_o2a_act_stats -> instance norm (B1 + B7, the prologue and both
  statistics' cotangents) against the port's Conv3x3 Function, and
  jax.vjp of conv3x3_s2d (B12 + B13); bf16 inputs on both sides, so the
  tolerance is rel-L2 2e-2 (bf16 rounding of the intermediates).
* K2: finale_bwd_pallas with and without the pool cotangent, on bf16
  inputs with exact ties, at the model's widths C 16, 32 and 64; dt to one
  bf16 ulp, the sums to 1e-5, and the plain version's d_ys and d_rs equal
  to the JAX dt rounded to bf16 and scaled (the scaling K2 folds in).
* K3/K4: the Pallas kernels at rate 0 at the four DSA levels' (C, P)
  (rel 3e-2 of max, bf16); at rate 0.1 the plain backward equals autograd
  through the plain forward with the same hash key (f32, 1e-5) and keeps
  0.9 +- 1% of the attention.

Same numpy inputs (RandomState) go to both packages; layouts are
converted with the JAX package's own to_s2d / from_s2d.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.kernels import spatial_attn as jsa
from fcd_tpu.kernels.finale import finale_bwd_pallas
from fcd_tpu.ops.s2d_ops import (
    conv3x3_s2d,
    conv8_a2o_stats,
    conv8_o2a_act_stats,
    from_s2d,
    instance_norm_s2d,
    to_s2d,
)
from fcd_tpu_torch.kernels import spatial_attn as sa
from fcd_tpu_torch.kernels.block_conv import conv3x3_op
from fcd_tpu_torch.kernels.finale import finale_bwd_plain, finale_grads_plain
from fcd_tpu_torch.ops.layers import instance_affine_from_sums

import torch_port_workers

torch_port_workers.share_cores()

BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _conv_inputs(seed, c=16, s=16):
    rng = np.random.RandomState(seed)
    x = (rng.rand(2, s, s, s, c).astype(np.float32) - 0.5)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    w1 = rng.rand(3, 3, 3, c, c).astype(np.float32) * 0.4 - 0.2
    w2 = rng.rand(3, 3, 3, c, c).astype(np.float32) * 0.4 - 0.2
    return x, w1, w2


def test_conv_backward_matches_conv8_pair_vjp():
    """conv1 with statistics, conv2 with the norm1 + leaky prologue and
    statistics, instance norm: value, dx, dW1, dW2 (the statistics'
    cotangents flow through both affines)."""
    c, s, slope = 16, 16, 0.01
    x, w1, w2 = _conv_inputs(41, c, s)
    n = s ** 3

    def jax_fn(xs, w1_, w2_):
        y1o, s1, s2 = conv8_a2o_stats((xs.astype(jnp.bfloat16),), (w1_,))
        ys, o1, o2 = conv8_o2a_act_stats(y1o, s1, s2, w2_, s // 2, slope)
        out = instance_norm_s2d(ys, c, stats=(o1, o2))
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    val, (gx, gw1, gw2) = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        to_s2d(jnp.asarray(x)), jnp.asarray(w1), jnp.asarray(w2))

    xt = _t(x, BF).requires_grad_(True)
    w1t, w2t = _t(w1).requires_grad_(True), _t(w2).requires_grad_(True)
    o1 = conv3x3_op([xt], [w1t], want_stats=True)
    sc1, sh1 = instance_affine_from_sums(o1.ysum, o1.ysq, n)
    o2 = conv3x3_op([o1.y], [w2t], prologue=(sc1, sh1, slope),
                    want_stats=True)
    sc2, sh2 = instance_affine_from_sums(o2.ysum, o2.ysq, n)
    out = (o2.y.float() * sc2[:, None, None, None, :]
           + sh2[:, None, None, None, :]).to(BF)
    loss = out.float().sin().sum()
    loss.backward()

    assert abs(float(loss.detach()) - float(val)) < 2e-2 * (abs(float(val)) + 1)
    assert _rel_l2(xt.grad.float(), from_s2d(gx, c)) < 2e-2
    assert _rel_l2(w1t.grad, gw1) < 2e-2
    assert _rel_l2(w2t.grad, gw2) < 2e-2


def test_conv_backward_matches_conv3x3_s2d_vjp():
    """B12 (27-tap conv) + B13 (its weight gradient) against the port's
    Conv3x3 forward/backward at 16^3, c = 16."""
    c = 16
    x, w, _ = _conv_inputs(7, c, 16)
    cot = np.random.RandomState(8).normal(size=(2, 16, 16, 16, c)).astype(
        np.float32)

    def jax_fn(xs, w_):
        y = from_s2d(conv3x3_s2d(xs.astype(jnp.bfloat16), w_), c)
        return jnp.sum(y.astype(jnp.float32) * cot)

    (gx, gw) = jax.grad(jax_fn, argnums=(0, 1))(to_s2d(jnp.asarray(x)),
                                                 jnp.asarray(w))
    xt = _t(x, BF).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    y = conv3x3_op([xt], [wt]).y
    (y.float() * _t(cot)).sum().backward()
    assert _rel_l2(xt.grad.float(), from_s2d(gx, c)) < 2e-2
    assert _rel_l2(wt.grad, gw) < 2e-2


def _finale_inputs(seed, b=2, s=8, c=16):
    """ys on integers (exactly representable in bf16), rs scaled by 0 in
    the affine and norm2 a scale of 2: t = 2 ys exactly, so 2x2x2 blocks
    hold exact ties, 3+ of them as well."""
    rng = np.random.RandomState(seed)
    ys = rng.randint(-2, 3, size=(b, s, s, s, c)).astype(np.float32)
    rs = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    gp = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    gq = rng.normal(size=(b, s // 2, s // 2, s // 2, c)).astype(np.float32)
    s2 = np.full((b, c), 2.0, np.float32)
    b2 = np.zeros((b, c), np.float32)
    sr = np.zeros((b, c), np.float32)
    br = np.zeros((b, c), np.float32)
    return ys, rs, s2, b2, sr, br, gp, gq


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("with_pool", [False, True])
def test_finale_bwd_matches_pallas(with_pool, c):
    slope = 0.01
    ys, rs, s2, b2, sr, br, gp, gq = _finale_inputs(3, c=c)
    bfj = jnp.bfloat16

    def s2d(a):
        return to_s2d(jnp.asarray(a)).astype(bfj)

    def tile(a):
        return jnp.tile(jnp.asarray(a), (1, 8))

    dt_j, a1_j, a2_j, a3_j = finale_bwd_pallas(
        s2d(ys), s2d(rs), tile(s2), tile(b2), tile(sr), tile(br), s2d(gp),
        jnp.asarray(gq).astype(bfj) if with_pool else None, c, slope,
        emit_pad=False, interpret=True)
    args = (_t(ys, BF), _t(rs, BF), _t(s2), _t(b2), _t(sr), _t(br),
            _t(gp, BF), _t(gq, BF) if with_pool else None, slope)
    got = finale_bwd_plain(*args)
    dt_jax = np.asarray(from_s2d(dt_j, c), np.float32)
    np.testing.assert_allclose(got[0].float().numpy(), dt_jax, rtol=2 ** -7,
                               atol=1e-6)
    # what Finale.backward returns: the JAX dt, rounded, times each scale
    d_ys, d_rs = finale_grads_plain(*args)[:2]
    dt_b = torch.tensor(dt_jax).to(BF).float()
    for mine, scale in ((d_ys, s2), (d_rs, sr)):
        assert mine.dtype == BF
        assert torch.equal(mine, (dt_b * _t(scale)[:, None, None, None, :])
                           .to(BF))
    for mine, theirs in zip(got[1:], (a1_j, a2_j, a3_j)):
        want = np.asarray(theirs, np.float32).reshape(2, 8, c).sum(axis=1)
        np.testing.assert_allclose(mine.numpy(), want, rtol=1e-5, atol=1e-3)
    if with_pool:
        # the data hold 3-way (and wider) ties, split evenly
        blocks = ys.reshape(2, 4, 2, 4, 2, 4, 2, c).transpose(
            0, 1, 3, 5, 2, 4, 6, 7).reshape(2, 4, 4, 4, 8, c)
        ties = (blocks == blocks.max(axis=4, keepdims=True)).sum(axis=4)
        assert (ties >= 3).sum() > 10


def _sa_inputs(seed, b=2, n=256, c=32, h=4, p=64):
    rng = np.random.RandomState(seed)
    qn = rng.randn(b, n, c).astype(np.float32)
    kpb = rng.randn(b, c, h * p).astype(np.float32) * 0.3 * (32 / c) ** 0.5
    vpb = rng.randn(b, h * p, c).astype(np.float32)
    g = rng.randn(b, n, c).astype(np.float32)
    return qn, kpb, vpb, g


@pytest.mark.parametrize("n,c,p", [(256, 32, 64), (200, 64, 64),
                                   (128, 128, 64), (64, 256, 32)])
def test_spatial_attn_fwd_bwd_match_pallas(n, c, p):
    """Rate 0 (the dropout streams differ between the packages), at each
    DSA level's (C, P) with 4 heads; N = 200 is not a multiple of the
    kernels' 16-token tiles."""
    h = 4
    qn, kpb, vpb, g = _sa_inputs(0, n=n, c=c, h=h, p=p)
    bfj = jnp.bfloat16
    seed = jnp.zeros((1,), jnp.int32)
    args = [jnp.asarray(a).astype(bfj) for a in (qn, kpb, vpb)]
    out_j = jsa.spatial_attn_fwd_pallas(*args, seed, h, 0.0, interpret=True)
    dq_j, dk_j, dv_j = jsa.spatial_attn_bwd_pallas(
        *args, seed, jnp.asarray(g).astype(bfj), h, 0.0, interpret=True)
    t_args = [_t(a, BF) for a in (qn, kpb, vpb)]
    out = sa.spatial_attn_fwd_plain(*t_args, h, 0, 0.0)
    dq, dk, dv = sa.spatial_attn_bwd_plain(*t_args, _t(g, BF), h, 0, 0.0)
    for mine, theirs in ((out, out_j), (dq, dq_j), (dk, dk_j), (dv, dv_j)):
        want = np.asarray(theirs, np.float32)
        err = np.abs(mine.float().numpy() - want).max() / np.abs(want).max()
        assert err < 3e-2


def test_spatial_attn_dropout_backward_is_autograd_of_forward():
    """Rate 0.1: the plain backward (K4's function) regenerates the
    forward's mask: it equals autograd through the plain forward with the
    same key, in f32."""
    h, rate = 4, 0.1
    qn, kpb, vpb, g = _sa_inputs(1)
    key = sa.dropout_key(1234, 7)
    ins = [_t(a).requires_grad_(True) for a in (qn, kpb, vpb)]
    out = sa.spatial_attn_fwd_plain(*ins, h, key, rate)
    (out * _t(g)).sum().backward()
    dq, dk, dv = sa.spatial_attn_bwd_plain(*(t.detach() for t in ins),
                                           _t(g), h, key, rate)
    for mine, ref in zip((dq, dk, dv), (t.grad for t in ins)):
        err = (mine - ref).abs().max() / ref.abs().max()
        assert float(err) < 1e-5
    # the Function's backward is the same
    ins2 = [_t(a).requires_grad_(True) for a in (qn, kpb, vpb)]
    (sa.spatial_attn(*ins2, h, key, rate) * _t(g)).sum().backward()
    for a, b in zip(ins, ins2):
        assert torch.allclose(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def test_dropout_keep_fraction_and_salts():
    b, n, hp = 2, 256, 256
    rate = 0.1
    k1 = sa.keep_mask(b, n, hp, sa.dropout_key(5, 0), rate)
    k2 = sa.keep_mask(b, n, hp, sa.dropout_key(5, 1), rate)
    k3 = sa.keep_mask(b, n, hp, sa.dropout_key(6, 0), rate)
    for k in (k1, k2, k3):
        assert abs(float(k.float().mean()) - (1 - rate)) < 0.01 * (1 - rate)
    # another layer (salt) or another step (seed) draws another mask
    assert float((k1 != k2).float().mean()) > 0.1
    assert float((k1 != k3).float().mean()) > 0.1
    # the Python-int key path and the int64 tensor path agree
    key = sa.dropout_key(5, 0)
    idx = 12345
    h = sa._fmix32(sa._mul32(idx, 0x9E3779B1) ^ key)
    assert bool(k1.reshape(-1)[idx]) == (h >= sa.keep_threshold(rate))
