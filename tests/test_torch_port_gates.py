"""The port's performance gates and the kernels behind them (CPU), against
the JAX package.

* The gate registry (`fcd_tpu_torch/flags.py`): names and defaults equal
  `fcd_tpu.flags.FLAGS`; an exported variable beats `perf_flags`, which
  beats the default; unknown keys raise; building a trainer leaves
  `os.environ` as it was; `pool_in_finale`, `fused_head` and
  `levels12_tie` give what the cited JAX conditions give, evaluated by the
  JAX package's own predicates under the same environment.
* B3 and B9 (`kernels/pool2x.py`), B15 (`kernels/finale_head.py`): their
  plain versions against `pool_fwd_pallas`, `pool_bwd_pallas` and
  `fused_finale_head` in interpret mode, as the JAX package's tests run
  them: B3 and B9 bit for bit (a max and one f32 division are exact
  operations), B15 to the f32 summation order (rel 1e-6) and, in bf16, to
  one bf16 ulp.
* B11, B12 `aligned`, B14, B16 and B18, closed by function: each Pallas
  kernel in interpret mode against the plain version of the port's op
  whose kernel computes the same function (B1's `conv3x3_plain`, B4's
  `upsample2x_plain`), tolerances stated per test.
* A port UnetResBlock at encoder 1's widths in training with the pool in
  a pass of its own: its gradients against the fused block's and against
  JAX's UnetResBlock with FCD_FINALE_TRAIN=0.
* The slice: a small MS_DSA_NET through ModelTrainer with `perf_flags`:
  gated inference bit-equal to the default path, the fused head within
  f32 rounding, gated train steps equal to the default ones.

Inputs are numpy arrays from np.random.RandomState, given to both
packages; layouts are converted with the JAX package's to_s2d / from_s2d.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from fcd_tpu import flags as jflags
from fcd_tpu.kernels import block_conv as jbc
from fcd_tpu.kernels.pool import pool_bwd_pallas, pool_fwd_pallas
from fcd_tpu.kernels.upsample import upsample_s2d_pallas
from fcd_tpu.ops import blocks as jblocks
from fcd_tpu.ops import s2d_ops as js2d
from fcd_tpu.ops.blocks import UnetResBlock as FlaxUnetResBlock
from fcd_tpu.ops.s2d_ops import from_s2d, to_s2d
from fcd_tpu_torch import flags
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.kernels import finale_head as fh
from fcd_tpu_torch.kernels import pool2x
from fcd_tpu_torch.kernels.block_conv import conv3x3_plain
from fcd_tpu_torch.kernels.upsample import upsample2x_plain
from fcd_tpu_torch.ops.blocks import UnetResBlock
from fcd_tpu_torch.train.trainer import ModelTrainer

import torch_port_workers

torch_port_workers.share_cores()

BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


@pytest.fixture
def clean_env(monkeypatch):
    """os.environ replaced, for this test, by a copy without FCD_*
    variables: both packages read their gates there, and the JAX
    package's apply_perf_flags writes there."""
    monkeypatch.setattr(os, "environ", {
        k: v for k, v in os.environ.items() if not k.startswith("FCD_")})
    return monkeypatch


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _bf16(a):
    """numpy f32 array rounded to bf16 values (kept f32)."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _np(t):
    return t.detach().float().numpy()


# -- the gate registry -----------------------------------------------------------

def test_registry_names_and_defaults_equal_jax():
    assert set(flags.FLAGS) == set(jflags.FLAGS)
    for name, f in jflags.FLAGS.items():
        mine = flags.FLAGS[name]
        assert (mine.default, mine.values, mine.status) == (
            f.default, f.values, f.status), name
        assert mine.port, f"{name} does not say what it does in the port"


def test_env_beats_perf_flags_beats_default(clean_env):
    assert flags.resolve()["FCD_FINALE_POOL"] == "1"
    assert flags.resolve({"FCD_FINALE_POOL": 0})["FCD_FINALE_POOL"] == "0"
    clean_env.setenv("FCD_FINALE_POOL", "1")
    gates = flags.resolve({"FCD_FINALE_POOL": "0", "FCD_FUSED_HEAD": "1"})
    assert gates["FCD_FINALE_POOL"] == "1" and gates["FCD_FUSED_HEAD"] == "1"
    assert flags.get("FCD_FINALE_POOL") == "1"
    assert not flags.on("FCD_FUSED_HEAD") and flags.on("FCD_FUSED_HEAD", gates)
    # the same order as the JAX package's apply_perf_flags + get
    clean_env.setenv("FCD_FUSED_HEAD", "0")
    gates = flags.resolve({"FCD_FUSED_HEAD": "1", "FCD_PAD_CHAIN": "0"})
    jflags.apply_perf_flags({"FCD_FUSED_HEAD": "1", "FCD_PAD_CHAIN": "0"})
    for name in flags.FLAGS:
        assert gates[name] == jflags.get(name), name


def test_unknown_gate_raises(clean_env):
    with pytest.raises(KeyError):
        flags.resolve({"FCD_NO_SUCH_GATE": "1"})
    with pytest.raises(KeyError):
        flags.get("FCD_NO_SUCH_GATE")
    params = _small_params({"FCD_FINAL_POOL": "0"})   # a typo
    with pytest.raises(KeyError):
        ModelTrainer(params, device="cpu")


def test_building_a_trainer_leaves_environ_unchanged(clean_env):
    before = dict(os.environ)
    tr = ModelTrainer(_small_params({"FCD_FINALE_POOL": "0",
                                     "FCD_FUSED_HEAD": "1"}), device="cpu")
    assert dict(os.environ) == before
    assert tr.model.pool_in_finale == (False, False) and tr.model.fused_head
    # a later trainer without perf_flags runs the defaults
    tr2 = ModelTrainer(_small_params({}), device="cpu")
    assert tr2.model.pool_in_finale == (True, True)
    assert not tr2.model.fused_head and tr2.model.levels12_tie == "even"


GATES = ("FCD_S2D", "FCD_PAD_CHAIN", "FCD_FUSED_BLOCK", "FCD_FINALE_POOL",
         "FCD_CONV8_TRAIN", "FCD_CONV8_STATS", "FCD_FINALE_TRAIN",
         "FCD_FUSED_HEAD")


def _jax_conditions():
    """The JAX package's own predicates under the current environment:
    (eval pool in the finale, train pool in the finale, fused head, tie).
    use_s2d1 reduces to FCD_S2D (the backend and dtype checks of
    `_s2d_block_eligible` hold on the TPU)."""
    s2d = jflags.get("FCD_S2D") != "0"
    fuse_pool = jflags.get("FCD_FINALE_POOL") != "0"
    ev = jblocks._pad_chain_ok(False, "instance", False) and fuse_pool
    tr = (jblocks._pad_chain_ok(True, "instance", False) and fuse_pool
          and jflags.get("FCD_CONV8_STATS") != "0"
          and js2d._finale_train_use_pallas(64, 64, 16))
    head = (s2d and jflags.get("FCD_FUSED_BLOCK") != "0"
            and jflags.get("FCD_FUSED_HEAD") != "0")
    return ev, tr, head, "even" if s2d else "chain"


def _port_conditions(gates):
    return (flags.pool_in_finale(gates, False), flags.pool_in_finale(gates, True),
            flags.fused_head(gates), flags.levels12_tie(gates))


@pytest.mark.parametrize("gate", GATES)
def test_each_gate_decides_as_jax_does(clean_env, gate):
    value = "1" if gate == "FCD_FUSED_HEAD" else "0"
    clean_env.setenv(gate, value)
    assert _port_conditions(flags.resolve()) == _jax_conditions()
    clean_env.delenv(gate)
    assert _port_conditions(flags.resolve({gate: value})) == \
        _port_conditions({**flags.resolve(), gate: value})


def test_every_gate_setting_decides_as_jax_does(clean_env):
    seen = set()
    for bits in itertools.product("01", repeat=len(GATES)):
        for g, v in zip(GATES, bits):
            clean_env.setenv(g, v)
        want = _jax_conditions()
        assert _port_conditions(flags.resolve()) == want, dict(zip(GATES, bits))
        seen.add(want)
    assert len(seen) >= 6


# -- B3 and B9: the pool in a pass of its own --------------------------------------

def _pool_input(seed, b=2, s=8, c=16):
    """Small integers: many 2x2x2 blocks hold exact ties."""
    rng = np.random.RandomState(seed)
    return rng.randint(-3, 4, size=(b, s, s, s, c)).astype(np.float32)


@pytest.mark.parametrize("interior", [False, True])
def test_b3_plain_equals_pool_fwd_pallas(interior):
    """pooled bit for bit; interior=True reads a padded-chain input."""
    c = 16
    x = _pool_input(0, c=c) + np.random.RandomState(1).rand(2, 8, 8, 8, c)
    x = _bf16(x)
    xs = to_s2d(jnp.asarray(x)).astype(jnp.bfloat16)
    if interior:
        xs = jnp.pad(xs, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
    want = np.asarray(pool_fwd_pallas(xs, c, interpret=True, interior=interior),
                      np.float32)
    got = pool2x.max_pool2x(_t(x, BF))
    assert got.dtype == BF and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("ties", [2, 3, 8])
def test_b9_plain_equals_pool_bwd_pallas(ties):
    """dx bit for bit on blocks whose maximum is held by exactly `ties`
    children (the rest strictly below), bf16 x and g."""
    b, s, c = 2, 8, 16
    rng = np.random.RandomState(ties)
    blocks = rng.randint(-4, 2, size=(b, s // 2, s // 2, s // 2, 8, c)).astype(
        np.float32)
    top = rng.randint(3, 6, size=(b, s // 2, s // 2, s // 2, 1, c))
    for idx in np.ndindex(b, s // 2, s // 2, s // 2):
        for ch in range(c):
            who = rng.permutation(8)[:ties]
            blocks[idx + (who, ch)] = top[idx + (0, ch)]
    x = blocks.reshape(b, s // 2, s // 2, s // 2, 2, 2, 2, c).transpose(
        0, 1, 4, 2, 5, 3, 6, 7).reshape(b, s, s, s, c)
    g = _bf16(rng.normal(size=(b, s // 2, s // 2, s // 2, c)))
    xs = to_s2d(jnp.asarray(x)).astype(jnp.bfloat16)
    m = js2d._pool_max(xs, c)
    want = np.asarray(from_s2d(pool_bwd_pallas(
        xs, m, jnp.asarray(g).astype(jnp.bfloat16), c, interpret=True), c),
        np.float32)
    got = pool2x.max_pool2x_bwd(_t(x, BF), _t(g, BF))
    assert got.dtype == BF
    np.testing.assert_array_equal(_np(got), want)
    # every block's maximum is held by exactly `ties` children
    assert ((_np(got) != 0).reshape(-1).sum()
            == np.count_nonzero(g) * ties)


def test_b9_op_gradient_is_the_even_split():
    """max_pool2x_op's backward (B9) against the even split written out."""
    x = _t(_pool_input(4), BF).requires_grad_(True)
    g = torch.randn(2, 4, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    out = pool2x.max_pool2x_op(x)
    assert torch.equal(out, pool2x.max_pool2x_plain(x.detach()))
    (out.float() * g).sum().backward()
    want = pool2x.max_pool2x_bwd_plain(x.detach(), g.to(BF))
    assert torch.equal(x.grad, want)


def test_gate_kernel_wrappers_refuse_other_devices():
    """B3, B9 and B15 take their plain versions only for CPU tensors: a
    tensor on another device is refused (on CUDA they launch the kernel
    or raise, tests/test_torch_port_cuda.py)."""
    m = torch.zeros(1, 2, 2, 2, 8, device="meta", dtype=BF)
    g = torch.zeros(1, 1, 1, 1, 8, device="meta", dtype=BF)
    aff = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pool2x.max_pool2x(m)
    with pytest.raises(ValueError, match="unsupported device"):
        pool2x.max_pool2x_bwd(m, g)
    with pytest.raises(ValueError, match="unsupported device"):
        fh.finale_head(m, m, aff, aff, aff, aff,
                       torch.zeros(8, 2, device="meta"), None, 0.01)
    with pytest.raises(ValueError, match="even D, H, W"):
        pool2x.max_pool2x(torch.zeros(1, 3, 2, 2, 8))


# -- B15: the finale fused with the segmentation head ------------------------------

def _head_inputs(seed, b=2, s=8, c=16, o=2):
    rng = np.random.RandomState(seed)
    y2 = _bf16(rng.normal(size=(b, s, s, s, c)))
    r = _bf16(rng.normal(size=(b, s, s, s, c)))
    aff = [rng.normal(size=(b, c)).astype(np.float32) * 0.5 + (1.0 if k % 2 == 0 else 0.0)
           for k in range(4)]
    w = rng.normal(size=(c, o)).astype(np.float32) * 0.3
    bias = rng.normal(size=(o,)).astype(np.float32)
    return y2, r, aff, w, bias


def _fused_finale_head_jax(y2, r, aff, w, bias, out_dtype):
    c = y2.shape[-1]
    tile = [jnp.tile(jnp.asarray(a), (1, 8)) for a in aff]
    wh = jbc.make_blocked_weights_1x1(jnp.asarray(w)).astype(jnp.bfloat16)
    bias8 = None if bias is None else jnp.tile(jnp.asarray(bias), 8)
    out = jbc.fused_finale_head(
        to_s2d(jnp.asarray(y2)).astype(jnp.bfloat16),
        to_s2d(jnp.asarray(r)).astype(jnp.bfloat16), *tile, wh, bias8,
        neg_slope=0.01, out_dtype=out_dtype, interpret=True)
    return np.asarray(from_s2d(out, w.shape[1]), np.float32)


@pytest.mark.parametrize("with_bias", [True, False])
def test_b15_plain_matches_fused_finale_head_f32(with_bias):
    """out_dtype f32: the same activations and products, summed in
    another order (rel 1e-6 of max|logit|)."""
    y2, r, aff, w, bias = _head_inputs(0)
    bias = bias if with_bias else None
    want = _fused_finale_head_jax(y2, r, aff, w, bias, jnp.float32)
    got = fh.finale_head(_t(y2, BF), _t(r, BF), *(_t(a) for a in aff), _t(w),
                         None if bias is None else _t(bias), 0.01,
                         out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _rel(_np(got), want) < 1e-6


def test_b15_plain_matches_fused_finale_head_bf16():
    """bf16 logits: within one bf16 ulp of the Pallas kernel's (the f32
    sums may straddle a rounding boundary)."""
    y2, r, aff, w, bias = _head_inputs(1)
    want = _fused_finale_head_jax(y2, r, aff, w, bias, jnp.bfloat16)
    got = _np(fh.finale_head(_t(y2, BF), _t(r, BF), *(_t(a) for a in aff),
                             _t(w), _t(bias), 0.01))
    ulp = np.abs(want) * 2.0 ** -7 + 1e-30
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.99


# -- closed by function: B11, B12 aligned, B14, B16, B18 ----------------------------

def _conv_inputs(seed, b=2, s=8, cin=16, cout=16):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.rand(b, s, s, s, cin) - 0.5)
    w = _bf16(rng.rand(3, 3, 3, cin, cout) * 0.4 - 0.2)
    return x, w


def _sums8(a, c):
    """(B, 1, 8c) per-lane sums of the s2d kernels -> (B, c)."""
    a = np.asarray(a, np.float64)
    return a.reshape(a.shape[0], 8, c).sum(axis=1)


def _bf16_close(got, want):
    """bf16 outputs of the same f32 sum taken in another order: one bf16
    ulp of the larger magnitude, or 1e-6 of the tensor's max near 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = np.maximum(np.abs(want), np.abs(got)) * 2.0 ** -7 \
        + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), float(
        (np.abs(got - want) - tol).max())


def test_b11_fused_conv_with_shortcut_and_stats_is_b1():
    """`blocked_conv_s2d_fused` as conv1 (FCD_CONV8=0): the 27-tap conv,
    the 1x1 shortcut from the same reads and both statistics. Outputs in
    bf16 to one ulp; the statistics, sums of the f32 accumulator over the
    8 parity groups, to rel 1e-5."""
    cin, cout = 16, 16
    x, w = _conv_inputs(2, cin=cin, cout=cout)
    wr = _bf16(np.random.RandomState(3).rand(cin, cout) * 0.4 - 0.2)
    wblk = jbc.make_blocked_weights_aligned(jnp.asarray(w)).astype(jnp.bfloat16)
    rblk = jbc.make_blocked_weights_1x1(jnp.asarray(wr)).astype(jnp.bfloat16)
    y, ys, yq, rr, rs, rq = jbc.blocked_conv_s2d_fused(
        to_s2d(jnp.asarray(x)).astype(jnp.bfloat16), wblk, res_wblk=rblk,
        want_stats=True, out_dtype=jnp.bfloat16, interpret=True)
    o = conv3x3_plain([_t(x, BF)], [_t(w)], shortcut=[_t(wr)],
                      want_stats=True)
    _bf16_close(_np(o.y), np.asarray(from_s2d(y, cout), np.float32))
    _bf16_close(_np(o.r), np.asarray(from_s2d(rr, cout), np.float32))
    for mine, theirs in ((o.ysum, ys), (o.ysq, yq), (o.rsum, rs), (o.rsq, rq)):
        assert _rel(_np(mine), _sums8(theirs, cout)) < 1e-5


def test_b11_fused_conv_with_prologue_is_b1():
    """`blocked_conv_s2d_fused` as conv2: leaky(x * scale + shift) rounded
    to bf16, zero padding applied after the prologue, statistics. XLA may
    contract the prologue's multiply-add, so a prologue value can round to
    the neighbouring bf16 value: the output then moves by a weight times
    one bf16 ulp of the activation, so y is held to one ulp plus 2^-9 of
    max|y|, and 99% of it bit-equal; the statistics to rel 1e-5."""
    c = 16
    x, w = _conv_inputs(4, cin=c, cout=c)
    rng = np.random.RandomState(5)
    scale = (rng.rand(2, c) + 0.5).astype(np.float32)
    shift = (rng.rand(2, c) - 0.5).astype(np.float32)
    wblk = jbc.make_blocked_weights_aligned(jnp.asarray(w)).astype(jnp.bfloat16)
    y, ys, yq = jbc.blocked_conv_s2d_fused(
        to_s2d(jnp.asarray(x)).astype(jnp.bfloat16), wblk,
        in_scale=jnp.tile(jnp.asarray(scale), (1, 8)),
        in_shift=jnp.tile(jnp.asarray(shift), (1, 8)), neg_slope=0.01,
        want_stats=True, out_dtype=jnp.bfloat16, interpret=True)
    o = conv3x3_plain([_t(x, BF)], [_t(w)],
                      prologue=(_t(scale), _t(shift), 0.01), want_stats=True)
    got, want = _np(o.y), np.asarray(from_s2d(y, c), np.float32)
    tol = np.abs(want) * 2.0 ** -7 + 2.0 ** -9 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all()
    assert (got == want).mean() > 0.99
    assert _rel(_np(o.ysum), _sums8(ys, c)) < 1e-5
    assert _rel(_np(o.ysq), _sums8(yq, c)) < 1e-5


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_b12_aligned_is_b1(cin, cout):
    """`blocked_conv_s2d_aligned` (FCD_S2D_CONV=aligned), f32 out, on
    bf16-valued inputs: B1's function to the f32 summation order (rel
    1e-5 of max)."""
    x, w = _conv_inputs(6, cin=cin, cout=cout)
    wblk = jbc.make_blocked_weights_aligned(jnp.asarray(w)).astype(jnp.bfloat16)
    y = jbc.blocked_conv_s2d_aligned(
        to_s2d(jnp.asarray(x)).astype(jnp.bfloat16), wblk, cin, 8 * cout,
        jnp.float32, True)
    got = conv3x3_plain([_t(x)], [_t(w)]).y
    assert _rel(_np(got), np.asarray(from_s2d(y, cout))) < 1e-5


@pytest.mark.parametrize("cin,cout", [(16, 16), (2, 16)])
def test_b14_blocked_conv3x3_forward_and_dx_are_b1(cin, cout):
    """`blocked_conv3x3` (FCD_FAST_CONV=1) as tests/test_block_conv.py
    runs it, forward and dx (its backward runs the same kernel on flipped
    weights and a bf16 cotangent), against the port's Conv3x3 op on
    bf16-valued f32 inputs: rel 1e-5 of max (f32 summation order)."""
    x, w = _conv_inputs(8, b=1, cin=cin, cout=cout)
    cot = _bf16(np.random.RandomState(9).normal(size=(1, 8, 8, 8, cout)))

    def loss(xx):
        return jnp.sum(jbc.blocked_conv3x3(xx, jnp.asarray(w), jnp.float32,
                                           True) * cot)

    y = jbc.blocked_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.float32, True)
    gx = jax.grad(loss)(jnp.asarray(x))
    from fcd_tpu_torch.kernels.block_conv import conv3x3_op

    xt = _t(x).requires_grad_(True)
    yt = conv3x3_op([xt], [_t(w)]).y
    (yt * _t(cot)).sum().backward()
    assert _rel(_np(yt), np.asarray(y)) < 1e-5
    assert _rel(_np(xt.grad), np.asarray(gx)) < 1e-5


@pytest.mark.parametrize("with_bias", [False, True])
def test_b16_upsample_s2d_pallas_is_b4(with_bias):
    """`upsample_s2d_pallas` (FCD_UP_KERNEL=1), f32 out, on bf16-valued
    inputs: B4's function, each output one product sum of cin terms plus
    the f32 bias (rel 1e-6 of max)."""
    cin, cout = 16, 8
    rng = np.random.RandomState(10)
    x = _bf16(rng.normal(size=(2, 4, 6, 4, cin)))
    k = _bf16(rng.normal(size=(2, 2, 2, cin, cout)) * 0.3)
    bias = rng.normal(size=(cout,)).astype(np.float32) if with_bias else None
    wm = js2d._upsample_wm(jnp.asarray(k), cin)
    out = upsample_s2d_pallas(
        to_s2d(jnp.asarray(x)).astype(jnp.bfloat16), wm, cin, cout,
        None if bias is None else jnp.asarray(bias), out_dtype=jnp.float32,
        interpret=True)
    got = upsample2x_plain(_t(x), _t(k), None if bias is None else _t(bias))
    assert _rel(_np(got), np.asarray(from_s2d(out, cout))) < 1e-6


def test_b18_halo_pad_kernel_is_the_zero_pad():
    """`_halo_pad`'s kernel (FCD_A2O_PAD=pallas), whose pallas_call
    hard-codes interpret=False behind a TPU check: the same call built
    here in interpret mode equals the zero halo pad, bit for bit."""
    rng = np.random.RandomState(11)
    b, d2, h2, w2, c8 = 2, 3, 4, 6, 128
    xs = jnp.asarray(_bf16(rng.normal(size=(b, d2, h2, w2, c8)))).astype(
        jnp.bfloat16)
    w_in = jbc._pad8(jbc._pad8(w2 + 1) + 1)
    out = pl.pallas_call(
        jbc._halo_pad_kernel(h2, w2, w_in),
        grid=(b, d2),
        in_specs=[pl.BlockSpec((1, 1, h2, w2, c8),
                               lambda bb, z: (bb, z, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, h2 + 2, w_in, c8),
                               lambda bb, z: (bb, z + 1, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, d2 + 2, h2 + 2, w_in, c8),
                                       xs.dtype),
        interpret=True,
    )(xs)
    zrow = jnp.zeros((b, 1, h2 + 2, w_in, c8), xs.dtype)
    out = jax.lax.dynamic_update_slice(out, zrow, (0, 0, 0, 0, 0))
    out = jax.lax.dynamic_update_slice(out, zrow, (0, d2 + 1, 0, 0, 0))
    want = jnp.pad(xs, ((0, 0), (1, 1), (1, 1), (1, w_in - 1 - w2), (0, 0)))
    np.testing.assert_array_equal(np.asarray(out, np.float32),
                                  np.asarray(want, np.float32))


def test_b18_conv_behind_the_xla_halo_is_b1(monkeypatch):
    """`blocked_conv_a2o` with FCD_A2O_PAD=pad (the halo padded outside
    the kernel, the form `pallas` computes): its offset-blocked output,
    read back on the dense grid, is B1's conv (rel 1e-5 of max, f32 out,
    bf16-valued inputs)."""
    monkeypatch.setenv("FCD_A2O_PAD", "pad")
    x, w = _conv_inputs(12, b=1, cin=16, cout=16)
    x = x[:, :, :6, :]                                    # 8 x 6 x 8
    y = jbc.blocked_conv_a2o(
        to_s2d(jnp.asarray(x)).astype(jnp.bfloat16),
        jbc.make_blocked_weights_8tap(jnp.asarray(w)).astype(jnp.bfloat16),
        out_dtype=jnp.float32, interpret=True)[0]
    d, h, wd = x.shape[1:4]
    dense = np.asarray(from_s2d(y, 16))[:, 1:1 + d, 1:1 + h, 1:1 + wd]
    got = conv3x3_plain([_t(x)], [_t(w)]).y
    assert _rel(_np(got), dense) < 1e-5


# -- the block: encoder 1 in training with the pool in a pass of its own ------------

def _enc1_block(seed, cin=4, oc=16):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.normal(size=(1, 8, 8, 8, cin)))
    w1 = rng.normal(size=(3, 3, 3, cin, oc)).astype(np.float32) * 0.2
    w2 = rng.normal(size=(3, 3, 3, oc, oc)).astype(np.float32) * 0.1
    w3 = rng.normal(size=(cin, oc)).astype(np.float32) * 0.3
    return x, {"Conv3d_0": {"kernel": w1}, "Conv3d_1": {"kernel": w2},
               "Conv3d_2": {"kernel": w3.reshape(1, 1, 1, cin, oc)}}


def _port_block_grads(x, params, pool_in_finale, dtype=BF):
    cin, oc = x.shape[-1], params["Conv3d_0"]["kernel"].shape[-1]
    blk = UnetResBlock(cin, oc).train()
    weights.load_resblock(blk, params)
    xt = _t(x, dtype).requires_grad_(True)
    out, pooled = blk([xt], pool=True, pool_in_finale=pool_in_finale)
    loss = out.float().square().sum() + pooled.float().square().sum()
    loss.backward()
    grads = {k: v["kernel"] for k, v in weights.export_block_grads(blk).items()}
    grads["x"] = _np(xt.grad)
    return float(loss.detach()), grads


def test_unfused_pool_block_grads_match_the_fused_block_and_jax(clean_env):
    """bf16, as on the card. Fused (K2 adds the pool's share to the skip
    cotangent in f32) against unfused (autograd adds B9's dx to the skip
    cotangent in bf16): the two differ by the rounding of that bf16 sum,
    rel-L2 <= 1e-2 (2^-8 per element, then through two convs). Against
    JAX's UnetResBlock with FCD_FINALE_TRAIN=0 (s2d parts passed directly,
    as tests/test_finale_train.py forces it; composed finale, the s2d
    pool's even split): its norms round to bf16 before the residual add,
    the port's finale does not, so rel-L2 <= 5e-2 (test_finale_train's
    own fused-vs-composed check allows 0.08 of max)."""
    x, params = _enc1_block(13)
    l_fused, g_fused = _port_block_grads(x, params, True)
    l_own, g_own = _port_block_grads(x, params, False)
    assert l_fused == l_own
    for k in g_fused:
        assert _rel_l2(g_own[k], g_fused[k]) < 1e-2, k

    clean_env.setenv("FCD_FINALE_TRAIN", "0")
    cin = x.shape[-1]
    xs = to_s2d(jnp.asarray(x)).astype(jnp.bfloat16)
    fm = FlaxUnetResBlock(out_channels=16, kernel_size=3, stride=1,
                          norm_name="instance", dtype=jnp.bfloat16)
    jparams = {k: {"kernel": jnp.asarray(v["kernel"])} for k, v in params.items()}

    def f(p, xx):
        out, pooled = fm.apply({"params": p}, None, train=True,
                               s2d_parts=[(xx, cin)], emit_s2d=True,
                               emit_pool=True)
        return (jnp.sum(out.astype(jnp.float32) ** 2)
                + jnp.sum(pooled.astype(jnp.float32) ** 2))

    val, (gp, gx) = jax.value_and_grad(f, argnums=(0, 1))(jparams, xs)
    assert abs(l_own - float(val)) < 2e-2 * abs(float(val))
    assert _rel_l2(g_own["x"], np.asarray(from_s2d(gx, cin), np.float32)) < 5e-2
    for k in params:
        assert _rel_l2(g_own[k].reshape(-1),
                       np.asarray(gp[k]["kernel"], np.float32).reshape(-1)) \
            < 5e-2, k


# -- the slice: a small MS_DSA_NET through the trainer ------------------------------

POOL_GATES = {"FCD_FINALE_POOL": "0", "FCD_FINALE_TRAIN": "0"}


def _small_params(perf_flags):
    p = get_default_params()
    p.update(patch_size=[32, 64, 64], feature_size=4, project_size=16,
             loss="DiceCELoss", perf_flags=dict(perf_flags))
    return p


@pytest.fixture
def spies(monkeypatch):
    """Counts calls of the plain versions behind B2, B3, B9 and B15 (on
    the CPU the wrappers take them instead of launching)."""
    from fcd_tpu_torch.kernels import finale as k2
    from fcd_tpu_torch.kernels import pool as b2

    calls = {}

    def spy(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(b2, "finale_pool_plain", "B2")
    spy(k2, "finale_bwd_plain", "K2")
    spy(pool2x, "max_pool2x_plain", "B3")
    spy(pool2x, "max_pool2x_bwd_plain", "B9")
    spy(fh, "finale_head_plain", "B15")
    return calls


def test_gated_inference_is_bit_equal_and_fused_head_within_rounding(
        clean_env, spies):
    """fs 4, 32x64x64 patches (ROADMAP C4), f32 on the CPU. The pool's
    own pass takes the same values as the fused pool: bit-equal logits.
    The fused head adds the bias before its one rounding, in f32 here:
    rel 1e-5 of max|logit|."""
    vol = np.random.RandomState(14).normal(size=(40, 70, 66, 2)).astype(
        np.float32)
    runs = {}
    for name, pf in (("default", {}), ("pool", POOL_GATES),
                     ("head", {"FCD_FUSED_HEAD": "1"})):
        spies.clear()
        runs[name] = ModelTrainer(_small_params(pf), device="cpu").inference(vol)
        runs[name + " calls"] = dict(spies)
    n = runs["default calls"]["B2"] // 23        # patches
    assert n >= 2
    assert runs["default calls"] == {"B2": 23 * n}
    assert runs["pool calls"] == {"B2": 23 * n, "B3": 2 * n}
    assert runs["head calls"] == {"B2": 22 * n, "B15": n}
    assert torch.equal(runs["pool"], runs["default"])
    assert _rel(runs["head"].numpy(), runs["default"].numpy()) < 1e-5
    agree = (runs["head"].argmax(-1) == runs["default"].argmax(-1)).float()
    assert float(agree.mean()) > 0.999


def test_gated_train_steps_equal_the_default_steps(clean_env, spies):
    """Two train steps, f32 on the CPU: the own-pass pool's forward takes
    the same values and B9 + autograd add the same f32 cotangents as K2
    does inside the finale, so the losses agree to rel 1e-6 (and both
    steps' gradients move the weights alike)."""
    rng = np.random.RandomState(15)
    x = rng.normal(size=(2, 32, 64, 64, 2)).astype(np.float32)
    y = (rng.rand(2, 32, 64, 64, 1) > 0.9).astype(np.float32)
    out = {}
    for name, pf in (("default", {}), ("pool", POOL_GATES)):
        tr = ModelTrainer(_small_params(pf), device="cpu")
        spies.clear()
        losses = [float(tr.train_step(x, y, 1e-3)) for _ in range(2)]
        out[name] = (losses, dict(spies), tr.model.state_dict())
    assert out["default"][1] == {"B2": 46, "K2": 46}
    assert out["pool"][1] == {"B2": 46, "K2": 46, "B3": 4, "B9": 4}
    for a, b in zip(out["pool"][0], out["default"][0]):
        assert abs(a - b) <= 1e-6 * abs(b)
    for k, v in out["default"][2].items():
        assert torch.allclose(out["pool"][2][k], v, rtol=1e-4, atol=1e-6), k
