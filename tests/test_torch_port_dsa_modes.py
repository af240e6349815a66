"""The DSA's four sa_types in the port (CPU) against the JAX package.

- B5's plain versions (phase A, the glue, phase B, and the einsum
  reference) in 'parallel', 'serial', 'spatial' and 'channel' against
  `fcd_tpu.kernels.dsa_attention.dsa_fused` in interpret mode, f32, with
  the fused pos-embed, LayerNorm and residual; 'channel' has no EF (JAX
  feeds a zero (N, 8) one) and the port's plan and phases take P = 0.
- The transformer block in each type, eval (B5's plain path) and train
  (`dsa_train` around K3/K4's plain versions): outputs, and the gradients
  of every parameter and of the input against jax.grad, dropout 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fcd_tpu.ops.attention as jattention
from fcd_tpu.ops.attention import TransformerBlock as FlaxTransformerBlock
from fcd_tpu_torch import weights
from fcd_tpu_torch.kernels import dsa_attention as tdk
from fcd_tpu_torch.ops.attention import TransformerBlock
from tests.test_torch_parity import randomize_batch_stats, randomize_params

import torch_port_workers

torch_port_workers.share_cores()

SA_TYPES = ["parallel", "serial", "spatial", "channel"]


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(rng, b, n, c, h, p, sa_type):
    ns = tdk.num_slots(sa_type)
    return dict(
        x=rng.randn(b, n, c).astype(np.float32),
        w=(rng.randn(c, ns * c) * 0.3).astype(np.float32),
        ef=(None if sa_type == "channel"
            else (rng.randn(n, p) * 0.3).astype(np.float32)),
        t1=(rng.rand(h) + 0.5).astype(np.float32),
        t2=(rng.rand(h) + 0.5).astype(np.float32),
        lns=(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
        lnb=(0.1 * rng.randn(c)).astype(np.float32),
        pe=(0.3 * rng.randn(n, c)).astype(np.float32),
        gamma=rng.randn(c).astype(np.float32),
    )


@pytest.mark.parametrize("sa_type", SA_TYPES)
@pytest.mark.parametrize("b,n,c,h,p", [(2, 64, 32, 4, 16),
                                       (1, 100, 64, 4, 64)])
def test_b5_plain_matches_dsa_fused(sa_type, b, n, c, h, p):
    from fcd_tpu.kernels import dsa_attention as jdk

    a = _inputs(np.random.RandomState(7), b, n, c, h, p, sa_type)
    ns = tdk.num_slots(sa_type)
    wk = jnp.asarray(a["w"]).reshape(c, ns, c).transpose(1, 0, 2)
    ef = (jnp.zeros((n, 8), jnp.float32) if a["ef"] is None
          else jnp.asarray(a["ef"]))
    want = np.asarray(jdk.dsa_fused(
        jnp.asarray(a["x"]), wk, ef, jnp.asarray(a["t1"]),
        jnp.asarray(a["t2"]), num_heads=h, sa_type=sa_type,
        ln_scale=jnp.asarray(a["lns"]), ln_bias=jnp.asarray(a["lnb"]),
        pos_embed=jnp.asarray(a["pe"]), res_gamma=jnp.asarray(a["gamma"]),
        interpret=True))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    tok = (t["lns"], t["lnb"], t["pe"])
    ref = tdk.dsa_attention(t["x"], t["w"], t["ef"], t["t1"].reshape(h, 1, 1),
                            t["t2"].reshape(h, 1, 1), *tok, t["gamma"], h,
                            sa_type=sa_type).numpy()
    pa = tdk.dsa_phase_a(t["x"], t["w"], t["ef"], *tok, h, sa_type=sa_type)
    pp = 0 if sa_type == "channel" else p
    assert pa.kp.shape == pa.vp.shape == (b, c, pp)
    glue = tdk.dsa_glue(pa, t["t1"], t["t2"], h, torch.float32)
    finished = tdk.dsa_phase_a(t["x"], t["w"], t["ef"], *tok, h,
                               temperatures=(t["t1"], t["t2"]),
                               sa_type=sa_type)
    for got_, want_ in zip(finished, glue):
        assert torch.equal(got_, want_)
    composed = tdk.dsa_phase_b(t["x"], t["w"], *glue, t["gamma"], *tok, h,
                               sa_type=sa_type).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(ref, want, atol=2e-4 * scale)
    np.testing.assert_allclose(composed, want, atol=2e-4 * scale)


def test_b5_modes_refuse_a_mismatched_ef():
    """'channel' takes no EF, the other types need one; a (C, 4C) matrix
    is refused for a three-slot type."""
    a = _inputs(np.random.RandomState(1), 1, 32, 16, 4, 16, "spatial")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tok = (t["lns"], t["lnb"], t["pe"])
    with pytest.raises(ValueError):
        tdk.dsa_phase_a(t["x"], t["w"], t["ef"], *tok, 4, sa_type="channel")
    with pytest.raises(ValueError):
        tdk.dsa_phase_a(t["x"], t["w"], None, *tok, 4, sa_type="spatial")
    with pytest.raises(ValueError):
        tdk.dsa_phase_a(t["x"], t["w"], t["ef"], *tok, 4, sa_type="parallel")


def _flax_block(sa_type, n, c, p, h, x, rng):
    fm = FlaxTransformerBlock(input_size=n, hidden_size=c, proj_size=p,
                              num_heads=h, sa_type=sa_type, pos_embed=True,
                              dropout_rate=0.0)
    shapes = jax.eval_shape(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x)))
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    v = _numpy_tree(randomize_batch_stats(randomize_params(v, rng), rng))
    # gamma large enough that the attention moves the output
    v["params"]["gamma"] = (rng.normal(size=(c,)) * 0.5).astype(np.float32)
    tm = TransformerBlock(n, c, p, h, sa_type=sa_type)
    weights.load_transformer_block(tm, v["params"], v["batch_stats"])
    return fm, v, tm


@pytest.mark.parametrize("sa_type", SA_TYPES)
def test_transformer_block_eval_matches_jax(sa_type):
    s, c, p, h = 4, 32, 16, 4
    rng = np.random.RandomState(8)
    x = rng.normal(size=(2, s, s, s, c)).astype(np.float32)
    fm, v, tm = _flax_block(sa_type, s ** 3, c, p, h, x, rng)
    assert (tm.dsa.EF is None) == (sa_type == "channel")
    want = np.asarray(jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("sa_type", SA_TYPES)
def test_dsa_train_matches_jax_grads(monkeypatch, sa_type):
    """dsa_train (the train DSA around K3/K4's plain versions; 'serial'
    carries the spatial output through the channel matrix) and the rest of
    the block in train mode: the loss, the input's and every parameter's
    gradient against jax.grad, dropout 0."""
    monkeypatch.setattr(
        jattention, "ChannelDropout3d",
        lambda rate: (lambda x, train=False, s2d_channels=None: x))
    s, c, p, h = 4, 32, 16, 4
    rng = np.random.RandomState(9)
    x = rng.normal(size=(2, s, s, s, c)).astype(np.float32)
    cot = rng.normal(size=(2, s, s, s, c)).astype(np.float32)
    fm, v, tm = _flax_block(sa_type, s ** 3, c, p, h, x, rng)

    def f(params, xx):
        out, _ = fm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xx, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
        return jnp.sum(out * cot)

    val, (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        v["params"], jnp.asarray(x))
    tm.train()
    tm.dropout.rate = 0.0
    xt = torch.tensor(x, requires_grad=True)
    loss = (tm(xt) * torch.tensor(cot)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(val)) <= 1e-4 * abs(float(val))
    assert _rel_l2(xt.grad.numpy(), gx) < 1e-4
    got = weights.export_block_grads(tm)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            _numpy_tree(gp))[0]:
        node = got
        for k in path:
            node = node.get(k.key) if node is not None else None
        if node is None:   # a parameter the type does not read
            assert not np.any(leaf), jax.tree_util.keystr(path)
            continue
        assert _rel_l2(node, leaf) < 1e-4, jax.tree_util.keystr(path)
