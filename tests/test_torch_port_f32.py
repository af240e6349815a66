"""C18: the f32 route of the port (CPU) against the JAX package at dtype
None (use_amp=False).

A model built to compute in f32 on the card (`get_model(...,
compute_dtype=torch.float32)`, as ModelTrainer builds it there) takes the
JAX package's f32 route: the blocks' plain branch with library convs,
the `jnp.maximum` pool chain, `lax.conv_transpose` upsampling, a padded
volume entry, and only B5 and K3/K4 (the DSA kernels, dtype-generic in
the JAX package) as kernels, in f32. Here, on the CPU:

- MS_DSA_NET's forward at fs 4 on 32x64x64 (C4: level 6 is 1x2x2)
  against the JAX forward, rel 1e-4, with every bf16-only kernel's entry
  patched to raise (the route calls none of them);
- (one MS_DSA_NET train step of the f32 route against jax.grad is in
  test_torch_port_train.py, beside the slice test, whose JAX step it
  shares: one XLA compile for both);
- the other ported models' forwards at fs 4 on a 32^3 patch, rel 1e-4;
- B5's plain versions and K3/K4's plain versions on f32 operands against
  `dsa_fused` and the spatial-attention Pallas kernels in interpret mode
  given f32 operands (rate 0), rel 1e-5;
- `compute_dtype_for` on a `torch.device("cuda")`, which needs no card:
  f32 is taken (and, since C20, float16); a CPU trainer keeps the
  kernels' plain versions (no f32 route), and a sliding-window inference
  in f32 enters with a pad, not B17; the trainer's `numerics` scope
  gives the TF32 flags back.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.kernels import dsa_attention as jdk
from fcd_tpu.kernels import spatial_attn as jsa
from fcd_tpu.models.factory import get_model as jax_get_model
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.kernels import dsa_attention as tdk
from fcd_tpu_torch.kernels import spatial_attn as tsa
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.train.trainer import ModelTrainer, compute_dtype_for
from tests.test_torch_parity import randomize_batch_stats, randomize_params

import torch_port_workers

torch_port_workers.share_cores()

F32 = torch.float32
IMG = (32, 64, 64)   # C4: level 6 is 1x2x2


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


@pytest.fixture
def no_kernel_route(monkeypatch):
    """Every entry of the bf16-only kernels (B1, B2, B3, B4, B15, B17 and
    the fast conv) raises: the f32 route must call none of them."""
    import fcd_tpu_torch.infer.sliding_window as sw
    import fcd_tpu_torch.kernels.block_conv as bc
    import fcd_tpu_torch.kernels.upsample as up
    import fcd_tpu_torch.models.segresnet as sr
    import fcd_tpu_torch.ops.blocks as blocks

    def refuse(*args, **kwargs):
        raise AssertionError("the f32 route called a bf16-only kernel")

    for mod, name in ((blocks, "conv3x3_op"), (blocks, "finale"),
                      (blocks, "finale_head"), (blocks, "max_pool2x_op"),
                      (blocks, "upsample2x_op"), (bc, "conv3x3_op"),
                      (up, "upsample2x_op"), (sr, "conv3x3_op"),
                      (sw, "sw_entry")):
        monkeypatch.setattr(mod, name, refuse)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_variables(init_fn, rng):
    shapes = jax.eval_shape(init_fn)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return _numpy_tree(randomize_batch_stats(randomize_params(v, rng), rng))


def _params(model_type, img, **kw):
    """The same settings for both factories: fs 4, P 16, use_amp False."""
    out = []
    for p in (jax_default_params(), get_default_params()):
        p.update(model_type=model_type, feature_size=4, project_size=16,
                 patch_size=img, chans_in=2, chans_out=2, use_amp=False)
        p.update(kw)
        out.append(p)
    return out


def _forward_pair(model_type, img, seed, **kw):
    """(JAX logits, the f32 route's logits) of one random patch with the
    same random weights."""
    jp, tp = _params(model_type, img, **kw)
    fm, _ = jax_get_model(jp)
    x0 = jnp.zeros((1,) + tuple(img) + (2,))
    rng = np.random.RandomState(seed)
    v = _random_variables(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x0, train=False), rng)
    tm, _ = get_model(tp, compute_dtype=F32)
    assert any(getattr(m, "plain_route", False) for m in tm.modules())
    tm.eval()
    weights.load_flax_variables(tm, v)
    x = rng.normal(size=(1,) + tuple(img) + (2,)).astype(np.float32)
    out = jax.jit(lambda vv, xx: fm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    vae = jp["model_returns_vaeloss"]
    want = np.asarray(out[0] if vae else out)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return want, (got[0] if vae else got).numpy()


def test_ms_dsa_net_f32_route_forward_matches_jax(no_kernel_route):
    want, got = _forward_pair("MS_DSA_NET", IMG, 3)
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("model_type,kw", [
    ("MS_DSA_NET_PS", {"sa_type": "serial"}),
    ("BaseUNet", {}),
    ("SegResNet_DSA", {"segresnet_upsample_mode": "deconv"}),
    ("SegResNetVAE", {})])
def test_other_models_f32_route_forward_matches_jax(no_kernel_route,
                                                     model_type, kw):
    want, got = _forward_pair(model_type, (32, 32, 32), 5, **kw)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("sa_type", ["parallel", "serial"])
def test_b5_plain_at_f32_matches_dsa_fused(sa_type):
    """B5's plain phases (the f32 instances' function) on f32 tokens,
    weights and EF against dsa_fused in interpret mode, all f32."""
    b, n, c, h, p = 1, 100, 32, 4, 16
    rng = np.random.RandomState(2)
    ns = tdk.num_slots(sa_type)
    a = dict(x=rng.randn(b, n, c), w=rng.randn(c, ns * c) * 0.3,
             ef=rng.randn(n, p) * 0.3, t1=rng.rand(h) + 0.5,
             t2=rng.rand(h) + 0.5, lns=1 + 0.1 * rng.randn(c),
             lnb=0.1 * rng.randn(c), pe=0.3 * rng.randn(n, c),
             gamma=rng.randn(c))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    want = np.asarray(jdk.dsa_fused(
        jnp.asarray(a["x"]),
        jnp.asarray(a["w"]).reshape(c, ns, c).transpose(1, 0, 2),
        jnp.asarray(a["ef"]), jnp.asarray(a["t1"]), jnp.asarray(a["t2"]),
        num_heads=h, sa_type=sa_type, ln_scale=jnp.asarray(a["lns"]),
        ln_bias=jnp.asarray(a["lnb"]), pos_embed=jnp.asarray(a["pe"]),
        res_gamma=jnp.asarray(a["gamma"]), interpret=True))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tok = (t["lns"], t["lnb"], t["pe"])
    ops = tdk.dsa_phase_a(t["x"], t["w"], t["ef"], *tok, h,
                          temperatures=(t["t1"], t["t2"]), sa_type=sa_type)
    assert all(o.dtype == F32 for o in ops)
    got = tdk.dsa_phase_b(t["x"], t["w"], *ops, t["gamma"], *tok, h,
                          sa_type=sa_type)
    assert got.dtype == F32 and _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("n,c,p", [(200, 32, 64), (64, 256, 32)])
def test_spatial_attn_plain_at_f32_matches_pallas(n, c, p):
    """K3/K4's plain versions on f32 operands against the Pallas kernels
    in interpret mode on f32 operands, rate 0."""
    h = 4
    rng = np.random.RandomState(1)
    qn = rng.randn(2, n, c).astype(np.float32)
    kpb = (rng.randn(2, c, h * p) * 0.3 * (32 / c) ** 0.5).astype(np.float32)
    vpb = rng.randn(2, h * p, c).astype(np.float32)
    g = rng.randn(2, n, c).astype(np.float32)
    seed = jnp.zeros((1,), jnp.int32)
    args = [jnp.asarray(a) for a in (qn, kpb, vpb)]
    out_j = jsa.spatial_attn_fwd_pallas(*args, seed, h, 0.0, interpret=True)
    grads_j = jsa.spatial_attn_bwd_pallas(*args, seed, jnp.asarray(g), h, 0.0,
                                          interpret=True)
    t_args = [torch.from_numpy(a) for a in (qn, kpb, vpb)]
    out = tsa.spatial_attn_fwd_plain(*t_args, h, 0, 0.0)
    grads = tsa.spatial_attn_bwd_plain(*t_args, torch.from_numpy(g), h, 0,
                                       0.0)
    for mine, theirs in zip((out,) + tuple(grads), (out_j,) + tuple(grads_j)):
        assert mine.dtype == F32
        assert _rel(mine.numpy(), np.asarray(theirs)) < 1e-5


@pytest.mark.parametrize("setting,want", [
    ({"use_amp": False}, F32),
    ({"compute_dtype": "float32"}, F32),
    ({"use_amp": False, "compute_dtype": "float16"}, F32),
    ({}, torch.bfloat16),
    # the case keeps the id it was collected under
    pytest.param({"compute_dtype": "float16"}, torch.float16,
                 id="setting4-None")])
def test_compute_dtype_for_the_card(setting, want):
    """A torch.device("cuda") is only read here, never touched. float16 is
    taken since C20 (tests/test_torch_port_f16.py)."""
    params = get_default_params()
    params.update(setting)
    assert compute_dtype_for(params, torch.device("cuda")) == want


def test_cpu_trainer_keeps_the_kernel_route_and_pads_its_entry(monkeypatch):
    """On the CPU the trainer builds the kernel route (its plain versions),
    and its f32 inference enters the volume with a pad, not B17."""
    import fcd_tpu_torch.infer.sliding_window as sw

    params = get_default_params()
    params.update(feature_size=4, project_size=16, patch_size=32,
                  use_amp=False)
    tr = ModelTrainer(params, device="cpu", verbose=False)
    assert not any(getattr(m, "plain_route", False) for m in tr.model.modules())
    assert get_model(dict(params), compute_dtype=F32)[0].plain_route

    def refuse(*args, **kwargs):
        raise AssertionError("B17 at f32")

    monkeypatch.setattr(sw, "sw_entry", refuse)
    vol = np.random.RandomState(0).normal(size=(30, 31, 32, 2))
    out = tr.inference(vol.astype(np.float32))   # one padded patch
    assert out.shape == (30, 31, 32, 2) and out.dtype == F32


def test_ieee_f32_scope_restores_the_tf32_flags():
    """`ModelTrainer.numerics` turns TF32 off for its block only where the
    trainer computes in f32 on the card, and gives the caller's flags back
    (also when the block raises); elsewhere it leaves them alone. The
    card's case is taken here by handing the trainer the f32 table."""
    from fcd_tpu_torch.train import trainer as tt

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    params = get_default_params()
    params.update(feature_size=4, project_size=16, patch_size=32,
                  use_amp=False)
    tr = ModelTrainer(params, device="cpu", verbose=False)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with tr.numerics():
            assert cudnn.allow_tf32 and matmul.allow_tf32
        tr._numerics = tt._CARD_NUMERICS[F32]
        with pytest.raises(RuntimeError, match="inside"):
            with tr.numerics():
                assert not (cudnn.allow_tf32 or matmul.allow_tf32)
                raise RuntimeError("inside")
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
