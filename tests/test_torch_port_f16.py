"""C20: a model that computes in float16 (CPU) against the JAX package at
compute_dtype='float16' (use_amp=True).

At f16 the JAX package takes the same branches as at f32: every Pallas
gate of its blocks, its `Conv3d` and its volume entry needs bf16, while
B5 (`dsa_fused`) and B10 (the spatial-attention tail) are dtype-generic
and round at f16 where they round at bf16. Its trainer casts the volume
to bf16 whenever use_amp (`fcd_tpu/train/trainer.py:282-284`), so the
f16 model is fed bf16-rounded patches. Here, on the CPU:

- `compute_dtype_for` gives f16 on a `torch.device("cuda")` (read, never
  touched), `entry_dtype_for` bf16, and the trainer's `numerics` scope
  turns cuBLAS's f16 reduction off for its block only;
- the route at f16 against the JAX package's own gates (the s2d block
  gate and the Pallas volume entry, evaluated as on a TPU; the DSA
  kernels' shape gates, which read no dtype);
- B5's plain versions on f16 tokens against `dsa_fused` at f16 in
  interpret mode, rel 2e-3 (f16 rounding points on both sides, other
  summation orders; measured 0 and 3.34e-4);
- K3/K4's plain versions on f16 operands against the Pallas kernels at
  f16 in interpret mode, rate 0 (C2), rel 2e-3 (measured at most
  2.10e-4);
- the sliding window of an f16 MS_DSA_NET (fs 4, patch 64) fed through
  the entry `entry_dtype_for` gives, against fcd_tpu's
  `ModelTrainer.inference` at compute_dtype='float16', rel 5e-3
  (measured 2.24e-3); the same window with an f16 entry (the engine
  before C20's repair) lands 9.94e-3 from it. Patch 64, not 32: at 32
  level 6 is one token whose features are 0, and the JAX package's f16
  l2 normalisation (eps 1e-12, which f16 flushes to 0) gives NaN there,
  where the port normalises in f32 (ROADMAP C21).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.kernels import dsa_attention as jdk
from fcd_tpu.kernels import spatial_attn as jsa
from fcd_tpu.train.trainer import ModelTrainer as JaxTrainer
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.infer.sliding_window import sliding_window_inference
from fcd_tpu_torch.kernels import dsa_attention as tdk
from fcd_tpu_torch.kernels import spatial_attn as tsa
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.ops.layers import takes_plain_route
from fcd_tpu_torch.train.trainer import (
    ModelTrainer,
    compute_dtype_for,
    entry_dtype_for,
)

import torch_port_workers

torch_port_workers.share_cores()

F16 = torch.float16
CUDA = torch.device("cuda")
B5_REL = 2e-3       # measured 0 and 3.34e-4
SPATTN_REL = 2e-3   # measured at most 2.10e-4
ENGINE_REL = 5e-3   # measured 2.24e-3; the f16 entry 9.94e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _params(**kw):
    params = get_default_params()
    params.update(feature_size=4, project_size=16, patch_size=32,
                  compute_dtype="float16")
    params.update(kw)
    return params


def test_compute_and_entry_dtypes_at_f16():
    """f16 computes in f16 on the card and enters the window in bf16; the
    CPU computes and enters in f32; use_amp=False is f32 throughout."""
    params = _params()
    assert compute_dtype_for(params, CUDA) == F16
    assert entry_dtype_for(params, CUDA) == torch.bfloat16
    assert compute_dtype_for(params, torch.device("cpu")) == torch.float32
    assert entry_dtype_for(params, torch.device("cpu")) == torch.float32
    off = _params(use_amp=False)
    assert compute_dtype_for(off, CUDA) == entry_dtype_for(off, CUDA) \
        == torch.float32
    tr = ModelTrainer(params, device="cpu", verbose=False)
    assert tr.entry_dtype == torch.float32 and tr._numerics == {}


def test_numerics_scope_at_f16_restores_the_reduction_flag():
    """On the card at f16 `numerics` turns cuBLAS's f16 reduction off for
    its block (also when it raises) and gives the caller's setting back;
    the card's case is taken by handing a CPU trainer the f16 table."""
    from fcd_tpu_torch.train import trainer as tt

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_fp16_reduced_precision_reduction
    tr = ModelTrainer(_params(), device="cpu", verbose=False)
    try:
        matmul.allow_fp16_reduced_precision_reduction = True
        tr._numerics = tt._CARD_NUMERICS[F16]
        with pytest.raises(RuntimeError, match="inside"):
            with tr.numerics():
                assert not matmul.allow_fp16_reduced_precision_reduction
                raise RuntimeError("inside")
        assert matmul.allow_fp16_reduced_precision_reduction
    finally:
        matmul.allow_fp16_reduced_precision_reduction = saved


def test_route_at_f16_follows_the_jax_gates(monkeypatch):
    """With the backend read as a TPU, the JAX package's s2d block gate and
    its Pallas volume entry take bf16 and refuse f16; the port's route
    decision is the same (plain at f16, kernels at bf16), and the DSA
    kernels' gates, which the JAX package applies at any dtype, take the
    default model's four levels."""
    import fcd_tpu.infer.sliding_window as jsw
    import fcd_tpu.kernels.s2d_entry as jentry
    from fcd_tpu.ops.blocks import _s2d_block_eligible

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    gate = {dt: _s2d_block_eligible((32, 32, 32), 16, 16, 3, 1, "instance",
                                    "leakyrelu", dt)
            for dt in (jnp.bfloat16, jnp.float16)}
    assert gate == {jnp.bfloat16: True, jnp.float16: False}
    entered = []
    monkeypatch.setattr(jentry, "s2d_entry",
                        lambda v, out_dtype: entered.append(out_dtype) or v)
    monkeypatch.setattr(jentry, "s2d_entry_supported", lambda *a: True)
    monkeypatch.setattr(jsw._fcd_flags, "get",
                        lambda k, *d: "1" if k == "FCD_ENTRY_KERNEL" else
                        (d[0] if d else None))
    vol = jnp.zeros((32, 32, 32, 2), jnp.float32)
    for dt in (jnp.bfloat16, jnp.float16):
        jsw._entry_s2d.__wrapped__(vol, compute_dtype=dt)
    assert entered == [jnp.bfloat16]
    assert takes_plain_route(F16) and takes_plain_route(torch.float32)
    assert not takes_plain_route(torch.bfloat16)
    model = get_model(_params(), compute_dtype=F16)[0]
    assert model.plain_route and all(
        getattr(m, "plain_route", True) for m in model.modules())
    for n, c, p in ((32768, 32, 64), (4096, 64, 64), (512, 128, 64),
                    (64, 256, 32)):
        assert jdk.dsa_fused_supported(n, c, p, 4)
        assert jsa.spatial_attn_supported(n, c, 4 * p)


@pytest.mark.parametrize("sa_type", ["parallel", "serial"])
def test_b5_plain_at_f16_matches_dsa_fused(sa_type):
    """B5's plain phases on f16 tokens (f32 weights, rounded to f16 where
    the kernels round them) against dsa_fused at f16 in interpret mode,
    which takes the weights and EF cast to f16 as the JAX block casts
    them."""
    b, n, c, h, p = 1, 100, 32, 4, 16
    rng = np.random.RandomState(2)
    ns = tdk.num_slots(sa_type)
    a = dict(x=rng.randn(b, n, c), w=rng.randn(c, ns * c) * 0.3,
             ef=rng.randn(n, p) * 0.3, t1=rng.rand(h) + 0.5,
             t2=rng.rand(h) + 0.5, lns=1 + 0.1 * rng.randn(c),
             lnb=0.1 * rng.randn(c), pe=0.3 * rng.randn(n, c),
             gamma=rng.randn(c))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    f16 = jnp.float16
    want = np.asarray(jdk.dsa_fused(
        jnp.asarray(a["x"]).astype(f16),
        jnp.asarray(a["w"]).reshape(c, ns, c).transpose(1, 0, 2).astype(f16),
        jnp.asarray(a["ef"]).astype(f16), jnp.asarray(a["t1"]),
        jnp.asarray(a["t2"]), num_heads=h, sa_type=sa_type,
        ln_scale=jnp.asarray(a["lns"]), ln_bias=jnp.asarray(a["lnb"]),
        pos_embed=jnp.asarray(a["pe"]), res_gamma=jnp.asarray(a["gamma"]),
        interpret=True)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    x = t["x"].to(F16)
    tok = (t["lns"], t["lnb"], t["pe"])
    ops = tdk.dsa_phase_a(x, t["w"], t["ef"].to(F16), *tok, h,
                          temperatures=(t["t1"], t["t2"]), sa_type=sa_type)
    assert [o.dtype for o in ops] == [torch.float32, F16, F16, F16]
    got = tdk.dsa_phase_b(x, t["w"], *ops, t["gamma"], *tok, h,
                          sa_type=sa_type)
    assert got.dtype == F16 and _rel(got.float().numpy(), want) < B5_REL


@pytest.mark.parametrize("n,c,p", [(200, 32, 64), (64, 256, 32)])
def test_spatial_attn_plain_at_f16_matches_pallas(n, c, p):
    """K3/K4's plain versions on f16 operands against the Pallas kernels
    in interpret mode on f16 operands, rate 0."""
    h = 4
    rng = np.random.RandomState(1)
    qn = (rng.randn(2, n, c) / np.sqrt(c)).astype(np.float16)
    kpb = (rng.randn(2, c, h * p) * 2.0).astype(np.float16)
    vpb = rng.randn(2, h * p, c).astype(np.float16)
    g = rng.randn(2, n, c).astype(np.float16)
    seed = jnp.zeros((1,), jnp.int32)
    args = [jnp.asarray(a) for a in (qn, kpb, vpb)]
    out_j = jsa.spatial_attn_fwd_pallas(*args, seed, h, 0.0, interpret=True)
    grads_j = jsa.spatial_attn_bwd_pallas(*args, seed, jnp.asarray(g), h, 0.0,
                                          interpret=True)
    t_args = [torch.from_numpy(a) for a in (qn, kpb, vpb)]
    out = tsa.spatial_attn_fwd_plain(*t_args, h, 0, 0.0)
    grads = tsa.spatial_attn_bwd_plain(*t_args, torch.from_numpy(g), h, 0,
                                       0.0)
    assert out.dtype == grads[0].dtype == F16
    for mine, theirs in zip((out,) + tuple(grads), (out_j,) + tuple(grads_j)):
        want = np.asarray(theirs).astype(np.float32)
        assert _rel(mine.float().numpy(), want) < SPATTN_REL


def test_f16_window_enters_in_bf16_as_the_jax_trainer():
    """fcd_tpu's ModelTrainer.inference at compute_dtype='float16' (bf16
    entry, f16 model, patch 64) against the port's window over the same
    f16 MS_DSA_NET, entered at `entry_dtype_for` on the card: within
    ENGINE_REL; an f16 entry lands over twice as far."""
    jp = jax_default_params()
    jp.update(feature_size=4, project_size=16, patch_size=64,
              compute_dtype="float16")
    jt = JaxTrainer(jp, verbose=False)
    vol = np.random.RandomState(7).normal(size=(64, 72, 64, 2)).astype(
        np.float32)
    want = np.asarray(jt.inference(vol)).astype(np.float32)
    assert np.isfinite(want).all()
    tp = _params(patch_size=64)
    tm = get_model(tp, compute_dtype=F16)[0].eval()
    tm.compute_dtype = F16
    weights.load_flax_variables(
        tm, jax.tree_util.tree_map(np.asarray, jt.variables))

    def window(entry):
        with torch.no_grad():
            return sliding_window_inference(
                vol, tm, roi_size=(64, 64, 64), out_channels=2, sw_batch=2,
                overlap=0.25, compute_dtype=entry, device="cpu").numpy()

    got = window(entry_dtype_for(tp, CUDA))
    assert got.shape == want.shape
    near = _rel(got, want)
    far = _rel(window(F16), want)
    assert near < ENGINE_REL and far > 2 * near, (near, far)
