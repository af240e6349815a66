"""The library-only blocks (ROADMAP A10) and UnetBasicBlock in the port
(CPU) against the JAX package: eval forwards, B5's prologue-free instance,
the weight tables.

- B5's plain versions (phase A, the glue, phase B, the einsum reference)
  in the prologue-free form, for each sa_type, against
  `fcd_tpu.kernels.dsa_attention.dsa_fused` in interpret mode called with
  no ln_scale, pos_embed or res_gamma (f32); a partial mix of the fused
  form's operands is refused, as dsa_fused's assert refuses it.
- Each block's eval forward (`tests/torch_port_a10_cases.py`: every
  `fuse` of DsaUpBlock and AgUpBlock, res_block both ways, the selectors'
  res_block=False arms) against `model.apply` of the JAX block on the same
  variables, loaded through `weights.py`, on the kernel route (the
  kernels' plain versions here) and the plain route, f32: rel-L2 within
  1e-5 (the same f32 function, its sums in another order).
- `export_block_variables` gives back the JAX tree's paths, shapes and
  values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu_torch import weights
from fcd_tpu_torch.kernels import dsa_attention as tdk
from fcd_tpu_torch.ops.layers import use_plain_route

import torch_port_a10_cases as cases
import torch_port_workers

torch_port_workers.share_cores()

SA_TYPES = ["parallel", "serial", "spatial", "channel"]
EVAL_REL = 1e-5     # rel-L2, f32 on both sides
B5_REL = 2e-4       # max abs over max |want|, as the fused form's test


def _inputs(rng, b, n, c, h, p, sa_type):
    ns = tdk.num_slots(sa_type)
    return dict(
        x=rng.randn(b, n, c).astype(np.float32),
        w=(rng.randn(c, ns * c) * 0.3).astype(np.float32),
        ef=(None if sa_type == "channel"
            else (rng.randn(n, p) * 0.3).astype(np.float32)),
        t1=(rng.rand(h) + 0.5).astype(np.float32),
        t2=(rng.rand(h) + 0.5).astype(np.float32),
    )


@pytest.mark.parametrize("sa_type", SA_TYPES)
def test_b5_prologue_free_plain_matches_dsa_fused(sa_type):
    from fcd_tpu.kernels import dsa_attention as jdk

    b, n, c, h, p = 2, 64, 32, 4, 16
    a = _inputs(np.random.RandomState(11), b, n, c, h, p, sa_type)
    ns = tdk.num_slots(sa_type)
    wk = jnp.asarray(a["w"]).reshape(c, ns, c).transpose(1, 0, 2)
    ef = (jnp.zeros((n, 8), jnp.float32) if a["ef"] is None
          else jnp.asarray(a["ef"]))
    want = np.asarray(jdk.dsa_fused(
        jnp.asarray(a["x"]), wk, ef, jnp.asarray(a["t1"]),
        jnp.asarray(a["t2"]), num_heads=h, sa_type=sa_type, interpret=True))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
    none = (None, None, None)
    ref = tdk.dsa_attention(t["x"], t["w"], t["ef"], t["t1"].reshape(h, 1, 1),
                            t["t2"].reshape(h, 1, 1), *none, None, h,
                            sa_type=sa_type).numpy()
    ops = tdk.dsa_phase_a(t["x"], t["w"], t["ef"], *none, h,
                          temperatures=(t["t1"], t["t2"]), sa_type=sa_type)
    composed = tdk.dsa_phase_b(t["x"], t["w"], *ops, None, *none, h,
                               sa_type=sa_type).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(ref, want, atol=B5_REL * scale)
    np.testing.assert_allclose(composed, want, atol=B5_REL * scale)


@pytest.mark.parametrize("given", ["ln_scale", "pos_embed", "no_gamma",
                                   "gamma_only"])
def test_b5_refuses_a_partial_form(given):
    """ln_scale without ln_bias, a pos-embed without the LayerNorm, the
    LayerNorm without gamma, gamma without the LayerNorm: each raises."""
    a = _inputs(np.random.RandomState(2), 1, 32, 16, 4, 16, "parallel")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    c = 16
    lns, lnb, pe = torch.ones(c), torch.zeros(c), torch.zeros(32, c)
    gamma = torch.ones(c)
    tok, g = {"ln_scale": ((lns, None, None), gamma),
              "pos_embed": ((None, None, pe), None),
              "no_gamma": ((lns, lnb, pe), None),
              "gamma_only": ((None, None, None), gamma)}[given]
    temps = (t["t1"], t["t2"])
    with pytest.raises(ValueError):
        tdk.dsa_attention(t["x"], t["w"], t["ef"], *temps, *tok, g, 4)
    with pytest.raises(ValueError):
        ops = tdk.dsa_phase_a(t["x"], t["w"], t["ef"], None, None, None, 4,
                              temperatures=temps)
        tdk.dsa_phase_b(t["x"], t["w"], *ops, g, *tok, 4)


@pytest.mark.parametrize("name", cases.NAMES)
def test_block_eval_matches_jax(name):
    case = cases.make(name)
    apply = jax.jit(lambda vv, *xs: case.fm.apply(vv, *xs, train=False))
    want = np.asarray(apply(case.v, *[jnp.asarray(a) for a in case.inputs]))
    tensors = [torch.from_numpy(a) for a in case.inputs]
    tm = case.tm.eval()
    with torch.no_grad():
        got = case.call(tm, tensors).numpy()
        assert cases.rel_l2(got, want) < EVAL_REL, "kernel route"
        plain = case.call(use_plain_route(tm), tensors).numpy()
    assert cases.rel_l2(plain, want) < EVAL_REL, "plain route"


@pytest.mark.parametrize("name", cases.NAMES)
def test_block_variables_round_trip(name):
    """export_block_variables: the JAX tree's paths and shapes, and the
    values loaded."""
    case = cases.make(name)
    want = case.v if case.sub is None else {
        coll: tree[case.sub] for coll, tree in case.v.items()
        if case.sub in tree}
    got = cases.leaves(weights.export_block_variables(case.tm))
    ref = cases.leaves(want)
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        assert got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf.astype(np.float32))


def test_unetr_basic_block_selects_its_arm():
    assert isinstance(cases.tblocks.unetr_basic_block(8, 8),
                      cases.tblocks.UnetrBasicBlock)
    assert isinstance(cases.tblocks.unetr_basic_block(8, 8, res_block=False),
                      cases.tblocks.UnetBasicBlock)
