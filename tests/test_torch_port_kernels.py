"""The port's kernel modules (plain versions, CPU) against the JAX kernels.

Each test feeds the same numpy inputs (np.random.RandomState) to the JAX
Pallas kernel, run in interpret mode on the CPU as the JAX package's own
tests run it, and to the port's wrapper on CPU tensors, which takes the
plain PyTorch version. The JAX kernels compute in bf16 with f32
accumulation, the port's plain versions in f32 on the same (bf16-valued
where stated) inputs, so the tolerances are the JAX tests' own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fcd_tpu.ops.s2d_ops import from_s2d, to_s2d
from fcd_tpu_torch.kernels.dsa_attention import (
    dsa_attention,
    dsa_glue,
    dsa_phase_a,
    dsa_phase_b,
)
from fcd_tpu_torch.kernels.pool import finale_pool
from fcd_tpu_torch.kernels.upsample import upsample2x
from fcd_tpu_torch.ops.blocks import UnetResBlock

torch.set_grad_enabled(False)


def _bf16_values(a):
    """numpy f32 array rounded to bf16 values (kept f32)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _port_resblock(cin, oc, w1, w2, wres):
    blk = UnetResBlock(cin, oc, "instance").eval()
    blk.conv1.copy_(torch.from_numpy(np.asarray(w1)))
    blk.conv2.copy_(torch.from_numpy(np.asarray(w2)))
    if blk.conv3 is not None:
        blk.conv3.copy_(torch.from_numpy(np.asarray(wres)))
    return blk


@pytest.mark.parametrize(
    "shape,cin", [((8, 8, 8), 16), ((8, 16, 24), 16), ((8, 8, 8), 2)])
def test_resblock_b1_b2_matches_fused_resblock_eval(monkeypatch, shape, cin):
    """B1 (conv1 + shortcut + stats, conv2 with the norm1/act prologue) and
    B2 (finale) composed by the port's UnetResBlock == the JAX fused eval
    resblock (8-tap kernel pair, interpret mode), at the shapes and the
    0.05 * max|ref| tolerance of tests/test_s2d_blocks.py."""
    from fcd_tpu.ops.s2d_ops import fused_resblock_eval

    monkeypatch.setenv("FCD_CONV8", "1")
    rng = np.random.RandomState(11)
    oc = 16
    d, h, w = shape
    x = rng.rand(1, d, h, w, cin).astype(np.float32) - 0.5
    w1 = rng.rand(3, 3, 3, cin, oc).astype(np.float32) * 0.4 - 0.2
    w2 = rng.rand(3, 3, 3, oc, oc).astype(np.float32) * 0.4 - 0.2
    wres = (rng.rand(cin, oc).astype(np.float32) * 0.4 - 0.2
            if cin != oc else None)
    want = np.asarray(from_s2d(fused_resblock_eval(
        [(to_s2d(jnp.asarray(x)), cin)], jnp.asarray(w1), jnp.asarray(w2),
        None if wres is None else jnp.asarray(wres), oc, 0.01,
        out_dtype=jnp.float32), oc))
    got = _port_resblock(cin, oc, w1, w2, wres)([torch.from_numpy(x)]).numpy()
    np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max())


def test_resblock_two_parts_matches_fused_resblock_eval(monkeypatch):
    """The decoder form: two input parts summed inside B1 (no concat)."""
    from fcd_tpu.ops.s2d_ops import fused_resblock_eval

    monkeypatch.setenv("FCD_CONV8", "1")
    rng = np.random.RandomState(12)
    oc = 16
    a = rng.rand(1, 8, 8, 8, 16).astype(np.float32) - 0.5
    b = rng.rand(1, 8, 8, 8, 16).astype(np.float32) - 0.5
    w1 = rng.rand(3, 3, 3, 32, oc).astype(np.float32) * 0.4 - 0.2
    w2 = rng.rand(3, 3, 3, oc, oc).astype(np.float32) * 0.4 - 0.2
    wres = rng.rand(32, oc).astype(np.float32) * 0.4 - 0.2
    want = np.asarray(from_s2d(fused_resblock_eval(
        [(to_s2d(jnp.asarray(a)), 16), (to_s2d(jnp.asarray(b)), 16)],
        jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(wres), oc, 0.01,
        out_dtype=jnp.float32), oc))
    blk = _port_resblock(32, oc, w1, w2, wres)
    got = blk([torch.from_numpy(a), torch.from_numpy(b)]).numpy()
    np.testing.assert_allclose(got, want, atol=0.05 * np.abs(want).max())


def test_finale_pool_matches_fused_finale_pool():
    """B2's output and its pool of the bf16-ROUNDED output == the JAX
    fused_finale_pool kernel (interpret mode) on the same bf16 inputs."""
    from fcd_tpu.kernels.pool import fused_finale_pool

    rng = np.random.RandomState(5)
    b, d, h, w, c = 2, 8, 6, 4, 16
    y2 = _bf16_values(rng.randn(b, d, h, w, c))
    r = _bf16_values(rng.randn(b, d, h, w, c))
    s2, b2, sr, br = (rng.randn(b, c).astype(np.float32) for _ in range(4))

    def tile8(a):
        return jnp.tile(jnp.asarray(a), (1, 8))

    outp, pooled = fused_finale_pool(
        to_s2d(jnp.asarray(y2, jnp.bfloat16)),
        to_s2d(jnp.asarray(r, jnp.bfloat16)),
        tile8(s2), tile8(b2), tile8(sr), tile8(br), c, 0.01, interpret=True)
    want_out = np.asarray(from_s2d(outp[:, 1:-1], c).astype(jnp.float32))
    want_pool = np.asarray(pooled.astype(jnp.float32))

    def t(a):
        return torch.from_numpy(a)

    out, pool = finale_pool(t(y2).bfloat16(), t(r).bfloat16(), t(s2), t(b2),
                            t(sr), t(br), 0.01, pool=True)
    assert out.dtype == pool.dtype == torch.bfloat16
    scale = np.abs(want_out).max()
    np.testing.assert_allclose(out.float().numpy(), want_out,
                               atol=1e-2 * scale, rtol=0)
    np.testing.assert_allclose(pool.float().numpy(), want_pool,
                               atol=1e-2 * scale, rtol=0)
    # the pool is exactly the max of the port's own rounded output
    ref_pool = torch.nn.functional.max_pool3d(
        out.float().permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1)
    assert torch.equal(pool.float(), ref_pool)


def test_upsample_matches_upsample_s2d_pad():
    """B4 == the padded-chain Pallas upsample (interpret mode), with and
    without bias, as tests/test_upsample_kernel.py:68-93 checks it."""
    from fcd_tpu.kernels.upsample import upsample_s2d_pad
    from fcd_tpu.ops.s2d_ops import _upsample_wm

    cin, cout = 8, 4
    rng = np.random.RandomState(2)
    x = _bf16_values(rng.randn(2, 8, 10, 8, cin))
    w = _bf16_values(rng.randn(2, 2, 2, cin, cout) * 0.1)
    bias = rng.randn(cout).astype(np.float32)
    ysp = jnp.pad(to_s2d(jnp.asarray(x)), ((0, 0), (1, 1), (0, 0), (0, 0),
                                           (0, 0)))
    wm = _upsample_wm(jnp.asarray(w, jnp.bfloat16), cin)
    for bb in (None, bias):
        got_s2d = upsample_s2d_pad(
            ysp.astype(jnp.bfloat16), wm, cin, cout,
            None if bb is None else jnp.asarray(bb), out_dtype=jnp.float32,
            interpret=True)
        want = np.asarray(from_s2d(got_s2d[:, 1:-1], cout))
        got = upsample2x(torch.from_numpy(x), torch.from_numpy(w),
                         None if bb is None else torch.from_numpy(bb))
        assert got.shape == (2, 16, 20, 16, cout)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)


def _dsa_inputs(rng, b, n, c, h, p):
    return dict(
        x=rng.randn(b, n, c).astype(np.float32),
        w=(rng.randn(c, 4 * c) * 0.3).astype(np.float32),
        ef=(rng.randn(n, p) * 0.3).astype(np.float32),
        t1=(rng.rand(h) + 0.5).astype(np.float32),
        t2=(rng.rand(h) + 0.5).astype(np.float32),
        lns=(1.0 + 0.1 * rng.randn(c)).astype(np.float32),
        lnb=(0.1 * rng.randn(c)).astype(np.float32),
        pe=(0.3 * rng.randn(n, c)).astype(np.float32),
        gamma=rng.randn(c).astype(np.float32),
    )


@pytest.mark.parametrize("b,n,c,h,p,tile", [
    (2, 64, 32, 4, 16, None), (1, 128, 16, 2, 8, 16),
    # each level's (C, P, heads) at a small N, and at a ragged one (no
    # multiple of the kernels' 16-token tiles)
    (1, 128, 32, 4, 64, 32), (1, 100, 32, 4, 64, None),
    (1, 64, 64, 4, 64, None), (1, 90, 64, 4, 64, None),
    (1, 64, 128, 4, 64, None), (1, 76, 128, 4, 64, None),
    (1, 64, 256, 4, 32, None), (1, 70, 256, 4, 32, None),
    # C16's widths: head widths 4 and 2 (feature sizes 8 and 4 at level
    # 3), P 16 and 128, and C 512 (feature size 32 at level 6)
    (1, 64, 16, 4, 16, None), (1, 64, 8, 4, 128, None),
    (1, 64, 512, 4, 32, None)])
def test_dsa_matches_dsa_fused(monkeypatch, b, n, c, h, p, tile):
    """B5 == the JAX fused DSA kernel (interpret mode, f32) with the fused
    pos-embed, LayerNorm and residual; tile=16 spans several token tiles
    (grid accumulation), as tests/test_dsa_fused.py:28-60 checks it. Both
    the einsum reference and the port's phase A (the diagonal blocks of
    q^T k) -> plain glue -> phase B composition are held to it, and phase
    A with the temperatures (the finishing step) gives the glue's result."""
    from fcd_tpu.kernels import dsa_attention as dk

    if tile is not None:
        monkeypatch.setattr(dk, "_pick_tile", lambda n_: tile)
    a = _dsa_inputs(np.random.RandomState(3), b, n, c, h, p)
    wk = jnp.asarray(a["w"]).reshape(c, 4, c).transpose(1, 0, 2)
    want = np.asarray(dk.dsa_fused(
        jnp.asarray(a["x"]), wk, jnp.asarray(a["ef"]), jnp.asarray(a["t1"]),
        jnp.asarray(a["t2"]), num_heads=h, sa_type="parallel",
        ln_scale=jnp.asarray(a["lns"]), ln_bias=jnp.asarray(a["lnb"]),
        pos_embed=jnp.asarray(a["pe"]), res_gamma=jnp.asarray(a["gamma"]),
        interpret=True))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ref = dsa_attention(t["x"], t["w"], t["ef"], t["t1"].reshape(h, 1, 1),
                        t["t2"].reshape(h, 1, 1), t["lns"], t["lnb"], t["pe"],
                        t["gamma"], h).numpy()
    tok = (t["lns"], t["lnb"], t["pe"])
    pa = dsa_phase_a(t["x"], t["w"], t["ef"], *tok, h)
    assert pa.qk.shape == (b, h, c // h, c // h)
    glue = dsa_glue(pa, t["t1"], t["t2"], h, torch.float32)
    finished = dsa_phase_a(t["x"], t["w"], t["ef"], *tok, h,
                           temperatures=(t["t1"], t["t2"]))
    for got_, want_ in zip(finished, glue):
        assert torch.equal(got_, want_)
    composed = dsa_phase_b(t["x"], t["w"], *glue, t["gamma"], *tok,
                           h).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(ref, want, atol=2e-4 * scale)
    np.testing.assert_allclose(composed, want, atol=2e-4 * scale)
