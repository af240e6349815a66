"""The port's kernels on the card against their plain versions (marker
`cuda`; skipped without a CUDA device). Run on the machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Small shapes, bf16 activations; the tolerances are chip_smoke.py's.
Whether a card exists is decided inside the fixture, so every worker
collects the same tests.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def _randn(gen, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("parts_c,cout,mode", [
    ((16,), 16, "prologue"), ((2,), 16, "shortcut"),
    ((8, 8), 20, "shortcut"), ((24,), 64, "shortcut"), ((32,), 32, "plain")])
def test_conv3x3_kernel_matches_plain(dev, parts_c, cout, mode):
    from fcd_tpu_torch.kernels.block_conv import conv3x3, conv3x3_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    parts = [_randn(gen, dev, 2, 6, 10, 7, c, dtype=bf) for c in parts_c]
    ws = [_randn(gen, dev, 3, 3, 3, c, cout, scale=0.2, dtype=bf)
          for c in parts_c]
    kw = dict(want_stats=True)
    if mode == "shortcut":
        kw["shortcut"] = [_randn(gen, dev, c, cout, scale=0.3, dtype=bf)
                          for c in parts_c]
    if mode == "prologue":
        kw["prologue"] = (torch.rand(2, parts_c[0], generator=gen,
                                     device=dev) + 0.5,
                          _randn(gen, dev, 2, parts_c[0], scale=0.1), 0.01)
    before = conv3x3.launches
    got = conv3x3(parts, ws, **kw)
    want = conv3x3_plain(parts, ws, **kw)
    torch.cuda.synchronize()
    assert conv3x3.launches == before + 1
    assert _rel(got.y, want.y) < 2e-2
    assert _rel(got.ysum, want.ysum) < 1e-3 and _rel(got.ysq, want.ysq) < 1e-3
    if mode == "shortcut":
        assert _rel(got.r, want.r) < 2e-2
        assert _rel(got.rsq, want.rsq) < 1e-3


@pytest.mark.parametrize("pool", [False, True])
def test_finale_pool_kernel_matches_plain(dev, pool):
    from fcd_tpu_torch.kernels.pool import finale_pool, finale_pool_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    y2 = _randn(gen, dev, 2, 6, 8, 10, 24, dtype=torch.bfloat16)
    r = _randn(gen, dev, 2, 6, 8, 10, 24, dtype=torch.bfloat16)
    aff = [_randn(gen, dev, 2, 24) for _ in range(4)]
    got = finale_pool(y2, r, *aff, 0.01, pool=pool)
    want = finale_pool_plain(y2, r, *aff, 0.01, pool=pool)
    got = got if pool else (got,)
    want = want if pool else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert _rel(g, w) < 1e-2


@pytest.mark.parametrize("ci,co,bias", [(32, 16, False), (12, 20, True)])
def test_upsample_kernel_matches_plain(dev, ci, co, bias):
    from fcd_tpu_torch.kernels.upsample import upsample2x, upsample2x_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    x = _randn(gen, dev, 2, 3, 5, 4, ci, dtype=torch.bfloat16)
    k = _randn(gen, dev, 2, 2, 2, ci, co, scale=0.2, dtype=torch.bfloat16)
    b = _randn(gen, dev, co) if bias else None
    assert _rel(upsample2x(x, k, b), upsample2x_plain(x, k, b)) < 2e-2


@pytest.mark.parametrize("n,c,p,h", [(300, 32, 64, 4), (64, 256, 32, 4)])
def test_dsa_kernels_match_plain(dev, n, c, p, h):
    from fcd_tpu_torch.kernels import dsa_attention as dk

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    x = _randn(gen, dev, 2, n, c, dtype=bf)
    w_qkvv = _randn(gen, dev, c, 4 * c, scale=c ** -0.5)
    ef = _randn(gen, dev, n, p, scale=p ** -0.5)
    t1 = torch.rand(h, 1, 1, generator=gen, device=dev) + 0.5
    t2 = torch.rand(h, 1, 1, generator=gen, device=dev) + 0.5
    lns, lnb = 1 + _randn(gen, dev, c, scale=0.1), _randn(gen, dev, c, scale=0.1)
    pe, gamma = _randn(gen, dev, n, c, scale=0.1), _randn(gen, dev, c)
    w4 = dk.split_qkvv(w_qkvv)
    ka = dk.dsa_phase_a(x, w4, ef, lns, lnb, pe)
    wa = dk.dsa_phase_a_plain(x, w4, ef, lns, lnb, pe)
    for g, w in zip(ka, wa):
        assert _rel(g, w) < 2e-2
    glue = dk.dsa_glue(ka, t1, t2, h, bf)
    got = dk.dsa_phase_b(x, w4, *glue, gamma, lns, lnb, pe, h)
    want = dk.dsa_phase_b_plain(x, w4, *glue, gamma, lns, lnb, pe, h)
    assert _rel(got, want) < 2e-2
    ref = dk.dsa_reference(x, w_qkvv, ef, t1, t2, lns, lnb, pe, gamma, h)
    whole = dk.dsa_attention(x, w_qkvv, ef, t1, t2, lns, lnb, pe, gamma, h)
    assert _rel(whole, ref) < 5e-2


def test_wrappers_refuse_f32_on_the_card(dev):
    from fcd_tpu_torch.kernels.upsample import upsample2x

    with pytest.raises(TypeError, match="bf16"):
        upsample2x(torch.zeros(1, 2, 2, 2, 4, device=dev),
                   torch.zeros(2, 2, 2, 4, 4, device=dev))
