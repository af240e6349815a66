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


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


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


@pytest.mark.parametrize("parts_c,cout,mode,grid", [
    ((16,), 16, "prologue", (2, 6, 10, 7)),
    ((2,), 16, "shortcut", (2, 6, 10, 7)),
    ((8, 8), 20, "shortcut", (2, 6, 10, 7)),
    ((24,), 64, "shortcut", (2, 6, 10, 7)),
    ((32,), 32, "plain", (2, 6, 10, 7)),
    # a 1-voxel-thick grid that no tile divides, cout 24
    ((16,), 24, "shortcut", (1, 1, 9, 17)),
    # |shift| ~ 1: a prologue applied before the zero padding would show
    # at every border
    ((16,), 16, "prologue_shift1", (1, 5, 9, 11)),
    ((2, 2), 16, "shortcut", (1, 6, 10, 7)),
    ((16,), 8, "plain", (1, 6, 10, 7)),
    # the deepest level: one tile, 16 k-steps, the weights spread over cout
    ((256,), 512, "shortcut", (1, 4, 4, 4)),
    # batch 2, two parts of two k-steps each, several tiles
    ((32, 32), 32, "shortcut", (2, 12, 10, 14))])
def test_conv3x3_kernel_matches_plain(dev, parts_c, cout, mode, grid):
    from fcd_tpu_torch.kernels.block_conv import conv3x3, conv3x3_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    parts = [_randn(gen, dev, *grid, c, dtype=bf) for c in parts_c]
    ws = [_randn(gen, dev, 3, 3, 3, c, cout, scale=0.2, dtype=bf)
          for c in parts_c]
    kw = dict(want_stats=True)
    if mode == "shortcut":
        kw["shortcut"] = [_randn(gen, dev, c, cout, scale=0.3, dtype=bf)
                          for c in parts_c]
    if mode.startswith("prologue"):
        b, c0 = grid[0], parts_c[0]
        kw["prologue"] = (torch.rand(b, c0, generator=gen, device=dev) + 0.5,
                          _randn(gen, dev, b, c0, scale=0.1)
                          + (1.0 if mode == "prologue_shift1" else 0.0),
                          0.01)
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


# -- the training slice's kernels (K1-K4) and autograd Functions -------------

def _grads(fn, inputs):
    """(outputs, grads of sum(out * cotangent) w.r.t. inputs) in f32."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=ins[0].device).manual_seed(7)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen,
                                        device=o.device)).sum()
               for o in outs)
    loss.backward()
    return outs, [t.grad for t in ins]


@pytest.mark.parametrize("shape,ci,co,pro", [
    ((2, 6, 10, 7), 16, 16, True),
    ((2, 6, 10, 7), 2, 16, False),
    ((2, 6, 10, 7), 2, 16, True),
    ((2, 6, 10, 7), 32, 64, False),
    ((2, 6, 10, 7), 12, 20, True),
    ((2, 6, 10, 7), 24, 8, True),
    # a 1-voxel-thick grid that no tile divides
    ((1, 1, 9, 17), 8, 8, True),
    ((1, 1, 9, 17), 20, 20, False),
    # the widest dW, one 4^3 tile per batch item
    ((1, 4, 4, 4), 512, 512, True),
    # many chunks: the partial sums and the second pass
    ((2, 20, 24, 24), 16, 16, True),
    ((2, 20, 24, 24), 2, 16, False),
    ((1, 16, 32, 32), 32, 32, True),
    ((2, 10, 18, 21), 20, 20, True)])
def test_conv3d_wgrad_kernel_matches_plain(dev, shape, ci, co, pro):
    """K1 against its plain version (f32 sums in another order), and two
    calls bit-equal (the chunks' partial sums are added in a fixed
    order)."""
    from fcd_tpu_torch.kernels.conv_wgrad import (
        conv3d_wgrad,
        conv3d_wgrad_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    b = shape[0]
    x = _randn(gen, dev, *shape, ci, dtype=bf)
    g = _randn(gen, dev, *shape, co, dtype=bf)
    prologue = None
    if pro:
        prologue = (torch.rand(b, ci, generator=gen, device=dev) + 0.5,
                    _randn(gen, dev, b, ci, scale=0.1), 0.01)
    before = conv3d_wgrad.launches
    got = conv3d_wgrad(x, g, prologue)
    again = conv3d_wgrad(x, g, prologue)
    torch.cuda.synchronize()
    assert conv3d_wgrad.launches == before + 2
    assert got.shape == (27, ci, co) and got.dtype == torch.float32
    assert _rel(got, conv3d_wgrad_plain(x, g, prologue)) < 1e-4
    assert torch.equal(got, again)


@pytest.mark.parametrize("kernel", ["finale_bwd", "finale_bwd_pool",
                                    "finale_bwd_chain", "spatial_attn_bwd",
                                    "spatial_attn_bwd_level6"])
def test_backward_sums_are_reproducible(dev, kernel):
    """K2's per-channel sums and K4's dkpb and dvpb are added over the
    programs / token blocks in a fixed order: two launches on the same
    inputs give the same bits."""
    from fcd_tpu_torch.kernels import spatial_attn as sa
    from fcd_tpu_torch.kernels.finale import finale_bwd

    gen = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    if kernel.startswith("finale_bwd"):
        shape = (2, 16, 16, 16, 24)
        ys, rs, gp = (_randn(gen, dev, *shape, dtype=bf) for _ in range(3))
        aff = [_randn(gen, dev, 2, 24) for _ in range(4)]
        pool = kernel != "finale_bwd"
        gq = (_randn(gen, dev, 2, 8, 8, 8, 24, dtype=bf) if pool else None)
        tie = "chain" if kernel.endswith("chain") else "even"

        def call():
            return finale_bwd(ys, rs, *aff, gp, gq, 0.01, tie=tie)
    else:
        n, c, h, p = (64, 256, 4, 32) if kernel.endswith("6") else \
            (700, 32, 4, 64)
        qn = _randn(gen, dev, 2, n, c, scale=0.2, dtype=bf)
        kpb = _randn(gen, dev, 2, c, h * p, scale=0.5, dtype=bf)
        vpb = _randn(gen, dev, 2, h * p, c, dtype=bf)
        g = _randn(gen, dev, 2, n, c, dtype=bf)
        key = sa.dropout_key(99, 1)

        def call():
            return sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1)
    for a, b in zip(call(), call()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pool", [False, True])
def test_finale_bwd_kernel_matches_plain(dev, pool):
    """Inputs on a coarse bf16 grid, so the pool has exact ties."""
    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_bwd_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    ys = torch.randint(-2, 3, (2, 6, 8, 10, 24), generator=gen,
                       device=dev).to(bf)
    rs = _randn(gen, dev, 2, 6, 8, 10, 24, dtype=bf)
    aff = [torch.ones(2, 24, device=dev), _randn(gen, dev, 2, 24),
           torch.zeros(2, 24, device=dev), torch.zeros(2, 24, device=dev)]
    gp = _randn(gen, dev, 2, 6, 8, 10, 24, dtype=bf)
    gq = _randn(gen, dev, 2, 3, 4, 5, 24, dtype=bf) if pool else None
    got = finale_bwd(ys, rs, *aff, gp, gq, 0.01)
    want = finale_bwd_plain(ys, rs, *aff, gp, gq, 0.01)
    assert got[0].dtype == bf
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 1e-2


def test_finale_bwd_chain_kernel_matches_plain(dev):
    """K2's `chain` tie split (levels 3-5) on tied inputs: small integers
    with dyadic affines, exact in f32 whether or not a multiply-add is
    contracted, so kernel and plain version see the same ties."""
    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_bwd_plain

    gen = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    ys = torch.randint(-2, 3, (2, 6, 8, 10, 40), generator=gen,
                       device=dev).to(bf)
    rs = torch.randint(-1, 2, (2, 6, 8, 10, 40), generator=gen,
                       device=dev).to(bf)
    aff = [torch.full((2, 40), 0.5, device=dev),
           torch.randint(-8, 9, (2, 40), generator=gen, device=dev) / 8.0,
           torch.ones(2, 40, device=dev), torch.zeros(2, 40, device=dev)]
    gp = _randn(gen, dev, 2, 6, 8, 10, 40, dtype=bf)
    gq = _randn(gen, dev, 2, 3, 4, 5, 40, dtype=bf)
    got = finale_bwd(ys, rs, *aff, gp, gq, 0.01, tie="chain")
    want = finale_bwd_plain(ys, rs, *aff, gp, gq, 0.01, tie="chain")
    even = finale_bwd_plain(ys, rs, *aff, gp, gq, 0.01, tie="even")
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g_, w_ in zip(got[1:], want[1:]):
        assert _rel(g_, w_) < 1e-5
    assert not torch.equal(want[0], even[0])


def test_forward_sums_are_reproducible(dev):
    """B1's statistics and B5 phase A's token sums are added in a fixed
    order: two launches on the same inputs give the same bits."""
    from fcd_tpu_torch.kernels import dsa_attention as dk
    from fcd_tpu_torch.kernels.block_conv import conv3x3

    gen = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    x = _randn(gen, dev, 2, 12, 10, 14, 16, dtype=bf)
    w = _randn(gen, dev, 3, 3, 3, 16, 32, scale=0.2, dtype=bf)
    wr = _randn(gen, dev, 16, 32, scale=0.3, dtype=bf)
    a = conv3x3([x], [w], shortcut=[wr], want_stats=True)
    b = conv3x3([x], [w], shortcut=[wr], want_stats=True)
    for name in ("ysum", "ysq", "rsum", "rsq"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    n, c, p = 700, 32, 64
    t = _randn(gen, dev, 2, n, c, dtype=bf)
    w4 = _randn(gen, dev, 4, c, c, scale=0.2, dtype=bf)
    ef = _randn(gen, dev, n, p, scale=0.05, dtype=bf)
    args = (t, w4, ef, torch.ones(c, device=dev), torch.zeros(c, device=dev),
            _randn(gen, dev, n, c, scale=0.1))
    for g_, w_ in zip(dk.dsa_phase_a(*args), dk.dsa_phase_a(*args)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("shape,roi,dtype", [
    ((10, 16, 8, 2), (8, 16, 8), torch.bfloat16),
    ((10, 12, 7, 2), (16, 16, 8), torch.bfloat16),
    ((9, 12, 7, 3), (16, 8, 8), torch.float32)])
def test_sw_entry_kernel_matches_plain(dev, shape, roi, dtype):
    from fcd_tpu_torch.kernels.sw_io import sw_entry, sw_entry_plain

    gen = torch.Generator(device=dev).manual_seed(8)
    vol = _randn(gen, dev, *shape, scale=3.0)
    before = sw_entry.launches
    got = sw_entry(vol, roi, dtype)
    want = sw_entry_plain(vol, roi, dtype)
    torch.cuda.synchronize()
    assert sw_entry.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("start,size", [((0, 0, 0), (10, 12, 14)),
                                        ((1, 2, 3), (7, 9, 8))])
def test_sw_exit_kernel_matches_plain(dev, start, size):
    from fcd_tpu_torch.kernels.sw_io import sw_exit, sw_exit_plain

    gen = torch.Generator(device=dev).manual_seed(9)
    acc = _randn(gen, dev, 10, 12, 14, 2)
    inv = torch.rand(10, 12, 14, 1, generator=gen, device=dev) + 0.1
    before = sw_exit.launches
    got = sw_exit(acc, inv, start, size)
    want = sw_exit_plain(acc, inv, start, size)
    torch.cuda.synchronize()
    assert sw_exit.launches == before + 1
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("n,c,h,p,rate", [(300, 32, 4, 64, 0.0),
                                          (300, 32, 4, 64, 0.1),
                                          (64, 256, 4, 32, 0.1)])
def test_spatial_attn_kernels_match_plain(dev, n, c, h, p, rate):
    """Equal dropout masks: the outputs agree to bf16 rounding."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    gen = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    qn = _randn(gen, dev, 2, n, c, scale=0.2, dtype=bf)
    kpb = _randn(gen, dev, 2, c, h * p, scale=0.5, dtype=bf)
    vpb = _randn(gen, dev, 2, h * p, c, dtype=bf)
    g = _randn(gen, dev, 2, n, c, dtype=bf)
    key = sa.dropout_key(1234, 5)
    assert _rel(sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate),
                sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate)) < 2e-2
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 2e-2


def test_conv_function_grads_match_plain_autograd(dev):
    """Conv3x3 (B1 + K1 backward) against autograd through conv3x3_plain:
    two parts with the shortcut, then one part with the prologue."""
    from fcd_tpu_torch.kernels.block_conv import conv3x3_op, conv3x3_plain

    gen = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    x0 = _randn(gen, dev, 2, 6, 8, 6, 8, dtype=bf)
    x1 = _randn(gen, dev, 2, 6, 8, 6, 8, dtype=bf)
    w0 = _randn(gen, dev, 3, 3, 3, 8, 16, scale=0.2)
    w1 = _randn(gen, dev, 3, 3, 3, 8, 16, scale=0.2)
    r0 = _randn(gen, dev, 8, 16, scale=0.3)
    r1 = _randn(gen, dev, 8, 16, scale=0.3)

    def run(conv):
        def f(a, b, wa, wb, ra, rb):
            o = conv([a, b], [wa, wb], shortcut=[ra, rb], want_stats=True)
            return o.y, o.ysum, o.ysq, o.r, o.rsum, o.rsq
        return _grads(f, [x0, x1, w0, w1, r0, r1])

    (_, got), (_, want) = run(conv3x3_op), run(conv3x3_plain)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2
    sc = torch.rand(2, 8, generator=gen, device=dev) + 0.5
    sh = _randn(gen, dev, 2, 8, scale=0.1)

    def run_pro(conv):
        def f(a, wa, s, t):
            o = conv([a], [wa], prologue=(s, t, 0.01), want_stats=True)
            return o.y, o.ysum, o.ysq
        return _grads(f, [x0, w0, sc, sh])

    (_, got), (_, want) = run_pro(conv3x3_op), run_pro(conv3x3_plain)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2


def test_finale_and_upsample_functions_match_plain_autograd(dev):
    """The pool reference is torch.amax over each block, whose backward
    splits ties evenly, as K2 does (bf16 outputs do tie)."""
    from fcd_tpu_torch.kernels.finale import finale
    from fcd_tpu_torch.kernels.pool import finale_pool_plain
    from fcd_tpu_torch.kernels.upsample import upsample2x_op, upsample2x_plain
    from fcd_tpu_torch.ops.layers import blocks_2x

    def plain(*a):
        out = finale_pool_plain(*a, 0.01)
        return out, blocks_2x(out).amax(dim=4)

    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    ins = [_randn(gen, dev, 2, 6, 8, 10, 16, dtype=bf),
           _randn(gen, dev, 2, 6, 8, 10, 16, dtype=bf)] + \
        [_randn(gen, dev, 2, 16) for _ in range(4)]
    (_, got) = _grads(lambda *a: finale(*a, 0.01, True), ins)
    (_, want) = _grads(plain, ins)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2
    x = _randn(gen, dev, 2, 3, 5, 4, 24, dtype=bf)
    k = _randn(gen, dev, 2, 2, 2, 24, 16, scale=0.2)
    (_, got) = _grads(upsample2x_op, [x, k])
    (_, want) = _grads(upsample2x_plain, [x, k])
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2


def test_spatial_attn_function_matches_plain_autograd(dev):
    from fcd_tpu_torch.kernels import spatial_attn as sa

    gen = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    ins = [_randn(gen, dev, 2, 200, 32, scale=0.2, dtype=bf),
           _randn(gen, dev, 2, 32, 256, scale=0.5, dtype=bf),
           _randn(gen, dev, 2, 256, 32, dtype=bf)]
    key = sa.dropout_key(99, 3)
    (_, got) = _grads(lambda *a: sa.spatial_attn(*a, 4, key, 0.1), ins)
    (_, want) = _grads(
        lambda *a: sa.spatial_attn_fwd_plain(*a, 4, key, 0.1), ins)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2


def test_train_step_on_the_card(dev):
    """A small MS_DSA_NET train step in bf16: finite, falling losses, and
    every kernel of the train path launched."""
    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.kernels import (
        block_conv,
        conv_wgrad,
        finale,
        pool,
        spatial_attn,
        upsample,
    )
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params.update(patch_size=32, feature_size=8, project_size=16,
                  loss="DiceCELoss")
    tr = ModelTrainer(params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(2, 32, 32, 32, 2, generator=gen, device=dev)
    y = (torch.rand(2, 32, 32, 32, 1, generator=gen, device=dev) > 0.9).float()
    fns = [block_conv.conv3x3, conv_wgrad.conv3d_wgrad, pool.finale_pool,
           finale.finale_bwd, upsample.upsample2x,
           spatial_attn.spatial_attn_fwd, spatial_attn.spatial_attn_bwd]
    before = [f.launches for f in fns]
    losses = [float(tr.train_step(x, y, 1e-3)) for _ in range(3)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]
    assert all(f.launches > b for f, b in zip(fns, before))


@pytest.mark.parametrize("shape", [(2, 6, 8, 10, 24), (1, 4, 4, 4, 5)])
def test_max_pool2x_kernels_match_plain(dev, shape):
    """B3 and B9 bit-equal to their plain versions, on tied inputs."""
    from fcd_tpu_torch.kernels.pool2x import (
        max_pool2x,
        max_pool2x_bwd,
        max_pool2x_bwd_plain,
        max_pool2x_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    x = torch.randint(-3, 4, shape, generator=gen, device=dev).to(bf)
    b, d, h, w, c = shape
    g = _randn(gen, dev, b, d // 2, h // 2, w // 2, c, dtype=bf)
    before = (max_pool2x.launches, max_pool2x_bwd.launches)
    pooled, dx = max_pool2x(x), max_pool2x_bwd(x, g)
    torch.cuda.synchronize()
    assert (max_pool2x.launches, max_pool2x_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(pooled, max_pool2x_plain(x))
    assert torch.equal(dx, max_pool2x_bwd_plain(x, g))


@pytest.mark.parametrize("c,o,bias,out_dtype", [
    (16, 2, True, torch.bfloat16), (24, 3, False, torch.float32)])
def test_finale_head_kernel_matches_plain(dev, c, o, bias, out_dtype):
    from fcd_tpu_torch.kernels.finale_head import (
        finale_head,
        finale_head_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    y2 = _randn(gen, dev, 2, 6, 8, 10, c, dtype=bf)
    r = _randn(gen, dev, 2, 6, 8, 10, c, dtype=bf)
    aff = [_randn(gen, dev, 2, c) for _ in range(4)]
    w = _randn(gen, dev, c, o, scale=0.5)
    b = _randn(gen, dev, o) if bias else None
    got = finale_head(y2, r, *aff, w, b, 0.01, out_dtype=out_dtype)
    want = finale_head_plain(y2, r, *aff, w, b, 0.01, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    assert _rel(got, want) < (1e-2 if out_dtype == bf else 1e-5)
