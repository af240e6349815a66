"""The port's kernels on the card against their plain versions (marker
`cuda`; skipped without a CUDA device). Run on the machine with the card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Small shapes, bf16 activations; the tolerances are chip_smoke.py's.
Whether a card exists is decided inside the fixture, so every worker
collects the same tests.
"""

import pytest
import torch

import torch_port_workers

torch_port_workers.share_cores()

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


_BUILT = []


@pytest.fixture
def dev():
    """The card, with every CUDA library of the port built before the first
    test uses it: in runs that built a library (nvcc in a subprocess) after
    this process had read the card's profiler, every later trace came back
    empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if not _BUILT:
        from fcd_tpu_torch.kernels import _build

        _build.build_all()
        _BUILT.append(True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def _randn(gen, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


# aten ops that allocate or view and launch no device work: what a
# kernel's wrapper may make beside the launches of its CUDA kernels
NO_DEVICE_WORK = {
    "aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
    "aten.new_empty_strided", "aten.view", "aten._unsafe_view",
    "aten.as_strided", "aten.t", "aten.transpose", "aten.permute",
    "aten.unsqueeze", "aten.squeeze", "aten.select", "aten.slice",
    "aten.expand", "aten.alias", "aten.detach", "aten.split", "aten.unbind"}


def _aten_ops(call):
    """The aten ops one call makes, in order, after a warm-up call (a
    TorchDispatchMode log; no profiler). The port's kernels launch through
    ctypes, which no aten op sees, so an op outside NO_DEVICE_WORK in the
    log is device work beside the kernels: a cast, a copy or a sum."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    call()
    torch.cuda.synchronize()
    with Log() as log:
        call()
    torch.cuda.synchronize()
    return log.ops


def _library_kernels(lib, names):
    """{name: the functions of library `lib` whose names hold it}, from the
    library's SASS (cuobjdump): each kernel a wrapper launches is there."""
    from chip_smoke import _sass_functions

    fns = _sass_functions(lib, lambda f: True)
    return {k: [f for f in fns if k in f] for k in names}


def _only_kernels(call, counters, lib, names):
    """One call of `call` is one count on each of `counters` (the wrappers'
    launch counts; (object, launches per call)), launches the kernels of
    `names`, which library `lib` holds, and makes no aten op that does
    device work (`_aten_ops`). The names are checked in the library's
    SASS only: how many device kernels one C entry launches, and in which
    order, is held by chip_smoke.py's `device_kernels` (a whole trace),
    not here."""
    before = [c.launches for c, _ in counters]
    ops = _aten_ops(call)
    assert [c.launches - b for (c, _), b in zip(counters, before)] == [
        2 * n for _, n in counters], "launches"
    assert set(ops) <= NO_DEVICE_WORK, ops
    for k, fns in _library_kernels(lib, names).items():
        assert fns, (lib, k)


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


# B1's row-parallel split at the shard widths (tensor parallelism): the
# rank's input channels -> the whole cout
@pytest.mark.parametrize("c,cout,grid,prologue", [
    (8, 16, (2, 6, 10, 7), True),      # enc1's conv2 at fs16, n_model 2
    (16, 32, (1, 6, 10, 7), True),
    (4, 8, (1, 6, 10, 7), False),      # fs8 over 4 ranks
    (128, 256, (1, 4, 4, 4), True),    # the deepest level's conv2
    (8, 20, (1, 1, 9, 17), True)])     # cout 20, a 1-voxel-thick grid
def test_conv3x3_partial_kernel_matches_plain(dev, c, cout, grid, prologue):
    from fcd_tpu_torch.kernels.block_conv import (
        conv3x3_partial,
        conv3x3_partial_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(8)
    x = _randn(gen, dev, *grid, c, dtype=torch.bfloat16)
    w = _randn(gen, dev, 3, 3, 3, c, cout, scale=0.2, dtype=torch.bfloat16)
    pro = None
    if prologue:
        pro = (torch.rand(grid[0], c, generator=gen, device=dev) + 0.5,
               _randn(gen, dev, grid[0], c, scale=0.5), 0.01)
    before = conv3x3_partial.launches
    got = conv3x3_partial(x, w, pro)
    torch.cuda.synchronize()
    assert conv3x3_partial.launches == before + 1
    assert got.dtype == torch.float32
    # bf16 products are exact in f32: only the order of the sum differs
    assert _rel(got, conv3x3_partial_plain(x, w, pro)) < 1e-4
    assert torch.equal(got, conv3x3_partial(x, w, pro))


@pytest.mark.parametrize("shape", [(2, 6, 10, 7, 16), (1, 4, 4, 4, 512),
                                   (1, 3, 5, 7, 24), (2, 9, 8, 5, 768),
                                   (1, 32, 32, 32, 16)])
def test_conv_finish_kernel_matches_plain(dev, shape):
    from fcd_tpu_torch.kernels.conv_finish import (
        conv_finish,
        conv_finish_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(9)
    s = _randn(gen, dev, *shape) + 0.3
    before = conv_finish.launches
    y, s1, s2 = conv_finish(s)
    torch.cuda.synchronize()
    assert conv_finish.launches == before + 1
    wy, w1, w2 = conv_finish_plain(s, torch.bfloat16)
    assert torch.equal(y, wy)            # the same round to nearest
    assert _rel(s1, w1) < 1e-4 and _rel(s2, w2) < 1e-5
    again = conv_finish(s)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))


# the finishing pass at its edges: C 8 and 1024, batch 2, voxel counts no
# multiple of a chunk or of a block's rows, and one shape on each side of
# the one-launch threshold (ONE_LAUNCH = 32 x 32 x 16 voxels x 16)
@pytest.mark.parametrize("shape,one_launch", [
    ((1, 4, 4, 4, 1024), True), ((2, 5, 7, 9, 8), True),
    ((2, 13, 11, 9, 32), True), ((1, 32, 32, 16, 16), True),
    ((1, 32, 32, 17, 16), False), ((2, 33, 31, 29, 20), False)])
def test_conv_finish_kernel_at_its_edges(dev, shape, one_launch):
    from fcd_tpu_torch.kernels.conv_finish import (
        conv_finish,
        conv_finish_plain,
        finish_plan,
    )

    nvox = shape[1] * shape[2] * shape[3]
    assert bool(finish_plan(shape[0], nvox, shape[-1]).cluster) == one_launch
    gen = torch.Generator(device=dev).manual_seed(10)
    s = _randn(gen, dev, *shape) + 0.3
    got = conv_finish(s)
    torch.cuda.synchronize()
    want = conv_finish_plain(s, torch.bfloat16)
    assert torch.equal(got[0], want[0])
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[2], want[2]) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, conv_finish(s)))


def test_conv_finish_kernel_under_every_plan(dev):
    """One launch at cluster sizes 1 to the card's limit and two launches
    at 1 to 528 blocks: y the same bits, the sums within rel 1e-5."""
    from fcd_tpu_torch.kernels.conv_finish import (
        cluster_limit,
        conv_finish,
        conv_finish_plain,
        finish_plan,
    )

    shape = (2, 9, 8, 5, 20)
    nvox = 9 * 8 * 5
    s = _randn(torch.Generator(device=dev).manual_seed(11), dev, *shape)
    want = conv_finish_plain(s, torch.bfloat16)
    limit = cluster_limit(s.device)
    plans = [finish_plan(2, nvox, 20, one_launch=True, cluster=k)
             for k in (1, 3, 8, 16) if k <= limit] + [
        finish_plan(2, nvox, 20, one_launch=False, blocks=n)
        for n in (1, 7, 528)]
    for plan in plans:
        got = conv_finish(s, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), plan
        assert _rel(got[1], want[1]) <= 1e-5, plan
        assert _rel(got[2], want[2]) <= 1e-5, plan


@pytest.mark.parametrize("grid,c,names", [
    ((4, 4, 4), 512, ["conv_finish_bulk_kernel"]),
    ((32, 32, 32), 32, ["conv_finish_bulk_kernel", "conv_finish_sum_kernel"])])
def test_conv_finish_launches_only_its_kernels(dev, grid, c, names):
    """One launch (a cluster) below the threshold, the kernel and its run
    sum above it: no PyTorch op does device work beside them."""
    from fcd_tpu_torch.kernels.conv_finish import conv_finish

    s = _randn(torch.Generator(device=dev).manual_seed(12), dev, 1, *grid, c)
    _only_kernels(lambda: conv_finish(s), [(conv_finish, 1)], "conv_finish",
                  names)


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


# the five decoders' (ci, co), and a ragged case with bias and bf16 weights
UPSAMPLE_CASES = [(256, 128, False, "f32"), (128, 64, False, "f32"),
                  (64, 32, False, "f32"), (32, 32, False, "f32"),
                  (32, 16, False, "f32"), (12, 20, True, "f32"),
                  (12, 20, True, "bf16")]


def _upsample_inputs(dev, batch, ci, co, bias, wdtype, grid=(3, 5, 4)):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = _randn(gen, dev, batch, *grid, ci, dtype=torch.bfloat16)
    wd = torch.float32 if wdtype == "f32" else torch.bfloat16
    k = _randn(gen, dev, 2, 2, 2, ci, co, scale=0.2, dtype=wd)
    b = _randn(gen, dev, co, dtype=wd) if bias else None
    return x, k, b


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("ci,co,bias,wdtype", UPSAMPLE_CASES)
def test_upsample_kernel_matches_plain(dev, batch, ci, co, bias, wdtype):
    from fcd_tpu_torch.kernels.upsample import upsample2x, upsample2x_plain

    x, k, b = _upsample_inputs(dev, batch, ci, co, bias, wdtype)
    before = upsample2x.launches
    got = upsample2x(x, k, b)
    torch.cuda.synchronize()
    assert upsample2x.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert _rel(got, upsample2x_plain(x, k, b)) < 2e-2
    # two calls, the same bits
    assert torch.equal(got, upsample2x(x, k, b))


@pytest.mark.parametrize("tile", range(4))
def test_upsample_kernel_every_tile(dev, tile):
    """Every tile of the plan's list, at a shape that leaves ragged edges
    in both of the grid's axes, under several walks."""
    from fcd_tpu_torch.kernels.upsample import (
        plan_for,
        upsample2x,
        upsample2x_plain,
    )

    x, k, b = _upsample_inputs(dev, 2, 40, 24, True, "f32", grid=(3, 7, 5))
    want = upsample2x_plain(x, k, b)
    plan = plan_for(tile, 2 * 3 * 7 * 5, 8 * 24)
    # the plan's walk, a walk of several tiles a block, and one tile a block
    for m_blocks in (plan.m_blocks, 1, 3, plan.m_tiles):
        walk = plan._replace(m_blocks=min(m_blocks, plan.m_tiles))
        assert _rel(upsample2x(x, k, b, plan=walk), want) < 2e-2


def test_upsample_is_one_device_launch(dev):
    """The model's call (f32 kernel, no bias): one kernel on the card
    (one count on the wrapper, whose one C call launches upsample_kernel),
    no cast, flip or copy beside it (no aten op but its allocation)."""
    from fcd_tpu_torch.kernels.upsample import upsample2x

    x, k, _ = _upsample_inputs(dev, 1, 32, 16, False, "f32", grid=(8, 8, 8))
    _only_kernels(lambda: upsample2x(x, k), [(upsample2x, 1)], "upsample",
                  ["upsample_kernel"])


def _dsa_inputs(gen, dev, n, c, p, h, wdtype=torch.float32):
    bf = torch.bfloat16
    return dict(
        x=_randn(gen, dev, 2, n, c, dtype=bf),
        w=_randn(gen, dev, c, 4 * c, scale=c ** -0.5, dtype=wdtype),
        ef=_randn(gen, dev, n, p, scale=p ** -0.5, dtype=wdtype),
        t1=torch.rand(h, 1, 1, generator=gen, device=dev) + 0.5,
        t2=torch.rand(h, 1, 1, generator=gen, device=dev) + 0.5,
        lns=1 + _randn(gen, dev, c, scale=0.1), lnb=_randn(gen, dev, c, scale=0.1),
        pe=_randn(gen, dev, n, c, scale=0.1), gamma=_randn(gen, dev, c))


@pytest.mark.parametrize("n,c,p,wdtype", [
    # the four levels of a 128^3 patch, each also at a ragged N (bf16
    # weights and EF there; the model's are f32)
    (32768, 32, 64, "f32"), (300, 32, 64, "bf16"),
    (4096, 64, 64, "f32"), (700, 64, 64, "bf16"),
    (512, 128, 64, "f32"), (100, 128, 64, "bf16"),
    (64, 256, 32, "f32"), (70, 256, 32, "bf16")])
def test_dsa_kernels_match_plain(dev, n, c, p, wdtype):
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h, bf = 4, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    a = _dsa_inputs(gen, dev, n, c, p, h,
                    torch.float32 if wdtype == "f32" else bf)
    x, w, ef, gamma = a["x"], a["w"], a["ef"], a["gamma"]
    tok = (a["lns"], a["lnb"], a["pe"])
    before = (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches)
    ka = dk.dsa_phase_a(x, w, ef, *tok, h)
    wa = dk.dsa_phase_a_plain(x, w, ef, *tok, h)
    assert ka.qk.shape == (2, h, c // h, c // h)
    for g, w_ in zip(ka, wa):
        assert _rel(g, w_) < 2e-2
    # the finishing pass: phase B's operands against the plain glue
    glue = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=(a["t1"], a["t2"]))
    want_glue = dk.dsa_glue(wa, a["t1"], a["t2"], h, bf)
    for g, w_ in zip(glue, want_glue):
        assert g.dtype == w_.dtype and _rel(g, w_) < 2e-2
    got = dk.dsa_phase_b(x, w, *glue, gamma, *tok, h)
    want = dk.dsa_phase_b_plain(x, w, *glue, gamma, *tok, h)
    assert _rel(got, want) < 2e-2
    assert (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches) == (
        before[0] + 2, before[1] + 1)
    ref = dk.dsa_reference(x, w, ef, a["t1"], a["t2"], *tok, gamma, h)
    whole = dk.dsa_attention(x, w, ef, a["t1"], a["t2"], *tok, gamma, h)
    assert _rel(whole, ref) < 5e-2


# C16: the widths of MS_DSA_NET at 4 heads beyond the default model's,
# (N, C, P): feature size 8 and 4 at level 3 (head widths 4 and 2, C 16 and
# 8), feature size 32 at level 6 (C 512, head width 128: the weights
# stream), P 16 and 128 at levels 3-5, each kind also at a ragged N
DSA_WIDTHS = [
    (32768, 16, 16), (300, 16, 64),      # fs8 level 3
    (32768, 8, 16), (100, 8, 128),       # fs4 level 3
    (64, 512, 32), (70, 512, 32),        # fs32 level 6
    (32768, 32, 16), (4096, 64, 16), (512, 128, 16), (130, 128, 16),
    (32768, 32, 128), (4096, 64, 128), (512, 128, 128), (130, 64, 128),
    (512, 256, 128), (4096, 128, 16),    # fs32 levels 5 and 4
    (64, 128, 32)]                       # fs8 level 6


@pytest.mark.parametrize("n,c,p", DSA_WIDTHS)
def test_dsa_kernels_at_every_width(dev, n, c, p):
    """B5 at each width: against the plain versions at the tolerances of
    the default widths, two calls bit-equal, and one dsa_attention call
    one launch of each wrapper (test_dsa_every_width_is_three_device_launches
    reads the device kernels)."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h, bf = 4, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    a = _dsa_inputs(gen, dev, n, c, p, h)
    x, w, ef, gamma = a["x"], a["w"], a["ef"], a["gamma"]
    tok = (a["lns"], a["lnb"], a["pe"])
    temps = (a["t1"], a["t2"])
    ka = dk.dsa_phase_a(x, w, ef, *tok, h)
    wa = dk.dsa_phase_a_plain(x, w, ef, *tok, h)
    for name, g, w_ in zip(ka._fields, ka, wa):
        assert _rel(g, w_) < 2e-2, name
    for g, w_ in zip(ka, dk.dsa_phase_a(x, w, ef, *tok, h)):
        assert torch.equal(g, w_)
    glue = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps)
    for name, g, w_ in zip(glue._fields, glue,
                           dk.dsa_glue(wa, *temps, h, bf)):
        assert g.dtype == w_.dtype and _rel(g, w_) < 2e-2, name
    for g, w_ in zip(glue, dk.dsa_phase_a(x, w, ef, *tok, h,
                                          temperatures=temps)):
        assert torch.equal(g, w_)
    got = dk.dsa_phase_b(x, w, *glue, gamma, *tok, h)
    assert _rel(got, dk.dsa_phase_b_plain(x, w, *glue, gamma, *tok, h)) < 2e-2
    assert torch.equal(got, dk.dsa_phase_b(x, w, *glue, gamma, *tok, h))
    args = (x, w, ef, *temps, *tok, gamma, h)
    before = (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches)
    whole = dk.dsa_attention(*args)
    assert (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(whole, dk.dsa_reference(*args)) < 5e-2


DSA_KERNELS = ("dsa_phase_a_kernel", "dsa_phase_a_finish",
               "dsa_phase_b_kernel")


def test_dsa_every_width_is_three_device_launches(dev):
    """One dsa_attention call at each of DSA_WIDTHS launches phase A, its
    finishing pass and phase B (one count on each phase wrapper; phase A's
    one C call launches the sums kernel and the finishing pass), and no
    other device op (no aten op but allocations)."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    gen = torch.Generator(device=dev).manual_seed(23)
    calls = []
    for n, c, p in DSA_WIDTHS:
        a = _dsa_inputs(gen, dev, n, c, p, 4)
        calls.append((a["x"], a["w"], a["ef"], a["t1"], a["t2"], a["lns"],
                      a["lnb"], a["pe"], a["gamma"], 4))

    def every_width():
        for args in calls:
            dk.dsa_attention(*args)

    _only_kernels(every_width, [(dk.dsa_phase_a, len(DSA_WIDTHS)),
                                (dk.dsa_phase_b, len(DSA_WIDTHS))], "dsa",
                  DSA_KERNELS)


def test_dsa_attention_is_three_device_launches(dev):
    """One dsa_attention call on the card: phase A, its finishing pass and
    phase B (one count on each phase wrapper), and no other device op (no
    cast, copy or sum: no aten op but allocations)."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    gen = torch.Generator(device=dev).manual_seed(4)
    a = _dsa_inputs(gen, dev, 4096, 64, 64, 4)
    args = (a["x"], a["w"], a["ef"], a["t1"], a["t2"], a["lns"], a["lnb"],
            a["pe"], a["gamma"], 4)
    _only_kernels(lambda: dk.dsa_attention(*args),
                  [(dk.dsa_phase_a, 1), (dk.dsa_phase_b, 1)], "dsa",
                  DSA_KERNELS)


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


# the res blocks of SwinUNETR (feature size 24) and UNETR at their widths:
# (label, batch, grid, parts' widths, cout, B4's ci where an up block
# upsamples into the first part (coarse grid = grid / 2))
A7_BLOCKS = [
    ("swin enc0", 1, (128, 128, 128), (2,), 24, None),
    ("swin enc1", 4, (16, 24, 20), (24,), 24, None),
    ("swin d1", 2, (16, 16, 16), (48, 48), 48, 96),
    ("swin d2", 2, (16, 16, 16), (96, 96), 96, 192),
    ("swin d3", 4, (8, 8, 8), (192, 192), 192, 384),
    ("swin dec4", 4, (4, 4, 4), (384,), 384, None),
    ("swin out", 1, (64, 64, 64), (24, 24), 24, 24),
    ("unetr d4", 2, (16, 16, 16), (128, 128), 128, 768),
]


@pytest.mark.parametrize("label,batch,grid,parts_c,cout,ci", A7_BLOCKS,
                         ids=[b[0] for b in A7_BLOCKS])
def test_a7_block_kernels_match_plain(dev, label, batch, grid, parts_c,
                                      cout, ci):
    """A res block's kernels at UNETR's and SwinUNETR's widths, each
    against its plain version and counted once a call: B1's conv1 (the
    shortcut where the width changes) and conv2 (with the prologue), B2's
    finale (no pool), K1 per conv1 part and for conv2 and K2 (two calls
    bit-equal each; K2's d_ys, d_rs bit-equal to the plain version's), and
    B4 from the coarse grid where the block is an up block's (two calls
    bit-equal)."""
    from fcd_tpu_torch.kernels.block_conv import conv3x3, conv3x3_plain
    from fcd_tpu_torch.kernels.conv_wgrad import (
        conv3d_wgrad,
        conv3d_wgrad_plain,
    )
    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_grads_plain
    from fcd_tpu_torch.kernels.pool import finale_pool, finale_pool_plain
    from fcd_tpu_torch.kernels.upsample import upsample2x, upsample2x_plain

    gen = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16
    counters = (conv3x3, conv3d_wgrad, finale_pool, finale_bwd, upsample2x)
    before = [fn.launches for fn in counters]
    parts = [_randn(gen, dev, batch, *grid, c, dtype=bf) for c in parts_c]
    if ci is not None:
        coarse = tuple(g // 2 for g in grid)
        x = _randn(gen, dev, batch, *coarse, ci, dtype=bf)
        k = _randn(gen, dev, 2, 2, 2, ci, parts_c[0],
                   scale=(2.0 / (8 * parts_c[0])) ** 0.5)
        up = upsample2x(x, k)
        assert _rel(up, upsample2x_plain(x, k)) < 2e-2
        assert torch.equal(up, upsample2x(x, k))
        parts[0] = up
    std = (2.0 / (27 * cout)) ** 0.5
    w1 = [_randn(gen, dev, 3, 3, 3, c, cout, scale=std, dtype=bf)
          for c in parts_c]
    wr = ([_randn(gen, dev, c, cout, scale=0.3, dtype=bf) for c in parts_c]
          if sum(parts_c) != cout else None)
    o1 = conv3x3(parts, w1, shortcut=wr, want_stats=True)
    p1 = conv3x3_plain(parts, w1, shortcut=wr, want_stats=True)
    assert _rel(o1.y, p1.y) < 2e-2
    assert _rel(o1.ysum, p1.ysum) < 1e-3 and _rel(o1.ysq, p1.ysq) < 1e-3
    if wr is not None:
        assert _rel(o1.r, p1.r) < 2e-2 and _rel(o1.rsq, p1.rsq) < 1e-3
    pro = (torch.rand(batch, cout, generator=gen, device=dev) + 0.5,
           _randn(gen, dev, batch, cout, scale=0.1), 0.01)
    w2 = _randn(gen, dev, 3, 3, 3, cout, cout, scale=std, dtype=bf)
    o2 = conv3x3([o1.y], [w2], prologue=pro, want_stats=True)
    p2 = conv3x3_plain([o1.y], [w2], prologue=pro, want_stats=True)
    assert _rel(o2.y, p2.y) < 2e-2 and _rel(o2.ysq, p2.ysq) < 1e-3
    r = o1.r if wr is not None else parts[0]
    aff = [torch.rand(batch, cout, generator=gen, device=dev) + 0.5,
           _randn(gen, dev, batch, cout, scale=0.1),
           torch.rand(batch, cout, generator=gen, device=dev) + 0.5,
           _randn(gen, dev, batch, cout, scale=0.1)]
    out = finale_pool(o2.y, r, *aff, 0.01)
    assert _rel(out, finale_pool_plain(o2.y, r, *aff, 0.01)) < 1e-2
    gp = _randn(gen, dev, batch, *grid, cout, dtype=bf)
    got = finale_bwd(o2.y, r, *aff, gp, None, 0.01)
    want = finale_grads_plain(o2.y, r, *aff, gp, None, 0.01)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g_, w_ in zip(got[2:], want[2:]):
        assert _rel(g_, w_) < 1e-3
    for a, b in zip(got, finale_bwd(o2.y, r, *aff, gp, None, 0.01)):
        assert torch.equal(a, b)
    calls = [(o1.y, got[0], pro)] + [(p, gp, None) for p in parts]
    for xin, gin, pr in calls:
        dw = conv3d_wgrad(xin, gin, pr)
        # f32 sums over up to 2 x 16^3 voxels in another order than the
        # plain version's: chip_smoke.py's K1 tolerance (unetr d4 read
        # 2.2e-4 on an H100)
        assert _rel(dw, conv3d_wgrad_plain(xin, gin, pr)) < 1e-3
        assert torch.equal(dw, conv3d_wgrad(xin, gin, pr))
    torch.cuda.synchronize()
    ups = 2 if ci is not None else 0
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        2, 2 * len(calls), 1, 2, ups], label


@pytest.mark.parametrize("kernel", ["finale_bwd", "finale_bwd_pool",
                                    "finale_bwd_chain", "spatial_attn_bwd",
                                    "spatial_attn_bwd_level6",
                                    "spatial_attn_bwd_level4"])
def test_backward_sums_are_reproducible(dev, kernel):
    """K2's per-channel sums (its blocks' partial rows) and K4's dkpb and
    dvpb (and, split by head, dqn) are added over the blocks / token chunks
    in a fixed order: two launches on the same inputs give the same bits."""
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
        n, c, h, p = {"6": (64, 256, 4, 32), "4": (4096, 64, 4, 64)}.get(
            kernel[-1], (700, 32, 4, 64))
        qn = _randn(gen, dev, 2, n, c, scale=0.2, dtype=bf)
        kpb = _randn(gen, dev, 2, c, h * p, scale=0.5, dtype=bf)
        vpb = _randn(gen, dev, 2, h * p, c, dtype=bf)
        g = _randn(gen, dev, 2, n, c, dtype=bf)
        key = sa.dropout_key(99, 1)

        def call():
            return sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1)
    for a, b in zip(call(), call()):
        assert torch.equal(a, b)


# the 16-byte path (C % 8 == 0) and the general path (12)
FINALE_WIDTHS = [8, 12, 16, 24, 40, 64, 256, 512]


def _finale_inputs(gen, dev, c, inputs, pool, shape=(2, 6, 8, 10)):
    """`tied`: small integers through dyadic affines, exact in f32, so the
    pool's blocks hold exact ties; `random`: normal activations and random
    non-dyadic affines, whose preactivation rounds."""
    bf = torch.bfloat16
    b = shape[0]
    if inputs == "tied":
        ys = torch.randint(-2, 3, (*shape, c), generator=gen,
                           device=dev).to(bf)
        rs = torch.randint(-1, 2, (*shape, c), generator=gen,
                           device=dev).to(bf)
        aff = [torch.full((b, c), 0.5, device=dev),
               torch.randint(-8, 9, (b, c), generator=gen, device=dev) / 8.0,
               torch.ones(b, c, device=dev), torch.zeros(b, c, device=dev)]
    else:
        ys = _randn(gen, dev, *shape, c, dtype=bf)
        rs = _randn(gen, dev, *shape, c, dtype=bf)
        aff = [torch.rand(b, c, generator=gen, device=dev) + 0.5,
               _randn(gen, dev, b, c, scale=0.1),
               torch.rand(b, c, generator=gen, device=dev) + 0.5,
               _randn(gen, dev, b, c, scale=0.1)]
    gp = _randn(gen, dev, *shape, c, dtype=bf)
    gq = (_randn(gen, dev, b, *(v // 2 for v in shape[1:]), c, dtype=bf)
          if pool else None)
    return ys, rs, aff, gp, gq


@pytest.mark.parametrize("inputs", ["tied", "random"])
@pytest.mark.parametrize("c", FINALE_WIDTHS)
@pytest.mark.parametrize("pool", [False, True])
def test_finale_bwd_kernel_matches_plain(dev, pool, c, inputs):
    """d_ys and d_rs bit-equal to the plain version's (t without
    contraction, the same roundings); the sums within 1e-3 of their max."""
    from fcd_tpu_torch.kernels.finale import (
        finale_bwd,
        finale_grads_plain,
        plan_for,
    )

    gen = torch.Generator(device=dev).manual_seed(5)
    ys, rs, aff, gp, gq = _finale_inputs(gen, dev, c, inputs, pool)
    before = finale_bwd.launches
    got = finale_bwd(ys, rs, *aff, gp, gq, 0.01)
    want = finale_grads_plain(ys, rs, *aff, gp, gq, 0.01)
    torch.cuda.synchronize()
    assert finale_bwd.launches == before + 1
    for g_, w_ in zip(got[:2], want[:2]):
        assert g_.dtype == torch.bfloat16 and torch.equal(g_, w_)
    for g_, w_ in zip(got[2:], want[2:]):
        assert g_.dtype == torch.float32 and _rel(g_, w_) < 1e-3
    if not pool and c % 8 == 0:
        # the 16-byte path too: so small a call takes one channel a thread
        plan = plan_for(*ys.shape, "none", 8)
        got = finale_bwd(ys, rs, *aff, gp, gq, 0.01, plan=plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g_, w_ in zip(got[2:], want[2:]):
            assert _rel(g_, w_) < 1e-3


@pytest.mark.parametrize("inputs", ["tied", "random"])
@pytest.mark.parametrize("c", FINALE_WIDTHS)
def test_finale_bwd_chain_kernel_matches_plain(dev, c, inputs):
    """K2's `chain` tie split (levels 3-5): d_ys and d_rs bit-equal to the
    plain version's; on the tied inputs the sums to 1e-5 (they differ only
    in summation order) and the chain split differs from the even one."""
    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_grads_plain

    gen = torch.Generator(device=dev).manual_seed(6)
    ys, rs, aff, gp, gq = _finale_inputs(gen, dev, c, inputs, True)
    got = finale_bwd(ys, rs, *aff, gp, gq, 0.01, tie="chain")
    want = finale_grads_plain(ys, rs, *aff, gp, gq, 0.01, tie="chain")
    torch.cuda.synchronize()
    for g_, w_ in zip(got[:2], want[:2]):
        assert torch.equal(g_, w_)
    for g_, w_ in zip(got[2:], want[2:]):
        assert _rel(g_, w_) < (1e-5 if inputs == "tied" else 1e-3)
    if inputs == "tied":
        even = finale_grads_plain(ys, rs, *aff, gp, gq, 0.01, tie="even")
        assert not torch.equal(want[0], even[0])


@pytest.mark.parametrize("mode,vec", [("none", 8), ("none", 1),
                                      ("even", 1), ("chain", 1)])
def test_finale_bwd_every_instance_matches_plain(dev, mode, vec):
    """Each instance of the kernel in each mode it is built for, not only
    the plan's choice, with blocks that walk several tiles."""
    from fcd_tpu_torch.kernels import finale as k2

    gen = torch.Generator(device=dev).manual_seed(16)
    ys, rs, aff, gp, gq = _finale_inputs(gen, dev, 24, "random",
                                         mode != "none", (2, 16, 16, 16))
    tie = "even" if mode == "none" else mode
    plan = k2.plan_for(2, 16, 16, 16, 24, mode, vec, 2)
    assert plan.tiles_per_block > 1
    got = k2.finale_bwd(ys, rs, *aff, gp, gq, 0.01, tie, plan=plan)
    want = k2.finale_grads_plain(ys, rs, *aff, gp, gq, 0.01, tie)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g_, w_ in zip(got[2:], want[2:]):
        assert _rel(g_, w_) < 1e-3


def test_finale_bwd_refuses_a_plan_that_does_not_fit(dev):
    """A plan for another grid, or 8 channels a thread on tensors that are
    not 16-byte aligned, raises instead of reading past the tensors."""
    from fcd_tpu_torch.kernels import finale as k2

    gen = torch.Generator(device=dev).manual_seed(17)
    ys, rs, aff, gp, _ = _finale_inputs(gen, dev, 24, "random", False,
                                        (2, 16, 16, 16))
    with pytest.raises(ValueError, match="does not fit"):
        k2.finale_bwd(ys, rs, *aff, gp, None, 0.01,
                      plan=k2.plan_for(2, 32, 16, 16, 24, "none", 8))
    with pytest.raises(ValueError, match="does not fit"):
        k2.finale_bwd(ys, rs, *aff, gp, None, 0.01,
                      plan=k2.plan_for(2, 16, 16, 16, 24, "none", 8)._replace(
                          tiles=1))

    def shifted(t):   # the same values 2 bytes past a 16-byte boundary
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = out[1:].view(t.shape)
        out.copy_(t)
        return out

    plan = k2.plan_for(2, 16, 16, 16, 24, "none", 8)
    with pytest.raises(ValueError, match="aligned"):
        k2.finale_bwd(shifted(ys), rs, *aff, gp, None, 0.01, plan=plan)
    # without a plan it takes one channel a thread, and the same bits
    got = k2.finale_bwd(shifted(ys), rs, *aff, gp, None, 0.01)
    want = k2.finale_grads_plain(ys, rs, *aff, gp, None, 0.01)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_finale_bwd_takes_expanded_affines(dev):
    """A batch norm's (C,) affines expanded over the batch (stride 0) are
    read as they are."""
    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_grads_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    ys, rs, aff, gp, gq = _finale_inputs(gen, dev, 24, "random", True)
    aff = [a[:1].expand(2, -1) for a in aff[:2]] + aff[2:]
    got = finale_bwd(ys, rs, *aff, gp, gq, 0.01)
    want = finale_grads_plain(ys, rs, *aff, gp, gq, 0.01)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g_, w_ in zip(got[2:], want[2:]):
        assert _rel(g_, w_) < 1e-3


@pytest.mark.parametrize("block", ["instance, shortcut, pool",
                                   "transformer's batch norm, identity"])
def test_finale_backward_launches_only_k2(dev, block, monkeypatch):
    """One Finale.backward, as a block's backward calls it (the cotangents
    and the saved affines the graph gives it), launches K2's two kernels
    and no other device op: no cast, copy or sum."""
    import types

    from fcd_tpu_torch.kernels import finale
    from fcd_tpu_torch.ops.blocks import UnetResBlock

    gen = torch.Generator(device=dev).manual_seed(15)
    if block.startswith("instance"):
        blk, pool, cin, c = UnetResBlock(8, 16, "instance"), True, 8, 16
    else:
        blk, pool, cin, c = UnetResBlock(32, 32, "batch"), False, 32, 32
    blk.reset_parameters(torch.Generator().manual_seed(3))
    blk = blk.to(dev).train()
    x = _randn(gen, dev, 2, 8, 8, 8, cin, dtype=torch.bfloat16)
    calls, orig = [], finale.Finale.backward

    def recorded(ctx, *grads):
        calls.append((types.SimpleNamespace(
            saved_tensors=ctx.saved_tensors, slope=ctx.slope, pool=ctx.pool,
            tie=ctx.tie), grads))
        return orig(ctx, *grads)

    monkeypatch.setattr(finale.Finale, "backward", staticmethod(recorded))
    out = blk([x], pool=pool)
    outs = out if pool else (out,)
    sum((o.float() * _randn(gen, dev, *o.shape)).sum() for o in outs).backward()
    assert len(calls) == 1
    ctx, grads = calls[0]
    # the pooled output's cotangent where the block pools
    assert len(grads) == (2 if pool else 1)

    # one count on K2's wrapper, whose one C call launches its two kernels
    _only_kernels(lambda: orig(ctx, *grads), [(finale.finale_bwd, 1)],
                  "finale_bwd", ["finale_bwd_kernel", "finale_bwd_finish"])


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
    n, c, p, h = 700, 32, 64, 4
    d = _dsa_inputs(gen, dev, n, c, p, h)
    args = (d["x"], d["w"], d["ef"], d["lns"], d["lnb"], d["pe"], h)
    for g_, w_ in zip(dk.dsa_phase_a(*args), dk.dsa_phase_a(*args)):
        assert torch.equal(g_, w_)
    temps = (d["t1"], d["t2"])
    ops = dk.dsa_phase_a(*args, temperatures=temps)
    for g_, w_ in zip(ops, dk.dsa_phase_a(*args, temperatures=temps)):
        assert torch.equal(g_, w_)
    tok = (d["lns"], d["lnb"], d["pe"])
    assert torch.equal(dk.dsa_phase_b(d["x"], d["w"], *ops, d["gamma"], *tok, h),
                       dk.dsa_phase_b(d["x"], d["w"], *ops, d["gamma"], *tok, h))


@pytest.mark.parametrize("shape,roi,dtype", [
    ((10, 16, 8, 2), (8, 16, 8), torch.bfloat16),
    ((10, 12, 7, 2), (16, 16, 8), torch.bfloat16),
    ((9, 12, 7, 3), (16, 8, 8), torch.float32),
    # aligned: a float4 a unit, pad on every side, both output types
    ((12, 10, 8, 2), (16, 16, 16), torch.bfloat16),
    ((12, 10, 8, 2), (16, 16, 16), torch.float32),
    # an odd lead pad (bw = 1): a float2 a unit
    ((10, 9, 5, 2), (12, 12, 8), torch.bfloat16),
    ((10, 9, 5, 2), (12, 12, 8), torch.float32)])
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


@pytest.mark.parametrize("o", [1, 2, 3])
@pytest.mark.parametrize("start,size", [((0, 0, 0), (10, 12, 14)),
                                        ((1, 2, 3), (7, 9, 8)),
                                        ((1, 2, 3), (7, 9, 11)),
                                        ((2, 0, 2), (6, 12, 12))])
def test_sw_exit_kernel_matches_plain(dev, start, size, o):
    from fcd_tpu_torch.kernels.sw_io import sw_exit, sw_exit_plain

    gen = torch.Generator(device=dev).manual_seed(9)
    acc = _randn(gen, dev, 10, 12, 14, o)
    inv = torch.rand(10, 12, 14, 1, generator=gen, device=dev) + 0.1
    before = sw_exit.launches
    got = sw_exit(acc, inv, start, size)
    want = sw_exit_plain(acc, inv, start, size)
    torch.cuda.synchronize()
    assert sw_exit.launches == before + 1
    assert got.is_contiguous() and torch.equal(got, want)


# the four DSA levels' (N, C, P) at 4 heads, each also at a ragged N
SPATTN_SHAPES = [(32768, 32, 4, 64), (300, 32, 4, 64), (4096, 64, 4, 64),
                 (700, 64, 4, 64), (512, 128, 4, 64), (100, 128, 4, 64),
                 (64, 256, 4, 32), (70, 256, 4, 32)]


def _spattn_inputs(gen, dev, n, c, h, p, batch=2):
    """Dense kpb and vpb: the kernels take them as general matrices."""
    bf = torch.bfloat16
    return (_randn(gen, dev, batch, n, c, scale=0.2, dtype=bf),
            _randn(gen, dev, batch, c, h * p, scale=0.5, dtype=bf),
            _randn(gen, dev, batch, h * p, c, dtype=bf),
            _randn(gen, dev, batch, n, c, dtype=bf))


# the levels of a feature size 8, projection 16 model on a 32^3 patch, and
# the narrow and wide corners of the widths the kernels take
SPATTN_SMALL = [(512, 16, 4, 16), (64, 32, 4, 16), (8, 64, 4, 16),
                (1, 128, 4, 32), (100, 16, 1, 16), (100, 16, 2, 64),
                (70, 256, 2, 16), (70, 128, 4, 16)]


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
@pytest.mark.parametrize("n,c,h,p", [(512, 16, 4, 16), (70, 256, 2, 16)])
def test_spatial_attn_batch_offset(dev, n, c, h, p, dtype):
    """A data mesh's rank passes its first sample's global index
    (`offset`): K3 and K4 with an offset against the plain versions with
    the same offset, whose keep bits are rows offset.. of the full
    batch's; at a tensor-core and a wide shape, each operand type."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    dt = {"bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32}[dtype]
    gen = torch.Generator(device=dev).manual_seed(n + c)
    qn, kpb, vpb, g = (t.to(dt) for t in _spattn_inputs(gen, dev, n, c, h,
                                                        p, batch=2))
    key = sa.dropout_key(7, 3)
    full = sa.keep_mask(4, n, h * p, key, 0.1, dev)
    assert torch.equal(sa.keep_mask(2, n, h * p, key, 0.1, dev, offset=2),
                       full[2:])
    out = sa.spatial_attn_fwd(qn, kpb, vpb, h, key, 0.1, offset=2)
    assert _rel(out, sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, 0.1,
                                               offset=2)) < 2e-2
    assert not torch.equal(out, sa.spatial_attn_fwd(qn, kpb, vpb, h, key,
                                                    0.1))
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1, offset=2)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, 0.1, offset=2)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 2e-2


@pytest.mark.parametrize("n,c,h,p,rate", [
    (n, c, h, p, rate) for n, c, h, p in SPATTN_SHAPES for rate in (0.0, 0.1)]
    + [(300, 32, 2, 64, 0.1), (300, 32, 8, 64, 0.1)]
    + [(n, c, h, p, 0.1) for n, c, h, p in SPATTN_SMALL])
def test_spatial_attn_kernels_match_plain(dev, n, c, h, p, rate):
    """Equal dropout masks: the outputs agree to bf16 rounding. Two and
    eight heads too: a K4 block then owns two of two heads (the whole row)
    or four of eight (f32 dqn partials of two head groups); and the
    narrower widths, where a K4 block's sums have fewer tiles than warps."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    gen = torch.Generator(device=dev).manual_seed(6)
    qn, kpb, vpb, g = _spattn_inputs(gen, dev, n, c, h, p)
    key = sa.dropout_key(1234, 5)
    assert _rel(sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate),
                sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate)) < 2e-2
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and _rel(g_, w_) < 2e-2


@pytest.mark.parametrize("n,c,h,p", [(4096, 64, 4, 64), (512, 128, 4, 64)])
def test_spatial_attn_bwd_writes_the_asked_dtype(dev, n, c, h, p):
    """The finishing pass writes dkpb and dvpb in bf16 when asked: the f32
    sums rounded once."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    gen = torch.Generator(device=dev).manual_seed(13)
    qn, kpb, vpb, g = _spattn_inputs(gen, dev, n, c, h, p)
    key = sa.dropout_key(7, 2)
    f32 = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1)
    bf = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1,
                             dtypes=(torch.bfloat16, torch.bfloat16))
    assert torch.equal(f32[0], bf[0])
    for a, b in zip(f32[1:], bf[1:]):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)


def test_spatial_attn_launches_only_its_kernels(dev):
    """One K3 call is one device kernel; one K4 call is its product kernel
    and its finishing pass (one count on the wrapper, whose one C call
    launches them), with no other device op (no sum or cast: no aten op
    but allocations)."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    gen = torch.Generator(device=dev).manual_seed(14)
    for n, c, h, p in SPATTN_SHAPES[::2]:
        qn, kpb, vpb, g = _spattn_inputs(gen, dev, n, c, h, p)
        key = sa.dropout_key(5, 1)
        assert not sa.spatial_attn_plan(n, c, p, h, qn.shape[0]).wide
        for call, fn, want in (
                (lambda: sa.spatial_attn_fwd(qn, kpb, vpb, h, key, 0.1),
                 sa.spatial_attn_fwd, ["spatial_attn_fwd_kernel"]),
                (lambda: sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1),
                 sa.spatial_attn_bwd,
                 ["spatial_attn_bwd_kernel", "spatial_attn_bwd_finish"]),
                (lambda: sa.spatial_attn_bwd(
                    qn, kpb, vpb, g, h, key, 0.1,
                    dtypes=(torch.bfloat16, torch.bfloat16)),
                 sa.spatial_attn_bwd,
                 ["spatial_attn_bwd_kernel", "spatial_attn_bwd_finish"])):
            _only_kernels(call, [(fn, 1)], "spatial_attn", want)


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


def test_column_parallel_grads_on_the_card(dev):
    """B1 and B4 as column-parallel ops (`grad_sum`, ROADMAP C23) on a
    model axis of one: x's gradient through B1's partial instance (f32)
    plus the shortcut's f32 term, then the sum (here the identity), then
    one rounding; and the prologue's backward on that sum. Against
    autograd through the plain versions, as the one-device op is held;
    the partial instance counted once per part, B1 not at all, in the
    backward."""
    from fcd_tpu_torch.kernels.block_conv import (
        conv3x3,
        conv3x3_op,
        conv3x3_partial,
        conv3x3_plain,
    )
    from fcd_tpu_torch.kernels.upsample import upsample2x_op, upsample2x_plain

    gen = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    sums = []

    def grad_sum(t):
        sums.append(t.dtype)
        return t

    x0 = _randn(gen, dev, 1, 6, 8, 6, 12, dtype=bf)
    x1 = _randn(gen, dev, 1, 6, 8, 6, 12, dtype=bf)
    w0, w1 = (_randn(gen, dev, 3, 3, 3, 12, 12, scale=0.2) for _ in "ab")
    r0, r1 = (_randn(gen, dev, 12, 12, scale=0.3) for _ in "ab")

    def run(conv, **kw):
        def f(a, b, wa, wb, ra, rb):
            o = conv([a, b], [wa, wb], shortcut=[ra, rb], want_stats=True,
                     **kw)
            return o.y, o.ysum, o.ysq, o.r, o.rsum, o.rsq
        return _grads(f, [x0, x1, w0, w1, r0, r1])

    b1, part = conv3x3.launches, conv3x3_partial.launches
    (_, got), (_, want) = run(conv3x3_op, grad_sum=grad_sum), \
        run(conv3x3_plain)
    assert conv3x3.launches - b1 == 1          # the forward
    assert conv3x3_partial.launches - part == 2    # one dx a part
    assert sums == [torch.float32] * 2
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2
    sc = torch.rand(1, 12, generator=gen, device=dev) + 0.5
    sh = _randn(gen, dev, 1, 12, scale=0.1)

    def run_pro(conv, **kw):
        def f(a, wa, s, t):
            o = conv([a], [wa], prologue=(s, t, 0.01), want_stats=True,
                     **kw)
            return o.y, o.ysum, o.ysq
        return _grads(f, [x0, w0, sc, sh])

    (_, got), (_, want) = run_pro(conv3x3_op, grad_sum=grad_sum), \
        run_pro(conv3x3_plain)
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2
    x = _randn(gen, dev, 1, 3, 5, 4, 24, dtype=bf)
    k = _randn(gen, dev, 2, 2, 2, 24, 12, scale=0.2)
    (_, got) = _grads(lambda a, b: upsample2x_op(a, b, grad_sum=grad_sum),
                      [x, k])
    (_, want) = _grads(upsample2x_plain, [x, k])
    assert sums[-1] == torch.float32
    for g_, w_ in zip(got, want):
        assert _rel(g_, w_) < 3e-2


# the zoo's shard widths under tensor parallelism over 2 ranks at the
# factory's widths (ROADMAP A9): SwinUNETR (feature size 24) splits its
# res blocks to 12 channels a rank, UNETR's d4 upsamples 768 -> 128 / 2,
# a SegResNet ResBlock's conv1 takes its prologue on the whole input
@pytest.mark.parametrize("kind,parts_c,cout,grid,extra", [
    ("b1", (2,), 12, (1, 6, 10, 7), "shortcut"),          # swin enc0.conv1
    ("b1", (24, 24), 12, (1, 6, 10, 7), "shortcut"),      # swin out.conv1
    ("b1", (16,), 8, (1, 6, 10, 7), "prologue"),          # segres conv1
    ("partial", (12,), 24, (1, 6, 10, 7), "prologue"),    # swin conv2
    ("partial", (12,), 24, (1, 6, 10, 7), None),          # its dgrad (C23)
    ("partial", (8,), 16, (1, 6, 10, 7), None),           # dec1's dgrad
    ("k1", (24,), 12, (1, 6, 10, 7), None),               # swin out.conv1
    ("k1", (12,), 24, (1, 6, 10, 7), "prologue"),         # swin conv2
    ("b4", (24,), 12, (1, 3, 5, 4), None),                # swin out
    ("b4", (768,), 64, (1, 2, 2, 2), None)])              # unetr d4
def test_tp_zoo_shard_widths_match_plain(dev, kind, parts_c, cout, grid,
                                         extra):
    """B1, its partial instance, K1 and B4 at the zoo's shard widths,
    each against its plain version, counted once a call."""
    from fcd_tpu_torch.kernels import block_conv as bc
    from fcd_tpu_torch.kernels.conv_wgrad import (
        conv3d_wgrad,
        conv3d_wgrad_plain,
    )
    from fcd_tpu_torch.kernels.upsample import upsample2x, upsample2x_plain

    gen = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    parts = [_randn(gen, dev, *grid, c, dtype=bf) for c in parts_c]
    c0 = parts_c[0]
    pro = None
    if extra == "prologue":
        pro = (torch.rand(grid[0], c0, generator=gen, device=dev) + 0.5,
               _randn(gen, dev, grid[0], c0, scale=0.1), 0.01)
    if kind == "b4":
        k = _randn(gen, dev, 2, 2, 2, c0, cout, scale=0.2)
        fn, counter = (lambda: upsample2x(parts[0], k)), upsample2x
        want, tol = upsample2x_plain(parts[0], k), 2e-2
    elif kind == "k1":
        g = _randn(gen, dev, *grid, cout, dtype=bf)
        fn = lambda: conv3d_wgrad(parts[0], g, pro)   # noqa: E731
        counter, tol = conv3d_wgrad, 1e-4
        want = conv3d_wgrad_plain(parts[0], g, pro)
    else:
        ws = [_randn(gen, dev, 3, 3, 3, c, cout, scale=0.2, dtype=bf)
              for c in parts_c]
        if kind == "partial":
            fn = lambda: bc.conv3x3_partial(parts[0], ws[0], pro)  # noqa
            counter, tol = bc.conv3x3_partial, 1e-4
            want = bc.conv3x3_partial_plain(parts[0], ws[0], pro)
        else:
            kw = dict(prologue=pro, want_stats=True, shortcut=(
                [_randn(gen, dev, c, cout, scale=0.3, dtype=bf)
                 for c in parts_c] if extra == "shortcut" else None))
            fn = lambda: bc.conv3x3(parts, ws, **kw).y    # noqa: E731
            counter, tol = bc.conv3x3, 2e-2
            want = bc.conv3x3_plain(parts, ws, **kw).y
    before = counter.launches
    got = fn()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == want.shape
    assert _rel(got, want) < tol


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


def _train_step_launches_every_kernel(dev, **widths):
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
    params.update(patch_size=32, loss="DiceCELoss", **widths)
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


def test_train_step_on_the_card(dev):
    """A small MS_DSA_NET train step in bf16: finite, falling losses, and
    every kernel of the train path launched."""
    _train_step_launches_every_kernel(dev, feature_size=8, project_size=16)


def test_train_step_on_the_card_at_default_widths(dev):
    """The same at the default feature and projection sizes: K3 and K4 at
    the default model's (C, P) per level."""
    _train_step_launches_every_kernel(dev)


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


def _tied(gen, dev, shape):
    """Small integers in bf16: the 2x2x2 blocks hold exact ties."""
    return torch.randint(-3, 4, shape, generator=gen, device=dev).to(
        torch.bfloat16)


@pytest.mark.parametrize("shape,tied,vec", [
    ((4, 128, 128, 128, 16), True, 4),    # enc1 in the gated train step
    ((4, 64, 64, 64, 32), False, 4),      # enc2
    ((4, 64, 64, 64, 32), True, 4),
    ((2, 6, 8, 10, 24), True, 4),
    ((2, 4, 6, 8, 6), True, 2),           # C % 8 != 0
    ((1, 4, 4, 4, 5), True, 1)])
def test_max_pool2x_bwd_kernel_is_bit_equal(dev, shape, tied, vec):
    """B9 (csrc/pool2x_bwd.cu) bit-equal to its plain version: at the
    gated train step's two shapes, on tied and on random inputs, and at
    the narrower channel widths; one launch a call, with the plan's
    channel width."""
    from fcd_tpu_torch.kernels.pool2x import (
        max_pool2x_bwd,
        max_pool2x_bwd_plain,
        pool2x_bwd_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(13)
    b, d, h, w, c = shape
    x = (_tied(gen, dev, shape) if tied
         else _randn(gen, dev, *shape, dtype=torch.bfloat16))
    g = _randn(gen, dev, b, d // 2, h // 2, w // 2, c, dtype=torch.bfloat16)
    assert pool2x_bwd_plan(b, d, h, w, c).vec == vec
    before = max_pool2x_bwd.launches
    dx = max_pool2x_bwd(x, g)
    torch.cuda.synchronize()
    assert max_pool2x_bwd.launches == before + 1
    assert torch.equal(dx, max_pool2x_bwd_plain(x, g))
    assert torch.equal(dx, max_pool2x_bwd(x, g))


def test_max_pool2x_bwd_kernel_under_every_plan(dev):
    """Each channel width and block count the plan takes gives the plain
    version's bits, NaN blocks and signed zeros included."""
    from fcd_tpu_torch.kernels.pool2x import (
        BUILT,
        max_pool2x_bwd,
        max_pool2x_bwd_plain,
        plan_for,
    )

    gen = torch.Generator(device=dev).manual_seed(14)
    shape = (2, 8, 12, 16, 16)
    x = _tied(gen, dev, shape)
    x[0, 0, 0, 0, :3] = float("nan")
    x[1, 2:4, 2:4, 2:4, 5] = 0.0
    x[1, 2, 2, 2, 5] = -0.0
    g = _randn(gen, dev, 2, 4, 6, 8, 16, dtype=torch.bfloat16)
    g[0, 1, 1, 1, 0] = -0.0
    want = max_pool2x_bwd_plain(x, g)
    for vec in BUILT:
        for blocks in (1, 3, 7, 1000):
            plan = plan_for(*shape, vec, blocks)
            assert torch.equal(max_pool2x_bwd(x, g, plan=plan), want), plan


def test_max_pool2x_bwd_kernel_refuses_what_it_cannot_take(dev):
    """A CUDA tensor the kernel does not take raises: another dtype, a
    non-contiguous view, a plan of another shape, an 8-byte plan on a
    tensor that is not 8-byte aligned."""
    from fcd_tpu_torch.kernels.pool2x import max_pool2x_bwd, plan_for

    bf = torch.bfloat16
    x = torch.zeros(1, 4, 4, 4, 16, device=dev, dtype=bf)
    g = torch.zeros(1, 2, 2, 2, 16, device=dev, dtype=bf)
    with pytest.raises(TypeError, match="bf16"):
        max_pool2x_bwd(x.float(), g.float())
    with pytest.raises(ValueError, match="contiguous"):
        max_pool2x_bwd(x.transpose(1, 2), g)
    with pytest.raises(ValueError, match="does not fit"):
        max_pool2x_bwd(x, g, plan=plan_for(1, 8, 4, 4, 16, 4))
    buf = torch.zeros(1 + x.numel(), device=dev, dtype=bf)
    xu = buf[1:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        max_pool2x_bwd(xu, g, plan=plan_for(1, 4, 4, 4, 16, 4))
    # without a plan the unaligned view takes one channel a thread
    assert torch.equal(max_pool2x_bwd(xu, g), torch.zeros_like(x))


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


def test_inference_at_feature_size_8(dev):
    """ModelTrainer.inference on the card at feature size 8, project size
    16 (the eval DSA at head width 4 and P 16): finite logits of the
    volume's shape through B5, and one patch against the port's fp32 CPU
    forward from the same weights at chip_smoke.py's patch tolerances (the
    DSA blocks' gamma and pos-embed redrawn so that they count, as there).
    Late in the file: it compiles Triton kernels at new widths, and after a
    compile in this process the card's profiler came back empty (PERF.md
    section 7)."""
    import copy

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.kernels import dsa_attention as dk
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params.update(patch_size=64, feature_size=8, project_size=16)
    tr = ModelTrainer(params, device=dev)
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for stack in tr.model.transformers:
            for blk in stack:
                blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape,
                                                  generator=gen))
                blk.pos_embed.copy_(0.1 * torch.randn(blk.pos_embed.shape,
                                                      generator=gen))
    vol = torch.randn(70, 80, 66, 2, generator=gen)
    before = (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches)
    logits = tr.inference(vol.numpy())
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (70, 80, 66, 2)
    assert bool(torch.isfinite(logits).all())
    assert dk.dsa_phase_a.launches > before[0]
    assert dk.dsa_phase_b.launches > before[1]
    patch = vol[None, :64, :64, :64]
    with torch.no_grad():
        got = tr.model(patch.to(dev)).float().cpu()
        cpu_model = copy.deepcopy(tr.model).cpu()
        cpu_model.compute_dtype = torch.float32
        want = cpu_model(patch).float()
    assert _rel(got, want) < 0.05
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) >= 0.99


def _other_model_widths():
    """The (N, C, P) of MS_DSA_NET's DSA levels with 4 heads at feature
    sizes 4-32 and project sizes 16-128 (level 6 takes P 32), one for each
    (C, P) that DSA_WIDTHS and the default levels leave out, at the
    largest of its levels' 128^3 token counts (C16)."""
    out = {}
    for fs in (4, 8, 16, 32):
        for ps in (16, 32, 64, 128):
            for n, c, p in ((32768, 2 * fs, ps), (4096, 4 * fs, ps),
                            (512, 8 * fs, ps), (64, 16 * fs, 32)):
                out[(c, p)] = max(out.get((c, p), 0), n)
    seen = {(c, p) for _, c, p in DSA_WIDTHS} | {
        (32, 64), (64, 64), (128, 64), (256, 32)}
    return sorted((n, c, p) for (c, p), n in out.items()
                  if (c, p) not in seen)


@pytest.mark.parametrize("n,c,p", _other_model_widths())
def test_dsa_kernels_at_the_other_widths(dev, n, c, p):
    """With DSA_WIDTHS and the default levels, every (C, P) of the model
    (C16): the same checks as test_dsa_kernels_at_every_width."""
    test_dsa_kernels_at_every_width(dev, n, c, p)



# -- the DSA family (sa_types, C15's widths, SegResNet_DSA) -------------------

@pytest.mark.parametrize("sa_type", ["serial", "spatial", "channel"])
@pytest.mark.parametrize("n,c,p", [(4096, 64, 64), (700, 128, 64),
                                   (300, 8, 16), (64, 512, 128)])
def test_dsa_modes_match_plain(dev, sa_type, n, c, p):
    """B5 in the other sa_types: phase A (with and without the finishing
    pass) and phase B against their plain versions, two calls bit-equal,
    and one dsa_attention call one launch of each phase wrapper ('channel':
    P = 0, no EF). That a call is exactly the three B5 device kernels in
    every type is chip_smoke.py's check (a profiler trace, which the card
    drops at times: PERF.md section 7)."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h, bf = 4, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(31)
    ns = dk.num_slots(sa_type)
    x = _randn(gen, dev, 1, n, c, dtype=bf)
    w = _randn(gen, dev, c, ns * c, scale=(6.0 / ((ns + 1) * c)) ** 0.5)
    ef = (None if sa_type == "channel"
          else _randn(gen, dev, n, p, scale=p ** -0.5))
    t1 = torch.rand(h, 1, 1, generator=gen, device=dev) + 0.5
    t2 = torch.rand(h, 1, 1, generator=gen, device=dev) + 0.5
    tok = (1.0 + _randn(gen, dev, c, scale=0.1), _randn(gen, dev, c, scale=0.1),
           _randn(gen, dev, n, c, scale=0.1))
    gamma = _randn(gen, dev, c)
    mode = dict(sa_type=sa_type)
    ka = dk.dsa_phase_a(x, w, ef, *tok, h, **mode)
    wa = dk.dsa_phase_a_plain(x, w, ef, *tok, h, **mode)
    for g_, w_ in zip(ka, wa):
        assert g_.shape == w_.shape
        if g_.numel():
            assert _rel(g_, w_) < 2e-2
    ops = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=(t1, t2), **mode)
    again = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=(t1, t2), **mode)
    assert all(torch.equal(a, b) for a, b in zip(ops, again))
    for g_, w_ in zip(ops, dk.dsa_glue(wa, t1, t2, h, bf)):
        if g_.numel():
            assert _rel(g_, w_) < 2e-2
    out = dk.dsa_phase_b(x, w, *ops, gamma, *tok, h, **mode)
    assert torch.equal(out, dk.dsa_phase_b(x, w, *ops, gamma, *tok, h,
                                           **mode))
    assert _rel(out, dk.dsa_phase_b_plain(x, w, *ops, gamma, *tok, h,
                                          **mode)) < 2e-2
    args = (x, w, ef, t1, t2, *tok, gamma, h)
    assert _rel(dk.dsa_attention(*args, **mode),
                dk.dsa_reference(*args, **mode)) < 5e-2
    before = (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches)
    dk.dsa_attention(*args, **mode)
    assert (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches) == (
        before[0] + 1, before[1] + 1)


def _c15_shapes():
    from fcd_tpu_torch.kernels import spatial_attn as sa

    return [(100, c, p) for c, p in sa.SHAPES_WIDE]


@pytest.mark.parametrize("n,c,p", _c15_shapes())
def test_spatial_attn_at_every_c15_width(dev, n, c, p):
    """C15: K3 and K4 take every (C, P) of B5's set at 4 heads; the wide
    instances against the plain versions with dropout, two calls
    bit-equal, each call one count on its wrapper's counter, and the
    library's SASS holds the wide kernels (K3's, and K4's row blocks and
    token sums, each on the tensor cores) and the finishing pass."""
    from chip_smoke import SPATTN_WIDE_KERNELS, _sass_functions
    from fcd_tpu_torch.kernels import spatial_attn as sa

    h = 4
    gen = torch.Generator(device=dev).manual_seed(c + p)
    qn, kpb, vpb, g = _spattn_inputs(gen, dev, n, c, h, p, batch=4)
    key = sa.dropout_key(99, 4)
    assert sa.spatial_attn_plan(n, c, p, h, 4).wide
    before = (sa.spatial_attn_fwd.launches, sa.spatial_attn_bwd.launches)
    out = sa.spatial_attn_fwd(qn, kpb, vpb, h, key, 0.1)
    assert torch.equal(out, sa.spatial_attn_fwd(qn, kpb, vpb, h, key, 0.1))
    assert _rel(out, sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                               0.1)) < 2e-2
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1)
    again = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, 0.1)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, 0.1)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        assert g_.dtype == w_.dtype and _rel(g_, w_) < 2e-2
    assert (sa.spatial_attn_fwd.launches, sa.spatial_attn_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    fns = _sass_functions("spatial_attn", lambda f: True)
    for k in SPATTN_WIDE_KERNELS:
        mine = [tc for f, tc in fns.items() if k in f]
        assert mine and (k == "spatial_attn_bwd_finish" or all(mine)), (k,
                                                                         mine)


def test_segresnet_dsa_patch_forward_on_the_card(dev):
    """SegResNet_DSA at full width (fs16, P 64) on a 64^3 patch: the card's
    logits (B1, B2, B5) against the port's fp32 CPU forward from the same
    weights at chip_smoke.py's patch tolerances, the DSA blocks' gamma
    and pos-embed redrawn so that they count."""
    import copy

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.kernels import dsa_attention as dk
    from fcd_tpu_torch.ops.attention import TransformerBlock
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params.update(model_type="SegResNet_DSA", patch_size=64)
    tr = ModelTrainer(params, device=dev, verbose=False)
    gen = torch.Generator().manual_seed(23)
    with torch.no_grad():
        for blk in tr.model.modules():
            if isinstance(blk, TransformerBlock):
                blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape,
                                                  generator=gen))
                blk.pos_embed.copy_(0.1 * torch.randn(blk.pos_embed.shape,
                                                      generator=gen))
    patch = torch.randn(1, 64, 64, 64, 2, generator=gen)
    before = dk.dsa_phase_b.launches
    got = tr.predict(patch.to(dev)).float().cpu()
    torch.cuda.synchronize()
    assert dk.dsa_phase_b.launches == before + 6
    with torch.no_grad():
        cpu_model = copy.deepcopy(tr.model).cpu()
        cpu_model.compute_dtype = torch.float32
        want = cpu_model(patch).float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) < 0.05
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.99


# -- C18: the f32 route (use_amp=False) ---------------------------------------

# B5's and K3/K4's f32 instances against their plain versions: the same
# function in f32 on both sides, sums taken in another order; chip_smoke.py
# holds them to rel 1e-5 of max |out|
F32_REL = 1e-5
# (N, C, P): the four levels of a 128^3 patch at fs16, a ragged N, the
# widest and narrowest heads, P 16 and 128, UNETR++'s levels
DSA_F32_SHAPES = [(32768, 32, 64), (4096, 64, 64), (512, 128, 64),
                  (64, 256, 32), (300, 32, 64), (64, 512, 32),
                  (4096, 8, 16), (512, 256, 128), (4096, 64, 128)]


def _f32_dsa_args(gen, dev, n, c, p, h, sa_type="parallel"):
    from fcd_tpu_torch.kernels import dsa_attention as dk

    a = _dsa_inputs(gen, dev, n, c, p, h)
    ns = dk.num_slots(sa_type)
    w = a["w"][:, :ns * c].contiguous()
    ef = None if sa_type == "channel" else a["ef"]
    return a["x"].float(), w, ef, a


@pytest.mark.parametrize("sa_type", ["parallel", "serial", "spatial",
                                     "channel"])
@pytest.mark.parametrize("n,c,p", DSA_F32_SHAPES)
def test_dsa_f32_kernels_match_plain(dev, n, c, p, sa_type):
    """B5's f32 instances: phase A's sums, the finishing pass and phase B
    against the plain versions at F32_REL, the whole op against the f32
    reference, two calls bit-equal, counted apart from the bf16 kernels
    (chip_smoke.py reads their three device kernels by profiler)."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h = 4
    gen = torch.Generator(device=dev).manual_seed(n + c + p)
    x, w, ef, a = _f32_dsa_args(gen, dev, n, c, p, h, sa_type)
    tok = (a["lns"], a["lnb"], a["pe"])
    temps = (a["t1"], a["t2"])
    mode = dict(sa_type=sa_type)
    bf16_before = (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches)
    before = (dk.PHASE_A_F32.launches, dk.PHASE_B_F32.launches)
    ka = dk.dsa_phase_a(x, w, ef, *tok, h, **mode)
    wa = dk.dsa_phase_a_plain(x, w, ef, *tok, h, **mode)
    for name, g, w_ in zip(ka._fields, ka, wa):
        if g.numel():
            assert g.dtype == torch.float32 and _rel(g, w_) < F32_REL, name
    glue = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps, **mode)
    for name, g, w_ in zip(glue._fields, glue,
                           dk.dsa_glue(wa, *temps, h, torch.float32)):
        if g.numel():
            assert g.dtype == torch.float32 and _rel(g, w_) < F32_REL, name
    for g, w_ in zip(glue, dk.dsa_phase_a(x, w, ef, *tok, h,
                                          temperatures=temps, **mode)):
        assert torch.equal(g, w_)
    got = dk.dsa_phase_b(x, w, *glue, a["gamma"], *tok, h, **mode)
    assert got.dtype == torch.float32
    assert _rel(got, dk.dsa_phase_b_plain(x, w, *glue, a["gamma"], *tok, h,
                                          **mode)) < F32_REL
    assert torch.equal(got, dk.dsa_phase_b(x, w, *glue, a["gamma"], *tok,
                                           h, **mode))
    args = (x, w, ef, *temps, *tok, a["gamma"], h)
    assert _rel(dk.dsa_attention(*args, **mode),
                dk.dsa_reference(*args, **mode)) < F32_REL
    assert (dk.PHASE_A_F32.launches, dk.PHASE_B_F32.launches) == (
        before[0] + 4, before[1] + 3)
    assert (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches) == bf16_before


# (N, C, P) where the f32 plans differ: level 3 (two heads a phase B
# block), a ragged N at level 3's widths, level 6 (column groups), head
# width 4 with four heads a block, head width 2, P 128
DSA_F32_PLAN_SHAPES = [(32768, 32, 64), (300, 32, 64), (64, 256, 32),
                       (4096, 16, 16), (2048, 8, 16), (512, 128, 128)]


@pytest.mark.parametrize("sa_type", ["parallel", "serial", "channel"])
@pytest.mark.parametrize("n,c,p", DSA_F32_PLAN_SHAPES)
def test_dsa_f32_kernels_under_every_plan(dev, n, c, p, sa_type):
    """B5's f32 instances under every plan `plan_for_f32` takes at the
    shape (token tiles, chunk lengths, column groups for phase A, heads a
    phase B block): phase B's operands and its output against the plain
    versions at F32_REL, so each path of the kernels (resident or
    streamed weights, tokens split over the warps for the sums or not,
    whole rows a warp in phase B or not) is held, not only the chosen
    plan's."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h = 4
    gen = torch.Generator(device=dev).manual_seed(n + c + p + 1)
    x, w, ef, a = _f32_dsa_args(gen, dev, n, c, p, h, sa_type)
    tok = (a["lns"], a["lnb"], a["pe"])
    temps = (a["t1"], a["t2"])
    mode = dict(sa_type=sa_type)
    pp = 0 if sa_type == "channel" else p
    want_ops = dk.dsa_glue(dk.dsa_phase_a_plain(x, w, ef, *tok, h, **mode),
                           *temps, h, torch.float32)
    seen = set()
    for tile in dk.TILES_F32:
        for per_chunk in (1, 4):
            for groups in (1, 2, 8):
                for hb in (1, 2, 4):
                    try:
                        plan = dk.plan_for_f32(n, c, pp, h, 1, tile,
                                               per_chunk, groups, hb)
                    except ValueError:
                        continue
                    if plan in seen:
                        continue
                    seen.add(plan)
                    ops = dk.dsa_phase_a(x, w, ef, *tok, h,
                                         temperatures=temps, plan=plan,
                                         **mode)
                    for name, g_, w_ in zip(ops._fields, ops, want_ops):
                        if g_.numel():
                            assert _rel(g_, w_) < F32_REL, (plan, name)
                    got = dk.dsa_phase_b(x, w, *ops, a["gamma"], *tok, h,
                                         plan=plan, **mode)
                    want = dk.dsa_phase_b_plain(x, w, *ops, a["gamma"],
                                                *tok, h, **mode)
                    assert _rel(got, want) < F32_REL, plan
    assert len(seen) >= 2


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,c,p", [(32768, 32, 64), (4096, 64, 64),
                                   (512, 128, 64), (64, 256, 32),
                                   (300, 8, 16), (512, 256, 128),
                                   (64, 512, 128)])
def test_spatial_attn_f32_kernels_match_plain(dev, n, c, p, rate):
    """K3/K4's f32 instances (the wide kernels on f32 operands) against
    the plain versions with the same dropout bits, two calls bit-equal,
    dqn, dkpb and dvpb in f32, counted apart from the bf16 kernels
    (chip_smoke.py reads their device kernels by profiler)."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    h = 4
    gen = torch.Generator(device=dev).manual_seed(c * p + n)
    qn, kpb, vpb, g = (t.float() for t in _spattn_inputs(gen, dev, n, c, h,
                                                         p, batch=4))
    key = sa.dropout_key(17, 3)
    before = (sa.FWD_F32.launches, sa.BWD_F32.launches,
              sa.spatial_attn_fwd.launches)
    out = sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate)
    assert out.dtype == torch.float32
    assert torch.equal(out, sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate))
    assert _rel(out, sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                               rate)) < F32_REL
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
    again = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    for name, g_, a_, w_ in zip(("dqn", "dkpb", "dvpb"), got, again, want):
        assert torch.equal(g_, a_), name
        assert g_.dtype == torch.float32 and _rel(g_, w_) < F32_REL, name
    assert (sa.FWD_F32.launches, sa.BWD_F32.launches,
            sa.spatial_attn_fwd.launches) == (before[0] + 2, before[1] + 2,
                                               before[2])


def test_f32_route_conv_is_ieee_f32(dev):
    """A trainer built with use_amp=False holds to IEEE f32 in its
    `numerics` scope and leaves the process's TF32 flags as they were:
    inside it an f32-route conv (cuDNN) against an f64 conv stays under
    1e-5 relative, which TF32's ~1e-3 would not."""
    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.ops.layers import conv3d
    from fcd_tpu_torch.train.trainer import ModelTrainer

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    params = get_default_params()
    params.update(use_amp=False, patch_size=32, feature_size=4,
                  project_size=16)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _randn(gen, dev, 1, 32, 32, 32, 64)
    k = _randn(gen, dev, 3, 3, 3, 64, 64, scale=0.05)
    want = conv3d(x.double(), k.double())
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        trainer = ModelTrainer(params, device=dev, verbose=False)
        assert cudnn.allow_tf32 and matmul.allow_tf32
        with trainer.numerics():
            assert not (cudnn.allow_tf32 or matmul.allow_tf32)
            got = conv3d(x, k)
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("model_type", ["MS_DSA_NET", "unetrpp"])
def test_f32_route_launches_no_bf16_kernel(dev, model_type):
    """use_amp=False on the card: a patch forward and a train step launch
    B5's and K3/K4's f32 instances and none of the bf16-only kernels, and
    the patch matches the f32 CPU route of the same weights."""
    import copy

    from chip_smoke import counters, read_counts, reset_counts
    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params.update(model_type=model_type, use_amp=False, patch_size=64)
    tr = ModelTrainer(params, device=dev, verbose=False)
    patch = torch.randn(1, 64, 64, 64, 2, generator=torch.Generator()
                        .manual_seed(4))
    reset_counts()
    got = tr.predict(patch.to(dev)).float().cpu()
    fwd = read_counts()
    with torch.no_grad():
        cpu = copy.deepcopy(tr.model).cpu().eval()
        want = cpu(patch)
    x = torch.rand(2, 64, 64, 64, 2, device=dev)
    y = (torch.rand(2, 64, 64, 64, 1, device=dev) > 0.95).float()
    reset_counts()
    loss = float(tr.train_step(x, y, 1e-4))
    step = read_counts()
    tb = 12 if model_type == "MS_DSA_NET" else 21
    f32 = {"dsa_phase_a_f32", "dsa_phase_b_f32", "spatial_attn_fwd_f32",
           "spatial_attn_bwd_f32", "sw_exit"}
    assert set(counters()) >= f32
    assert {k: v for k, v in fwd.items() if v} == {
        "dsa_phase_a_f32": tb, "dsa_phase_b_f32": tb}
    assert {k: v for k, v in step.items() if v} == {
        "spatial_attn_fwd_f32": tb, "spatial_attn_bwd_f32": tb}
    assert torch.isfinite(torch.tensor(loss))
    assert _rel(got, want) < 1e-4


# -- C20: float16 (compute_dtype='float16') -----------------------------------

# the 16-bit kernels against their plain versions at the operands' type:
# chip_smoke.py's tolerance for bf16, kept for f16
F16_REL = 2e-2


@pytest.mark.parametrize("sa_type", ["parallel", "serial", "spatial",
                                     "channel"])
@pytest.mark.parametrize("n,c,p", [(32768, 32, 64), (4096, 64, 64),
                                   (512, 128, 64), (64, 256, 32),
                                   (300, 32, 64), (512, 256, 128)])
def test_dsa_f16_kernels_match_plain(dev, n, c, p, sa_type):
    """B5's f16 instances (csrc/dsa.cu built with -DFCD_F16): phase A with
    its glue and phase B against the plain versions on f16 tokens, two
    calls bit-equal, counted apart from the bf16 kernels."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h, f16 = 4, torch.float16
    gen = torch.Generator(device=dev).manual_seed(n + c + p + 1)
    a = _dsa_inputs(gen, dev, n, c, p, h)
    x = a["x"].to(f16)
    ns = dk.num_slots(sa_type)
    w = a["w"][:, :ns * c].contiguous()
    ef = None if sa_type == "channel" else a["ef"].to(f16)
    tok = (a["lns"], a["lnb"], a["pe"])
    temps = (a["t1"], a["t2"])
    mode = dict(sa_type=sa_type)
    bf16_before = (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches)
    before = (dk.PHASE_A_F16.launches, dk.PHASE_B_F16.launches)
    glue = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps, **mode)
    want = dk.dsa_glue(dk.dsa_phase_a_plain(x, w, ef, *tok, h, **mode),
                       *temps, h, f16)
    for name, g, w_ in zip(glue._fields, glue, want):
        if g.numel():
            assert g.dtype == w_.dtype and _rel(g, w_) < F16_REL, name
    got = dk.dsa_phase_b(x, w, *glue, a["gamma"], *tok, h, **mode)
    assert got.dtype == f16
    assert _rel(got, dk.dsa_phase_b_plain(x, w, *glue, a["gamma"], *tok, h,
                                          **mode)) < F16_REL
    assert torch.equal(got, dk.dsa_phase_b(x, w, *glue, a["gamma"], *tok,
                                           h, **mode))
    assert (dk.PHASE_A_F16.launches, dk.PHASE_B_F16.launches) == (
        before[0] + 1, before[1] + 2)
    assert (dk.dsa_phase_a.launches, dk.dsa_phase_b.launches) == bf16_before


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,c,p", [(32768, 32, 64), (4096, 64, 64),
                                   (512, 128, 64), (64, 256, 32),
                                   (512, 256, 64), (512, 256, 128),
                                   (64, 512, 32), (100, 8, 16)])
def test_spatial_attn_f16_kernels_match_plain(dev, n, c, p, rate):
    """K3/K4's f16 instances, the tensor-core ones at the four levels and
    the wide ones past them, against the plain versions with the same
    dropout bits, two calls bit-equal, dkpb and dvpb in f16 and f32,
    counted apart from the bf16 kernels."""
    from fcd_tpu_torch.kernels import spatial_attn as sa

    h, f16 = 4, torch.float16
    gen = torch.Generator(device=dev).manual_seed(c * p + n + 1)
    qn, kpb, vpb, g = (t.to(f16) for t in _spattn_inputs(gen, dev, n, c, h,
                                                         p, batch=4))
    key = sa.dropout_key(21, 3)
    before = (sa.FWD_F16.launches, sa.BWD_F16.launches,
              sa.spatial_attn_fwd.launches, sa.spatial_attn_bwd.launches)
    out = sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate)
    assert out.dtype == f16
    assert torch.equal(out, sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate))
    assert _rel(out, sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                               rate)) < F16_REL
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    for dtypes in ((f16, f16), (torch.float32, torch.float32)):
        got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate,
                                  dtypes=dtypes)
        again = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate,
                                    dtypes=dtypes)
        for name, g_, a_, w_ in zip(("dqn", "dkpb", "dvpb"), got, again,
                                    want):
            assert torch.equal(g_, a_), name
            assert _rel(g_, w_) < F16_REL, name
        assert got[1].dtype == dtypes[0] and got[2].dtype == dtypes[1]
    with pytest.raises(TypeError):
        sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate,
                            dtypes=(torch.bfloat16, torch.bfloat16))
    assert (sa.FWD_F16.launches, sa.BWD_F16.launches,
            sa.spatial_attn_fwd.launches, sa.spatial_attn_bwd.launches) == (
        before[0] + 2, before[1] + 4, before[2], before[3])


def test_f16_route_launches_no_bf16_kernel(dev):
    """compute_dtype='float16' on the card: a patch forward and a train step
    of MS_DSA_NET launch B5's and K3/K4's f16 instances and nothing of the
    bf16-only kernels, the patch near the f32 CPU forward of the same
    weights, the loss finite."""
    import copy

    from chip_smoke import read_counts, reset_counts
    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params.update(compute_dtype="float16", patch_size=64)
    tr = ModelTrainer(params, device=dev, verbose=False)
    assert tr.compute_dtype == torch.float16
    assert tr.entry_dtype == torch.bfloat16
    patch = torch.randn(1, 64, 64, 64, 2, generator=torch.Generator()
                        .manual_seed(4))
    reset_counts()
    got = tr.predict(patch.to(dev)).float().cpu()
    fwd = read_counts()
    with torch.no_grad():
        cpu = copy.deepcopy(tr.model).cpu().eval()
        cpu.compute_dtype = torch.float32
        want = cpu(patch).float()
    x = torch.rand(2, 64, 64, 64, 2, device=dev)
    y = (torch.rand(2, 64, 64, 64, 1, device=dev) > 0.95).float()
    reset_counts()
    loss = float(tr.train_step(x, y, 1e-4))
    step = read_counts()
    assert {k: v for k, v in fwd.items() if v} == {
        "dsa_phase_a_f16": 12, "dsa_phase_b_f16": 12}
    assert {k: v for k, v in step.items() if v} == {
        "spatial_attn_fwd_f16": 12, "spatial_attn_bwd_f16": 12}
    assert torch.isfinite(torch.tensor(loss))
    assert _rel(got, want) < 0.05


# -- B5's prologue-free instance and the blocks no factory model builds
# (ROADMAP A10) --------------------------------------------------------------

_RAW_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
               "f32": torch.float32}


def _raw_counts(dk):
    return [c.launches for c in (
        dk.PHASE_A_RAW, dk.PHASE_B_RAW, dk.PHASE_A_RAW_F16, dk.PHASE_B_RAW_F16,
        dk.PHASE_A_RAW_F32, dk.PHASE_B_RAW_F32, dk.dsa_phase_a,
        dk.dsa_phase_b, dk.PHASE_A_F16, dk.PHASE_B_F16, dk.PHASE_A_F32,
        dk.PHASE_B_F32)]


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
@pytest.mark.parametrize("sa_type", ["parallel", "serial", "spatial",
                                     "channel"])
@pytest.mark.parametrize("n,c,p", [(4096, 64, 64), (70, 256, 32)])
def test_dsa_prologue_free_kernels_match_plain(dev, n, c, p, sa_type, dtype):
    """B5 with no LayerNorm affine, pos-embed or gamma (libdsa_raw,
    libdsa_raw_f16, libdsa_f32_raw): phase A's sums, the finishing pass and
    phase B against the plain versions (16-bit 2e-2, f32 F32_REL), two
    calls bit-equal, the whole op against the f32 reference, counted on
    the prologue-free counters alone."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    h, dt = 4, _RAW_DTYPES[dtype]
    tol = F32_REL if dt == torch.float32 else 2e-2
    gen = torch.Generator(device=dev).manual_seed(n + c + p)
    x, w, ef, a = _f32_dsa_args(gen, dev, n, c, p, h, sa_type)
    x = x.to(dt)
    none = (None, None, None)
    temps = (a["t1"], a["t2"])
    mode = dict(sa_type=sa_type)
    before = _raw_counts(dk)
    ka = dk.dsa_phase_a(x, w, ef, *none, h, **mode)
    wa = dk.dsa_phase_a_plain(x, w, ef, *none, h, **mode)
    for name, g, w_ in zip(ka._fields, ka, wa):
        if g.numel():
            assert _rel(g, w_) < tol, name
    glue = dk.dsa_phase_a(x, w, ef, *none, h, temperatures=temps, **mode)
    for name, g, w_ in zip(glue._fields, glue, dk.dsa_glue(wa, *temps, h, dt)):
        if g.numel():
            assert g.dtype == w_.dtype and _rel(g, w_) < tol, name
    for g, w_ in zip(glue, dk.dsa_phase_a(x, w, ef, *none, h,
                                          temperatures=temps, **mode)):
        assert torch.equal(g, w_)
    got = dk.dsa_phase_b(x, w, *glue, None, *none, h, **mode)
    assert got.dtype == dt
    assert _rel(got, dk.dsa_phase_b_plain(x, w, *glue, None, *none, h,
                                          **mode)) < tol
    assert torch.equal(got, dk.dsa_phase_b(x, w, *glue, None, *none, h,
                                           **mode))
    args = (x, w, ef, *temps, *none, None, h)
    assert _rel(dk.dsa_attention(*args, **mode),
                dk.dsa_reference(*args, **mode)) < (
        F32_REL if dt == torch.float32 else 5e-2)
    k = {"bf16": 0, "f16": 2, "f32": 4}[dtype]
    want = list(before)
    want[k] += 4
    want[k + 1] += 3
    assert _raw_counts(dk) == want


def test_dsa_prologue_free_is_three_device_launches(dev):
    """One prologue-free dsa_attention call: one count on each of its
    phase wrappers, the kernels of libdsa_raw, and no other device op."""
    from fcd_tpu_torch.kernels import dsa_attention as dk

    gen = torch.Generator(device=dev).manual_seed(5)
    a = _dsa_inputs(gen, dev, 4096, 64, 64, 4)
    args = (a["x"], a["w"], a["ef"], a["t1"], a["t2"], None, None, None,
            None, 4)
    _only_kernels(lambda: dk.dsa_attention(*args),
                  [(dk.PHASE_A_RAW, 1), (dk.PHASE_B_RAW, 1)], "dsa_raw",
                  DSA_KERNELS)


@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
def test_transformer_block_dsa_launches_the_prologue_free_instance(dev,
                                                                   dtype):
    """TransformerBlockDSA at eval on the card: one launch of each phase of
    B5's prologue-free instance of the dtype and no other kernel (no
    fused-form B5), its output near the f32 CPU forward (bf16 5e-2, f16
    1e-2, f32 1e-4: chip_smoke's patch limits)."""
    import copy

    from chip_smoke import read_counts, reset_counts
    from fcd_tpu_torch.ops.attention import TransformerBlockDSA

    dt = _RAW_DTYPES[dtype]
    torch.manual_seed(7)
    tm = TransformerBlockDSA(4096, 64, 64, 4)
    tm.reset_parameters(torch.Generator().manual_seed(7))
    with torch.no_grad():
        tm.pos_embed.normal_(0, 0.1)
    tm.eval()
    x = torch.randn(1, 16, 16, 16, 64)
    with torch.no_grad():
        want = tm(x)
        card = copy.deepcopy(tm).to(dev)
        xd = x.to(dev, dt)
        card(xd)
        reset_counts()
        got = card(xd).float().cpu()
    sfx = {"bf16": "", "f16": "_f16", "f32": "_f32"}[dtype]
    assert {k: v for k, v in read_counts().items() if v} == {
        f"dsa_phase_a_raw{sfx}": 1, f"dsa_phase_b_raw{sfx}": 1}
    assert _rel(got, want) < {"bf16": 5e-2, "f16": 1e-2, "f32": 1e-4}[dtype]
