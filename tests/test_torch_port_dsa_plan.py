"""B5's plans (`dsa_attention.dsa_plan` for the 16-bit instances,
`dsa_plan_f32` for the f32 ones; pure Python) on the CPU.

At the four DSA levels of a 128^3 patch and at ragged token counts: the
plan covers every token of every head once in each phase, phase A's
chunks walk their tiles in a fixed order, tiles are multiples of 16, both
kernels' shared memory fits, and the grids fill the card. Emulations of
the kernels' decomposition (per head and column group, per chunk of
token tiles, partial records added in chunk order, then the finishing
pass's glue; phase B per tile and head) hold it against the plain
versions.
"""

import numpy as np
import pytest
import torch

from fcd_tpu_torch.kernels import dsa_attention as dk

import torch_port_workers

torch_port_workers.share_cores()

torch.set_grad_enabled(False)

# (N, C, P) of the four levels (4 heads), and ragged N at level 3's widths
LEVELS = [(32768, 32, 64), (4096, 64, 64), (512, 128, 64), (64, 256, 32)]
SHAPES = LEVELS + [(300, 32, 64), (700, 32, 64), (300, 256, 32),
                   (700, 128, 64)]

# the 16-bit instances' planner (csrc/dsa.cu) and the f32 instances'
# (csrc/dsa_f32.cu), by name: (plan, plan_for, tiles)
PLANNERS = {"h16": (dk.dsa_plan, dk.plan_for, dk.TILES),
            "f32": (dk.dsa_plan_f32, dk.plan_for_f32, dk.TILES_F32)}


def _smem(kind, plan, c):
    """The plan's two shared-memory sizes, by the planner's own rule."""
    ch, p, t = c // plan.heads, plan.p, plan.tile
    if kind == "f32":
        return (dk.smem_a_f32(c, ch, p, t, plan.groups),
                dk.smem_b_f32(c, ch, p, t, plan.hb))
    return dk.smem_a(c, ch, p, t), dk.smem_b(c, ch, p, t)


@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n,c,p", SHAPES)
def test_plan_covers_every_token_of_every_head_once(n, c, p, batch, kind):
    planner, _, tiles = PLANNERS[kind]
    plan = planner(n, c, p, 4, batch)
    assert plan.tile % 16 == 0 and plan.tile in tiles
    assert plan.tiles == -(-n // plan.tile)
    # phase A: chunk k walks tiles chunk_tiles(k); every block is one
    # (chunk, head, batch), so a token of a head is covered once per batch
    seen = np.zeros(plan.tiles * plan.tile, dtype=int)
    for k in range(plan.chunks):
        tiles = list(plan.chunk_tiles(k))
        assert tiles, f"chunk {k} is empty"
        assert tiles == sorted(tiles) and len(tiles) <= plan.per_chunk
        for t in tiles:
            seen[t * plan.tile:(t + 1) * plan.tile] += 1
    assert (seen[:n] == 1).all() and (seen == 1).all()
    # a head's column groups (f32) split its columns, not its tokens
    assert plan.a_blocks == plan.chunks * 4 * batch * plan.groups
    assert plan.groups == 1 or kind == "f32"
    # phase B: one block per (tile, group of hb heads, batch); hb is 1
    # but for the f32 plan, whose blocks may take several heads
    assert 4 % plan.hb == 0 and (plan.hb == 1 or kind == "f32")
    assert plan.b_blocks * plan.hb == plan.tiles * 4 * batch
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile


@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("n,c,p", SHAPES)
def test_plan_chunk_order_is_fixed(n, c, p, kind):
    planner = PLANNERS[kind][0]
    plan = planner(n, c, p, 4)
    again = planner.__wrapped__(n, c, p, 4)
    assert plan == again
    order = [t for k in range(plan.chunks) for t in plan.chunk_tiles(k)]
    assert order == list(range(plan.tiles))


@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("n,c,p", SHAPES)
def test_plan_fits_shared_memory(n, c, p, kind):
    plan = PLANNERS[kind][0](n, c, p, 4)
    ch = c // 4
    assert (plan.smem_a, plan.smem_b) == _smem(kind, plan, c)
    assert max(plan.smem_a, plan.smem_b) <= 227 * 1024
    for width in (c, 2 * ch, 3 * ch, p, max(ch, 16)):
        if kind == "h16":
            # a bf16 row pitch is an odd multiple of 16 bytes
            assert dk._pitch(width) >= width and (dk._pitch(width) // 8) % 2
        else:
            # f32 pitches for conflict-free fragment loads: 4 mod 8 along
            # rows, 8 mod 16 down columns (16-byte rows for cp.async)
            assert dk._prow(width) >= width and dk._prow(width) % 8 == 4
            assert dk._pcol(width) >= width and dk._pcol(width) % 16 == 8
            assert dk._prow(width) < width + 8 and dk._pcol(width) < width + 16


@pytest.mark.parametrize("kind", PLANNERS)
def test_plan_fills_the_card(kind):
    """At least 16 blocks of each phase at level 6 (64 tokens), and at
    least one per SM at levels 3 and 4. The f32 plan splits level 6's
    heads into column groups: phase A's 4 tiles x 4 heads become 128
    blocks, within one per SM, each group of 8 columns or more."""
    by_n = {n: PLANNERS[kind][0](n, c, p, 4) for n, c, p in LEVELS}
    assert by_n[64].a_blocks >= 16 and by_n[64].b_blocks >= 16
    for n in (32768, 4096):
        assert by_n[n].a_blocks >= 132 and by_n[n].b_blocks >= 132
    # level 3 walks several tiles a block, so its partials stay few
    assert by_n[32768].per_chunk > 1 and by_n[32768].chunks <= 2 * 132
    # level 6 and level 5 take the smallest tile
    assert by_n[64].tile == by_n[512].tile == 16
    if kind == "f32":
        lv6 = by_n[64]
        assert lv6.groups == 8 and 0.9 * dk.SMS < lv6.a_blocks <= dk.SMS
        assert lv6.ch // lv6.groups >= 8
        # where the card is full without them, no groups
        assert all(by_n[n].groups == 1 for n in (32768, 4096, 512))
        # level 3's phase B blocks take two heads each, and stay two a SM
        lv3 = by_n[32768]
        assert lv3.hb == 2 and 2 * (lv3.smem_b + 1024) <= dk.SMEM_SM


@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("n,c,p,h", [(32, 24, 64, 4), (64, 32, 48, 4),
                                     (64, 1024, 32, 4), (64, 32, 64, 0),
                                     (64, 96, 64, 4), (64, 16, 1024, 4)])
def test_plan_refuses_what_the_kernels_do_not_take(n, c, p, h, kind):
    """Head widths that are not powers of two, P outside 16-128, C over
    512 or no heads; C 1024 and P 1024 lie outside the JAX kernel's gate
    too."""
    with pytest.raises(ValueError):
        PLANNERS[kind][0](n, c, p, h)


# C16: every (N, C, P) of MS_DSA_NET's DSA levels at a 128^3 patch with 4
# heads, feature sizes 4-32 and project sizes 16-128 (level 6 takes P 32:
# fcd_tpu/models/ms_dsa_net.py:245-248)
TARGET = sorted({(n, c, ps if lv < 6 else 32)
                 for fs in (4, 8, 16, 32) for ps in (16, 32, 64, 128)
                 for lv, n, c in ((3, 32768, 2 * fs), (4, 4096, 4 * fs),
                                  (5, 512, 8 * fs), (6, 64, 16 * fs))})


def _jax_gate(n, c, p, h):
    from fcd_tpu.kernels.dsa_attention import dsa_fused_supported

    return dsa_fused_supported(n, c, p, h)


@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("n,c,p", TARGET)
def test_plan_takes_every_width_of_the_model(n, c, p, kind):
    """At each width the JAX kernel takes, the plan exists, fits shared
    memory, and covers every token of every head once; head widths of 128
    take 16-token tiles (their weights stream)."""
    assert _jax_gate(n, c, p, 4)
    plan = PLANNERS[kind][0](n, c, p, 4)
    assert max(plan.smem_a, plan.smem_b) <= dk.SMEM_CAP
    assert (plan.smem_a, plan.smem_b) == _smem(kind, plan, c)
    if c // 4 >= dk.STREAM_WIDTH:
        assert plan.tile == 16
    order = [t for k in range(plan.chunks) for t in plan.chunk_tiles(k)]
    assert order == list(range(plan.tiles))
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile


@pytest.mark.parametrize("kind", PLANNERS)
def test_plan_refuses_only_outside_the_jax_gate(kind):
    """Over C 4-1024 and P 8-1024 at 4 heads (powers of two), and N of
    the four levels: where the JAX kernel takes a width that MS_DSA_NET
    reaches (P 16-128, head width >= 2), the plan exists; where the JAX
    gate refuses, the plan refuses too."""
    for n in (32768, 4096, 512, 64):
        for c in (4, 8, 16, 32, 64, 128, 256, 512, 1024):
            for p in (8, 16, 32, 64, 128, 256, 512, 1024):
                jax_ok = _jax_gate(n, c, p, 4)
                try:
                    PLANNERS[kind][0](n, c, p, 4)
                    ours = True
                except ValueError:
                    ours = False
                if not jax_ok:
                    assert not ours, (n, c, p)
                elif 16 <= p <= 128 and c >= 8:
                    assert ours, (n, c, p)


def _inputs(rng, b, n, c, p, h):
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return dict(x=t(rng.randn(b, n, c)), w=t(rng.randn(c, 4 * c) * c ** -0.5),
                ef=t(rng.randn(n, p) * p ** -0.5),
                t1=t(rng.rand(h, 1, 1) + 0.5), t2=t(rng.rand(h, 1, 1) + 0.5),
                lns=t(1 + 0.1 * rng.randn(c)), lnb=t(0.1 * rng.randn(c)),
                pe=t(0.1 * rng.randn(n, c)), gamma=t(rng.randn(c)))


def _emulate(a, plan, h):
    """The kernels' decomposition in plain PyTorch: phase A blocks per
    (chunk, head) build partial records from their tiles' tokens with the
    head's weight columns, the finishing pass adds them in chunk order and
    does the glue, phase B blocks per (tile, head) write their head's
    channels."""
    x, w = a["x"], a["w"]
    b, n, c = x.shape
    ch, p, tile = c // h, plan.p, plan.tile
    _, xln = dk._ln_tokens(x, a["pe"], a["lns"], a["lnb"], 1e-5)
    base = x + a["pe"]
    col = lambda s, j: w[:, s * c + j * ch:s * c + (j + 1) * ch]  # noqa: E731
    qnorm = torch.empty(b, c)
    abig = torch.empty(b, h, ch, ch)
    kpt, vp = torch.empty(b, c, p), torch.empty(b, c, p)
    out = torch.empty_like(x)
    qw = ch // plan.groups
    for j in range(h):
        hs = slice(j * ch, (j + 1) * ch)
        wq, wk, wv = (col(s, j) for s in dk.PHASE_A_SLOTS)
        recs = []
        for k in range(plan.chunks):
            # the chunk's record, written by its column groups' blocks:
            # group g owns rows g qw .. of q^T k, q2, k2, kp and vp
            rec = torch.full((b, plan.record), float("nan"))
            for g in range(plan.groups):
                js = slice(g * qw, (g + 1) * qw)
                part = 0
                for t in plan.chunk_tiles(k):
                    rows = slice(t * tile, min((t + 1) * tile, n))
                    xt, ef = xln[:, rows], a["ef"][rows]
                    q, kk, v = xt @ wq[:, js], xt @ wk, xt @ wv[:, js]
                    part = part + torch.cat([
                        (q.transpose(1, 2) @ kk).reshape(b, -1),
                        q.square().sum(1), kk[:, :, js].square().sum(1),
                        (kk[:, :, js].transpose(1, 2) @ ef).reshape(b, -1),
                        (v.transpose(1, 2) @ ef).reshape(b, -1)], dim=1)
                offs = [(g * qw * ch, qw * ch), (ch * ch + g * qw, qw),
                        (ch * ch + ch + g * qw, qw),
                        (ch * ch + 2 * ch + g * qw * p, qw * p),
                        (ch * ch + 2 * ch + ch * p + g * qw * p, qw * p)]
                i = 0
                for o, size in offs:
                    rec[:, o:o + size] = part[:, i:i + size]
                    i += size
            assert not rec.isnan().any(), "a record value no group wrote"
            recs.append(rec)
        total = recs[0]
        for rec in recs[1:]:
            total = total + rec
        qk = total[:, :ch * ch].reshape(b, ch, ch)
        q2, k2 = total[:, ch * ch:ch * ch + ch], total[:, ch * ch + ch:
                                                       ch * ch + 2 * ch]
        kp = total[:, ch * ch + 2 * ch:].reshape(b, 2, ch, p)
        qn, kn = torch.rsqrt(q2 + 1e-12), torch.rsqrt(k2 + 1e-12)
        att = torch.softmax(qk * qn[:, :, None] * kn[:, None, :]
                            * a["t1"].reshape(h)[j], dim=-1)
        qnorm[:, hs], abig[:, j] = qn, att.transpose(1, 2)
        kpt[:, hs], vp[:, hs] = kp[:, 0] * a["t2"].reshape(h)[j], kp[:, 1]
        wq, wv = (col(s, j) for s in dk.PHASE_B_SLOTS)
        for t in range(plan.tiles):
            rows = slice(t * tile, min((t + 1) * tile, n))
            xt = xln[:, rows]
            o = (xt @ wv) @ abig[:, j]
            s = torch.softmax((xt @ wq) * qnorm[:, None, hs] @ kpt[:, hs], -1)
            o = o + s @ vp[:, hs].transpose(1, 2)
            out[:, rows, hs] = base[:, rows, hs] + a["gamma"][hs] * o
    return dk.PhaseBOperands(qnorm, abig, kpt, vp), out


@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("b,n,c,p", [(1, 300, 32, 64), (2, 100, 64, 64),
                                     (1, 76, 128, 64), (1, 70, 256, 32),
                                     (1, 100, 8, 16), (2, 60, 16, 128),
                                     (1, 40, 512, 32)])
def test_decomposition_matches_the_plain_versions(b, n, c, p, kind):
    h = 4
    a = _inputs(np.random.RandomState(5), b, n, c, p, h)
    # several tiles per chunk, so the chunk walk and the record sum are
    # exercised at these small N; the f32 plan with as many column groups
    # as a head of 8 columns or more takes (at most 4)
    groups = min(4, max(1, c // 4 // 8)) if kind == "f32" else 1
    plan = (dk.plan_for_f32(n, c, p, h, b, 16, 3, groups) if kind == "f32"
            else dk.plan_for(n, c, p, h, b, 16, 3))
    ops, out = _emulate(a, plan, h)
    tok = (a["lns"], a["lnb"], a["pe"])
    want_ops = dk.dsa_phase_a(a["x"], a["w"], a["ef"], *tok, h,
                              temperatures=(a["t1"], a["t2"]))
    for name, got_, want_ in zip(ops._fields, ops, want_ops):
        scale = want_.abs().max()
        assert (got_ - want_).abs().max() <= 1e-5 * scale, name
    want = dk.dsa_phase_b(a["x"], a["w"], *want_ops, a["gamma"], *tok, h)
    assert (out - want).abs().max() <= 1e-5 * want.abs().max()
    # the emulation repeats itself bit for bit (fixed order)
    again = _emulate(a, plan, h)[1]
    assert torch.equal(out, again)


def test_levels_are_chip_smokes_and_the_sweeps():
    import chip_smoke
    from fcd_tpu_torch.kernels import dsa_sweep

    assert [lv[1:] for lv in chip_smoke.DSA_LEVELS] == LEVELS
    assert [lv[1:] for lv in dsa_sweep.LEVELS] == LEVELS
    assert chip_smoke.PER_PATCH["dsa_phase_a"] == len(LEVELS) * 3


# -- sa_type 'channel': no EF, no P --------------------------------------------

@pytest.mark.parametrize("kind", PLANNERS)
@pytest.mark.parametrize("n,c", [(32768, 32), (4096, 64), (512, 128),
                                 (64, 256), (300, 8), (64, 512)])
def test_channel_mode_plan_asks_for_no_projection(n, c, kind):
    """'channel' has no EF (JAX feeds a zero (N, 8) one): the port plans it
    with P = 0, which no other type takes, and phase A stages two slots
    (q, k) and writes records without kp | vp. The plan covers every token
    once and fits shared memory, as the other types' plans do."""
    plan = PLANNERS[kind][0](n, c, 0, 4, 2)
    ch = c // 4
    assert plan.p == 0 and plan.record == ch * ch + 2 * ch
    assert dk.supported(c, 0, 4) and not dk.supported(c, 8, 4)
    order = [t for k in range(plan.chunks) for t in plan.chunk_tiles(k)]
    assert order == list(range(plan.tiles))
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile
    assert max(plan.smem_a, plan.smem_b) <= dk.SMEM_CAP
    # two staged weight slots instead of three
    if kind == "f32":
        chp = max(ch, 8)
        assert dk._cols_a(chp, 1, 0) == 2 * chp < dk._cols_a(chp, 1, 16)
    else:
        assert dk.smem_a(c, ch, 0, plan.tile) < dk.smem_a(c, ch, 16,
                                                          plan.tile)
    assert dk.phase_a_slots("channel") == (0, 1)
    assert dk.phase_a_slots("serial") == dk.phase_a_slots("spatial") == \
        (0, 1, 2)


def test_modes_are_the_cuda_sources():
    """csrc/dsa.cu numbers the modes as SA_TYPES does, builds a P = 0
    instance of every head width, and takes P = 0 in 'channel' mode only."""
    from pathlib import Path

    src = (Path(dk.__file__).resolve().parents[1] / "csrc"
           / "dsa.cu").read_text()
    assert ("enum Mode { PARALLEL = 0, SERIAL = 1, SPATIAL = 2, "
            "CHANNEL = 3 };") in src
    assert [dk.mode_of(t) for t in dk.SA_TYPES] == [0, 1, 2, 3]
    assert "case CH * 1000 + 0: return CALL(CH, 0);" in src
    assert "if ((P == 0) != (mode == CHANNEL)) return false;" in src
    with pytest.raises(ValueError):
        dk.mode_of("cross")


def test_f32_plan_refuses_exactly_outside_supported():
    """Over heads 1-16, C 4-1024 and P 0-256 (powers of two) at four N,
    batch 1 and 3: the f32 plan exists exactly where `supported` takes the
    width, with its groups and tile inside what csrc/dsa_f32.cu accepts."""
    for n in (64, 300, 4096, 32768):
        for heads in (1, 2, 4, 8, 16):
            for c in (4, 8, 16, 32, 64, 128, 256, 512, 1024):
                for p in (0, 8, 16, 32, 64, 128, 256):
                    for batch in (1, 3):
                        ok = dk.supported(c, p, heads)
                        try:
                            plan = dk.dsa_plan_f32(n, c, p, heads, batch)
                        except ValueError:
                            assert not ok, (n, heads, c, p, batch)
                            continue
                        assert ok, (n, heads, c, p, batch)
                        chp = max(c // heads, 8)
                        assert plan.groups == 1 or (
                            chp // plan.groups >= 8
                            and plan.a_blocks <= dk.SMS)
                        assert plan == dk.plan_for_f32(
                            n, c, p, heads, batch, plan.tile,
                            plan.per_chunk, plan.groups, plan.hb)
                        assert heads % plan.hb == 0 and (
                            plan.hb == 1 or plan.b_blocks >= dk.SMS)


def test_f32_plan_constants_are_the_cuda_source():
    """kernels/dsa_attention.py's f32 plan reads the widths, pitches and
    caps that csrc/dsa_f32.cu's kernels and launchers check."""
    from pathlib import Path

    src = (Path(dk.__file__).resolve().parents[1] / "csrc"
           / "dsa_f32.cu").read_text()
    for line in (f"constexpr int NT = {dk.NT};",
                 f"constexpr int SMEM_CAP = {dk.SMEM_CAP};",
                 f"constexpr int KC = {dk.KC_F32};",
                 f"constexpr int MJ = {dk.MJ_F32};",
                 f"constexpr int STREAM_CH = {dk.STREAM_WIDTH};",
                 f"constexpr int SLACK = {dk.SLACK_F32};",
                 "return (n + 3) / 8 * 8 + 4;",           # prow
                 "return (n + 7) / 16 * 16 + 8;",         # pcol
                 "return chp + (p > 0 ? 2 : 1) * (chp / g);",  # cols_a
                 "pow2(T) && T >= 16 && T <= 128;",
                 "if (groups > 1 && CH / groups < 8)"):
        assert line in src, line
    assert dk.TILES_F32 == (128, 64, 32, 16)
    assert [dk._prow(n) for n in (8, 16, 32, 64)] == [12, 20, 36, 68]
    assert [dk._pcol(n) for n in (8, 16, 24, 64)] == [8, 24, 24, 72]
    # the plan's one-unit-a-warp rule is the launcher's: level 5's head
    # width 32 projects 96 columns, which 128-token tiles cannot
    assert dk._projects(64, 96) and not dk._projects(128, 96)
    assert dk._projects(16, 384) and not dk._projects(32, 384)
