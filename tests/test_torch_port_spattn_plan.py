"""K3's and K4's plan (`spatial_attn.spatial_attn_plan`, pure Python) on
the CPU.

At the four DSA levels of a 128^3 patch and at ragged token counts, batch
1 and 4: K3's blocks cover every unit (16 tokens x a column group) once,
K4's chunks cover every token of every head group once, in a fixed order,
tiles are multiples of 16, both kernels' shared memory fits, and the grids
fill the card. Emulations of the kernels' decomposition (K4: per chunk and
head group partials, added in the plan's order; K3: per unit) hold it
against the plain versions at rate 0 and 0.1.
"""

import numpy as np
import pytest
import torch

from fcd_tpu_torch.kernels import spatial_attn as sa

import torch_port_workers

torch_port_workers.share_cores()

torch.set_grad_enabled(False)

# (N, C, P) of the four levels (4 heads), ragged N, and the levels of a
# feature size 8, projection 16 model on a 32^3 patch
LEVELS = [(32768, 32, 64), (4096, 64, 64), (512, 128, 64), (64, 256, 32)]
SMALL_LEVELS = [(512, 16, 16), (64, 32, 16), (8, 64, 16), (1, 128, 32)]
SHAPES = LEVELS + [(300, 32, 64), (700, 32, 64), (300, 64, 64),
                   (700, 128, 64), (300, 256, 32)] + SMALL_LEVELS


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n,c,p", SHAPES)
def test_plan_covers_every_token_once(n, c, p, batch):
    plan = sa.spatial_attn_plan(n, c, p, 4, batch)
    # K3: block k of a batch item walks units fwd_units(k), each unit once
    seen = np.zeros(plan.units, dtype=int)
    for k in range(plan.fwd_blocks):
        units = list(plan.fwd_units(k))
        assert units, f"K3 block {k} is empty"
        seen[units] += 1
    assert (seen == 1).all()
    groups = c // plan.cols
    assert plan.units == -(-n // 16) * groups and plan.cols * groups == c
    # K4: chunk k walks tiles chunk_tiles(k); every block is one (chunk,
    # head group, batch), so each token of each head is covered once a
    # batch item
    assert plan.tiles == -(-n // plan.tile)
    cover = np.zeros((plan.tiles * plan.tile, 4), dtype=int)
    for hg in range(plan.head_groups):
        for k in range(plan.chunks):
            tiles = list(plan.chunk_tiles(k))
            assert tiles and tiles == sorted(tiles), f"chunk {k}: {tiles}"
            for t in tiles:
                cover[t * plan.tile:(t + 1) * plan.tile,
                      hg * plan.head_block:(hg + 1) * plan.head_block] += 1
    assert (cover == 1).all()
    assert plan.bwd_grid == plan.chunks * plan.head_groups * batch
    assert plan.fwd_grid == plan.fwd_blocks * batch


@pytest.mark.parametrize("n,c,p", SHAPES)
def test_plan_order_is_fixed(n, c, p):
    plan = sa.spatial_attn_plan(n, c, p, 4, 4)
    again = sa.spatial_attn_plan.__wrapped__(n, c, p, 4, 4)
    assert plan == again
    order = [t for k in range(plan.chunks) for t in plan.chunk_tiles(k)]
    assert order == list(range(plan.tiles))
    units = [u for k in range(plan.fwd_blocks) for u in plan.fwd_units(k)]
    assert units == list(range(plan.units))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n,c,p", SHAPES)
def test_plan_tiles_and_shared_memory(n, c, p, batch):
    plan = sa.spatial_attn_plan(n, c, p, 4, batch)
    assert plan.tile % 16 == 0 and plan.tile in sa.TILES
    assert plan.smem_fwd == sa.smem_fwd(c, 4 * p)
    assert plan.smem_bwd == sa.smem_bwd(c, plan.head_block * p, plan.tile)
    assert max(plan.smem_fwd, plan.smem_bwd) <= 227 * 1024
    # a block's dkpb and dvpb sums stay in registers: 64 f32 a thread
    assert 2 * c * plan.head_block * p // 256 <= 64
    assert plan.partial_bytes <= sa.PART_BUDGET + 4 * plan.dq_groups * \
        batch * n * c
    for width in (c, p, 4 * p, plan.head_block * p):
        assert sa._pitch(width) >= width and (sa._pitch(width) // 8) % 2


def test_plan_fills_the_card():
    """Both grids fill the card at levels 3 and 4 (batch 4, as the train
    step calls them): K3 with at least a block per SM; K4, one block an
    SM, in one wave that leaves fewer SMs idle than one chunk has blocks
    (level 3: 132 blocks; level 4, 8 blocks a chunk: 128, the one-wave
    grid `spattn_sweep --plans` timed faster than two waves). At least
    16 blocks each at level 6."""
    by_n = {n: sa.spatial_attn_plan(n, c, p, 4, 4) for n, c, p in LEVELS}
    for n in (32768, 4096):
        plan = by_n[n]
        per_chunk = plan.head_groups * plan.batch
        assert plan.fwd_grid >= 132
        assert sa.SMS - per_chunk < plan.bwd_grid <= sa.SMS
    assert by_n[32768].bwd_grid == 132
    assert by_n[64].fwd_grid >= 16 and by_n[64].bwd_grid >= 16
    # level 3: the whole row, blocks that walk many tiles, few partials
    l3 = by_n[32768]
    assert l3.split == "row" and l3.dq_groups == 0
    assert l3.tile == 128 and len(l3.chunk_tiles(0)) >= 4
    assert l3.chunks <= 132 // 4 + 1
    # levels 5-6 split by head, with small tiles
    assert by_n[512].split == by_n[64].split == "head"
    assert by_n[512].head_block == by_n[64].head_block == 1
    assert by_n[64].tile == 16


# C 512, (256, 64) and C 8 are taken since C15 (the wide instances); C
# 1024, P 256 and C 4 are not
@pytest.mark.parametrize("n,c,p,h", [(64, 48, 64, 4), (64, 32, 48, 4),
                                     (64, 1024, 32, 4), (64, 32, 64, 0),
                                     (64, 256, 256, 4), (64, 4, 64, 4)])
def test_plan_refuses_what_the_kernels_do_not_take(n, c, p, h):
    with pytest.raises(ValueError):
        sa.spatial_attn_plan(n, c, p, h)


def test_shapes_are_the_ones_the_cuda_source_builds():
    """SHAPES (C, P and the heads a K4 block may own) lists exactly the
    instances csrc/spatial_attn.cu's SHAPES_FWD and SHAPES_BWD build:
    C a power of two from 16 to 256, P 16, 32 or 64, C P <= 8192."""
    import re
    from pathlib import Path

    src = (Path(sa.__file__).resolve().parents[1] / "csrc"
           / "spatial_attn.cu").read_text()
    fwd = src[src.index("#define SHAPES_FWD"):src.index("#define SHAPES_BWD")]
    bwd = src[src.index("#define SHAPES_BWD"):]
    bwd = bwd[:bwd.index("\n\n")]
    got_fwd = {tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+)\)",
                                                      fwd)}
    got_bwd = {tuple(map(int, m))
               for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", bwd)}
    assert got_fwd == set(sa.SHAPES)
    assert got_bwd == {(c, p, hb) for (c, p), hbs in sa.SHAPES.items()
                       for hb in hbs}
    assert set(sa.SHAPES) == {(c, p) for c in (16, 32, 64, 128, 256)
                              for p in (16, 32, 64) if c * p <= 8192}
    # 1, 2 and 4 heads have a plan at every width
    for c, p in sa.SHAPES:
        for h in (1, 2, 4):
            plan = sa.spatial_attn_plan(64, c, p, h, 2)
            assert h % plan.head_block == 0


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_a_plan_for_another_shape_is_refused(which):
    """A plan made for other heads, tokens or batch raises ValueError (on
    the card it would index the wrong scratch)."""
    h, n, c, p = 8, 64, 32, 64
    qn, kpb, vpb, g = _inputs(3, 2, n, c, h, p)
    for bad in (sa.spatial_attn_plan(n, c, p, h // 2, 2),
                sa.spatial_attn_plan(2 * n, c, p, h, 2),
                sa.spatial_attn_plan(n, c, p, h, 1)):
        with pytest.raises(ValueError):
            if which == "fwd":
                sa.spatial_attn_fwd(qn, kpb, vpb, h, 0, 0.0, plan=bad)
            else:
                sa.spatial_attn_bwd(qn, kpb, vpb, g, h, 0, 0.0, plan=bad)
    good = sa.spatial_attn_plan(n, c, p, h, 2)
    assert torch.equal(sa.spatial_attn_fwd(qn, kpb, vpb, h, 0, 0.0, plan=good),
                       sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, 0, 0.0))


def test_plan_for_refuses_bad_splits():
    with pytest.raises(ValueError):   # two heads a block do not fit C=128
        sa.plan_for(512, 128, 64, 4, 1, 32, 4, 2)
    with pytest.raises(ValueError):   # 3 heads a block of 4
        sa.plan_for(512, 32, 64, 4, 1, 32, 4, 3)
    with pytest.raises(ValueError):   # more chunks than tiles
        sa.plan_for(64, 32, 64, 4, 1, 32, 3, 4)
    with pytest.raises(ValueError):   # a tile not a multiple of 16
        sa.plan_for(64, 32, 64, 4, 1, 24, 1, 4)


def _inputs(seed, b, n, c, h, p):
    """bf16-valued inputs (dense kpb and vpb) and the cotangent."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()  # noqa: E731
    return (t(rng.randn(b, n, c) * c ** -0.5),
            t(rng.randn(b, c, h * p) * 2.0),
            t(rng.randn(b, h * p, c)), t(rng.randn(b, n, c)))


def _emulate_bwd(qn, kpb, vpb, g, h, key, rate, plan):
    """K4's decomposition in plain PyTorch: each (chunk, head group) block
    sums qn^T ds and a^T g over its chunk's tiles into its chunk's
    partials, and writes its head group's f32 dqn partial (split by head);
    the finishing pass adds the chunks' partials and the groups' dqn in
    order. The per-token values (s, a, da, ds) are the plain version's."""
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    p = hp // h
    soft, attn, keep = sa._attn(qn, kpb, h, key, rate)
    qf, gf, kf = qn.float(), g.float(), kpb.float()
    da = gf @ vpb.float().transpose(1, 2)
    if keep is not None:
        da = torch.where(keep, da / (1.0 - rate), torch.zeros_like(da))
    s4, d4 = soft.reshape(b, n, h, p), da.reshape(b, n, h, p)
    ds = (s4 * (d4 - (d4 * s4).sum(-1, keepdim=True))).reshape(b, n, hp)
    ds = ds.bfloat16().float()
    hbp, tile = plan.head_block * p, plan.tile
    dk_part = torch.zeros(plan.chunks, b, c, hp)
    dv_part = torch.zeros(plan.chunks, b, hp, c)
    for k in range(plan.chunks):
        for hg in range(plan.head_groups):
            cols = slice(hg * hbp, (hg + 1) * hbp)
            for t in plan.chunk_tiles(k):
                rows = slice(t * tile, min((t + 1) * tile, n))
                dk_part[k, :, :, cols] += (qf[:, rows].transpose(1, 2)
                                           @ ds[:, rows, cols])
                dv_part[k, :, cols] += (attn[:, rows, cols].transpose(1, 2)
                                        @ gf[:, rows])
    dkpb, dvpb = dk_part[0], dv_part[0]
    for k in range(1, plan.chunks):
        dkpb, dvpb = dkpb + dk_part[k], dvpb + dv_part[k]
    if plan.split == "row":
        dqn = (ds @ kf.transpose(1, 2)).bfloat16()
    else:
        parts = [ds[:, :, hg * hbp:(hg + 1) * hbp]
                 @ kf[:, :, hg * hbp:(hg + 1) * hbp].transpose(1, 2)
                 for hg in range(plan.head_groups)]
        dq = parts[0]
        for part in parts[1:]:
            dq = dq + part
        dqn = dq.bfloat16()
    return dqn, dkpb, dvpb


def _emulate_fwd(qn, kpb, vpb, h, key, rate, plan):
    """K3's decomposition: each unit (16 tokens x cols columns) walks the
    heads, its output columns summed over them."""
    b, n, c = qn.shape
    _, attn, _ = sa._attn(qn, kpb, h, key, rate)
    p = kpb.shape[-1] // h
    vf = vpb.float()
    out = torch.empty(b, n, c)
    groups = c // plan.cols
    for k in range(plan.fwd_blocks):
        for u in plan.fwd_units(k):
            rows = slice(16 * (u // groups), min(16 * (u // groups) + 16, n))
            cs = slice(plan.cols * (u % groups),
                       plan.cols * (u % groups + 1))
            o = torch.zeros(b, rows.stop - rows.start, plan.cols)
            for j in range(h):
                q = slice(j * p, (j + 1) * p)
                o = o + attn[:, rows, q] @ vf[:, q, cs]
            out[:, rows, cs] = o
    return out.bfloat16()


# (batch, N, C, P, K4 tile, chunks, heads a block): several tiles a chunk
# and ragged N, the whole row and both splits by head
EMULATED = [(2, 300, 32, 64, 16, 5, 4), (2, 200, 64, 64, 32, 3, 2),
            (1, 100, 128, 64, 16, 3, 1), (1, 70, 256, 32, 16, 2, 1),
            (2, 300, 32, 64, None, None, None),
            (2, 100, 16, 16, None, None, None), (2, 9, 128, 32, 16, 1, 2)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,c,p,tile,chunks,hb", EMULATED)
def test_decomposition_matches_the_plain_versions(b, n, c, p, tile, chunks,
                                                  hb, rate):
    h = 4
    plan = (sa.spatial_attn_plan(n, c, p, h, b) if tile is None
            else sa.plan_for(n, c, p, h, b, tile, chunks, hb))
    qn, kpb, vpb, g = _inputs(7, b, n, c, h, p)
    key = sa.dropout_key(11, 3)
    got = _emulate_bwd(qn, kpb, vpb, g, h, key, rate, plan)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    # the f32 sums in another order
    for name, got_, want_ in zip(("dkpb", "dvpb"), got[1:], want[1:]):
        assert (got_ - want_).abs().max() <= 1e-5 * want_.abs().max(), name
    # dqn: bf16 of f32 sums taken in another order, one rounding apart
    assert got[0].dtype == want[0].dtype == torch.bfloat16
    assert ((got[0].float() - want[0].float()).abs().max()
            <= 8e-3 * want[0].float().abs().max())
    # the emulation repeats itself bit for bit (fixed order)
    again = _emulate_bwd(qn, kpb, vpb, g, h, key, rate, plan)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    out = _emulate_fwd(qn, kpb, vpb, h, key, rate, plan)
    want_out = sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate)
    assert ((out.float() - want_out.float()).abs().max()
            <= 8e-3 * want_out.float().abs().max())


def test_levels_are_chip_smokes_and_the_sweeps():
    import chip_smoke
    from fcd_tpu_torch.kernels import spattn_sweep

    assert [lv[1:] for lv in chip_smoke.DSA_LEVELS] == LEVELS
    assert [lv[1:] for lv in spattn_sweep.LEVELS] == LEVELS
    assert chip_smoke.per_train_step()["spatial_attn_bwd"] == len(LEVELS) * 3


def test_sweeps_measure_each_checkout_in_its_own_process(tmp_path):
    """The sweeps' harness (`_sweep`): a checkout given as --parent is
    measured by this checkout's sweep code with the parent's package
    first on sys.path, in turns parent, this, this, parent."""
    from fcd_tpu_torch.kernels import _sweep

    parent = tmp_path / "parent"
    (parent / "fcd_tpu_torch").mkdir(parents=True)
    (parent / "fcd_tpu_torch" / "__init__.py").write_text("WHO = 'parent'\n")
    script = tmp_path / "some_sweep.py"
    script.write_text("def measure():\n"
                      "    import fcd_tpu_torch\n"
                      "    return {'who': getattr(fcd_tpu_torch, 'WHO', "
                      "'this')}\n")
    order = _sweep.turns(str(parent), 2)
    assert [label for label, _ in order] == ["parent", "this", "this",
                                             "parent"]
    got = {label: _sweep.measure_in(str(script), root)["who"]
           for label, root in order[:2]}
    assert got == {"parent": "parent", "this": "this"}
    assert _sweep.turns(None, 2) == [("this", _sweep.REPO)]


# -- C15: the wide instances ----------------------------------------------------
# (N, C, P) of widths past the tensor-core instances: segresnet_deeper's
# level 4 (256, 64), MS_DSA_NET's fs32 level 6 (512, 32), project-128
# levels, feature size 4's C = 8, and ragged N
WIDE = [(512, 256, 64), (64, 512, 32), (512, 256, 128), (4096, 8, 64),
        (300, 64, 128), (64, 512, 128), (100, 128, 128), (70, 512, 16),
        (40, 8, 16)]


def test_every_c15_width_has_a_plan():
    """Every (C, P) with C a power of two from 8 to 512 and P 16 .. 128 has
    a plan at 1, 2 and 4 heads: the tensor-core instances' where they take
    it, the wide instances' elsewhere."""
    assert set(sa.SHAPES_WIDE) | set(sa.SHAPES) == {
        (c, p) for c in (8, 16, 32, 64, 128, 256, 512)
        for p in (16, 32, 64, 128)}
    assert not set(sa.SHAPES_WIDE) & set(sa.SHAPES)
    for c in sa.WIDTHS:
        for p in sa.PROJECTIONS:
            for h in (1, 2, 4):
                plan = sa.spatial_attn_plan(64, c, p, h, 4)
                assert plan.wide == ((c, p) not in sa.SHAPES)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("n,c,p", WIDE)
def test_wide_plan_covers_every_column_and_token_once(n, c, p, batch):
    """The wide plan (16-bit and f32): K3's and K4's row blocks take every
    16-token unit once, 32 tokens a block; K4's token sums walk every
    64-token step once, chunk by chunk in order, and their tiles cover the
    hP x C sum once; the chunk sizes divide what they stream; both
    kernels' shared memory fits."""
    for f32 in (False, True):
        plan = sa.wide_plan(n, c, p, 4, batch, f32=f32)
        hp, ck = 4 * p, sa.wide_ck(c)
        assert plan.wide and plan.f32 == f32 and plan.head_block == 4
        assert plan.split == "row" and plan.dq_groups == 0
        seen = np.zeros(plan.units, dtype=int)
        for k in range(plan.fwd_blocks):
            seen[list(plan.fwd_units(k))] += 1
        assert (seen == 1).all() and plan.per_block * 16 == sa.WIDE_TOKENS
        assert plan.fwd_blocks == -(-n // sa.WIDE_TOKENS)
        steps = [t for k in range(plan.chunks) for t in plan.chunk_tiles(k)]
        assert steps == list(range(plan.tiles)) and plan.tile == 64
        assert all(len(plan.chunk_tiles(k)) for k in range(plan.chunks))
        tq, tc = min(hp, sa.SUM_TILE), min(ck, sa.SUM_TILE)
        cover = np.zeros((hp, ck), dtype=int)
        for x in range(plan.sum_tiles):
            q0, c0 = x // (ck // tc) * tq, x % (ck // tc) * tc
            cover[q0:q0 + tq, c0:c0 + tc] += 1
        assert (cover == 1).all() and tq % 16 == 0 and tc % 16 == 0
        kc, kq = plan.k_chunk, plan.q_chunk
        assert kc >= 16 and ck % kc == 0 and kq >= 16 and hp % kq == 0
        es = 4 if f32 else 2
        assert plan.smem_fwd == sa.smem_rows_wide(es, False, c, hp, kc, kq)
        assert plan.smem_bwd == max(sa.smem_rows_wide(es, True, c, hp, kc, kq),
                                    sa.smem_sums_wide(es, c, hp))
        assert max(plan.smem_fwd, plan.smem_bwd) <= sa.SMEM_CAP
        assert plan.bwd_grid == plan.chunks * plan.sum_tiles * 2 * batch


def test_wide_plan_matches_the_cuda_checks():
    """csrc/spatial_attn.cu's constants are the module's, and its wide_ok
    holds what wide_plan gives (C a power of two from 8 to 512, P 16 ..
    128, 1, 2 or 4 heads, the chunks powers of two from 16)."""
    from pathlib import Path

    src = (Path(sa.__file__).resolve().parents[1] / "csrc"
           / "spatial_attn.cu").read_text()
    for const in ("WT = 256;", f"WTOK = {sa.WIDE_TOKENS};",
                  f"WSUM_T = {sa.SUM_TOKENS};", f"WSUM_Q = {sa.SUM_TILE};",
                  f"WSUM_C = {sa.SUM_TILE};"):
        assert f"constexpr int {const}" in src
    assert "(h == 1 || h == 2 || h == 4)" in src and sa.WIDE_HEADS == (1, 2, 4)
    for c in sa.WIDTHS:
        for p in sa.PROJECTIONS:
            for h in sa.WIDE_HEADS:
                plan = sa.wide_plan(64, c, p, h, 2, f32=True)
                for kc in (plan.k_chunk, plan.q_chunk):
                    assert kc >= 16 and kc & (kc - 1) == 0
    with pytest.raises(ValueError):
        sa.wide_plan(64, 32, 64, 4, 1)     # a tensor-core width
    with pytest.raises(ValueError):
        sa.wide_plan(64, 1024, 64, 4, 1)   # past B5's widths
    with pytest.raises(ValueError):
        sa.wide_plan(64, 512, 64, 8, 1)    # more heads than warp pairs


def _emulate_wide(qn, kpb, vpb, g, h, key, rate, plan):
    """The wide instances' decomposition in plain PyTorch. K3: each
    32-token row block sums every head's a . vpb into one output, rounded
    once. K4: each row block writes a and ds (rounded to the operands'
    type) and dqn = ds . kpb^T over every head, rounded once; each
    (chunk, tile) sums qn^T ds and a^T g over its chunk's 64-token steps
    into its chunk's f32 partials, which the finishing pass adds in chunk
    order."""
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    p = hp // h
    dt = qn.dtype
    soft, attn, keep = sa._attn(qn, kpb, h, key, rate)
    qf, gf, kf, vf = qn.float(), g.float(), kpb.float(), vpb.float()
    da = gf @ vf.transpose(1, 2)
    if keep is not None:
        da = torch.where(keep, da / (1.0 - rate), torch.zeros_like(da))
    s4, d4 = soft.reshape(b, n, h, p), da.reshape(b, n, h, p)
    ds = (s4 * (d4 - (d4 * s4).sum(-1, keepdim=True))).reshape(b, n, hp)
    ds = ds.to(dt).float()
    out = torch.zeros(b, n, c)
    dq = torch.zeros(b, n, c)
    for k in range(plan.fwd_blocks):
        rows = slice(k * sa.WIDE_TOKENS, min((k + 1) * sa.WIDE_TOKENS, n))
        out[:, rows] = attn[:, rows] @ vf
        dq[:, rows] = ds[:, rows] @ kf.transpose(1, 2)
    parts = []
    for k in range(plan.chunks):
        dk_k, dv_k = torch.zeros(b, c, hp), torch.zeros(b, hp, c)
        for t in plan.chunk_tiles(k):
            rows = slice(t * plan.tile, min((t + 1) * plan.tile, n))
            dk_k += qf[:, rows].transpose(1, 2) @ ds[:, rows]
            dv_k += attn[:, rows].transpose(1, 2) @ gf[:, rows]
        parts.append((dk_k, dv_k))
    dkpb, dvpb = parts[0]
    for dk_k, dv_k in parts[1:]:
        dkpb, dvpb = dkpb + dk_k, dvpb + dv_k
    return out.to(dt), dq.to(dt), dkpb, dvpb


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,c,p", [(2, 70, 256, 64), (1, 40, 512, 32),
                                     (1, 20, 8, 128), (1, 33, 128, 128),
                                     (1, 17, 512, 128)])
def test_wide_decomposition_matches_the_plain_versions(b, n, c, p, rate):
    h = 4
    plan = sa.spatial_attn_plan(n, c, p, h, b)
    assert plan.wide
    qn, kpb, vpb, g = _inputs(9, b, n, c, h, p)
    key = sa.dropout_key(5, 2)
    out, dqn, dkpb, dvpb = _emulate_wide(qn, kpb, vpb, g, h, key, rate, plan)
    want_out = sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate)
    wq, wk, wv = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    for name, got_, want_ in (("dkpb", dkpb, wk), ("dvpb", dvpb, wv)):
        assert (got_ - want_).abs().max() <= 1e-5 * want_.abs().max(), name
    for got_, want_ in ((out, want_out), (dqn, wq)):
        assert got_.dtype == want_.dtype == torch.bfloat16
        assert ((got_.float() - want_.float()).abs().max()
                <= 8e-3 * want_.float().abs().max())
