"""K2's decomposition (`fcd_tpu_torch/kernels/finale.py::finale_bwd_plan`),
pure Python, on the CPU: which units each block and thread take at the
train step's 23 calls and at ragged grids, the fixed order of the partial
rows, shared memory and the grid sizes; then a torch emulation of the
kernel's sums (per-block partials, added in the plan's order) against the
plain version's, in all three modes. The kernel itself runs only on the
card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from fcd_tpu_torch.kernels import finale as k2
from fcd_tpu_torch.kernels.finale_sweep import BATCH, STEP_CALLS

import torch_port_workers

torch_port_workers.share_cores()

SMEM_MAX = 232448     # bytes a block can use on an H100
# the step's calls at batch 4, then ragged grids (pooled grids must be even)
CALLS = ([(b, g, g, g, c, mode) for _, g, c, mode, _ in STEP_CALLS
          for b in (1, BATCH)]
         + [(b, 6, 8, 10, c, mode) for b in (1, 4) for c in (16, 24, 12)
            for mode in ("even", "chain")]
         + [(b, 5, 7, 9, c, "none") for b in (1, 4) for c in (16, 40, 12)])


def test_step_calls_are_the_train_steps():
    assert sum(n for *_, n in STEP_CALLS) == \
        chip_smoke.per_train_step()["finale_bwd"] == 23


def block_tiles(plan, x):
    """The tiles block x of a batch item walks (finale_bwd_kernel's t0,
    t1)."""
    return range(x * plan.tiles // plan.grid[0],
                 (x + 1) * plan.tiles // plan.grid[0])


def _units_of(plan, x):
    """The units block x of a batch item takes, in thread order per tile."""
    per_tile = plan.threads * plan.per_thread
    out = []
    for tile in block_tiles(plan, x):
        for i in range(plan.per_thread):
            u = tile * per_tile + i * plan.threads + torch.arange(plan.threads)
            out.append(u[u < plan.units])
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.long)


@pytest.mark.parametrize("call", CALLS)
def test_plan_covers_every_unit_once(call):
    b, d, h, w, c, mode = call
    plan = k2.finale_bwd_plan(b, d, h, w, c, mode)
    blocks = plan.grid[0]
    assert plan.grid[1] == b and plan.rows == blocks * b
    if mode != "none" or c % 8:
        assert plan.vec == 1
    else:   # 8 channels a thread where those blocks fill the SMs
        assert (plan.vec == 8) == (
            k2.plan_for(b, d, h, w, c, mode, 8).rows >= k2.SMS)
    assert plan.groups * plan.vec == c
    nvox = d * h * w // (8 if mode != "none" else 1)
    assert plan.units == nvox * plan.groups
    # the blocks' tiles partition the item's tiles, in order
    starts = [block_tiles(plan, x) for x in range(blocks)]
    assert starts[0].start == 0 and starts[-1].stop == plan.tiles
    assert all(a.stop == n.start for a, n in zip(starts, starts[1:]))
    assert all(0 < len(r) <= plan.tiles_per_block for r in starts)
    per_tile = plan.threads * plan.per_thread
    assert (plan.tiles - 1) * per_tile < plan.units <= plan.tiles * per_tile
    # a thread's channel group is the same on every tile
    assert plan.threads % plan.groups == 0
    assert (plan.threads // plan.groups) & (plan.threads // plan.groups - 1) == 0
    if plan.units <= 1 << 16:
        units = torch.cat([_units_of(plan, x) for x in range(blocks)])
        assert torch.equal(units.sort().values, torch.arange(plan.units))


@pytest.mark.parametrize("call", CALLS[:2 * len(STEP_CALLS)])
def test_plan_fills_the_card_and_fits(call):
    """At the step's shapes of 32^3 and more, at least one block an SM and
    at most a few hundred partial rows; shared memory within a block's."""
    b, d, h, w, c, mode = call
    plan = k2.finale_bwd_plan(b, d, h, w, c, mode)
    assert plan.smem <= SMEM_MAX
    assert plan.threads <= k2.BUILT[plan.vec][0]
    if b == BATCH:   # 16-byte accesses without the pool, down to 32^3
        assert plan.vec == (8 if mode == "none" and d >= 32 else 1)
        # blocks walk MIN_WALK tiles, or fill the SMs
        assert (plan.tiles_per_block >= k2.MIN_WALK
                or plan.rows * plan.threads >= k2.SMS * 256)
    if d >= 32 and b == BATCH:
        assert plan.grid[0] * plan.grid[1] >= k2.SMS
        assert plan.rows <= 4 * k2.SMS
    # the same plan, and the same rows in the same order, on every call
    assert k2.finale_bwd_plan(b, d, h, w, c, mode) is plan
    assert plan == k2.plan_for(b, d, h, w, c, mode, plan.vec)


@pytest.mark.parametrize("c", [8, 16, 24, 64, 512, 1024, 12, 4, 300, 1000])
def test_every_width_takes_a_path(c):
    """Without the pool C % 8 == 0 takes the 16-byte path where it fills
    the SMs (4 x 64^3); the pool modes, any other C, unaligned tensors and
    a call too small to fill the SMs (4 x 4^3) one channel a thread."""
    for mode in k2.MODES:
        plan = k2.finale_bwd_plan(4, 64, 64, 64, c, mode)
        assert plan.vec == (8 if c % 8 == 0 and mode == "none" else 1)
        assert plan.smem <= SMEM_MAX
        assert k2.finale_bwd_plan(4, 64, 64, 64, c, mode, False).vec == 1
        assert k2.finale_bwd_plan(4, 4, 4, 4, c, mode).vec == 1
        # every instance takes each mode it is built for
        for vec, (bound, _) in k2.BUILT.items():
            if c % vec == 0 and c // vec <= bound and (
                    vec == 1 or mode == "none"):
                assert k2.plan_for(4, 4, 4, 4, c, mode, vec).vec == vec


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="even grid"):
        k2.plan_for(1, 5, 8, 8, 16, "even", 1)
    with pytest.raises(ValueError, match="does not divide"):
        k2.plan_for(1, 4, 4, 4, 12, "none", 8)
    with pytest.raises(ValueError, match="one channel"):
        k2.plan_for(1, 4, 4, 4, 16, "even", 8)
    with pytest.raises(ValueError, match="does not divide"):
        k2.plan_for(1, 4, 4, 4, 16, "none", 4)
    with pytest.raises(ValueError, match="threads"):
        k2.plan_for(1, 4, 4, 4, 1028, "none", 1)
    with pytest.raises(ValueError, match="mode"):
        k2.plan_for(1, 4, 4, 4, 16, "odd", 8)


def test_instances_are_the_cuda_sources():
    """BUILT is what `launch_mode` in csrc/finale_bwd.cu builds and
    dispatches on: one channel a thread in every mode, 8 without the
    pool."""
    src = (Path(k2.__file__).parents[1] / "csrc" / "finale_bwd.cu").read_text()
    found = re.findall(r"if \(vec == (\d+)\) return launch<(\d+), (\w+), "
                       r"(\d+), (\d+)>", src)
    assert all(v == v2 for v, v2, *_ in found)
    assert {int(v): (int(nt), int(m)) for v, _, _, nt, m in found} == k2.BUILT
    assert {int(v): mode for v, _, mode, _, _ in found} == {
        1: "MODE", 8: "NO_POOL"}


def emulate_sums(plan, ys, rs, s2, b2, sr, br, gp, gq, slope, tie):
    """The kernel's sums on f32 inputs: each block adds its units' dt*ys,
    dt, dt*rs into its partial row, then each item's rows are added in
    block order (dt from the plain version)."""
    b, d, h, w, c = ys.shape
    dt = k2.finale_bwd_plain(ys, rs, s2, b2, sr, br, gp, gq, slope, tie)[0]
    terms = torch.stack([dt * ys, dt, dt * rs], dim=-1)     # (..., C, 3)
    if plan.mode != "none":
        # unit = pooled voxel x group: children grouped by pooled voxel
        t = terms.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c, 3)
        t = t.permute(0, 1, 3, 5, 2, 4, 6, 7, 8).reshape(b, -1, 8, c, 3)
        t = t.sum(2)                                  # (b, pooled, C, 3)
    else:
        t = terms.reshape(b, -1, c, 3)
    # (b, units, vec, 3): unit u = voxel * groups + channel group
    t = t.reshape(b, plan.units, plan.vec, 3)
    rows = torch.zeros(plan.rows, 3, c)
    for item in range(b):
        for x in range(plan.grid[0]):
            u = _units_of(plan, x)
            part = t[item, u].reshape(-1, plan.groups, plan.vec, 3).sum(0)
            rows[item * plan.grid[0] + x] = part.reshape(c, 3).T
    out = torch.zeros(3, b, c)
    for item in range(b):
        for x in range(plan.grid[0]):
            out[:, item] += rows[item * plan.grid[0] + x]
    return out


@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("b,grid,c", [(1, (6, 8, 10), 16), (4, (6, 8, 10), 24),
                                      (2, (4, 6, 8), 12), (1, (8, 8, 8), 64),
                                      (2, (16, 16, 16), 16)])
def test_emulated_decomposition_matches_the_plain_sums(mode, b, grid, c):
    g = torch.Generator().manual_seed(c + b)
    shape = (b, *grid, c)
    ys = torch.randint(-2, 3, shape, generator=g).float()
    rs, gp = (torch.randn(shape, generator=g) for _ in range(2))
    gq = (None if mode == "none" else torch.randn(
        (b, *(v // 2 for v in grid), c), generator=g))
    s2 = torch.rand(b, c, generator=g) + 0.5
    b2, br = (0.1 * torch.randn(b, c, generator=g) for _ in range(2))
    sr = torch.rand(b, c, generator=g) + 0.5
    tie = "even" if mode == "none" else mode
    args = (ys, rs, s2, b2, sr, br, gp, gq, 0.01, tie)
    # a small block count, so that blocks walk several tiles
    for plan in (k2.finale_bwd_plan(*shape, mode),
                 k2.plan_for(*shape, mode, k2.finale_bwd_plan(
                     *shape, mode).vec, 2)):
        got = emulate_sums(plan, *args)
        want = k2.finale_bwd_plain(*args)[1:]
        for s in range(3):
            torch.testing.assert_close(got[s], want[s], rtol=1e-5, atol=1e-4)
        # the fixed order: the same bits again
        assert torch.equal(got, emulate_sums(plan, *args))
