"""K3 / K4: the train spatial-attention tail of the DSA block.

Replaces `fcd_tpu/kernels/spatial_attn.py::spatial_attn_fwd_pallas` (K3)
and `spatial_attn_bwd_pallas` (K4). The CUDA kernels are
`fcd_tpu_torch/csrc/spatial_attn.cu`; its header gives the math, what
bounds them on the card and what their design does about that.

    attn = softmax_per_head(qn @ kpb) dropped out (rate, inverted scaling)
    out  = bf16(attn) @ vpb

qn (B, N, C), kpb (B, C, h*P) (block-expanded keys, temperature folded),
vpb (B, h*P, C). `SpatialAttn` is the `torch.autograd.Function` the train
DSA calls: forward K3, backward K4.

Dropout bits come from a counter-based hash of (seed, salt, b, token,
column) (`keep_mask`), written identically in the kernels and here with
int64 torch ops, so the kernel's masks and the plain version's are the
same bits and K4 regenerates K3's mask. The seed is drawn per step and
the salt names the layer, so every layer of every step draws its own
mask. The JAX package draws from another stream (ROADMAP C2): parity with
it holds at rate 0.

CPU tensors take the plain PyTorch versions; CUDA tensors launch the
kernels or raise. The kernels take bf16 tensors; f32 tensors (the f32
route of a model that computes in f32, ROADMAP C18, where the JAX package
runs `spatial_attn_train` in f32 and its bf16 roundings are no-ops) run
the wide instances' f32 instantiation at every (C, P) of B5's set
(`spatial_attn_fwd` and `_bwd` dispatch on the dtype to
`_spatial_attn_fwd_f32` / `_bwd_f32`, counted apart and planned by
`spatial_attn_plan_f32`). The plain versions serve both dtypes.
`spatial_attn_plan` (pure Python) picks their tiles, chunks and head split; one K3 call is one
launch, one K4 call two (the product kernel and its finishing pass, which
adds the partial sums in a fixed order and writes dkpb and dvpb in the
dtype the caller asks for).

Widths: every (C, P) that B5 takes with 4 heads (C a power of two from 8
to 512, P 16, 32, 64 or 128). The tensor-core instances take
`SHAPES` (C 16 .. 256, P <= 64, C P <= 8192); the others (`SHAPES_WIDE`)
run the wide instances of the same source (a `wide` plan, `wide_plan`):
CUDA-core kernels whose K4 splits each head's P columns over `col_split`
blocks so that a block's dkpb and dvpb sums stay 32 f32 a thread.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from fcd_tpu_torch.kernels import _build

REPLACES_FWD = "fcd_tpu/kernels/spatial_attn.py:156"  # spatial_attn_fwd_pallas (pallas_call :166)
REPLACES_BWD = "fcd_tpu/kernels/spatial_attn.py:178"  # spatial_attn_bwd_pallas (pallas_call :190)

_M32 = 0xFFFFFFFF


def _mul32(h, k: int):
    """(h * k) mod 2^32 for h in [0, 2^32), without int64 overflow."""
    return ((h & 0xFFFF) * k + ((((h >> 16) * k) & _M32) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finaliser on ints (Python or int64 tensors)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_key(seed: int, salt: int) -> int:
    """The 32-bit key of one layer (salt) in one step (seed)."""
    return _fmix32((int(seed) & _M32) ^ _fmix32((int(salt) + 0x632BE5AB) & _M32))


def keep_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), _M32)


def keep_mask(b: int, n: int, hp: int, key: int, rate: float,
              device=None) -> torch.Tensor:
    """(B, N, hP) bool: the kernels' dropout keep bits."""
    idx = torch.arange(b * n * hp, dtype=torch.int64, device=device) & _M32
    h = _fmix32(_mul32(idx, 0x9E3779B1) ^ key)
    return (h >= keep_threshold(rate)).reshape(b, n, hp)


def _softmax_segments(logits: torch.Tensor, h: int) -> torch.Tensor:
    b, n, hp = logits.shape
    return torch.softmax(logits.reshape(b, n, h, hp // h), dim=-1).reshape(
        b, n, hp)


def _attn(qn, kpb, h, key, rate):
    """(soft, attn, keep): the f32 segment softmax, the dropped attention
    rounded to qn's dtype, and the keep mask (None at rate 0)."""
    b, n, _ = qn.shape
    hp = kpb.shape[-1]
    soft = _softmax_segments(qn.float() @ kpb.float(), h)
    keep = None
    attn = soft
    if rate > 0.0:
        keep = keep_mask(b, n, hp, key, rate, qn.device)
        attn = torch.where(keep, soft * (1.0 / (1.0 - rate)),
                           torch.zeros_like(soft))
    return soft, attn.to(qn.dtype).float(), keep


def spatial_attn_fwd_plain(qn, kpb, vpb, h: int, key: int,
                           rate: float) -> torch.Tensor:
    _, attn, _ = _attn(qn, kpb, h, key, rate)
    return (attn @ vpb.float()).to(qn.dtype)


def spatial_attn_bwd_plain(qn, kpb, vpb, g, h: int, key: int, rate: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dqn in qn's dtype, dkpb f32, dvpb f32)."""
    b, n, _ = qn.shape
    hp = kpb.shape[-1]
    soft, attn, keep = _attn(qn, kpb, h, key, rate)
    gf = g.float()
    dvpb = attn.transpose(1, 2) @ gf
    da = gf @ vpb.float().transpose(1, 2)
    if keep is not None:
        da = torch.where(keep, da * (1.0 / (1.0 - rate)), torch.zeros_like(da))
    s4 = soft.reshape(b, n, h, hp // h)
    d4 = da.reshape(b, n, h, hp // h)
    ds = (s4 * (d4 - (d4 * s4).sum(-1, keepdim=True))).reshape(b, n, hp)
    ds = ds.to(qn.dtype).float()
    dqn = (ds @ kpb.float().transpose(1, 2)).to(qn.dtype)
    dkpb = qn.float().transpose(1, 2) @ ds
    return dqn, dkpb, dvpb


# -- the kernels' plan ----------------------------------------------------------

SMS = 132                   # the H100's streaming multiprocessors
NW = 8                      # warps of a K3 or K4 block (256 threads)
SMEM_CAP = 232448           # shared memory one block may hold (227 KiB)
TILES = (128, 64, 32, 16)   # K4's tokens a step, largest first
FWD_BLOCKS = 2 * SMS        # K3's blocks aim at this many
PART_BUDGET = 24 << 20      # bytes of K4's f32 chunk partials at most
SUM_VALUES = 8192           # K4's dkpb (and dvpb) values a block sums in
                            # registers: 32 f32 a thread each


def _head_blocks(c: int, p: int) -> Tuple[int, ...]:
    """The heads a K4 block may own at (C, P): its dkpb and dvpb sums, C x
    (heads x P) f32 each, stay in registers, and where it owns more than
    one head, dqn's 16 x C accumulator too (C <= 128)."""
    return tuple(hb for hb in (1, 2, 4)
                 if hb * c * p <= SUM_VALUES and (hb == 1 or c <= 128))


# (C, P) the tensor-core kernels are built for (C a power of two from 16 to
# 256, P 16, 32 or 64, C P <= SUM_VALUES), and the heads a K4 block may own
# there; csrc/spatial_attn.cu's SHAPES_FWD and SHAPES_BWD list the same
SHAPES = {(c, p): _head_blocks(c, p) for c in (16, 32, 64, 128, 256)
          for p in (16, 32, 64) if c * p <= SUM_VALUES}

# every width the kernels take (B5's set at 4 heads), and the ones the wide
# instances run (csrc/spatial_attn.cu::wide_ok)
WIDTHS = tuple(8 << i for i in range(7))        # C: 8 .. 512
PROJECTIONS = (16, 32, 64, 128)
SHAPES_WIDE = tuple((c, p) for c in WIDTHS for p in PROJECTIONS
                    if (c, p) not in SHAPES)
WIDE_SUMS = 8192      # a wide block's tokens x C, and K4's C x its columns
WIDE_TILE = 64        # a wide block's tokens at most


def wide_tile(c: int) -> int:
    """A wide block's tokens: 4096 / C within 16 .. WIDE_TILE (tokens x C
    <= WIDE_SUMS), so that level-4 and -5 grids give 128 blocks or more."""
    return max(16, min(WIDE_TILE, 4096 // c))


def _pitch(n: int) -> int:
    """csrc/spatial_attn.cu::pitch: a bf16 row of >= n elements, an odd
    multiple of 16 bytes."""
    v = -(-n // 8)
    return 8 * v + (8 if v % 2 == 0 else 16)


def smem_fwd(c: int, hp: int) -> int:
    """Shared memory of a K3 block: kpb and vpb of one batch item, and
    each warp's 16-token tile."""
    return 2 * (c * _pitch(hp) + hp * _pitch(c) + NW * 16 * _pitch(c))


def smem_bwd(c: int, hbp: int, t: int) -> int:
    """Shared memory of a K4 block: its heads' kpb columns and vpb rows,
    two stages of the qn and g tiles, and the tile's a and ds."""
    return 2 * (c * _pitch(hbp) + hbp * _pitch(c) + 4 * t * _pitch(c)
                + 2 * t * _pitch(hbp))


def smem_fwd_wide(c: int, p: int, t: int, esize: int = 2,
                  pb: Optional[int] = None) -> int:
    """A wide K3 block (csrc/spatial_attn.cu::wide_fwd_smem): the qn tile,
    pb columns (all P by default) of one head's C x P operand at pitch
    pb + 2, the head's f32 scores; operands of `esize` bytes (2 bf16, 4
    f32)."""
    pb = p if pb is None else pb
    return esize * t * c + esize * c * (pb + 2) + 4 * t * p


def smem_bwd_wide(c: int, p: int, t: int, split: int, esize: int = 2,
                  pb: Optional[int] = None) -> int:
    """A wide K4 block (csrc/spatial_attn.cu::wide_bwd_smem): the qn and g
    tiles, pb columns of one head's C x P operand at pitch pb + 2, s and
    da / ds (t x P f32), a on its P / split columns, and those columns of
    kpb at pitch P / split + 2."""
    cs, pb = p // split, p if pb is None else pb
    return (2 * esize * t * c + esize * c * (pb + 2) + 8 * t * p
            + 4 * t * cs + esize * c * (cs + 2))


class SpattnPlan(NamedTuple):
    """K3's and K4's decomposition. Their accumulators live in registers:
    K3's 16 x cols outputs a warp, K4's dkpb and dvpb sums over its chunk
    (split over the block's warps) and, split by row, dqn; split by head,
    dqn goes out as f32 partials (`dq_groups`) that the finishing pass
    adds."""
    n: int
    c: int
    p: int
    heads: int
    batch: int
    cols: int        # K3: output columns a warp unit computes
    per_block: int   # K3: units (16 tokens x cols) a block walks
    fwd_blocks: int  # K3: blocks per batch item
    smem_fwd: int
    tile: int        # K4: tokens a block takes a step (a multiple of 16)
    tiles: int       # K4: ceil(N / tile)
    head_block: int  # K4: heads a block owns
    chunks: int      # K4: blocks along the tokens per head group and item
    smem_bwd: int
    wide: bool = False   # the wide instances (SHAPES_WIDE)
    col_split: int = 1   # wide K4: blocks each head's P columns split over
    col_block: int = 0   # wide: a head's columns staged at a time (0: P)
    f32: bool = False    # the f32 instances

    @property
    def units(self) -> int:
        """K3's warp units per batch item: 16-token tiles x column groups."""
        return -(-self.n // 16) * (self.c // self.cols)

    @property
    def head_groups(self) -> int:
        return self.heads // self.head_block

    @property
    def split(self) -> str:
        """"row": a K4 block owns every head and writes dqn itself; "head":
        each head group (wide: each head's column split) writes an f32
        partial of dqn, added in group order by the finishing pass."""
        return "row" if self.head_block == self.heads > 1 else "head"

    @property
    def dq_groups(self) -> int:
        return 0 if self.split == "row" else self.head_groups * self.col_split

    @property
    def fwd_grid(self) -> int:
        return self.fwd_blocks * self.batch

    @property
    def bwd_grid(self) -> int:
        return self.chunks * self.head_groups * self.col_split * self.batch

    @property
    def partial_bytes(self) -> int:
        """K4's f32 scratch: the chunks' dkpb and dvpb, the groups' dqn."""
        hp = self.heads * self.p
        return 4 * (2 * self.chunks * self.batch * self.c * hp
                    + self.dq_groups * self.batch * self.n * self.c)

    def fwd_units(self, block: int) -> range:
        """The K3 units block `block` walks (unit u: tokens 16 (u // g) ..,
        columns cols * (u % g) .., g = C / cols)."""
        return range(block * self.per_block,
                     min((block + 1) * self.per_block, self.units))

    def chunk_tiles(self, k: int) -> range:
        """The K4 tiles chunk k walks, in order; the finishing pass adds the
        chunks' partials in the order k = 0, 1, ..."""
        return range(k * self.tiles // self.chunks,
                     (k + 1) * self.tiles // self.chunks)


def plan_for(n: int, c: int, p: int, heads: int, batch: int, tile: int,
             chunks: int, head_block: int) -> SpattnPlan:
    """The plan with these K4 tiles, chunks and heads a block (K3's units
    a block by the rule). Raises ValueError on what the kernels do not
    take."""
    if (c, p) not in SHAPES or heads < 1 or n < 1 or batch < 1:
        raise ValueError(
            f"spatial_attn kernels: N={n} C={c} P={p} heads={heads} "
            f"batch={batch} not supported ((C, P) in {sorted(SHAPES)})")
    if head_block not in SHAPES[(c, p)] or heads % head_block:
        raise ValueError(f"spatial_attn kernels: {head_block} heads a block "
                         f"at C={c} P={p} with {heads} heads")
    if tile not in TILES:
        raise ValueError(f"spatial_attn kernels: tile {tile} not in {TILES}")
    hp = heads * p
    cols = min(c, 128)
    units = -(-n // 16) * (c // cols)
    per_block = max(1, min(-(-units * batch // FWD_BLOCKS), units))
    tiles = -(-n // tile)
    if not 1 <= chunks <= tiles:
        raise ValueError(f"spatial_attn kernels: {chunks} chunks of "
                         f"{tiles} tiles")
    sf, sb = smem_fwd(c, hp), smem_bwd(c, head_block * p, tile)
    if max(sf, sb) > SMEM_CAP:
        raise ValueError(f"spatial_attn kernels: C={c} hP={hp} tile {tile} "
                         f"needs {max(sf, sb)} bytes of shared memory")
    return SpattnPlan(n, c, p, heads, batch, cols, per_block,
                      -(-units // per_block), sf, tile, tiles, head_block,
                      chunks, sb)


@functools.lru_cache(maxsize=None)
def spatial_attn_plan(n: int, c: int, p: int, heads: int,
                      batch: int = 1) -> SpattnPlan:
    """K3's and K4's decomposition for N tokens of width C, `heads` heads
    of P columns, `batch` items. K3: blocks of units, as many as make
    about FWD_BLOCKS blocks. K4: a block owns the most heads whose sums
    fit its registers (level 3: all, the whole row), and one block fits an
    SM, so its grid is one wave: SMS // (head groups x items) chunks (their
    partials within PART_BUDGET), with the largest tile of TILES that gives
    every chunk a tile; where none does (levels 5-6 of small N), the
    smallest tile and a chunk a tile. So level 3's blocks walk many tiles
    and the small levels get small tiles (`spattn_sweep --plans` times the
    alternatives: a second wave lost at levels 4-5). Raises ValueError on
    shapes the kernels do not take."""
    if (c, p) in SHAPES_WIDE and heads >= 1:
        return wide_plan(n, c, p, heads, batch)
    if (c, p) not in SHAPES or heads < 1:
        raise ValueError(f"spatial_attn kernels: C={c} P={p} heads={heads} "
                         f"not supported (C a power of two from 8 to 512, P "
                         f"in {PROJECTIONS})")
    hb = max(k for k in SHAPES[(c, p)] if heads % k == 0)
    fits = [t for t in TILES if smem_bwd(c, hb * p, t) <= SMEM_CAP]
    if not fits:
        raise ValueError(f"spatial_attn kernels: C={c} P={p} heads a block "
                         f"{hb} do not fit shared memory")
    most = max(1, PART_BUDGET // (8 * batch * c * heads * p))
    want = max(1, min(SMS // (heads // hb * batch), most))
    t = next((t for t in fits if -(-n // t) >= want), fits[-1])
    return plan_for(n, c, p, heads, batch, t, min(want, -(-n // t)), hb)


def wide_plan(n: int, c: int, p: int, heads: int,
              batch: int = 1, f32: bool = False) -> SpattnPlan:
    """The wide instances' plan at (C, P) in SHAPES_WIDE (with f32, the f32
    instances' at any (C, P) of WIDTHS x PROJECTIONS): tiles of
    wide_tile(C) tokens (a K3 block takes one; units of
    16 tokens, one column group), each head's P columns split over C P /
    WIDE_SUMS K4 blocks (at least 1), and K4 blocks along the tokens as
    many as make about one wave, their partials within PART_BUDGET. The
    bf16 instances stage a head's P columns at once; the f32 ones the most
    of P, P / 2, P / 4, ... (at least 8) whose blocks fit shared memory.
    Raises ValueError on what they do not take."""
    ok = ((c in WIDTHS and p in PROJECTIONS) if f32
          else (c, p) in SHAPES_WIDE)
    if not ok or heads < 1 or n < 1 or batch < 1:
        raise ValueError(f"spatial_attn wide kernels: N={n} C={c} P={p} "
                         f"heads={heads} batch={batch} not supported")
    tok = wide_tile(c)
    split = max(1, c * p // WIDE_SUMS)
    units = -(-n // 16)
    per_block = tok // 16
    tiles = -(-n // tok)
    most = max(1, PART_BUDGET // (8 * batch * c * heads * p))
    chunks = max(1, min(SMS // (heads * split * batch), most, tiles))
    esize = 4 if f32 else 2
    blocks = [p >> k for k in range(5) if p >> k >= 8] if f32 else [p]

    def smem(pb):
        return (smem_fwd_wide(c, p, tok, esize, pb),
                smem_bwd_wide(c, p, tok, split, esize, pb))

    pb = next((b for b in blocks if max(smem(b)) <= SMEM_CAP), None)
    if pb is None:
        raise ValueError(f"spatial_attn wide kernels: C={c} P={p} do not "
                         f"fit shared memory")
    sf, sb = smem(pb)
    return SpattnPlan(n, c, p, heads, batch, c, per_block,
                      -(-units // per_block), sf, tok, tiles, 1, chunks, sb,
                      True, split, pb, f32)


@functools.lru_cache(maxsize=None)
def spatial_attn_plan_f32(n: int, c: int, p: int, heads: int,
                          batch: int = 1) -> SpattnPlan:
    """The f32 instances' plan (`wide_plan` with f32) at every (C, P) that
    B5 takes."""
    return wide_plan(n, c, p, heads, batch, f32=True)


# -- the wrappers ----------------------------------------------------------------

_FNS = {}


def _fns():
    if not _FNS:
        lib = _build.load("spatial_attn")
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        fwd = lib.fcd_spatial_attn_fwd
        fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cu,
                        cu, cf, ci, vp]
        fwd.restype = ci
        bwd = lib.fcd_spatial_attn_bwd
        bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                        ci, ci, ci, ci, ci, ci, ci, cu, cu, cf, ci, vp]
        bwd.restype = ci
        fwd_w = lib.fcd_spatial_attn_fwd_wide
        fwd_w.argtypes = [vp, vp, vp, vp] + [ci] * 8 + [cu, cu, cf, ci, vp]
        fwd_w.restype = ci
        bwd_w = lib.fcd_spatial_attn_bwd_wide
        bwd_w.argtypes = [vp] * 10 + [ci] * 12 + [cu, cu, cf, ci, vp]
        bwd_w.restype = ci
        _FNS.update(fwd=fwd, bwd=bwd, fwd_wide=fwd_w, bwd_wide=bwd_w)
    return _FNS


def _check(qn, kpb, vpb, h, g=None):
    if qn.dim() != 3 or kpb.dim() != 3 or vpb.dim() != 3:
        raise ValueError("qn, kpb, vpb must be 3-D")
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    if tuple(kpb.shape) != (b, c, hp) or tuple(vpb.shape) != (b, hp, c):
        raise ValueError(f"kpb {tuple(kpb.shape)} / vpb {tuple(vpb.shape)} "
                         f"do not fit qn {tuple(qn.shape)}")
    if hp % h:
        raise ValueError(f"{h} heads do not divide hP = {hp}")
    if g is not None and g.shape != qn.shape:
        raise ValueError("g must have qn's shape")
    for t in (kpb, vpb) + (() if g is None else (g,)):
        if t.device != qn.device:
            raise ValueError("spatial_attn tensors must share one device")
    if qn.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spatial_attn: unsupported device {qn.device}")


def _check_plan(plan, qn, kpb, h):
    """Raises ValueError if `plan` was made for another shape."""
    b, n, c = qn.shape
    got = (n, c, kpb.shape[-1] // h, h, b)
    if (plan.n, plan.c, plan.p, plan.heads, plan.batch) != got:
        raise ValueError(
            f"spatial_attn: a plan for N={plan.n} C={plan.c} P={plan.p} "
            f"heads={plan.heads} batch={plan.batch} given N, C, P, heads, "
            f"batch = {got}")


def _kernel_args(qn, kpb, vpb, g=None, dtype=torch.bfloat16):
    ts = (qn, kpb, vpb) + (() if g is None else (g,))
    if any(t.dtype != dtype for t in ts):
        raise TypeError(f"spatial_attn kernels take {dtype} tensors here: "
                        "bf16 (the kernel route) or f32 (the f32 route, "
                        "ROADMAP C18), one dtype for all")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("spatial_attn kernels take contiguous, 16-byte "
                         "aligned tensors")


def spatial_attn_fwd(qn: torch.Tensor, kpb: torch.Tensor, vpb: torch.Tensor,
                     h: int, key: int, rate: float,
                     plan: Optional[SpattnPlan] = None) -> torch.Tensor:
    """K3 wrapper: (B, N, C) out in qn's dtype. `plan` (default
    `spatial_attn_plan`'s) sets the kernel's blocks."""
    _check(qn, kpb, vpb, h)
    if plan is not None:
        _check_plan(plan, qn, kpb, h)
    if qn.device.type == "cpu":
        return spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate)
    if qn.dtype == torch.float32:
        return _spatial_attn_fwd_f32(qn, kpb, vpb, h, key, rate, plan)
    _kernel_args(qn, kpb, vpb)
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    plan = plan or spatial_attn_plan(n, c, hp // h, h, b)
    out = torch.empty_like(qn)
    if plan.wide:
        _launch_fwd_wide(qn, kpb, vpb, out, h, key, rate, plan)
        spatial_attn_fwd.launches += 1
        return out
    err = _fns()["fwd"](
        _build.ptr(qn), _build.ptr(kpb), _build.ptr(vpb), _build.ptr(out),
        b, n, c, hp, hp // h, plan.cols, plan.per_block, plan.fwd_blocks,
        key, keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
        _build.stream())
    _build.check(err, "spatial_attn_fwd")
    spatial_attn_fwd.launches += 1
    return out


_OUT_DTYPES = (torch.float32, torch.bfloat16)


def spatial_attn_bwd(qn: torch.Tensor, kpb: torch.Tensor, vpb: torch.Tensor,
                     g: torch.Tensor, h: int, key: int, rate: float,
                     dtypes=(torch.float32, torch.float32),
                     plan: Optional[SpattnPlan] = None):
    """K4 wrapper: (dqn in qn's dtype, dkpb, dvpb in `dtypes`, f32 or bf16).
    On the card one call is the product kernel and its finishing pass;
    `plan` (default `spatial_attn_plan`'s) sets their decomposition."""
    _check(qn, kpb, vpb, h, g)
    if plan is not None:
        _check_plan(plan, qn, kpb, h)
    if qn.device.type == "cpu":
        dqn, dkpb, dvpb = spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key,
                                                 rate)
        return dqn, dkpb.to(dtypes[0]), dvpb.to(dtypes[1])
    if qn.dtype == torch.float32:
        return _spatial_attn_bwd_f32(qn, kpb, vpb, g, h, key, rate, dtypes,
                                     plan)
    _kernel_args(qn, kpb, vpb, g)
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    plan = plan or spatial_attn_plan(n, c, hp // h, h, b)
    if plan.wide:
        out = _launch_bwd_wide(qn, kpb, vpb, g, h, key, rate, dtypes, plan)
        spatial_attn_bwd.launches += 1
        return out
    dqn, dq_part, dk_part, dv_part, dkpb, dvpb = _bwd_buffers(qn, kpb, dtypes,
                                                              plan)
    err = _fns()["bwd"](
        _build.ptr(qn), _build.ptr(kpb), _build.ptr(vpb), _build.ptr(g),
        _build.ptr(dqn), _build.ptr(dq_part), _build.ptr(dk_part),
        _build.ptr(dv_part), _build.ptr(dkpb), _build.ptr(dvpb),
        int(dtypes[0] == torch.bfloat16), int(dtypes[1] == torch.bfloat16),
        b, n, c, hp, hp // h, plan.head_block, plan.tile, plan.chunks, key,
        keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
        _build.stream())
    _build.check(err, "spatial_attn_bwd")
    spatial_attn_bwd.launches += 1
    return dqn, dkpb, dvpb


def _bwd_buffers(qn, kpb, dtypes, plan):
    """dqn in qn's dtype, K4's f32 scratch (the chunks' dkpb and dvpb
    partials, the groups' dqn partials) and dkpb, dvpb in `dtypes`."""
    if any(d not in _OUT_DTYPES for d in dtypes):
        raise TypeError(f"spatial_attn_bwd writes dkpb and dvpb in f32 or "
                        f"bf16, not {dtypes}")
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    dev, f32 = qn.device, torch.float32
    return (torch.empty_like(qn),
            (torch.empty((plan.dq_groups, b, n, c), dtype=f32, device=dev)
             if plan.dq_groups else None),
            torch.empty((plan.chunks, b, c, hp), dtype=f32, device=dev),
            torch.empty((plan.chunks, b, hp, c), dtype=f32, device=dev),
            torch.empty((b, c, hp), dtype=dtypes[0], device=dev),
            torch.empty((b, hp, c), dtype=dtypes[1], device=dev))


def _launch_fwd_wide(qn, kpb, vpb, out, h, key, rate, plan):
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    err = _fns()["fwd_wide"](
        _build.ptr(qn), _build.ptr(kpb), _build.ptr(vpb), _build.ptr(out),
        b, n, c, hp, hp // h, plan.tile, plan.col_block or hp // h,
        int(plan.f32), key, keep_threshold(rate), 1.0 / (1.0 - rate),
        int(rate > 0.0), _build.stream())
    _build.check(err, "spatial_attn_fwd")


def _launch_bwd_wide(qn, kpb, vpb, g, h, key, rate, dtypes, plan):
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    dqn, dq_part, dk_part, dv_part, dkpb, dvpb = _bwd_buffers(qn, kpb, dtypes,
                                                              plan)
    err = _fns()["bwd_wide"](
        _build.ptr(qn), _build.ptr(kpb), _build.ptr(vpb), _build.ptr(g),
        _build.ptr(dqn), _build.ptr(dq_part), _build.ptr(dk_part),
        _build.ptr(dv_part), _build.ptr(dkpb), _build.ptr(dvpb),
        int(dtypes[0] == torch.bfloat16), int(dtypes[1] == torch.bfloat16),
        b, n, c, hp, hp // h, plan.tile, plan.chunks, plan.col_split,
        plan.col_block or hp // h, int(plan.f32), key, keep_threshold(rate),
        1.0 / (1.0 - rate), int(rate > 0.0), _build.stream())
    _build.check(err, "spatial_attn_bwd")
    return dqn, dkpb, dvpb


def _f32_plan(qn, kpb, h, plan):
    b, n, c = qn.shape
    plan = plan or spatial_attn_plan_f32(n, c, kpb.shape[-1] // h, h, b)
    if not plan.f32:
        raise ValueError("spatial_attn f32 kernels take an f32 plan "
                         "(spatial_attn_plan_f32)")
    _check_plan(plan, qn, kpb, h)
    return plan


def _spatial_attn_fwd_f32(qn, kpb, vpb, h, key, rate, plan):
    """K3 on f32 CUDA tensors (`spatial_attn_fwd` checked them): the wide
    kernel's f32 instance, one launch and a count of its own."""
    _kernel_args(qn, kpb, vpb, dtype=torch.float32)
    plan = _f32_plan(qn, kpb, h, plan)
    out = torch.empty_like(qn)
    _launch_fwd_wide(qn, kpb, vpb, out, h, key, rate, plan)
    _spatial_attn_fwd_f32.launches += 1
    return out


def _spatial_attn_bwd_f32(qn, kpb, vpb, g, h, key, rate, dtypes, plan):
    """K4 on f32 CUDA tensors (`spatial_attn_bwd` checked them): the wide
    kernel's f32 instance and the finishing pass, its own count."""
    _kernel_args(qn, kpb, vpb, g, dtype=torch.float32)
    plan = _f32_plan(qn, kpb, h, plan)
    out = _launch_bwd_wide(qn, kpb, vpb, g, h, key, rate, dtypes, plan)
    _spatial_attn_bwd_f32.launches += 1
    return out


spatial_attn_fwd.launches = 0
spatial_attn_bwd.launches = 0
_spatial_attn_fwd_f32.launches = 0
_spatial_attn_bwd_f32.launches = 0


class SpatialAttn(torch.autograd.Function):
    """Differentiable spatial-attention tail: forward K3, backward K4.
    kpb and vpb are taken in qn's dtype, as the TPU kernel takes them."""

    @staticmethod
    def forward(ctx, qn, kpb, vpb, h: int, key: int, rate: float):
        kq, vq = kpb.to(qn.dtype).contiguous(), vpb.to(qn.dtype).contiguous()
        qn = qn.contiguous()
        ctx.save_for_backward(qn, kq, vq)
        ctx.h, ctx.key, ctx.rate = h, key, rate
        ctx.dtypes = (kpb.dtype, vpb.dtype)
        return spatial_attn_fwd(qn, kq, vq, h, key, rate)

    @staticmethod
    def backward(ctx, g):
        qn, kq, vq = ctx.saved_tensors
        dqn, dkpb, dvpb = spatial_attn_bwd(
            qn, kq, vq, g.to(qn.dtype).contiguous(), ctx.h, ctx.key, ctx.rate,
            dtypes=ctx.dtypes)
        return dqn, dkpb, dvpb, None, None, None


def spatial_attn(qn, kpb, vpb, h: int, key: int = 0,
                 rate: float = 0.0) -> torch.Tensor:
    return SpatialAttn.apply(qn, kpb, vpb, h, key, rate)
