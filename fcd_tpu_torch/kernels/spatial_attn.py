"""K3 / K4: the train spatial-attention tail of the DSA block.

Replaces `fcd_tpu/kernels/spatial_attn.py::spatial_attn_fwd_pallas` (K3)
and `spatial_attn_bwd_pallas` (K4). The CUDA kernels are
`fcd_tpu_torch/csrc/spatial_attn.cu`; its header gives the math, what
bounds them on the card and what their design does about that.

    attn = softmax_per_head(qn @ kpb) dropped out (rate, inverted scaling)
    out  = round(attn) @ vpb

qn (B, N, C), kpb (B, C, h*P) (block-expanded keys, temperature folded),
vpb (B, h*P, C). `SpatialAttn` is the `torch.autograd.Function` the train
DSA calls: forward K3, backward K4.

Dropout bits come from a counter-based hash of (seed, salt, b, token,
column) (`keep_mask`), written identically in the kernels and here with
int64 torch ops, so the kernel's masks and the plain version's are the
same bits and K4 regenerates K3's mask. The seed is drawn per step and
the salt names the layer, so every layer of every step draws its own
mask. `offset` is the global index of the call's first sample: a data
mesh's rank passes its own, so each sample keeps the mask the
single-device step gives it. The JAX package draws from another stream (ROADMAP C2): parity with
it holds at rate 0.

CPU tensors take the plain PyTorch versions (every dtype: they round at
the operands' type); CUDA tensors launch the kernels or raise. The
wrappers dispatch on the operands' dtype, as the JAX package's
dtype-generic kernels run at the model's compute type:

- bf16 (the kernel route): `libspatial_attn`, counted on
  `spatial_attn_fwd.launches` / `spatial_attn_bwd.launches`;
- f16 (a model that computes in f16, ROADMAP C20): the same source built
  with -DFCD_F16 (`libspatial_attn_f16`), the same plans, counted on
  `FWD_F16` / `BWD_F16`;
- f32 (the f32 route, ROADMAP C18, where the JAX package's bf16 roundings
  are no-ops): the wide kernels' f32 instances at every (C, P) of B5's
  set, planned by `spatial_attn_plan_f32`, counted on `FWD_F32` /
  `BWD_F32`.

Widths: every (C, P) that B5 takes (C a power of two from 8 to 512, P 16,
32, 64 or 128). The 16-bit tensor-core instances take `SHAPES` (C 16 ..
256, P <= 64, C P <= 8192, any heads): K3 one launch, K4 two (the product
kernel and its finishing pass, which adds the partial sums in a fixed
order). The others (`SHAPES_WIDE`), and every f32 call, run the wide
instances (`wide_plan`, 1, 2 or 4 heads): 32-token row blocks that own
every head (K3 one launch), and for K4 the row blocks, the token sums of
dkpb and dvpb in chunks of the tokens, and the finishing pass (three
launches). Every plan is pure Python; the finishing pass writes dkpb and
dvpb in the dtype the caller asks for (f32, or the operands' 16-bit
type).
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
              device=None, offset: int = 0) -> torch.Tensor:
    """(B, N, hP) bool: the kernels' dropout keep bits, samples counted
    from `offset`."""
    idx = (torch.arange(b * n * hp, dtype=torch.int64, device=device)
           + offset * n * hp) & _M32
    h = _fmix32(_mul32(idx, 0x9E3779B1) ^ key)
    return (h >= keep_threshold(rate)).reshape(b, n, hp)


def _softmax_segments(logits: torch.Tensor, h: int) -> torch.Tensor:
    b, n, hp = logits.shape
    return torch.softmax(logits.reshape(b, n, h, hp // h), dim=-1).reshape(
        b, n, hp)


def _xbase(offset: int, n: int, hp: int) -> int:
    """The kernels' `xbase`: the hashed index of sample `offset`'s first
    element (idx * 0x9E3779B1 mod 2^32)."""
    return _mul32((offset * n * hp) & _M32, 0x9E3779B1)


def _attn(qn, kpb, h, key, rate, offset=0):
    """(soft, attn, keep): the f32 segment softmax, the dropped attention
    rounded to qn's dtype, and the keep mask (None at rate 0)."""
    b, n, _ = qn.shape
    hp = kpb.shape[-1]
    soft = _softmax_segments(qn.float() @ kpb.float(), h)
    keep = None
    attn = soft
    if rate > 0.0:
        keep = keep_mask(b, n, hp, key, rate, qn.device, offset)
        attn = torch.where(keep, soft * (1.0 / (1.0 - rate)),
                           torch.zeros_like(soft))
    return soft, attn.to(qn.dtype).float(), keep


def spatial_attn_fwd_plain(qn, kpb, vpb, h: int, key: int,
                           rate: float, offset: int = 0) -> torch.Tensor:
    _, attn, _ = _attn(qn, kpb, h, key, rate, offset)
    return (attn @ vpb.float()).to(qn.dtype)


def spatial_attn_bwd_plain(qn, kpb, vpb, g, h: int, key: int, rate: float,
                           offset: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dqn in qn's dtype, dkpb f32, dvpb f32)."""
    b, n, _ = qn.shape
    hp = kpb.shape[-1]
    soft, attn, keep = _attn(qn, kpb, h, key, rate, offset)
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
WIDE_HEADS = (1, 2, 4)       # heads a wide row block owns (a unit a warp)
WIDE_TOKENS = 32             # tokens of a wide row block (csrc WTOK)
SUM_TOKENS = 64              # the token sums' step (WSUM_T)
SUM_TILE = 64                # their tile: hP rows and C columns at most
STAGE_BYTES = 48 << 10       # one stage of a row block's streamed operand;
                             # half that where the row blocks fill the card
                             # twice over, so that two blocks share an SM,
                             # and no cap but the SM's where they make less
                             # than one wave (fewer chunks, fewer waits)


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


def wide_ck(c: int) -> int:
    """csrc/spatial_attn.cu::wide_ck: C padded with zero columns to 16."""
    return max(c, 16)


def _pitch_rows(es: int, n: int) -> int:
    """csrc::pitch_rows: a tile's row pitch where a fragment runs along
    the rows (16-bit: `_pitch`; f32: an odd multiple of 4)."""
    return _pitch(n) if es == 2 else -(-n // 8) * 8 + 4


def _pitch_cols(es: int, n: int) -> int:
    """csrc::pitch_cols: where it runs along the columns (f32: an odd
    multiple of 8)."""
    return _pitch(n) if es == 2 else -(-n // 16) * 16 + 8


def wide_stage(es: int, bwd: bool, c: int, hp: int, kc: int, kq: int) -> int:
    """Elements of one stage of a wide row block's streamed operand: kc
    rows of kpb, kc columns of vpb (K4), kq rows of vpb (K3) or kq columns
    of kpb (K4)."""
    ck = wide_ck(c)
    return max(kc * _pitch_cols(es, hp),
               hp * _pitch_rows(es, kc) if bwd else 0,
               ck * _pitch_rows(es, kq) if bwd else kq * _pitch_cols(es, ck))


def smem_rows_wide(es: int, bwd: bool, c: int, hp: int, kc: int,
                   kq: int) -> int:
    """A wide row block's shared memory (csrc::wide_rows_smem): the qn tile
    (and K4's g tile), overlaid by a or ds, and two stages."""
    tiles = max(WIDE_TOKENS * _pitch_rows(es, wide_ck(c)) * (2 if bwd else 1),
                WIDE_TOKENS * _pitch_rows(es, hp))
    return es * (tiles + 2 * wide_stage(es, bwd, c, hp, kc, kq))


def smem_sums_wide(es: int, c: int, hp: int) -> int:
    """A token-sums block's (csrc::wide_sums_smem): two stages of
    SUM_TOKENS tokens of a or ds and of qn or g."""
    return es * 2 * SUM_TOKENS * (_pitch_cols(es, min(hp, SUM_TILE))
                                  + _pitch_cols(es, min(wide_ck(c),
                                                        SUM_TILE)))


class SpattnPlan(NamedTuple):
    """K3's and K4's decomposition. Their accumulators live in registers:
    K3's 16 x cols outputs a warp, K4's dkpb and dvpb sums over its chunk
    (split over the block's warps) and, split by row, dqn; split by head,
    dqn goes out as f32 partials (`dq_groups`) that the finishing pass
    adds. A wide plan: K3 and K4's row blocks take 32 tokens (2 units of
    16) and every head; K4's token sums take `chunks` chunks of the
    `tiles` steps of `tile` (64) tokens, `sum_tiles` tiles of dkpb^T and
    dvpb each."""
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
    wide: bool = False   # the wide instances (SHAPES_WIDE, and f32)
    k_chunk: int = 0     # wide: C (padded) a stage of the logits takes
    q_chunk: int = 0     # wide: hP a stage of the second product takes
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
        """"row": a K4 block owns every head and writes dqn itself (every
        wide plan); "head": each head group writes an f32 partial of dqn,
        added in group order by the finishing pass."""
        return ("row" if self.wide or self.head_block == self.heads > 1
                else "head")

    @property
    def dq_groups(self) -> int:
        return 0 if self.split == "row" else self.head_groups

    @property
    def fwd_grid(self) -> int:
        return self.fwd_blocks * self.batch

    @property
    def sum_tiles(self) -> int:
        """Wide K4: the token sums' tiles of one (hP x C) sum."""
        hp, ck = self.heads * self.p, wide_ck(self.c)
        return (hp // min(hp, SUM_TILE)) * (ck // min(ck, SUM_TILE))

    @property
    def bwd_grid(self) -> int:
        """K4's product blocks (wide: the token sums', two sums a batch
        item; its row blocks are `fwd_grid`)."""
        if self.wide:
            return self.chunks * self.sum_tiles * 2 * self.batch
        return self.chunks * self.head_groups * self.batch

    @property
    def partial_bytes(self) -> int:
        """K4's scratch: the chunks' f32 dkpb and dvpb, the groups' f32
        dqn; wide, a and ds in the operands' type."""
        hp = self.heads * self.p
        rows = (2 * self.batch * self.n * hp * (4 if self.f32 else 2)
                if self.wide else 0)
        return rows + 4 * (2 * self.chunks * self.batch * self.c * hp
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
    instances' at any (C, P) of WIDTHS x PROJECTIONS), 1, 2 or 4 heads:
    row blocks of WIDE_TOKENS tokens, whose logits take kpb's rows
    `k_chunk` at a time and whose second product hP `q_chunk` at a time,
    the largest powers of two whose two stages fit beside the tiles
    (STAGE_BYTES a stage at most, half that where the row blocks make two
    waves or more, the SM's whole where they make less than one or where
    nothing fits the cap); K4's token sums in chunks of the
    SUM_TOKENS-token steps, as many as make about two waves, their f32
    partials within PART_BUDGET. Raises ValueError on what they do not
    take."""
    ok = ((c in WIDTHS and p in PROJECTIONS) if f32
          else (c, p) in SHAPES_WIDE)
    if not ok or heads not in WIDE_HEADS or n < 1 or batch < 1:
        raise ValueError(f"spatial_attn wide kernels: N={n} C={c} P={p} "
                         f"heads={heads} batch={batch} not supported (heads "
                         f"in {WIDE_HEADS})")
    es, hp, ck = (4 if f32 else 2), heads * p, wide_ck(c)
    rows = -(-n // WIDE_TOKENS) * batch
    cap = (SMEM_CAP if rows <= SMS else
           STAGE_BYTES // (2 if rows > 2 * SMS else 1))

    def fits(kc, kq, cap):
        for bwd in (False, True):
            rest = SMEM_CAP - smem_rows_wide(es, bwd, c, hp, kc, kq)
            if rest < 0 or es * wide_stage(es, bwd, c, hp, kc, kq) > cap:
                return False
        return True

    kcs = [ck >> i for i in range(8) if ck >> i >= 16]
    kqs = [hp >> i for i in range(8) if hp >> i >= 16 and hp % (hp >> i) == 0]
    kc = kq = None
    for limit in (cap, SMEM_CAP):
        kc = next((k for k in kcs if fits(k, kqs[-1], limit)), None)
        if kc is not None:
            kq = next(q for q in kqs if fits(kc, q, limit))
            break
    if kc is None:
        raise ValueError(f"spatial_attn wide kernels: C={c} P={p} do not "
                         f"fit shared memory")
    tiles = -(-n // SUM_TOKENS)
    hq = min(hp, SUM_TILE)
    sum_blocks = (hp // hq) * (ck // min(ck, SUM_TILE)) * 2 * batch
    most = max(1, PART_BUDGET // (8 * batch * c * hp))
    chunks = max(1, min(-(-2 * SMS // sum_blocks), tiles, most))
    per_block = WIDE_TOKENS // 16
    sf = smem_rows_wide(es, False, c, hp, kc, kq)
    sb = max(smem_rows_wide(es, True, c, hp, kc, kq),
             smem_sums_wide(es, c, hp))
    return SpattnPlan(n, c, p, heads, batch, c, per_block,
                      -(-n // WIDE_TOKENS), sf, SUM_TOKENS, tiles, heads,
                      chunks, sb, True, kc, kq, f32)


@functools.lru_cache(maxsize=None)
def spatial_attn_plan_f32(n: int, c: int, p: int, heads: int,
                          batch: int = 1) -> SpattnPlan:
    """The f32 instances' plan (`wide_plan` with f32) at every (C, P) that
    B5 takes."""
    return wide_plan(n, c, p, heads, batch, f32=True)


# -- the wrappers ----------------------------------------------------------------

# the library of each operand type: the 16-bit instances are one source
# built twice (csrc/h16.cuh); the f32 instances live in the bf16 library
_LIBS = {torch.bfloat16: "spatial_attn", torch.float16: "spatial_attn_f16",
         torch.float32: "spatial_attn"}
_FNS = {}


def _fns(lib: str):
    fns = _FNS.get(lib)
    if fns is None:
        so = _build.load(lib)
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        fwd = so.fcd_spatial_attn_fwd
        fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cu,
                        cu, cu, cf, ci, vp]
        bwd = so.fcd_spatial_attn_bwd
        bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                        ci, ci, ci, ci, ci, ci, ci, cu, cu, cu, cf, ci, vp]
        fwd_w = so.fcd_spatial_attn_fwd_wide
        fwd_w.argtypes = [vp, vp, vp, vp] + [ci] * 8 + [cu, cu, cu, cf, ci,
                                                         vp]
        bwd_w = so.fcd_spatial_attn_bwd_wide
        bwd_w.argtypes = [vp] * 11 + [ci] * 11 + [cu, cu, cu, cf, ci, vp]
        for f in (fwd, bwd, fwd_w, bwd_w):
            f.restype = ci
        fns = _FNS[lib] = dict(fwd=fwd, bwd=bwd, fwd_wide=fwd_w,
                               bwd_wide=bwd_w)
    return fns


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
    """Raises ValueError if `plan` was made for another shape or dtype."""
    b, n, c = qn.shape
    got = (n, c, kpb.shape[-1] // h, h, b)
    if (plan.n, plan.c, plan.p, plan.heads, plan.batch) != got:
        raise ValueError(
            f"spatial_attn: a plan for N={plan.n} C={plan.c} P={plan.p} "
            f"heads={plan.heads} batch={plan.batch} given N, C, P, heads, "
            f"batch = {got}")
    if plan.f32 != (qn.dtype == torch.float32):
        raise ValueError("spatial_attn: f32 operands take an f32 plan "
                         "(spatial_attn_plan_f32), 16-bit ones a 16-bit plan")


def _kernel_args(qn, kpb, vpb, g=None):
    ts = (qn, kpb, vpb) + (() if g is None else (g,))
    if qn.dtype not in _LIBS or any(t.dtype != qn.dtype for t in ts):
        raise TypeError(f"spatial_attn kernels take one dtype for all: bf16 "
                        f"(the kernel route), f16 (ROADMAP C20) or f32 (the "
                        f"f32 route, ROADMAP C18), got "
                        f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("spatial_attn kernels take contiguous, 16-byte "
                         "aligned tensors")


def _plan(qn, kpb, h, plan):
    b, n, c = qn.shape
    p = kpb.shape[-1] // h
    if plan is None:
        plan = (spatial_attn_plan_f32 if qn.dtype == torch.float32
                else spatial_attn_plan)(n, c, p, h, b)
    _check_plan(plan, qn, kpb, h)
    return plan


def spatial_attn_fwd(qn: torch.Tensor, kpb: torch.Tensor, vpb: torch.Tensor,
                     h: int, key: int, rate: float,
                     plan: Optional[SpattnPlan] = None,
                     offset: int = 0) -> torch.Tensor:
    """K3 wrapper: (B, N, C) out in qn's dtype. `plan` (default
    `spatial_attn_plan`'s, f32: `spatial_attn_plan_f32`'s) sets the
    kernel's blocks; `offset` is the first sample's global index in the
    dropout hash."""
    _check(qn, kpb, vpb, h)
    if plan is not None:
        _check_plan(plan, qn, kpb, h)
    if qn.device.type == "cpu":
        return spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate, offset)
    _kernel_args(qn, kpb, vpb)
    plan = _plan(qn, kpb, h, plan)
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    fns = _fns(_LIBS[qn.dtype])
    out = torch.empty_like(qn)
    ptr = _build.ptr
    drop = (key, _xbase(offset, n, hp), keep_threshold(rate),
            1.0 / (1.0 - rate), int(rate > 0.0), _build.stream())
    if plan.wide:
        err = fns["fwd_wide"](ptr(qn), ptr(kpb), ptr(vpb), ptr(out), b, n, c,
                              hp, hp // h, plan.k_chunk, plan.q_chunk,
                              int(plan.f32), *drop)
    else:
        err = fns["fwd"](ptr(qn), ptr(kpb), ptr(vpb), ptr(out), b, n, c, hp,
                         hp // h, plan.cols, plan.per_block, plan.fwd_blocks,
                         *drop)
    _build.check(err, "spatial_attn_fwd")
    _COUNTS[qn.dtype][0].launches += 1
    return out


def spatial_attn_bwd(qn: torch.Tensor, kpb: torch.Tensor, vpb: torch.Tensor,
                     g: torch.Tensor, h: int, key: int, rate: float,
                     dtypes=(torch.float32, torch.float32),
                     plan: Optional[SpattnPlan] = None, offset: int = 0):
    """K4 wrapper: (dqn in qn's dtype, dkpb, dvpb in `dtypes`: f32, or qn's
    16-bit dtype). On the card one call is the product kernel and its
    finishing pass (wide: the row blocks, the token sums and the
    finishing pass); `plan` sets their decomposition, `offset` as K3's."""
    _check(qn, kpb, vpb, h, g)
    if plan is not None:
        _check_plan(plan, qn, kpb, h)
    if qn.device.type == "cpu":
        dqn, dkpb, dvpb = spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key,
                                                 rate, offset)
        return dqn, dkpb.to(dtypes[0]), dvpb.to(dtypes[1])
    _kernel_args(qn, kpb, vpb, g)
    if any(d not in (torch.float32, qn.dtype) for d in dtypes):
        raise TypeError(f"spatial_attn_bwd writes dkpb and dvpb in f32 or "
                        f"in qn's dtype ({qn.dtype}), not {dtypes}")
    plan = _plan(qn, kpb, h, plan)
    b, n, c = qn.shape
    hp = kpb.shape[-1]
    fns = _fns(_LIBS[qn.dtype])
    dev, f32 = qn.device, torch.float32
    dqn = torch.empty_like(qn)
    dk_part = torch.empty((plan.chunks, b, c, hp), dtype=f32, device=dev)
    dv_part = torch.empty((plan.chunks, b, hp, c), dtype=f32, device=dev)
    dkpb = torch.empty((b, c, hp), dtype=dtypes[0], device=dev)
    dvpb = torch.empty((b, hp, c), dtype=dtypes[1], device=dev)
    ptr = _build.ptr
    flags = (int(dtypes[0] != f32), int(dtypes[1] != f32))
    drop = (key, _xbase(offset, n, hp), keep_threshold(rate),
            1.0 / (1.0 - rate), int(rate > 0.0), _build.stream())
    if plan.wide:   # a and ds for the token sums, in the operands' type
        rows = torch.empty((2, b, n, hp), dtype=qn.dtype, device=dev)
        err = fns["bwd_wide"](
            ptr(qn), ptr(kpb), ptr(vpb), ptr(g), ptr(dqn), ptr(rows[0]),
            ptr(rows[1]), ptr(dk_part), ptr(dv_part), ptr(dkpb), ptr(dvpb),
            *flags, b, n, c, hp, hp // h, plan.k_chunk, plan.q_chunk,
            plan.chunks, int(plan.f32), *drop)
    else:
        dq_part = (torch.empty((plan.dq_groups, b, n, c), dtype=f32,
                               device=dev) if plan.dq_groups else None)
        err = fns["bwd"](
            ptr(qn), ptr(kpb), ptr(vpb), ptr(g), ptr(dqn), ptr(dq_part),
            ptr(dk_part), ptr(dv_part), ptr(dkpb), ptr(dvpb), *flags, b, n,
            c, hp, hp // h, plan.head_block, plan.tile, plan.chunks, *drop)
    _build.check(err, "spatial_attn_bwd")
    _COUNTS[qn.dtype][1].launches += 1
    return dqn, dkpb, dvpb


spatial_attn_fwd.launches = 0
spatial_attn_bwd.launches = 0
# the f16 (ROADMAP C20) and f32 (C18) instances' launches, counted apart
FWD_F16, BWD_F16 = _build.Launches(), _build.Launches()
FWD_F32, BWD_F32 = _build.Launches(), _build.Launches()
_COUNTS = {torch.bfloat16: (spatial_attn_fwd, spatial_attn_bwd),
           torch.float16: (FWD_F16, BWD_F16),
           torch.float32: (FWD_F32, BWD_F32)}


class SpatialAttn(torch.autograd.Function):
    """Differentiable spatial-attention tail: forward K3, backward K4.
    kpb and vpb are taken in qn's dtype, as the TPU kernel takes them."""

    @staticmethod
    def forward(ctx, qn, kpb, vpb, h: int, key: int, rate: float,
                offset: int = 0):
        kq, vq = kpb.to(qn.dtype).contiguous(), vpb.to(qn.dtype).contiguous()
        qn = qn.contiguous()
        ctx.save_for_backward(qn, kq, vq)
        ctx.h, ctx.key, ctx.rate, ctx.offset = h, key, rate, offset
        ctx.dtypes = (kpb.dtype, vpb.dtype)
        return spatial_attn_fwd(qn, kq, vq, h, key, rate, offset=offset)

    @staticmethod
    def backward(ctx, g):
        qn, kq, vq = ctx.saved_tensors
        dqn, dkpb, dvpb = spatial_attn_bwd(
            qn, kq, vq, g.to(qn.dtype).contiguous(), ctx.h, ctx.key, ctx.rate,
            dtypes=ctx.dtypes, offset=ctx.offset)
        return dqn, dkpb, dvpb, None, None, None, None


def spatial_attn(qn, kpb, vpb, h: int, key: int = 0,
                 rate: float = 0.0, offset: int = 0) -> torch.Tensor:
    return SpatialAttn.apply(qn, kpb, vpb, h, key, rate, offset)
