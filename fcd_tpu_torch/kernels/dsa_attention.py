"""B5: fused eval dual self-attention, every sa_type, three launches.

Replaces `fcd_tpu/kernels/dsa_attention.py::dsa_fused` (phase A
pallas_call :243, the XLA glue :277-300, phase B :310). The CUDA kernels
are `fcd_tpu_torch/csrc/dsa.cu`; its header gives the math, what bounds
the kernels on the card and what their design does about that.

`dsa_attention` is the op the transformer blocks call, in one of the two
forms of `dsa_fused`'s contract (`fcd_tpu/kernels/dsa_attention.py:186-
220`):
- the fused form (`TransformerBlock`, `EPABlock`): tokens (B, N, C) ->
  `t + gamma * DSA(LN(t))` with `t = x + pos_embed` (pos_embed optional),
  dsa_fused with ln_scale, ln_bias, pos_embed and res_gamma;
- the prologue-free form (`TransformerBlockDSA`): `ln_scale`, `ln_bias`,
  `pos_embed` and `gamma` all None, x the normalised tokens -> `DSA(x)`,
  dsa_fused without them (`has_ln` False: no LayerNorm prologue, no
  residual epilogue). Its kernels are the same sources built with
  -DFCD_DSA_RAW (`libdsa_raw`, `libdsa_raw_f16`, `libdsa_f32_raw`),
  counted apart on `PHASE_A_RAW` / `PHASE_B_RAW` (and `_F16`, `_F32`).
Any other mix raises (`fused_form`), as dsa_fused's assert refuses it.
On CPU tensors it is `dsa_reference`, the einsum math of
`fcd_tpu/ops/attention.py:116-303` in PyTorch. On CUDA tensors it is `dsa_phase_a` with the temperatures (the
token sums of each head, then a finishing pass that adds the chunks'
partial sums in a fixed order and does the glue, writing phase B's
operands) and `dsa_phase_b`: three kernels, no PyTorch op between them.
Each phase wrapper has its plain version and its launch counter; the
plain glue is `dsa_glue`.

The work splits by head: `dsa_plan` (pure Python) picks the token tile
and phase A's chunks of tiles; the kernels' grids are (chunk or tile,
head, batch). Weights: `w_qkvv` is the flax matrix with slots q, k, v_ca,
v_sa (`w_qkvv[:, s*C:(s+1)*C]`, (C, 4C)) for sa_type 'parallel', and q,
k, v ((C, 3C)) for 'serial', 'spatial' and 'channel'; the kernels read
it, and `EF`, as they are (f32 or bf16), rounding to bf16 on load.

The dtype picks the instances: bf16 tokens run `libdsa`; f16 tokens (a
model that computes in f16, ROADMAP C20) the same source built with
-DFCD_F16 (`libdsa_f16`: every bf16 rounding point an f16 one, the
weights and EF f32 or f16), counted on `PHASE_A_F16` / `PHASE_B_F16`;
f32 tokens `csrc/dsa_f32.cu` (`_dsa_phase_a_f32`, C18), counted on
`PHASE_A_F32` / `PHASE_B_F32`. The plain versions round at the tokens'
dtype.

The four types (`fcd_tpu/kernels/dsa_attention.py:121-181`, slot map
:223): phase A sums q^T k, q2, k2 and, except for 'channel', kp and vp
(v_sa is slot 3, or slot 2); the finishing pass writes `abig` for every
type. Phase B computes the channel attention ('parallel', 'channel':
bf16(v) abig), the spatial attention (every type but 'channel'), and
for 'serial' the spatial output rounded to the token dtype, then times
abig (C3's rounding point). 'channel' has no EF and no P: its plan and
its kernels take P = 0, and kp, kpt and vp are (B, C, 0).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import layer_norm

REPLACES_A = "fcd_tpu/kernels/dsa_attention.py:243"  # phase A pallas_call
REPLACES_B = "fcd_tpu/kernels/dsa_attention.py:310"  # phase B pallas_call
_L2_EPS = 1e-12  # fcd_tpu/ops/attention.py::_l2_normalize

SA_TYPES = ("parallel", "serial", "spatial", "channel")  # csrc/dsa.cu's modes


def mode_of(sa_type: str) -> int:
    """The kernels' mode number of an sa_type (csrc/dsa.cu::Mode)."""
    if sa_type not in SA_TYPES:
        raise ValueError(f"sa_type must be one of {SA_TYPES}, got {sa_type!r}")
    return SA_TYPES.index(sa_type)


def num_slots(sa_type: str) -> int:
    """Column groups of qkvv: q, k, v_ca, v_sa for 'parallel'; q, k, v
    for the others (`fcd_tpu/ops/attention.py:78`)."""
    return 4 if mode_of(sa_type) == 0 else 3


def phase_a_slots(sa_type: str):
    """The qkvv slots phase A's blocks stage: q, k and v_sa (slot 3 for
    'parallel', 2 for 'serial' and 'spatial'); q, k for 'channel'."""
    if sa_type == "channel":
        return (0, 1)
    return (0, 1, 3) if sa_type == "parallel" else (0, 1, 2)


PHASE_A_SLOTS = phase_a_slots("parallel")   # q, k, v_sa
PHASE_B_SLOTS = (0, 2)      # q, and v_ca (or v, unused but by 'channel')


class PhaseA(NamedTuple):
    qk: torch.Tensor   # (B, h, ch, ch) the diagonal blocks of q^T k
    q2: torch.Tensor   # (B, C) column sums of q^2
    k2: torch.Tensor   # (B, C)
    kp: torch.Tensor   # (B, C, P) bf16(k)^T ef
    vp: torch.Tensor   # (B, C, P) bf16(v_sa)^T ef


class PhaseBOperands(NamedTuple):
    qnorm: torch.Tensor  # (B, C) f32, rsqrt(q2 + 1e-12)
    abig: torch.Tensor   # (B, h, ch, ch): out[n, c] = sum_d v[n, d] abig[d, c]
    kpt: torch.Tensor    # (B, C, P) kp * temperature2 of the head
    vp: torch.Tensor     # (B, C, P)


def fused_form(ln_scale, ln_bias, pos_embed, *gamma) -> bool:
    """Whether B5's token operands are the fused form's (ln_scale and
    ln_bias, pos_embed optional, and in phase B `gamma`) or the
    prologue-free form's (all of them None). Any other mix raises, as
    dsa_fused's `assert has_ln or (not has_pe and not has_res)` does; the
    port has no instance with a LayerNorm and no residual, which no JAX
    caller runs."""
    given = [t is not None for t in (ln_scale, ln_bias, *gamma)]
    if all(given):
        return True
    if not any(given) and pos_embed is None:
        return False
    raise ValueError("B5 takes ln_scale, ln_bias and gamma (pos_embed "
                     "optional), or none of them and no pos_embed")


def _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps):
    """(base, xln): base = x + pe in f32, xln = LayerNorm(base) rounded to
    x's dtype; the prologue-free form (ln_scale None): (None, x)."""
    if ln_scale is None:
        return None, x
    base = x.float()
    if pos_embed is not None:
        base = base + pos_embed.float()
    return base, layer_norm(base, ln_scale, ln_bias, eps).to(x.dtype)


def dsa_reference(x, w_qkvv, ef, temperature, temperature2, ln_scale,
                  ln_bias, pos_embed, gamma, num_heads: int,
                  eps: float = 1e-5, sa_type: str = "parallel"
                  ) -> torch.Tensor:
    """The eval DSA block in plain PyTorch, f32 throughout: the einsum math
    of fcd_tpu/ops/attention.py:116-303 (tokens-resident form) for each
    sa_type; `ef` is None for 'channel'. The prologue-free form (ln_scale,
    ln_bias, pos_embed and gamma None) returns DSA(x)."""
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    fused = fused_form(ln_scale, ln_bias, pos_embed, gamma)
    base = x.float()
    if pos_embed is not None:
        base = base + pos_embed.float()
    xln = layer_norm(base, ln_scale, ln_bias, eps) if fused else base
    slots = (xln @ w_qkvv.float()).split(c, dim=-1)
    q, k = slots[0], slots[1]
    qn = q * torch.rsqrt(q.square().sum(dim=1, keepdim=True) + _L2_EPS)
    kn = k * torch.rsqrt(k.square().sum(dim=1, keepdim=True) + _L2_EPS)

    def channel(v):  # per head: (B, h, ch, ch)
        g = torch.einsum("bnc,bnd->bcd", qn, kn).reshape(b, h, ch, h, ch)
        blocks = torch.stack([g[:, j, :, j, :] for j in range(h)], dim=1)
        attn = torch.softmax(blocks * temperature.float().reshape(h, 1, 1),
                             -1)
        return torch.einsum("bhcd,bnhd->bnhc", attn,
                            v.reshape(b, n, h, ch)).reshape(b, n, c)

    def spatial(v):  # with the learned N -> P projection
        efp = ef.float()
        kp = torch.einsum("bnc,np->bcp", k, efp).reshape(b, h, ch, -1)
        vp = torch.einsum("bnc,np->bcp", v, efp).reshape(b, h, ch, -1)
        s = torch.einsum("bnhc,bhcp->bhnp", qn.reshape(b, n, h, ch), kp)
        s = torch.softmax(s * temperature2.float().reshape(1, h, 1, 1), -1)
        return torch.einsum("bhnp,bhcp->bnhc", s, vp).reshape(b, n, c)

    if sa_type == "channel":
        att = channel(slots[2])
    elif sa_type == "spatial":
        att = spatial(slots[2])
    elif sa_type == "serial":
        att = channel(spatial(slots[2]))
    else:
        att = channel(slots[2]) + spatial(slots[3])
    return (base + gamma.float() * att if fused else att).to(x.dtype)


def _slots(w_qkvv, dtype, slots):
    """The flax matrix's slots, rounded to `dtype` and held in f32."""
    c = w_qkvv.shape[0]
    wf = w_qkvv.to(dtype).float()
    return [wf[:, s * c:(s + 1) * c] for s in slots]


def dsa_phase_a_plain(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed,
                      num_heads: int, eps: float = 1e-5,
                      sa_type: str = "parallel") -> PhaseA:
    """Phase A's sums; for 'channel' (ef None) kp and vp are (B, C, 0).
    The prologue-free form (ln_scale None) projects x as it is."""
    dtype = x.dtype
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    _, xln = _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps)
    xf = xln.float()
    ws = _slots(w_qkvv, dtype, phase_a_slots(sa_type))
    q, k = xf @ ws[0], xf @ ws[1]
    qk = torch.einsum("bnhc,bnhd->bhcd", q.reshape(b, n, h, ch),
                      k.reshape(b, n, h, ch))
    if sa_type == "channel":
        kp = vp = xf.new_zeros((b, c, 0))
    else:
        v_sa = (xf @ ws[2]).to(dtype).float()
        eff = ef.to(dtype).float()
        kp = k.to(dtype).float().transpose(1, 2) @ eff
        vp = v_sa.transpose(1, 2) @ eff
    return PhaseA(qk, q.square().sum(1), k.square().sum(1), kp, vp)


def dsa_glue(a: PhaseA, temperature, temperature2, num_heads: int,
             dtype) -> PhaseBOperands:
    """Per-head softmax of the channel affinity and the phase-B operands
    (fcd_tpu/kernels/dsa_attention.py:277-300): qnorm (B, C) f32, abig
    (B, h, ch, ch) = each head's softmax transposed, kpt = kp * temperature2
    of the head and vp, the last three in `dtype`. The finishing pass of
    csrc/dsa.cu does these steps with these rounding points."""
    b, h, ch, _ = a.qk.shape
    qnorm = torch.rsqrt(a.q2 + _L2_EPS)
    knorm = torch.rsqrt(a.k2 + _L2_EPS)
    qk_n = (a.qk * qnorm.reshape(b, h, ch, 1)) * knorm.reshape(b, h, 1, ch)
    t1 = temperature.float().reshape(1, h, 1, 1)
    t2 = temperature2.float().reshape(1, h, 1, 1)
    abig = torch.softmax(qk_n * t1, dim=-1).transpose(2, 3)
    kpt = (a.kp.reshape(b, h, ch, a.kp.shape[-1]) * t2).reshape(a.kp.shape)
    return PhaseBOperands(qnorm, abig.to(dtype).contiguous(), kpt.to(dtype),
                          a.vp.to(dtype))


def dsa_phase_b_plain(x, w_qkvv, qnorm, abig, kpt, vp, gamma, ln_scale,
                      ln_bias, pos_embed, num_heads: int,
                      eps: float = 1e-5,
                      sa_type: str = "parallel") -> torch.Tensor:
    dtype = x.dtype
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    p = kpt.shape[-1]
    base, xln = _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps)
    xf = xln.float()
    wq, wv = _slots(w_qkvv, dtype, PHASE_B_SLOTS)
    ab = abig.float()
    out = None
    if sa_type in ("parallel", "channel"):
        v_ca = (xf @ wv).to(dtype).float().reshape(b, n, h, ch)
        out = torch.einsum("bnhd,bhdc->bnhc", v_ca, ab)
    if sa_type != "channel":
        qn = ((xf @ wq) * qnorm[:, None, :]).to(dtype).float()
        s = torch.einsum("bnhc,bhcp->bhnp", qn.reshape(b, n, h, ch),
                         kpt.float().reshape(b, h, ch, p))
        s = torch.softmax(s, dim=-1).to(dtype).float()
        sa = torch.einsum("bhnp,bhcp->bnhc", s,
                          vp.float().reshape(b, h, ch, p))
        if sa_type == "serial":  # the spatial output rounded, then abig
            out = torch.einsum("bnhd,bhdc->bnhc", sa.to(dtype).float(), ab)
        else:
            out = sa if out is None else out + sa
    out = out.reshape(b, n, c)
    return (out if base is None else base + gamma.float() * out).to(dtype)


# -- the kernels' plan ----------------------------------------------------------

SMS = 132                  # the H100's streaming multiprocessors
TILES = (128, 64, 32, 16)  # token tiles, largest first
HEAD_WIDTHS = (2, 4, 8, 16, 32, 64, 128)
PROJECTIONS = (16, 32, 64, 128)  # and 0: 'channel', no spatial attention
MAX_C = 512                # fcd_tpu/kernels/dsa_attention.py:345
STREAM_WIDTH = 128         # head widths whose blocks stream their weights
KW = 32                    # weight rows a streamed chunk
PHASE_A_BLOCKS = 2 * SMS   # phase A's chunks aim at this many blocks
NT = 256                   # threads of every block of csrc/dsa.cu
SMEM_CAP = 232448          # shared memory one block may hold (227 KiB)
SMEM_SM = 233472           # a SM's (228 KiB; 1 KiB of it reserved a block)


def _pitch(n: int) -> int:
    """csrc/dsa.cu::pitch: a bf16 row of >= n elements, an odd multiple of
    16 bytes."""
    v = -(-n // 8)
    return 8 * v + (8 if v % 2 == 0 else 16)


def _padded(ch: int) -> int:
    """csrc/dsa.cu::padded: a head's columns as staged, zero padded to 8."""
    return max(ch, 8)


def _weight_rows(c: int, ch: int) -> int:
    """Rows of the weight buffer: C padded to 16 (csrc/dsa.cu::depth), or
    the double buffer of 2 x KW rows where the weights stream."""
    return 2 * KW if ch >= STREAM_WIDTH else max(c, 16)


def smem_a(c: int, ch: int, p: int, t: int) -> int:
    """Shared memory of a phase A block (csrc/dsa.cu::ShapeA::smem): the
    head's q | k | v_sa weights, the LayerNormed tile, the ef tile, bf16(k)
    | bf16(v_sa), f32 q | k, and the token slices' sums."""
    chp, ck = _padded(ch), max(c, 16)
    no = ch * ch + 2 * ch
    s = max(1, NT // no)
    ns = 3 if p else 2   # the staged slots: q, k (and v_sa)
    return 2 * (_weight_rows(c, ch) * _pitch(ns * chp) + t * _pitch(ck)
                + t * _pitch(p) + t * _pitch(2 * chp)) \
        + 4 * (t * (2 * chp + 2) + (s * no if s > 1 else 0))


def smem_b(c: int, ch: int, p: int, t: int) -> int:
    """Shared memory of a phase B block (csrc/dsa.cu::ShapeB::smem)."""
    chp, ck = _padded(ch), max(c, 16)
    kc = max(chp, 16)
    return 2 * (_weight_rows(c, ch) * _pitch(2 * chp) + t * _pitch(ck)
                + 2 * t * _pitch(kc) + kc * _pitch(chp) + kc * _pitch(p)
                + chp * _pitch(p)) + 4 * (t * ch + 2 * chp)


def supported(c: int, p: int, heads: int) -> bool:
    """The widths the kernels take (csrc/dsa.cu::supported): head width a
    power of two from 2 to 128, P in PROJECTIONS (or 0, 'channel'), C a
    power of two from 8 to MAX_C. That is every (C, P) MS_DSA_NET and
    SegResNet_DSA reach with 4 heads at feature sizes 4-32 and project
    sizes 16-128."""
    if heads <= 0 or c % heads:
        return False
    return (c // heads in HEAD_WIDTHS and (p in PROJECTIONS or p == 0)
            and 8 <= c <= MAX_C and c & (c - 1) == 0)


class DsaPlan(NamedTuple):
    tile: int       # tokens a tile (a multiple of 16)
    tiles: int      # token tiles, ceil(N / tile)
    per_chunk: int  # tiles a phase A block walks, in order
    chunks: int     # phase A blocks per head and batch
    heads: int
    batch: int
    ch: int
    p: int
    smem_a: int
    smem_b: int
    groups: int = 1  # column groups a head's phase A blocks split into (f32)
    hb: int = 1      # heads a phase B block takes (f32)

    @property
    def a_blocks(self) -> int:
        return self.chunks * self.heads * self.batch * self.groups

    @property
    def b_blocks(self) -> int:
        return self.tiles * self.heads // self.hb * self.batch

    @property
    def record(self) -> int:
        """floats of one partial record: qk (ch x ch), q2, k2 (ch), kp and
        vp (ch x P)"""
        return self.ch * self.ch + 2 * self.ch + 2 * self.ch * self.p

    def chunk_tiles(self, k: int) -> range:
        """The tiles chunk k walks, in the order its sums take them; the
        finishing pass adds the chunks' records in the order k = 0, 1, ..."""
        return range(k * self.per_chunk,
                     min((k + 1) * self.per_chunk, self.tiles))


def plan_for(n: int, c: int, p: int, heads: int, batch: int, tile: int,
             per_chunk: int) -> DsaPlan:
    """The plan with this token tile and these tiles a phase A block walks.
    Raises ValueError on shapes the kernels do not take."""
    if not supported(c, p, heads) or n < 1 or batch < 1:
        raise ValueError(
            f"dsa kernels: N={n} C={c} P={p} heads={heads} batch={batch} not "
            f"supported (head width in {HEAD_WIDTHS}, P in {PROJECTIONS} or "
            f"0, C a power of two from 8 to {MAX_C})")
    ch = c // heads
    if tile < 16 or tile % 16 or per_chunk < 1:
        raise ValueError(f"dsa kernels: tile {tile} (a multiple of 16) and "
                         f"{per_chunk} tiles a chunk")
    if ch >= STREAM_WIDTH and tile != 16:
        raise ValueError(f"dsa kernels: head width {ch} streams its weights "
                         f"and takes 16-token tiles, not {tile}")
    tiles = -(-n // tile)
    per_chunk = min(per_chunk, tiles)
    chunks = -(-tiles // per_chunk)
    sa, sb = smem_a(c, ch, p, tile), smem_b(c, ch, p, tile)
    if max(sa, sb) > SMEM_CAP:
        raise ValueError(f"dsa kernels: C={c} P={p} tile {tile} needs "
                         f"{max(sa, sb)} bytes of shared memory")
    return DsaPlan(tile, tiles, per_chunk, chunks, heads, batch, ch, p, sa,
                   sb)


@functools.lru_cache(maxsize=None)
def dsa_plan(n: int, c: int, p: int, heads: int, batch: int = 1) -> DsaPlan:
    """The kernels' token tile and phase A's chunks for N tokens of width C,
    projection P, `heads` heads. The tile is the largest of TILES whose
    tiles alone give every SM a block (tile x head x batch) and whose
    blocks fit in shared memory, else 16: the small levels get small tiles
    and more blocks; streamed head widths take 16. Phase A's blocks then
    walk enough tiles each to come to about PHASE_A_BLOCKS blocks, so level
    3's partials stay few. P = 0 is 'channel' (no spatial attention).
    Raises ValueError on shapes the kernels do not take."""
    ch = c // heads if heads > 0 else 0
    tile = next((t for t in TILES
                 if -(-n // t) * heads * batch >= SMS and ch < STREAM_WIDTH
                 and max(smem_a(c, ch, p, t), smem_b(c, ch, p, t))
                 <= SMEM_CAP), TILES[-1])
    tiles = -(-n // tile)
    want = min(tiles, -(-PHASE_A_BLOCKS // max(1, heads * batch)))
    return plan_for(n, c, p, heads, batch, tile, -(-tiles // want))


# the f32 instances' plan (csrc/dsa_f32.cu, 3xTF32 on the tensor cores)
TILES_F32 = (128, 64, 32, 16)  # token tiles, largest first
KC_F32 = 32         # weight rows a streamed chunk
MJ_F32 = 8          # n-tiles of 8 columns a warp's unit, at most
SLACK_F32 = 16      # floats past phase A's q | k | v_sa (csrc::SLACK)
MAX_HB = 4          # heads a phase B block takes, at most


def _prow(n: int) -> int:
    """csrc/dsa_f32.cu::prow: an f32 row pitch of >= n elements, 4 mod 8
    (the operands read along their rows by the fragments)."""
    return (n + 3) // 8 * 8 + 4


def _pcol(n: int) -> int:
    """csrc/dsa_f32.cu::pcol: >= n elements, 8 mod 16 (the operands read
    down their columns)."""
    return (n + 7) // 16 * 16 + 8


def _cols_a(chp: int, groups: int, p: int) -> int:
    """Phase A's projected columns: the group's q and v_sa, the head's k
    (csrc/dsa_f32.cu::cols_a)."""
    return chp + (2 if p else 1) * (chp // groups)


def _units(mt: int, nt: int) -> int:
    """csrc/dsa_f32.cu::units_of(...).units: warp units of an mt x nt grid
    of m16n8 tiles, the n-tiles spread over the warps an m-tile has, at
    most MJ_F32 a unit."""
    groups = max(1, (NT // 32) // mt)
    nj = min(-(-nt // groups), MJ_F32)
    return mt * -(-nt // nj)


def _projects(t: int, nc: int) -> bool:
    """One projection unit a warp at most (csrc/dsa_f32.cu::projects)."""
    return _units(t // 16, nc // 8) <= NT // 32


def _wrows(c: int, wp: int, other: int) -> int:
    """csrc/dsa_f32.cu::wrows: the weight rows a block holds, all C
    (staged once a block) where its shared memory then stays within
    SMEM_CAP, else two stages of min(KC_F32, C) rows streamed a tile."""
    return c if 4 * (c * wp + other) <= SMEM_CAP else 2 * min(KC_F32, c)


def smem_a_f32(c: int, ch: int, p: int, t: int, groups: int = 1) -> int:
    """csrc/dsa_f32.cu::smem_a: the weights (resident or two stages), the
    tile's x and pe rows, its ef rows and q | k | v_sa, f32."""
    nc = _cols_a(max(ch, 8), groups, p)
    other = (2 * t * _prow(c) + (t * _pcol(p) if p else 0) + t * _pcol(nc)
             + SLACK_F32)
    return 4 * (_wrows(c, _pcol(nc), other) * _pcol(nc) + other)


def _rows_whole(t: int, p: int, chp: int) -> bool:
    """csrc/dsa_f32.cu::rows_whole: phase B's warps take 16 whole rows each
    from the scores to y (tiles of 64 tokens and more, P and the head's
    columns at most MJ_F32 n-tiles)."""
    return t >= 64 and 0 < p <= 8 * MJ_F32 and chp <= 8 * MJ_F32


def smem_b_f32(c: int, ch: int, p: int, t: int, hb: int = 1) -> int:
    """csrc/dsa_f32.cu::smem_b for hb heads a block: the weights (resident
    or two stages), x and pe rows, t, qn | v, qnorm, the scores (over x
    and pe where they fit) and the spatial output (a 16-row slab a warp,
    or the tile's rows), and (head widths under STREAM_WIDTH) each head's
    abig_h, kpt_h and vp_h, f32."""
    chp = max(ch, 8)
    sr = 16 * (NT // 32) if _rows_whole(t, p, chp) else t
    other = (2 * t * _prow(c) + t * hb * chp + t * _prow(2 * hb * chp)
             + hb * chp)
    if p:
        # the scores lie over the tile's x and pe rows where they fit
        # (csrc/dsa_f32.cu::s_on_x)
        over = sr * _prow(p) <= 2 * t * _prow(c)
        other += (0 if over else sr * _prow(p)) + sr * _prow(chp)
    if ch < STREAM_WIDTH:
        other += hb * (chp * _pcol(chp) + (chp * _pcol(p) + chp * _prow(p)
                                           if p else 0))
    wp = _pcol(2 * hb * chp)
    return 4 * (_wrows(c, wp, other) * wp + other)


def plan_for_f32(n: int, c: int, p: int, heads: int, batch: int, tile: int,
                 per_chunk: int, groups: int = 1, hb: int = 1) -> DsaPlan:
    """The f32 instances' plan with this token tile, these tiles a phase A
    block walks, these column groups a head (phase A) and hb heads a
    phase B block. Raises ValueError on shapes the kernels do not take
    (`supported`) and on a plan they refuse: a tile outside TILES_F32,
    groups not a power of two or of fewer than 8 columns, hb not a power
    of two up to MAX_HB dividing the heads, a projection of more than one
    unit a warp, or shared memory over SMEM_CAP."""
    if not supported(c, p, heads) or n < 1 or batch < 1:
        raise ValueError(
            f"dsa f32 kernels: N={n} C={c} P={p} heads={heads} batch="
            f"{batch} not supported (head width in {HEAD_WIDTHS}, P in "
            f"{PROJECTIONS} or 0, C a power of two from 8 to {MAX_C})")
    ch = c // heads
    chp = max(ch, 8)
    if tile not in TILES_F32 or per_chunk < 1:
        raise ValueError(f"dsa f32 kernels: tile {tile} (one of "
                         f"{TILES_F32}), {per_chunk} tiles a chunk")
    if groups < 1 or groups & (groups - 1) or (
            groups > 1 and chp // groups < 8):
        raise ValueError(f"dsa f32 kernels: {groups} column groups of a "
                         f"head of {ch} columns")
    if hb < 1 or hb & (hb - 1) or hb > MAX_HB or heads % hb:
        raise ValueError(f"dsa f32 kernels: {hb} heads a phase B block of "
                         f"{heads}")
    if not (_projects(tile, _cols_a(chp, groups, p))
            and _projects(tile, 2 * hb * chp)):
        raise ValueError(f"dsa f32 kernels: C={c} P={p} tile {tile}: more "
                         "than one projection unit a warp")
    sa = smem_a_f32(c, ch, p, tile, groups)
    sb = smem_b_f32(c, ch, p, tile, hb)
    if max(sa, sb) > SMEM_CAP:
        raise ValueError(f"dsa f32 kernels: C={c} P={p} tile {tile} needs "
                         f"{max(sa, sb)} bytes of shared memory")
    tiles = -(-n // tile)
    per_chunk = min(per_chunk, tiles)
    return DsaPlan(tile, tiles, per_chunk, -(-tiles // per_chunk), heads,
                   batch, ch, p, sa, sb, groups, hb)


@functools.lru_cache(maxsize=None)
def dsa_plan_f32(n: int, c: int, p: int, heads: int,
                 batch: int = 1) -> DsaPlan:
    """The f32 instances' plan, by `dsa_plan`'s rule: the largest tile of
    TILES_F32 whose tiles give every SM a block and that the kernels take
    (one projection unit a warp, shared memory within SMEM_CAP), else 16;
    phase A's blocks walk enough tiles to come to about PHASE_A_BLOCKS.
    Where phase A's blocks would still fill under half the card (level 6:
    4 tiles x 4 heads), each head's blocks split into column groups, the
    groups doubled while the blocks stay within one per SM and a group
    keeps 8 columns. Phase B's blocks take up to MAX_HB heads each while
    every SM still gets a block and two fit its shared memory. Raises
    ValueError on shapes the kernels do not take (`supported`)."""
    plan_for_f32(n, c, p, heads, batch, TILES_F32[-1], 1)  # refuses
    ch = c // heads

    def takes(t):
        try:
            plan_for_f32(n, c, p, heads, batch, t, 1)
        except ValueError:
            return False
        return True

    tile = next((t for t in TILES_F32
                 if -(-n // t) * heads * batch >= SMS and takes(t)),
                TILES_F32[-1])
    tiles = -(-n // tile)
    want = min(tiles, -(-PHASE_A_BLOCKS // (heads * batch)))
    per_chunk = -(-tiles // want)
    chunks = -(-tiles // per_chunk)
    groups = 1
    while (2 * groups <= max(ch, 8) // 8
           and 2 * groups * chunks * heads * batch <= SMS):
        groups *= 2
    # phase B's heads a block: the most that keep a block for every SM and
    # two blocks in a SM's shared memory, so that a tile's tokens are read
    # and LayerNormed once for them (level 3: two heads)
    hb = next(k for k in (4, 2, 1) if k == 1 or (
        heads % k == 0 and tiles * heads // k * batch >= SMS
        and _projects(tile, 2 * k * max(ch, 8))
        and 2 * (smem_b_f32(c, ch, p, tile, k) + 1024) <= SMEM_SM))
    return plan_for_f32(n, c, p, heads, batch, tile, per_chunk, groups, hb)


# -- the wrappers ----------------------------------------------------------------

_FNS = {}


def _fn(name: str, argtypes, lib: str = "dsa"):
    fn = _FNS.get((lib, name))
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(lib, name)] = fn
    return fn


# the 16-bit instances: csrc/dsa.cu built for bf16 (the kernel route) and,
# with -DFCD_F16, for f16 (a model that computes in f16, ROADMAP C20),
# whose launches are counted apart; each also prologue-free
# (-DFCD_DSA_RAW), keyed (dtype, fused)
_LIBS = {(torch.bfloat16, True): "dsa", (torch.float16, True): "dsa_f16",
         (torch.float32, True): "dsa_f32",
         (torch.bfloat16, False): "dsa_raw",
         (torch.float16, False): "dsa_raw_f16",
         (torch.float32, False): "dsa_f32_raw"}


def _check_tokens(x, w_qkvv, ln_scale, ln_bias, pos_embed, num_heads,
                  sa_type, *gamma) -> bool:
    """Checks the operands' shapes; returns `fused_form`'s answer."""
    if x.dim() != 3:
        raise ValueError(f"tokens must be (B, N, C), got {tuple(x.shape)}")
    _, n, c = x.shape
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"{num_heads} heads do not divide {c} channels")
    ns = num_slots(sa_type)
    if tuple(w_qkvv.shape) != (c, ns * c):
        raise ValueError(f"w_qkvv must be ({c}, {ns * c}) for sa_type "
                         f"{sa_type!r}, got {tuple(w_qkvv.shape)}")
    fused = fused_form(ln_scale, ln_bias, pos_embed, *gamma)
    if fused and (tuple(ln_scale.shape) != (c,)
                  or tuple(ln_bias.shape) != (c,)):
        raise ValueError(f"LayerNorm affine must be ({c},)")
    if pos_embed is not None and tuple(pos_embed.shape) != (n, c):
        raise ValueError(f"pos_embed must be ({n}, {c})")
    return fused


def _cuda_operands(what, x, named):
    """The kernels read every operand as it lies: bf16 or f16 (or, the f32
    instances, f32) contiguous tokens, and each (name, tensor, dtypes) on
    x's device, contiguous, 16-byte aligned and of one of `dtypes`. Raises
    on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{what} kernels take bf16 tokens (the kernel "
                        f"route), f16 tokens (ROADMAP C20) or f32 tokens "
                        f"(the f32 route, ROADMAP C18), got {x.dtype}")
    for name, t, dtypes in (("tokens", x, (x.dtype,)), *named):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, tokens on "
                             f"{x.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what} kernel takes {name} in "
                            f"{[str(d) for d in dtypes]}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel takes a contiguous, 16-byte "
                             f"aligned {name}")


_F32 = (torch.float32,)


def _phase_a_buffers(x, plan: DsaPlan, glue: bool):
    """Phase A's f32 partial records and its outputs: the sums (PhaseA,
    f32), or with the glue phase B's operands (PhaseBOperands: qnorm f32,
    the rest in x's dtype)."""
    b, _, c = x.shape
    h, ch, p, dev = plan.heads, plan.ch, plan.p, x.device
    part = torch.empty((plan.chunks, b, h, plan.record), dtype=torch.float32,
                       device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if not glue:
        return part, PhaseA(torch.empty((b, h, ch, ch), **f32),
                            torch.empty((b, c), **f32),
                            torch.empty((b, c), **f32),
                            torch.empty((b, c, p), **f32),
                            torch.empty((b, c, p), **f32))
    lo = dict(dtype=x.dtype, device=dev)
    return part, PhaseBOperands(torch.empty((b, c), **f32),
                                torch.empty((b, h, ch, ch), **lo),
                                torch.empty((b, c, p), **lo),
                                torch.empty((b, c, p), **lo))


def dsa_phase_a(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed, num_heads: int,
                eps: float = 1e-5, temperatures=None,
                plan: Optional[DsaPlan] = None, sa_type: str = "parallel"):
    """Phase A: the token sums of each head (PhaseA). With `temperatures`
    = (temperature, temperature2), the glue's result instead: phase B's
    operands (PhaseBOperands, in x's dtype). Plain on CPU; on CUDA the sums
    kernel and the finishing pass, two launches and one count. `plan`
    (default `dsa_plan`'s) sets the kernels' tiles and chunks. `ef` is
    None for sa_type 'channel', whose plan has P = 0. ln_scale, ln_bias
    and pos_embed all None: the prologue-free instance (x as it is)."""
    fused = _check_tokens(x, w_qkvv, ln_scale, ln_bias, pos_embed, num_heads,
                          sa_type)
    b, n, c = x.shape
    if (ef is None) != (sa_type == "channel"):
        raise ValueError("ef is None for sa_type 'channel' and only then")
    if ef is not None and (ef.dim() != 2 or ef.shape[0] != n):
        raise ValueError(f"ef must be ({n}, P), got {tuple(ef.shape)}")
    h = num_heads
    if temperatures is not None and any(
            t.numel() != h for t in temperatures):
        raise ValueError(f"temperatures must have {h} values each")
    if x.device.type == "cpu":
        a = dsa_phase_a_plain(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed, h,
                              eps, sa_type)
        return a if temperatures is None else dsa_glue(a, *temperatures, h,
                                                       x.dtype)
    t1, t2 = (None, None) if temperatures is None else temperatures
    if x.dtype == torch.float32:
        return _dsa_phase_a_f32(x, w_qkvv, ef, ln_scale, ln_bias,
                                pos_embed, h, eps, temperatures, plan,
                                sa_type, fused)
    lo = (torch.float32, x.dtype)   # f32, or the tokens' 16-bit type
    _cuda_operands("dsa_phase_a", x, (
        ("w_qkvv", w_qkvv, lo), ("ef", ef, lo),
        ("pos_embed", pos_embed, _F32), ("ln_scale", ln_scale, _F32),
        ("ln_bias", ln_bias, _F32), ("temperature", t1, _F32),
        ("temperature2", t2, _F32)))
    p = 0 if ef is None else ef.shape[1]
    plan = plan or dsa_plan(n, c, p, h, b)
    if plan.p != p:
        raise ValueError(f"dsa_phase_a: a plan for P={plan.p} given P={p}")
    part, out = _phase_a_buffers(x, plan, temperatures is not None)
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_phase_a", [vp_] * 5 + [ci, ci, vp_, ci, vp_, ci]
             + [vp_] * 7 + [ci] * 8 + [ctypes.c_float, vp_],
             _LIBS[x.dtype, fused])
    ptr = _build.ptr
    err = fn(ptr(x), ptr(pos_embed), ptr(ln_scale), ptr(ln_bias),
             ptr(w_qkvv), int(w_qkvv.dtype == torch.float32),
             mode_of(sa_type), ptr(ef),
             int(ef is not None and ef.dtype == torch.float32), ptr(part),
             int(temperatures is not None), ptr(t1), ptr(t2),
             *(ptr(t) for t in out), *([ptr(None)] * (5 - len(out))),
             b, n, c, p, h, plan.tile, plan.per_chunk, plan.chunks,
             float(eps), _build.stream())
    _build.check(err, "dsa_phase_a")
    _COUNTS[x.dtype, fused][0].launches += 1
    return out


def dsa_phase_b(x, w_qkvv, qnorm, abig, kpt, vp, gamma, ln_scale, ln_bias,
                pos_embed, num_heads: int, eps: float = 1e-5,
                plan: Optional[DsaPlan] = None,
                sa_type: str = "parallel") -> torch.Tensor:
    """Phase B: per token tile and head, the sa_type's attentions and the
    residual (plain on CPU, the kernel on CUDA). Returns (B, N, C) in x's
    dtype. `plan` (default `dsa_plan`'s) sets the token tile. gamma,
    ln_scale, ln_bias and pos_embed all None: the prologue-free instance,
    which writes the attention itself."""
    fused = _check_tokens(x, w_qkvv, ln_scale, ln_bias, pos_embed, num_heads,
                          sa_type, gamma)
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    p = kpt.shape[-1]
    if (p == 0) != (sa_type == "channel"):
        raise ValueError(f"kpt and vp have P = 0 for sa_type 'channel' and "
                         f"only then, got P = {p} for {sa_type!r}")
    for name, t, shape in (("qnorm", qnorm, (b, c)),
                           ("abig", abig, (b, h, ch, ch)),
                           ("kpt", kpt, (b, c, p)), ("vp", vp, (b, c, p)),
                           ("gamma", gamma, (c,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return dsa_phase_b_plain(x, w_qkvv, qnorm, abig, kpt, vp, gamma,
                                 ln_scale, ln_bias, pos_embed, h, eps,
                                 sa_type)
    if x.dtype == torch.float32:
        return _dsa_phase_b_f32(x, w_qkvv, qnorm, abig, kpt, vp, gamma,
                                ln_scale, ln_bias, pos_embed, h, eps, plan,
                                sa_type, fused)
    lo = (x.dtype,)   # the tokens' 16-bit type
    _cuda_operands("dsa_phase_b", x, (
        ("w_qkvv", w_qkvv, (torch.float32, x.dtype)),
        ("pos_embed", pos_embed, _F32), ("ln_scale", ln_scale, _F32),
        ("ln_bias", ln_bias, _F32), ("qnorm", qnorm, _F32),
        ("abig", abig, lo), ("kpt", kpt, lo), ("vp", vp, lo),
        ("gamma", gamma, _F32)))
    plan = plan or dsa_plan(n, c, p, h, b)
    if plan.p != p:
        raise ValueError(f"dsa_phase_b: a plan for P={plan.p} given P={p}")
    out = torch.empty_like(x)
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_phase_b", [vp_] * 5 + [ci, ci] + [vp_] * 6 + [ci] * 6
             + [ctypes.c_float, vp_], _LIBS[x.dtype, fused])
    ptr = _build.ptr
    err = fn(ptr(x), ptr(pos_embed), ptr(ln_scale), ptr(ln_bias),
             ptr(w_qkvv), int(w_qkvv.dtype == torch.float32),
             mode_of(sa_type), ptr(qnorm),
             ptr(abig), ptr(kpt), ptr(vp), ptr(gamma), ptr(out), b, n, c, p,
             h, plan.tile, float(eps), _build.stream())
    _build.check(err, "dsa_phase_b")
    _COUNTS[x.dtype, fused][1].launches += 1
    return out


def _dsa_phase_a_f32(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed,
                     num_heads: int, eps: float = 1e-5, temperatures=None,
                     plan: Optional[DsaPlan] = None,
                     sa_type: str = "parallel", fused: bool = True):
    """`dsa_phase_a` on f32 CUDA tokens (csrc/dsa_f32.cu): the sums kernel
    and the finishing pass, two launches and one count (`PHASE_A_F32`, the
    prologue-free instance `PHASE_A_RAW_F32`). Every operand f32; `plan`
    (`plan_for_f32`'s) defaults to `dsa_plan_f32`'s."""
    _cuda_operands("dsa_phase_a_f32", x, (
        ("w_qkvv", w_qkvv, _F32), ("ef", ef, _F32),
        ("pos_embed", pos_embed, _F32), ("ln_scale", ln_scale, _F32),
        ("ln_bias", ln_bias, _F32)) + (() if temperatures is None else (
            ("temperature", temperatures[0], _F32),
            ("temperature2", temperatures[1], _F32))))
    b, n, c = x.shape
    h = num_heads
    p = 0 if ef is None else ef.shape[1]
    plan = plan or dsa_plan_f32(n, c, p, h, b)
    if plan.p != p:
        raise ValueError(f"dsa_phase_a_f32: a plan for P={plan.p} given "
                         f"P={p}")
    part, out = _phase_a_buffers(x, plan, temperatures is not None)
    t1, t2 = (None, None) if temperatures is None else temperatures
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_f32_phase_a", [vp_] * 5 + [ci, vp_, vp_, ci]
             + [vp_] * 7 + [ci] * 9 + [ctypes.c_float, vp_],
             _LIBS[x.dtype, fused])
    ptr = _build.ptr
    err = fn(ptr(x), ptr(pos_embed), ptr(ln_scale), ptr(ln_bias),
             ptr(w_qkvv), mode_of(sa_type), ptr(ef), ptr(part),
             int(temperatures is not None), ptr(t1), ptr(t2),
             *(ptr(t) for t in out), *([ptr(None)] * (5 - len(out))),
             b, n, c, p, h, plan.tile, plan.per_chunk, plan.chunks,
             plan.groups, float(eps), _build.stream())
    _build.check(err, "dsa_phase_a_f32")
    _COUNTS[x.dtype, fused][0].launches += 1
    return out


def _dsa_phase_b_f32(x, w_qkvv, qnorm, abig, kpt, vp, gamma, ln_scale,
                     ln_bias, pos_embed, num_heads: int, eps: float = 1e-5,
                     plan: Optional[DsaPlan] = None,
                     sa_type: str = "parallel",
                     fused: bool = True) -> torch.Tensor:
    """`dsa_phase_b` on f32 CUDA tokens (csrc/dsa_f32.cu): one launch,
    counted on `PHASE_B_F32` (the prologue-free instance `PHASE_B_RAW_F32`).
    Every operand f32; `plan` defaults to `dsa_plan_f32`'s."""
    _cuda_operands("dsa_phase_b_f32", x, (
        ("w_qkvv", w_qkvv, _F32), ("pos_embed", pos_embed, _F32),
        ("ln_scale", ln_scale, _F32), ("ln_bias", ln_bias, _F32),
        ("qnorm", qnorm, _F32), ("abig", abig, _F32), ("kpt", kpt, _F32),
        ("vp", vp, _F32), ("gamma", gamma, _F32)))
    b, n, c = x.shape
    h = num_heads
    p = kpt.shape[-1]
    plan = plan or dsa_plan_f32(n, c, p, h, b)
    if plan.p != p:
        raise ValueError(f"dsa_phase_b_f32: a plan for P={plan.p} given "
                         f"P={p}")
    out = torch.empty_like(x)
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_f32_phase_b", [vp_] * 5 + [ci] + [vp_] * 6
             + [ci] * 7 + [ctypes.c_float, vp_], _LIBS[x.dtype, fused])
    ptr = _build.ptr
    err = fn(ptr(x), ptr(pos_embed), ptr(ln_scale), ptr(ln_bias),
             ptr(w_qkvv), mode_of(sa_type), ptr(qnorm), ptr(abig), ptr(kpt),
             ptr(vp), ptr(gamma), ptr(out), b, n, c, p, h, plan.tile,
             plan.hb, float(eps), _build.stream())
    _build.check(err, "dsa_phase_b_f32")
    _COUNTS[x.dtype, fused][1].launches += 1
    return out


dsa_phase_a.launches = 0
dsa_phase_b.launches = 0
# the f16 (ROADMAP C20) and f32 (C18) instances' launches, and the
# prologue-free instances' of each type, counted apart
PHASE_A_F16, PHASE_B_F16 = _build.Launches(), _build.Launches()
PHASE_A_F32, PHASE_B_F32 = _build.Launches(), _build.Launches()
PHASE_A_RAW, PHASE_B_RAW = _build.Launches(), _build.Launches()
PHASE_A_RAW_F16, PHASE_B_RAW_F16 = _build.Launches(), _build.Launches()
PHASE_A_RAW_F32, PHASE_B_RAW_F32 = _build.Launches(), _build.Launches()
_COUNTS = {(torch.bfloat16, True): (dsa_phase_a, dsa_phase_b),
           (torch.float16, True): (PHASE_A_F16, PHASE_B_F16),
           (torch.float32, True): (PHASE_A_F32, PHASE_B_F32),
           (torch.bfloat16, False): (PHASE_A_RAW, PHASE_B_RAW),
           (torch.float16, False): (PHASE_A_RAW_F16, PHASE_B_RAW_F16),
           (torch.float32, False): (PHASE_A_RAW_F32, PHASE_B_RAW_F32)}


def dsa_attention(x, w_qkvv, ef, temperature, temperature2, ln_scale,
                  ln_bias, pos_embed: Optional[torch.Tensor], gamma,
                  num_heads: int, eps: float = 1e-5,
                  sa_type: str = "parallel") -> torch.Tensor:
    """Eval DSA block on tokens (B, N, C), in either form of the module
    docstring: `t + gamma * DSA(LN(t))` with `t = x + pos_embed` (the
    fused form), or with ln_scale, ln_bias, pos_embed and gamma all None
    `DSA(x)` (the prologue-free form). CPU: dsa_reference; CUDA: phase A
    with its finishing pass, then phase B (the bf16, f16 or f32 instances
    of the form, by x's dtype)."""
    if x.device.type == "cpu":
        return dsa_reference(x, w_qkvv, ef, temperature, temperature2,
                             ln_scale, ln_bias, pos_embed, gamma, num_heads,
                             eps, sa_type)
    ops = dsa_phase_a(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed, num_heads,
                      eps, temperatures=(temperature, temperature2),
                      sa_type=sa_type)
    return dsa_phase_b(x, w_qkvv, *ops, gamma, ln_scale, ln_bias, pos_embed,
                       num_heads, eps, sa_type=sa_type)
