"""B5: fused eval dual self-attention (sa_type 'parallel'), three launches.

Replaces `fcd_tpu/kernels/dsa_attention.py::dsa_fused` (phase A
pallas_call :243, the XLA glue :277-300, phase B :310). The CUDA kernels
are `fcd_tpu_torch/csrc/dsa.cu`; its header gives the math, what bounds
the kernels on the card and what their design does about that.

`dsa_attention` is the op the transformer block calls: tokens (B, N, C)
-> `t + gamma * DSA(LN(t))` with `t = x + pos_embed`. On CPU tensors it is
`dsa_reference`, the einsum math of `fcd_tpu/ops/attention.py:116-303` in
PyTorch. On CUDA tensors it is `dsa_phase_a` with the temperatures (the
token sums of each head, then a finishing pass that adds the chunks'
partial sums in a fixed order and does the glue, writing phase B's
operands) and `dsa_phase_b`: three kernels, no PyTorch op between them.
Each phase wrapper has its plain version and its launch counter; the
plain glue is `dsa_glue`.

The work splits by head: `dsa_plan` (pure Python) picks the token tile
and phase A's chunks of tiles; the kernels' grids are (chunk or tile,
head, batch). Weights: `w_qkvv` is the flax (C, 4C) matrix with slots q,
k, v_ca, v_sa (`w_qkvv[:, s*C:(s+1)*C]`); the kernels read it, and `EF`,
as they are (f32 or bf16), rounding to bf16 on load.
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

# the slots of the qkvv matrix each phase's blocks stage (csrc/dsa.cu:
# 0x310 and 0x20)
PHASE_A_SLOTS = (0, 1, 3)   # q, k, v_sa
PHASE_B_SLOTS = (0, 2)      # q, v_ca


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


def _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps):
    """(base, xln): base = x + pe in f32, xln = LayerNorm(base) rounded to
    x's dtype."""
    base = x.float()
    if pos_embed is not None:
        base = base + pos_embed.float()
    return base, layer_norm(base, ln_scale, ln_bias, eps).to(x.dtype)


def dsa_reference(x, w_qkvv, ef, temperature, temperature2, ln_scale,
                  ln_bias, pos_embed, gamma, num_heads: int,
                  eps: float = 1e-5) -> torch.Tensor:
    """The eval DSA block in plain PyTorch, f32 throughout: the einsum math
    of fcd_tpu/ops/attention.py:116-303 (tokens-resident form, parallel)."""
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    base = x.float()
    if pos_embed is not None:
        base = base + pos_embed.float()
    qkvv = layer_norm(base, ln_scale, ln_bias, eps) @ w_qkvv.float()
    q, k, v_ca, v_sa = qkvv.split(c, dim=-1)
    qn = q * torch.rsqrt(q.square().sum(dim=1, keepdim=True) + _L2_EPS)
    kn = k * torch.rsqrt(k.square().sum(dim=1, keepdim=True) + _L2_EPS)
    # channel attention, per head: (B, h, ch, ch)
    g = torch.einsum("bnc,bnd->bcd", qn, kn).reshape(b, h, ch, h, ch)
    blocks = torch.stack([g[:, j, :, j, :] for j in range(h)], dim=1)
    attn = torch.softmax(blocks * temperature.float().reshape(h, 1, 1), -1)
    out_ca = torch.einsum("bhcd,bnhd->bnhc", attn,
                          v_ca.reshape(b, n, h, ch)).reshape(b, n, c)
    # spatial attention with the learned N -> P projection
    efp = ef.float()
    kp = torch.einsum("bnc,np->bcp", k, efp).reshape(b, h, ch, -1)
    vp = torch.einsum("bnc,np->bcp", v_sa, efp).reshape(b, h, ch, -1)
    s = torch.einsum("bnhc,bhcp->bhnp", qn.reshape(b, n, h, ch), kp)
    s = torch.softmax(s * temperature2.float().reshape(1, h, 1, 1), dim=-1)
    out_sa = torch.einsum("bhnp,bhcp->bnhc", s, vp).reshape(b, n, c)
    out = base + gamma.float() * (out_ca + out_sa)
    return out.to(x.dtype)


def _slots(w_qkvv, dtype, slots):
    """The flax matrix's slots, rounded to `dtype` and held in f32."""
    c = w_qkvv.shape[0]
    wf = w_qkvv.to(dtype).float()
    return [wf[:, s * c:(s + 1) * c] for s in slots]


def dsa_phase_a_plain(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed,
                      num_heads: int, eps: float = 1e-5) -> PhaseA:
    dtype = x.dtype
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    _, xln = _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps)
    xf = xln.float()
    wq, wk, wv = _slots(w_qkvv, dtype, PHASE_A_SLOTS)
    q, k = xf @ wq, xf @ wk
    v_sa = (xf @ wv).to(dtype).float()
    eff = ef.to(dtype).float()
    qk = torch.einsum("bnhc,bnhd->bhcd", q.reshape(b, n, h, ch),
                      k.reshape(b, n, h, ch))
    return PhaseA(qk, q.square().sum(1), k.square().sum(1),
                  k.to(dtype).float().transpose(1, 2) @ eff,
                  v_sa.transpose(1, 2) @ eff)


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
    kpt = (a.kp.reshape(b, h, ch, -1) * t2).reshape(a.kp.shape)
    return PhaseBOperands(qnorm, abig.to(dtype).contiguous(), kpt.to(dtype),
                          a.vp.to(dtype))


def dsa_phase_b_plain(x, w_qkvv, qnorm, abig, kpt, vp, gamma, ln_scale,
                      ln_bias, pos_embed, num_heads: int,
                      eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    base, xln = _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps)
    xf = xln.float()
    wq, wv = _slots(w_qkvv, dtype, PHASE_B_SLOTS)
    v_ca = (xf @ wv).to(dtype).float().reshape(b, n, h, ch)
    out = torch.einsum("bnhd,bhdc->bnhc", v_ca, abig.float())
    qn = ((xf @ wq) * qnorm[:, None, :]).to(dtype).float()
    s = torch.einsum("bnhc,bhcp->bhnp", qn.reshape(b, n, h, ch),
                     kpt.float().reshape(b, h, ch, -1))
    s = torch.softmax(s, dim=-1).to(dtype).float()
    out = out + torch.einsum("bhnp,bhcp->bnhc", s,
                             vp.float().reshape(b, h, ch, -1))
    return (base + gamma.float() * out.reshape(b, n, c)).to(dtype)


# -- the kernels' plan ----------------------------------------------------------

SMS = 132                  # the H100's streaming multiprocessors
TILES = (128, 64, 32, 16)  # token tiles, largest first
HEAD_WIDTHS = (2, 4, 8, 16, 32, 64, 128)
PROJECTIONS = (16, 32, 64, 128)
MAX_C = 512                # fcd_tpu/kernels/dsa_attention.py:345
STREAM_WIDTH = 128         # head widths whose blocks stream their weights
KW = 32                    # weight rows a streamed chunk
PHASE_A_BLOCKS = 2 * SMS   # phase A's chunks aim at this many blocks
NT = 256                   # threads of every block of csrc/dsa.cu
SMEM_CAP = 232448          # shared memory one block may hold (227 KiB)


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
    return 2 * (_weight_rows(c, ch) * _pitch(3 * chp) + t * _pitch(ck)
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
    power of two from 2 to 128, P in PROJECTIONS, C a power of two from 8
    to MAX_C. That is every (C, P) MS_DSA_NET reaches with 4 heads at
    feature sizes 4-32 and project sizes 16-128."""
    if heads <= 0 or c % heads:
        return False
    return (c // heads in HEAD_WIDTHS and p in PROJECTIONS
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

    @property
    def a_blocks(self) -> int:
        return self.chunks * self.heads * self.batch

    @property
    def b_blocks(self) -> int:
        return self.tiles * self.heads * self.batch

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
            f"supported (head width in {HEAD_WIDTHS}, P in {PROJECTIONS}, C "
            f"a power of two from 8 to {MAX_C})")
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
    3's partials stay few. Raises ValueError on shapes the kernels do not
    take."""
    ch = c // heads if heads > 0 else 0
    tile = next((t for t in TILES
                 if -(-n // t) * heads * batch >= SMS and ch < STREAM_WIDTH
                 and max(smem_a(c, ch, p, t), smem_b(c, ch, p, t))
                 <= SMEM_CAP), TILES[-1])
    tiles = -(-n // tile)
    want = min(tiles, -(-PHASE_A_BLOCKS // max(1, heads * batch)))
    return plan_for(n, c, p, heads, batch, tile, -(-tiles // want))


# -- the wrappers ----------------------------------------------------------------

_FNS = {}


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("dsa"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_tokens(x, w_qkvv, ln_scale, ln_bias, pos_embed, num_heads):
    if x.dim() != 3:
        raise ValueError(f"tokens must be (B, N, C), got {tuple(x.shape)}")
    _, n, c = x.shape
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"{num_heads} heads do not divide {c} channels")
    if tuple(w_qkvv.shape) != (c, 4 * c):
        raise ValueError(f"w_qkvv must be ({c}, {4 * c}), got "
                         f"{tuple(w_qkvv.shape)}")
    if tuple(ln_scale.shape) != (c,) or tuple(ln_bias.shape) != (c,):
        raise ValueError(f"LayerNorm affine must be ({c},)")
    if pos_embed is not None and tuple(pos_embed.shape) != (n, c):
        raise ValueError(f"pos_embed must be ({n}, {c})")


def _cuda_operands(what, x, named):
    """The kernels read every operand as it lies: bf16 contiguous tokens,
    and each (name, tensor, dtypes) on x's device, contiguous, 16-byte
    aligned and of one of `dtypes`. Raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 tokens, got {x.dtype}")
    for name, t, dtypes in (("tokens", x, (torch.bfloat16,)), *named):
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
_F32_BF16 = (torch.float32, torch.bfloat16)


def dsa_phase_a(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed, num_heads: int,
                eps: float = 1e-5, temperatures=None,
                plan: Optional[DsaPlan] = None):
    """Phase A: the token sums of each head (PhaseA). With `temperatures`
    = (temperature, temperature2), the glue's result instead: phase B's
    operands (PhaseBOperands, in x's dtype). Plain on CPU; on CUDA the sums
    kernel and the finishing pass, two launches and one count. `plan`
    (default `dsa_plan`'s) sets the kernels' tiles and chunks."""
    _check_tokens(x, w_qkvv, ln_scale, ln_bias, pos_embed, num_heads)
    b, n, c = x.shape
    if ef.dim() != 2 or ef.shape[0] != n:
        raise ValueError(f"ef must be ({n}, P), got {tuple(ef.shape)}")
    h = num_heads
    if temperatures is not None and any(
            t.numel() != h for t in temperatures):
        raise ValueError(f"temperatures must have {h} values each")
    if x.device.type == "cpu":
        a = dsa_phase_a_plain(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed, h,
                              eps)
        return a if temperatures is None else dsa_glue(a, *temperatures, h,
                                                       x.dtype)
    t1, t2 = (None, None) if temperatures is None else temperatures
    _cuda_operands("dsa_phase_a", x, (
        ("w_qkvv", w_qkvv, _F32_BF16), ("ef", ef, _F32_BF16),
        ("pos_embed", pos_embed, _F32), ("ln_scale", ln_scale, _F32),
        ("ln_bias", ln_bias, _F32), ("temperature", t1, _F32),
        ("temperature2", t2, _F32)))
    p = ef.shape[1]
    plan = plan or dsa_plan(n, c, p, h, b)
    ch, dev = plan.ch, x.device
    part = torch.empty((plan.chunks, b, h, plan.record), dtype=torch.float32,
                       device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if temperatures is None:
        out = PhaseA(torch.empty((b, h, ch, ch), **f32),
                     torch.empty((b, c), **f32), torch.empty((b, c), **f32),
                     torch.empty((b, c, p), **f32),
                     torch.empty((b, c, p), **f32))
    else:
        lo = dict(dtype=x.dtype, device=dev)
        out = PhaseBOperands(torch.empty((b, c), **f32),
                             torch.empty((b, h, ch, ch), **lo),
                             torch.empty((b, c, p), **lo),
                             torch.empty((b, c, p), **lo))
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_phase_a", [vp_] * 5 + [ci, vp_, ci, vp_, ci]
             + [vp_] * 7 + [ci] * 8 + [ctypes.c_float, vp_])
    ptr = _build.ptr
    err = fn(ptr(x), ptr(pos_embed), ptr(ln_scale), ptr(ln_bias),
             ptr(w_qkvv), int(w_qkvv.dtype == torch.float32), ptr(ef),
             int(ef.dtype == torch.float32), ptr(part),
             int(temperatures is not None), ptr(t1), ptr(t2),
             *(ptr(t) for t in out), *([ptr(None)] * (5 - len(out))),
             b, n, c, p, h, plan.tile, plan.per_chunk, plan.chunks,
             float(eps), _build.stream())
    _build.check(err, "dsa_phase_a")
    dsa_phase_a.launches += 1
    return out


def dsa_phase_b(x, w_qkvv, qnorm, abig, kpt, vp, gamma, ln_scale, ln_bias,
                pos_embed, num_heads: int, eps: float = 1e-5,
                plan: Optional[DsaPlan] = None) -> torch.Tensor:
    """Phase B: per token tile and head, both attentions and the residual
    (plain on CPU, the kernel on CUDA). Returns (B, N, C) in x's dtype.
    `plan` (default `dsa_plan`'s) sets the token tile."""
    _check_tokens(x, w_qkvv, ln_scale, ln_bias, pos_embed, num_heads)
    b, n, c = x.shape
    h, ch = num_heads, c // num_heads
    p = kpt.shape[-1]
    for name, t, shape in (("qnorm", qnorm, (b, c)),
                           ("abig", abig, (b, h, ch, ch)),
                           ("kpt", kpt, (b, c, p)), ("vp", vp, (b, c, p)),
                           ("gamma", gamma, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return dsa_phase_b_plain(x, w_qkvv, qnorm, abig, kpt, vp, gamma,
                                 ln_scale, ln_bias, pos_embed, h, eps)
    bf = (torch.bfloat16,)
    _cuda_operands("dsa_phase_b", x, (
        ("w_qkvv", w_qkvv, _F32_BF16), ("pos_embed", pos_embed, _F32),
        ("ln_scale", ln_scale, _F32), ("ln_bias", ln_bias, _F32),
        ("qnorm", qnorm, _F32), ("abig", abig, bf), ("kpt", kpt, bf),
        ("vp", vp, bf), ("gamma", gamma, _F32)))
    plan = plan or dsa_plan(n, c, p, h, b)
    out = torch.empty_like(x)
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_phase_b", [vp_] * 5 + [ci] + [vp_] * 6 + [ci] * 6
             + [ctypes.c_float, vp_])
    ptr = _build.ptr
    err = fn(ptr(x), ptr(pos_embed), ptr(ln_scale), ptr(ln_bias),
             ptr(w_qkvv), int(w_qkvv.dtype == torch.float32), ptr(qnorm),
             ptr(abig), ptr(kpt), ptr(vp), ptr(gamma), ptr(out), b, n, c, p,
             h, plan.tile, float(eps), _build.stream())
    _build.check(err, "dsa_phase_b")
    dsa_phase_b.launches += 1
    return out


dsa_phase_a.launches = 0
dsa_phase_b.launches = 0


def dsa_attention(x, w_qkvv, ef, temperature, temperature2, ln_scale,
                  ln_bias, pos_embed: Optional[torch.Tensor], gamma,
                  num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Eval DSA block on tokens (B, N, C): `t + gamma * DSA(LN(t))` with
    `t = x + pos_embed`. CPU: dsa_reference; CUDA: phase A with its
    finishing pass, then phase B."""
    if x.device.type == "cpu":
        return dsa_reference(x, w_qkvv, ef, temperature, temperature2,
                             ln_scale, ln_bias, pos_embed, gamma, num_heads,
                             eps)
    ops = dsa_phase_a(x, w_qkvv, ef, ln_scale, ln_bias, pos_embed, num_heads,
                      eps, temperatures=(temperature, temperature2))
    return dsa_phase_b(x, w_qkvv, *ops, gamma, ln_scale, ln_bias, pos_embed,
                       num_heads, eps)
