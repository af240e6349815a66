"""B5: fused eval dual self-attention (sa_type 'parallel'), two kernels.

Replaces `fcd_tpu/kernels/dsa_attention.py::dsa_fused` (phase A
pallas_call :243, phase B :310). The CUDA kernels are
`fcd_tpu_torch/csrc/dsa.cu`; its header gives the math, what bounds the
kernels on the card and what their design does about that.

`dsa_attention` is the op the transformer block calls: tokens (B, N, C)
-> `t + gamma * DSA(LN(t))` with `t = x + pos_embed`. On CPU tensors it is
`dsa_reference`, the einsum math of `fcd_tpu/ops/attention.py:116-303` in
PyTorch. On CUDA tensors it is phase A (`dsa_phase_a`), the per-head
softmax glue in PyTorch (`dsa_glue`, as the JAX package leaves it to XLA)
and phase B (`dsa_phase_b`). Each phase wrapper has its own plain version
and launch counter.

Weights: `w_qkvv` is the flax (C, 4C) matrix; the kernels take it as
`w4[slot, cin, cout] = w_qkvv[cin, slot*C + cout]` with slots q, k, v_ca,
v_sa.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import layer_norm

REPLACES_A = "fcd_tpu/kernels/dsa_attention.py:243"  # phase A pallas_call
REPLACES_B = "fcd_tpu/kernels/dsa_attention.py:310"  # phase B pallas_call
_L2_EPS = 1e-12  # fcd_tpu/ops/attention.py::_l2_normalize


class PhaseA(NamedTuple):
    qk: torch.Tensor   # (B, C, C) q^T k
    q2: torch.Tensor   # (B, C) column sums of q^2
    k2: torch.Tensor   # (B, C)
    kp: torch.Tensor   # (B, C, P) bf16(k)^T ef
    vp: torch.Tensor   # (B, C, P) bf16(v_sa)^T ef


def split_qkvv(w_qkvv: torch.Tensor) -> torch.Tensor:
    """(C, 4C) flax matrix -> (4, C, C) per-slot weights."""
    c = w_qkvv.shape[0]
    return w_qkvv.reshape(c, 4, c).permute(1, 0, 2)


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


def dsa_phase_a_plain(x, w4, ef, ln_scale, ln_bias, pos_embed,
                      eps: float = 1e-5) -> PhaseA:
    dtype = x.dtype
    _, xln = _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps)
    xf = xln.float()
    wf = w4.to(dtype).float()
    q, k = xf @ wf[0], xf @ wf[1]
    v_sa = (xf @ wf[3]).to(dtype).float()
    eff = ef.to(dtype).float()
    return PhaseA(q.transpose(1, 2) @ k, q.square().sum(1), k.square().sum(1),
                  k.to(dtype).float().transpose(1, 2) @ eff,
                  v_sa.transpose(1, 2) @ eff)


def dsa_glue(a: PhaseA, temperature, temperature2, num_heads: int, dtype):
    """Per-head softmax of the channel affinity and the phase-B operands
    (fcd_tpu/kernels/dsa_attention.py:277-300): qnorm (B, C) f32, abig
    (B, C, C) block diagonal with out[n, c] = sum_d v[n, d] abig[d, c], and
    kpt = kp * temperature2 of the head, vp, both in `dtype`."""
    b, c, _ = a.qk.shape
    h, ch = num_heads, c // num_heads
    qnorm = torch.rsqrt(a.q2 + _L2_EPS)
    knorm = torch.rsqrt(a.k2 + _L2_EPS)
    qk_n = a.qk * qnorm[:, :, None] * knorm[:, None, :]
    abig = torch.zeros_like(qk_n)
    t1 = temperature.float().reshape(h)
    t2 = temperature2.float().reshape(h)
    kpt = a.kp.clone()
    for j in range(h):
        sl = slice(j * ch, (j + 1) * ch)
        aj = torch.softmax(qk_n[:, sl, sl] * t1[j], dim=-1)
        abig[:, sl, sl] = aj.transpose(1, 2)
        kpt[:, sl] *= t2[j]
    return qnorm, abig.to(dtype), kpt.to(dtype), a.vp.to(dtype)


def dsa_phase_b_plain(x, w4, qnorm, abig, kpt, vp, gamma, ln_scale, ln_bias,
                      pos_embed, num_heads: int,
                      eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    c = x.shape[-1]
    ch = c // num_heads
    base, xln = _ln_tokens(x, pos_embed, ln_scale, ln_bias, eps)
    xf = xln.float()
    wf = w4.to(dtype).float()
    v_ca = (xf @ wf[2]).to(dtype).float()
    out = v_ca @ abig.float()
    qn = ((xf @ wf[0]) * qnorm[:, None, :]).to(dtype).float()
    for j in range(num_heads):
        sl = slice(j * ch, (j + 1) * ch)
        s = torch.softmax(qn[..., sl] @ kpt[:, sl].float(), dim=-1)
        out[..., sl] += s.to(dtype).float() @ vp[:, sl].float().transpose(1, 2)
    return (base + gamma.float() * out).to(dtype)


_FNS = {}


def _fn(name: str, argtypes):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("dsa"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _cuda_tokens(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 tokens, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel takes contiguous tokens")


def _f32(t, dev):
    return None if t is None else t.to(device=dev, dtype=torch.float32).contiguous()


def _bf16(t, dev):
    return t.to(device=dev, dtype=torch.bfloat16).contiguous()


def _check_tokens(x, w4, ln_scale, ln_bias, pos_embed):
    if x.dim() != 3:
        raise ValueError(f"tokens must be (B, N, C), got {tuple(x.shape)}")
    _, n, c = x.shape
    if tuple(w4.shape) != (4, c, c):
        raise ValueError(f"w4 must be (4, {c}, {c}), got {tuple(w4.shape)}")
    if tuple(ln_scale.shape) != (c,) or tuple(ln_bias.shape) != (c,):
        raise ValueError(f"LayerNorm affine must be ({c},)")
    if pos_embed is not None and tuple(pos_embed.shape) != (n, c):
        raise ValueError(f"pos_embed must be ({n}, {c})")


def _tile_tokens(c: int) -> int:
    """Tokens per block of csrc/dsa.cu (its tile_tokens): T * C <= 4096."""
    return 1 if c >= 4096 else 4096 // c


def dsa_phase_a(x, w4, ef, ln_scale, ln_bias, pos_embed,
                eps: float = 1e-5) -> PhaseA:
    """Phase A wrapper: token reductions (plain on CPU, kernel on CUDA)."""
    _check_tokens(x, w4, ln_scale, ln_bias, pos_embed)
    b, n, c = x.shape
    if ef.dim() != 2 or ef.shape[0] != n:
        raise ValueError(f"ef must be ({n}, P), got {tuple(ef.shape)}")
    if x.device.type == "cpu":
        return dsa_phase_a_plain(x, w4, ef, ln_scale, ln_bias, pos_embed, eps)
    _cuda_tokens(x, "dsa_phase_a")
    dev = x.device
    p = ef.shape[1]
    w4b, efb = _bf16(w4, dev), _bf16(ef, dev)
    # one row of partial sums per token tile, added below in a fixed order
    tiles = (n + _tile_tokens(c) - 1) // _tile_tokens(c)
    parts = [torch.empty((tiles,) + s, dtype=torch.float32, device=dev)
             for s in ((b, c, c), (b, c), (b, c), (b, c, p), (b, c, p))]
    # operands stay bound to names until the launch is enqueued
    ops = [x, _f32(pos_embed, dev), _f32(ln_scale, dev), _f32(ln_bias, dev),
           w4b, efb, *parts]
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_phase_a", [vp_] * 11 + [ci] * 4 + [ctypes.c_float, vp_])
    err = fn(*(_build.ptr(t) for t in ops), b, n, c, p, float(eps),
             _build.stream())
    _build.check(err, "dsa_phase_a")
    dsa_phase_a.launches += 1
    return PhaseA(*(t.sum(0) for t in parts))


def dsa_phase_b(x, w4, qnorm, abig, kpt, vp, gamma, ln_scale, ln_bias,
                pos_embed, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Phase B wrapper: per-token-tile attention + residual (plain on CPU,
    kernel on CUDA). Returns (B, N, C) in x's dtype."""
    _check_tokens(x, w4, ln_scale, ln_bias, pos_embed)
    b, n, c = x.shape
    if c % num_heads:
        raise ValueError(f"{num_heads} heads do not divide {c} channels")
    p = kpt.shape[-1]
    for name, t, shape in (("qnorm", qnorm, (b, c)), ("abig", abig, (b, c, c)),
                           ("kpt", kpt, (b, c, p)), ("vp", vp, (b, c, p)),
                           ("gamma", gamma, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return dsa_phase_b_plain(x, w4, qnorm, abig, kpt, vp, gamma, ln_scale,
                                 ln_bias, pos_embed, num_heads, eps)
    _cuda_tokens(x, "dsa_phase_b")
    dev = x.device
    out = torch.empty_like(x)
    # operands stay bound to names until the launch is enqueued
    ops = [x, _f32(pos_embed, dev), _f32(ln_scale, dev), _f32(ln_bias, dev),
           _bf16(w4, dev), _f32(qnorm, dev), _bf16(abig, dev),
           _bf16(kpt, dev), _bf16(vp, dev), _f32(gamma, dev), out]
    vp_, ci = ctypes.c_void_p, ctypes.c_int
    fn = _fn("fcd_dsa_phase_b", [vp_] * 11 + [ci] * 5 + [ctypes.c_float, vp_])
    err = fn(*(_build.ptr(t) for t in ops), b, n, c, p, num_heads,
             float(eps), _build.stream())
    _build.check(err, "dsa_phase_b")
    dsa_phase_b.launches += 1
    return out


dsa_phase_a.launches = 0
dsa_phase_b.launches = 0


def dsa_attention(x, w_qkvv, ef, temperature, temperature2, ln_scale,
                  ln_bias, pos_embed: Optional[torch.Tensor], gamma,
                  num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Eval DSA block on tokens (B, N, C): `t + gamma * DSA(LN(t))` with
    `t = x + pos_embed`. CPU: dsa_reference; CUDA: phase A, glue, phase B."""
    if x.device.type == "cpu":
        return dsa_reference(x, w_qkvv, ef, temperature, temperature2,
                             ln_scale, ln_bias, pos_embed, gamma, num_heads,
                             eps)
    w4 = split_qkvv(w_qkvv)
    a = dsa_phase_a(x, w4, ef, ln_scale, ln_bias, pos_embed, eps)
    qnorm, abig, kpt, vp = dsa_glue(a, temperature, temperature2, num_heads,
                                    x.dtype)
    return dsa_phase_b(x, w4, qnorm, abig, kpt, vp, gamma, ln_scale, ln_bias,
                       pos_embed, num_heads, eps)
