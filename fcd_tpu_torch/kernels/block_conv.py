"""B1: the eval residual blocks' 3x3x3 "same" convolution.

Replaces `fcd_tpu/kernels/block_conv.py::_fused8_call` (reached through
`blocked_conv_a2o`, `blocked_conv_a2o_multi` and `blocked_conv_o2a`). The
CUDA kernel is `fcd_tpu_torch/csrc/conv3d.cu`; its header says what bounds
it on the card and what its design does about that.

`conv3x3(parts, weights, ...)` convolves the sum of one or two input parts
(the decoder's concat is never materialised), with optional

* `prologue=(scale, shift, slope)`: part 0 is read as
  `leaky(x * scale[b, c] + shift[b, c])`, rounded to the activation dtype,
  with the zero padding applied after it (norm1 + act fused into conv2);
* `shortcut=[wr_0, ...]`: the 1x1 projection `sum_p x_p @ wr_p` as a second
  output from the same reads;
* `want_stats=True`: per-(b, cout) f32 sum and sum of squares of both
  outputs, taken on the f32 results before rounding.

CPU tensors take the plain PyTorch version (`conv3x3_plain`); CUDA tensors
launch the kernel or raise. The kernel takes bf16 activations only.

The kernel's tiling is chosen here (`conv_tiling`), and its weights are
packed here into the K-major layout its wgmma operands read
(`pack_weights`), so the CPU tests reach both.

`conv3x3_op` is the same op as a `torch.autograd.Function` (`Conv3x3`),
the training path's conv. Its backward, as `fcd_tpu/ops/s2d_ops.py:
381-421, 454-475, 618-673` computes it:

* folds the statistics' cotangents into the output's:
  `dy = gy + gysum + 2 * y * gysq` (and the same for the shortcut r);
* dx per part with B1 itself, on spatially flipped, channel-transposed
  weights (the conv's adjoint), skipped where no gradient is needed;
* the 1x1 shortcut's gradients with `torch.matmul`;
* dW per part with K1 (`kernels/conv_wgrad.py`), recomputing the
  prologue on its loads;
* with a prologue, its backward in plain PyTorch: the act mask and the
  affine from the saved input, the affine's cotangent as sums over the
  grid (they chain to the statistics that produced the affine).

Tensor parallelism's row-parallel conv (`parallel/tp.py`: conv2 of a res
block, and the transformers' conv1, hold this rank's slice of the input
channels) splits B1 around the all-reduce (`ops/blocks.py::
conv3x3_row_op`, which runs the all-reduce); its two pieces are here:

1. `conv3x3_partial_op`, B1's partial instance (`fcd_conv3d_partial`):
   the conv of the rank's channel slice, prologue on that slice, f32
   result, no statistics (its own plain version and launch counter);
2. `conv_finish_op`, after the f32 all-reduce: `kernels/conv_finish.py`,
   the sum rounded, and its statistics.

Their backward is `Conv3x3`'s for one part: the statistics' cotangents
fold into dy on the whole output (the same on every rank), then B1's data
gradient and K1's weight gradient on the rank's shard of the weight.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.kernels.conv_finish import conv_finish
from fcd_tpu_torch.kernels.conv_wgrad import conv3d_wgrad

REPLACES = "fcd_tpu/kernels/block_conv.py:909"  # _fused8_call (pallas_call :1000)
TILE_HW = 8  # a block's output tile is td x 8 x 8 voxels (one m64 per z)
KC = 16      # input channels per k-step of csrc/conv3d.cu (wgmma k16)
SMS = 132    # the H100's SMs: the block count the cout split aims for


class Tiling(NamedTuple):
    """A launch of csrc/conv3d.cu: td x 8 x 8 output voxels and bn output
    channels per block, over a (ntz * nty * ntx, ncout, batch) grid.
    `rows` is the partial statistics' first axis: one row per spatial
    tile."""
    td: int
    bn: int
    ntz: int
    nty: int
    ntx: int
    ncout: int

    @property
    def rows(self) -> int:
        return self.ntz * self.nty * self.ntx


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_tiling(b: int, d: int, h: int, w: int, cout: int) -> Tiling:
    """The kernel's tile for a (b, d, h, w) grid into cout channels: 4 z-
    slices (2 on grids at most 2 deep), bn the narrowest of 16/32/64 that
    holds cout, halved while the grid has fewer than SMS blocks."""
    td = 2 if d <= 2 else 4
    bn = 16 if cout <= 16 else 32 if cout <= 32 else 64
    tiles = _cdiv(d, td) * _cdiv(h, TILE_HW) * _cdiv(w, TILE_HW)
    while bn > 16 and tiles * _cdiv(cout, bn) * b < SMS:
        bn //= 2
    return Tiling(td, bn, _cdiv(d, td), _cdiv(h, TILE_HW),
                  _cdiv(w, TILE_HW), _cdiv(cout, bn))


def pack_weights(w: torch.Tensor, bn: int, dtype=None) -> torch.Tensor:
    """(3, 3, 3, C, cout), or the shortcut's (C, cout) as one tap, ->
    (cout/bn, C/16, taps, 2, bn, 8) in `dtype`, zero-padded: per cout
    slice and 16-channel k-step, each tap's wgmma B operand as two K-major
    planes of 8 channels x bn. One copy (cast and permute) where C and
    cout need no padding."""
    c, cout = w.shape[-2:]
    nch, nt = _cdiv(c, KC), _cdiv(cout, bn)
    src = w.reshape(-1, c, cout)
    if (nch * KC, nt * bn) != (c, cout):
        src = F.pad(src, (0, nt * bn - cout, 0, nch * KC - c))
    taps = src.shape[0]
    out = torch.empty((nt, nch, taps, 2, bn, 8), dtype=dtype or w.dtype,
                      device=w.device)
    out.permute(2, 1, 3, 5, 0, 4).copy_(src.reshape(taps, nch, 2, 8, nt, bn))
    return out


class ConvOut(NamedTuple):
    y: torch.Tensor
    ysum: Optional[torch.Tensor] = None
    ysq: Optional[torch.Tensor] = None
    r: Optional[torch.Tensor] = None
    rsum: Optional[torch.Tensor] = None
    rsq: Optional[torch.Tensor] = None


Prologue = Tuple[torch.Tensor, torch.Tensor, float]


def _sums(t: torch.Tensor):
    """Per-(b, c) sum and sum of squares over the spatial axes (f32)."""
    return t.sum(dim=(1, 2, 3)), t.square().sum(dim=(1, 2, 3))


def conv3x3_plain(parts: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor], *,
                  shortcut: Optional[Sequence[torch.Tensor]] = None,
                  prologue: Optional[Prologue] = None,
                  want_stats: bool = False) -> ConvOut:
    """The kernel's function in plain PyTorch: f32 arithmetic on the
    activation-dtype inputs and weights, outputs rounded to that dtype."""
    dtype = parts[0].dtype
    y = r = None
    for i, (x, w) in enumerate(zip(parts, weights)):
        xf = x.float()
        if i == 0 and prologue is not None:
            scale, shift, slope = prologue
            xf = xf * scale.float()[:, None, None, None, :] \
                + shift.float()[:, None, None, None, :]
            xf = F.leaky_relu(xf, slope).to(dtype).float()
        wf = w.to(dtype).float()
        yi = F.conv3d(xf.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2),
                      padding=1).permute(0, 2, 3, 4, 1)
        y = yi if y is None else y + yi
        if shortcut is not None:
            ri = torch.matmul(x.float(), shortcut[i].to(dtype).float())
            r = ri if r is None else r + ri
    ysum = ysq = rsum = rsq = None
    if want_stats:
        ysum, ysq = _sums(y)
        if r is not None:
            rsum, rsq = _sums(r)
    return ConvOut(y.to(dtype).contiguous(), ysum, ysq,
                   None if r is None else r.to(dtype).contiguous(), rsum, rsq)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("conv3d").fcd_conv3d
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, vp, vp, vp, ci, ci, vp, vp,
                       ctypes.c_float, vp, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _FN = fn
    return _FN


def _check_args(parts, weights, shortcut, prologue):
    if not 1 <= len(parts) <= 2 or len(weights) != len(parts):
        raise ValueError("conv3x3 takes one or two parts, one weight each")
    x0 = parts[0]
    if x0.dim() != 5:
        raise ValueError(f"parts must be (B, D, H, W, C), got {tuple(x0.shape)}")
    cout = weights[0].shape[-1]
    for x, w in zip(parts, weights):
        if x.shape[:4] != x0.shape[:4] or x.device != x0.device \
                or x.dtype != x0.dtype:
            raise ValueError("parts must share batch, grid, device and dtype")
        if tuple(w.shape) != (3, 3, 3, x.shape[-1], cout):
            raise ValueError(f"weight {tuple(w.shape)} does not fit part "
                             f"{tuple(x.shape)} -> {cout}")
    if shortcut is not None:
        if len(shortcut) != len(parts):
            raise ValueError("one shortcut weight per part")
        for x, wr in zip(parts, shortcut):
            if tuple(wr.shape) != (x.shape[-1], cout):
                raise ValueError(f"shortcut weight {tuple(wr.shape)} does "
                                 f"not fit part {tuple(x.shape)}")
    if prologue is not None:
        if len(parts) != 1 or shortcut is not None:
            raise ValueError("the prologue applies to a single part without "
                             "a shortcut")
        b, c = x0.shape[0], x0.shape[-1]
        for t in prologue[:2]:
            if tuple(t.shape) != (b, c):
                raise ValueError(f"prologue affine must be ({b}, {c})")


def conv3x3(parts: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
            *, shortcut: Optional[Sequence[torch.Tensor]] = None,
            prologue: Optional[Prologue] = None,
            want_stats: bool = False) -> ConvOut:
    """B1 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (bf16, contiguous) or an error."""
    _check_args(parts, weights, shortcut, prologue)
    x0 = parts[0]
    if x0.device.type == "cpu":
        return conv3x3_plain(parts, weights, shortcut=shortcut,
                             prologue=prologue, want_stats=want_stats)
    if x0.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x0.device}")
    if x0.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 kernel got {x0.dtype} activations"
                        + _build.BF16_ONLY)
    if not all(x.is_contiguous() for x in parts):
        raise ValueError("conv3x3 kernel takes contiguous parts")
    if (all(x.shape[-1] % 8 == 0 for x in parts)
            and any(x.data_ptr() % 16 for x in parts)):
        # C % 8 == 0 in every part: the kernel loads 16-byte vectors
        raise ValueError("conv3x3 kernel takes 16-byte aligned parts")
    b, d, h, w = x0.shape[:4]
    cout = weights[0].shape[-1]
    dev = x0.device
    t = conv_tiling(b, d, h, w, cout)
    bf = torch.bfloat16
    wk = [pack_weights(wt.to(dev), t.bn, bf) for wt in weights]
    wr = (None if shortcut is None else
          [pack_weights(s.to(dev), t.bn, bf) for s in shortcut])
    y = torch.empty((b, d, h, w, cout), dtype=bf, device=dev)
    r = None if wr is None else torch.empty_like(y)
    nsums = (2 if r is None else 4) if want_stats else 0
    # y's sum and sum of squares, then r's: one row per spatial tile
    sums = (torch.empty((nsums, t.rows, b, cout), dtype=torch.float32,
                        device=dev) if want_stats else None)
    at = [0] * 4   # the four buffers' pointers (NULL where absent)
    if sums is not None:
        at[:nsums] = [sums.data_ptr() + 4 * i * sums.stride(0)
                      for i in range(nsums)]
    scale = shift = None
    slope = 0.0
    if prologue is not None:
        scale = prologue[0].to(device=dev, dtype=torch.float32).contiguous()
        shift = prologue[1].to(device=dev, dtype=torch.float32).contiguous()
        slope = float(prologue[2])
    p1 = parts[1] if len(parts) > 1 else None
    err = _fn()(
        _build.ptr(x0), _build.ptr(wk[0]),
        _build.ptr(None if wr is None else wr[0]), x0.shape[-1],
        _build.ptr(p1), _build.ptr(wk[1] if p1 is not None else None),
        _build.ptr(wr[1] if (wr is not None and p1 is not None) else None),
        0 if p1 is None else p1.shape[-1], len(parts),
        _build.ptr(scale), _build.ptr(shift), slope,
        _build.ptr(y), _build.ptr(r), *map(ctypes.c_void_p, at),
        b, d, h, w, cout, t.td, t.bn,
        t.ntz, t.nty, t.ntx, _build.stream())
    _build.check(err, "conv3d")
    conv3x3.launches += 1
    if not want_stats:
        return ConvOut(y, r=r)
    # over the tiles, in a fixed order (the same bits run to run)
    tot = sums.sum(1).unbind(0)
    return ConvOut(y, tot[0], tot[1], r, *tot[2:])


conv3x3.launches = 0


_FN_PARTIAL = None


def _partial_fn():
    global _FN_PARTIAL
    if _FN_PARTIAL is None:
        fn = _build.load("conv3d").fcd_conv3d_partial
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, vp, vp, ctypes.c_float, vp] + [ci] * 10 \
            + [vp]
        fn.restype = ci
        _FN_PARTIAL = fn
    return _FN_PARTIAL


def conv3x3_partial_plain(x: torch.Tensor, w: torch.Tensor,
                          prologue: Optional[Prologue] = None
                          ) -> torch.Tensor:
    """B1's partial instance in plain PyTorch: `conv3x3_plain`'s conv of
    one part, left in f32 (no rounding, no statistics)."""
    xf = x.float()
    if prologue is not None:
        scale, shift, slope = prologue
        xf = xf * scale.float()[:, None, None, None, :] \
            + shift.float()[:, None, None, None, :]
        xf = F.leaky_relu(xf, slope).to(x.dtype).float()
    wf = w.to(x.dtype).float()
    return F.conv3d(xf.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2),
                    padding=1).permute(0, 2, 3, 4, 1).contiguous()


def conv3x3_partial(x: torch.Tensor, w: torch.Tensor,
                    prologue: Optional[Prologue] = None) -> torch.Tensor:
    """B1's partial instance: the f32 conv of one part (a rank's slice of
    the input channels), optional prologue; the plain version for a CPU
    tensor, the kernel for a CUDA one (bf16, contiguous)."""
    _check_args([x], [w], None, prologue)
    if x.device.type == "cpu":
        return conv3x3_partial_plain(x, w, prologue)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_partial: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_partial kernel got {x.dtype} activations"
                        + _build.BF16_ONLY)
    if not x.is_contiguous() or (x.shape[-1] % 8 == 0
                                 and x.data_ptr() % 16):
        raise ValueError("conv3x3_partial kernel takes a contiguous, "
                         "16-byte aligned part")
    b, d, h, wd = x.shape[:4]
    cout = w.shape[-1]
    t = conv_tiling(b, d, h, wd, cout)
    wk = pack_weights(w.to(x.device), t.bn, torch.bfloat16)
    yf = torch.empty((b, d, h, wd, cout), dtype=torch.float32,
                     device=x.device)
    scale = shift = None
    slope = 0.0
    if prologue is not None:
        scale = prologue[0].to(device=x.device,
                               dtype=torch.float32).contiguous()
        shift = prologue[1].to(device=x.device,
                               dtype=torch.float32).contiguous()
        slope = float(prologue[2])
    err = _partial_fn()(_build.ptr(x), _build.ptr(wk), x.shape[-1], _build.ptr(scale),
             _build.ptr(shift), slope, _build.ptr(yf), b, d, h, wd, cout,
             t.td, t.bn, t.ntz, t.nty, t.ntx, _build.stream())
    _build.check(err, "conv3d_partial")
    conv3x3_partial.launches += 1
    return yf


conv3x3_partial.launches = 0


def _fold_stats(g, gsum, gsq, y):
    """Cotangent of y with those of its sums folded in (f32)."""
    out = torch.zeros_like(y, dtype=torch.float32) if g is None else g.float()
    if gsum is not None:
        out = out + gsum.float()[:, None, None, None, :]
    if gsq is not None:
        out = out + 2.0 * y.float() * gsq.float()[:, None, None, None, :]
    return out


def _adjoint(w: torch.Tensor) -> torch.Tensor:
    """The conv's adjoint kernel: spatially flipped, channels swapped."""
    return torch.flip(w, dims=(0, 1, 2)).transpose(3, 4)


def _part_grads(x, w, dy, pro, short, need_x: bool, need_w: bool,
                need_pro: bool):
    """(dx, dw, (dscale, dshift)) of one part of the conv for the folded
    cotangent dy (x's dtype), each None where not needed: dx with B1 on the
    adjoint kernel (plus the shortcut's (dr, wr) term), the prologue's
    backward in plain PyTorch, dw with K1."""
    dx = dw = dpro = None
    if need_x or need_pro:
        da = conv3x3([dy], [_adjoint(w)]).y.float()
        if short is not None:
            dr, wr = short
            da = da + torch.matmul(dr, wr.to(dy.dtype).t()).float()
        if pro is not None:
            scale = pro[0].float()[:, None, None, None, :]
            shift = pro[1].float()[:, None, None, None, :]
            xf = x.float()
            dt = da * torch.where(xf * scale + shift >= 0, 1.0, pro[2])
            da = dt * scale
            dpro = ((dt * xf).sum(dim=(1, 2, 3)).to(pro[0].dtype),
                    dt.sum(dim=(1, 2, 3)).to(pro[1].dtype))
        if need_x:
            dx = da.to(x.dtype)
    if need_w:
        dw = conv3d_wgrad(x.contiguous(), dy, pro).reshape(w.shape).to(w.dtype)
    return dx, dw, dpro


class Conv3x3(torch.autograd.Function):
    """Differentiable `conv3x3`. Inputs after the flags: the parts, their
    weights, the shortcut weights (if any), the prologue's scale and shift
    (if any). Outputs: y, then (ysum, ysq) with stats, r with a shortcut,
    then (rsum, rsq) with both."""

    @staticmethod
    def forward(ctx, nparts: int, has_short: bool, has_pro: bool,
                want_stats: bool, slope: float, *tensors):
        parts = list(tensors[:nparts])
        weights = list(tensors[nparts:2 * nparts])
        k = 2 * nparts
        shortcut = list(tensors[k:k + nparts]) if has_short else None
        k += nparts if has_short else 0
        prologue = (tensors[k], tensors[k + 1], slope) if has_pro else None
        o = conv3x3(parts, weights, shortcut=shortcut, prologue=prologue,
                    want_stats=want_stats)
        ctx.set_materialize_grads(False)
        ctx.flags = (nparts, has_short, has_pro, want_stats, slope)
        ctx.save_for_backward(*tensors, o.y, o.r)
        outs = [o.y]
        if want_stats:
            outs += [o.ysum, o.ysq]
        if has_short:
            outs.append(o.r)
            if want_stats:
                outs += [o.rsum, o.rsq]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        nparts, has_short, has_pro, want_stats, slope = ctx.flags
        saved = ctx.saved_tensors
        tensors, y, r = saved[:-2], saved[-2], saved[-1]
        parts = tensors[:nparts]
        weights = tensors[nparts:2 * nparts]
        k = 2 * nparts
        shortcut = tensors[k:k + nparts] if has_short else None
        k += nparts if has_short else 0
        grads = list(grads)
        gy = grads.pop(0)
        gysum, gysq = (grads.pop(0), grads.pop(0)) if want_stats else (None, None)
        gr = grsum = grsq = None
        if has_short:
            gr = grads.pop(0)
            if want_stats:
                grsum, grsq = grads.pop(0), grads.pop(0)
        need = ctx.needs_input_grad[5:]   # after the five flags
        dtype = parts[0].dtype
        dy = _fold_stats(gy, gysum, gysq, y).to(dtype).contiguous()
        dr = (_fold_stats(gr, grsum, grsq, r).to(dtype)
              if has_short else None)
        out = [None] * len(tensors)
        for i, (x, w) in enumerate(zip(parts, weights)):
            pro = (tensors[k], tensors[k + 1], slope) if has_pro and i == 0 \
                else None
            short = (dr, shortcut[i]) if has_short else None
            dx, dw, dpro = _part_grads(
                x, w, dy, pro, short, need[i], need[nparts + i],
                pro is not None and (need[k] or need[k + 1]))
            out[i], out[nparts + i] = dx, dw
            if dpro is not None:
                out[k], out[k + 1] = dpro
            if has_short and need[2 * nparts + i]:
                ci, co = x.shape[-1], dr.shape[-1]
                out[2 * nparts + i] = torch.matmul(
                    x.reshape(-1, ci).t().float(),
                    dr.reshape(-1, co).float()).to(shortcut[i].dtype)
        return (None,) * 5 + tuple(out)


def conv3x3_op(parts: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
               *, shortcut: Optional[Sequence[torch.Tensor]] = None,
               prologue: Optional[Prologue] = None,
               want_stats: bool = False) -> ConvOut:
    """`conv3x3` with gradients (the `Conv3x3` Function)."""
    _check_args(parts, weights, shortcut, prologue)
    tensors = list(parts) + list(weights) + list(shortcut or [])
    slope = 0.0
    if prologue is not None:
        tensors += [prologue[0], prologue[1]]
        slope = float(prologue[2])
    outs = list(Conv3x3.apply(len(parts), shortcut is not None,
                              prologue is not None, want_stats, slope,
                              *tensors))
    y = outs.pop(0)
    ysum, ysq = (outs.pop(0), outs.pop(0)) if want_stats else (None, None)
    r = rsum = rsq = None
    if shortcut is not None:
        r = outs.pop(0)
        if want_stats:
            rsum, rsq = outs.pop(0), outs.pop(0)
    return ConvOut(y, ysum, ysq, r, rsum, rsq)


class Conv3x3Partial(torch.autograd.Function):
    """Differentiable `conv3x3_partial`: inputs x, w and, with a prologue,
    its scale and shift; output the f32 partial. Its cotangent is the whole
    output's (the all-reduce's backward is the identity), already folded
    with the statistics' by `_Finish`."""

    @staticmethod
    def forward(ctx, has_pro: bool, slope: float, x, w, *pro):
        prologue = (pro[0], pro[1], slope) if has_pro else None
        ctx.set_materialize_grads(False)
        ctx.has_pro, ctx.slope = has_pro, slope
        ctx.save_for_backward(x, w, *pro)
        return conv3x3_partial(x, w, prologue)

    @staticmethod
    def backward(ctx, g):
        x, w, *pro = ctx.saved_tensors
        if g is None:
            return (None,) * (4 + len(pro))
        need = ctx.needs_input_grad[2:]
        prologue = (pro[0], pro[1], ctx.slope) if ctx.has_pro else None
        dy = g.to(x.dtype).contiguous()
        dx, dw, dpro = _part_grads(
            x, w, dy, prologue, None, need[0], need[1],
            ctx.has_pro and (need[2] or need[3]))
        return (None, None, dx, dw) + (tuple(dpro) if dpro is not None
                                       else (None,) * len(pro))


class _Finish(torch.autograd.Function):
    """Differentiable `conv_finish`: (y, ysum, ysq) of an f32 sum; the
    backward folds the statistics' cotangents into y's, in f32."""

    @staticmethod
    def forward(ctx, s, dtype):
        y, ysum, ysq = conv_finish(s, dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y)
        return y, ysum, ysq

    @staticmethod
    def backward(ctx, gy, gsum, gsq):
        (y,) = ctx.saved_tensors
        return _fold_stats(gy, gsum, gsq, y), None


def conv3x3_partial_op(x: torch.Tensor, w: torch.Tensor, *,
                       prologue: Optional[Prologue] = None) -> torch.Tensor:
    """`conv3x3_partial` with gradients (the `Conv3x3Partial` Function):
    x and w are this rank's slices of the input channels, prologue the
    affine of that slice; the f32 partial sum of the output."""
    tensors = [x, w]
    slope = 0.0
    if prologue is not None:
        tensors += [prologue[0], prologue[1]]
        slope = float(prologue[2])
    return Conv3x3Partial.apply(prologue is not None, slope, *tensors)


def conv_finish_op(s: torch.Tensor, dtype: torch.dtype) -> ConvOut:
    """`conv_finish` with gradients (the `_Finish` Function): the whole f32
    sum rounded to dtype, with its f32 statistics."""
    y, ysum, ysq = _Finish.apply(s, dtype)
    return ConvOut(y, ysum, ysq)
