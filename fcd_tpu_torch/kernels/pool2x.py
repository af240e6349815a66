"""B3 and B9: the 2x2x2 max pool in a pass of its own, and its backward.

Where encoders 1-2 do not pool inside their block finale (the gates of
`fcd_tpu_torch/flags.py::pool_in_finale`), they pool here:

    B3   pooled = max over each 2x2x2 block of x
         x (B, D, H, W, C) -> (B, D/2, H/2, W/2, C), in x's dtype
    B9   dx = where(x == max of its block, g / (ties in the block), 0)
         the quotient in f32, stored in x's dtype; g is the cotangent of
         `pooled`, and the max is recomputed from x

B3 replaces `fcd_tpu/kernels/pool.py::pool_fwd_pallas` (:121, pallas_call
:144) and B9 `pool.py::pool_bwd_pallas` (:53, pallas_call :74; it too
recomputes the max, `del m` at :73). Both TPU kernels pool over the eight
parity lane groups of an s2d tensor, optionally reading the interior rows
of a padded-chain input; on the port's dense channels-last tensors that
is the 2x2x2 block of each pooled voxel. B9's even split among exact
ties is the s2d pool's custom VJP (`fcd_tpu/ops/s2d_ops.py:237-252`),
which torch's max-pool backward does not give (it sends the gradient to a
single index, ROADMAP C1).

Routes. B3 is Triton: an 8-way max reduction with no product, 2.25 bytes
an element (x read, pooled written); its program walks a tile's eight
children with the max in registers and reads at 83-85% of the bytes
bound on an H100, 3.4-4.0x faster than `max_pool3d` (PERF.md). B9 is CUDA
C++ (`csrc/pool2x_bwd.cu`, built by `_build.py` at first use): its
Triton kernel loaded a [voxels, 8, C] block per program with C a runtime
width and read at 49% of its bytes bound (4.25 bytes an element: x read,
g once per block, dx written; PERF.md). The CUDA kernel gives each
thread V channels (8-byte accesses at V = 4) of one pooled voxel's eight
children and issues all nine loads before it uses any; the plan
(`pool2x_bwd_plan`, `plan_for`) is computed here. dx is bit-equal to
`max_pool2x_bwd_plain`: an IEEE f32 division for the share, no
contraction, cvt.rn to bf16, and the ties counted on the values as the
plain version compares them.

CPU tensors take the plain PyTorch versions; CUDA tensors launch the
kernels or raise. Triton is imported, and the CUDA source built, only
when a kernel is launched.
`max_pool2x_op` is the differentiable op (`MaxPool2x`): forward B3,
backward B9.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.ops.layers import blocks_2x, max_pool_2x, unblocks_2x

REPLACES_FWD = "fcd_tpu/kernels/pool.py:121"  # pool_fwd_pallas (pallas_call :144)
REPLACES_BWD = "fcd_tpu/kernels/pool.py:53"   # pool_bwd_pallas (pallas_call :74)

max_pool2x_plain = max_pool_2x   # B3's function: torch max_pool3d(x, 2, 2)


def max_pool2x_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B9's function: each tied maximum of a block takes g / ties (f32),
    the rest 0, in x's dtype."""
    xb = blocks_2x(x.float())                             # (B, .., 8, C)
    eq = xb == xb.amax(dim=4, keepdim=True)
    share = g.float()[:, :, :, :, None, :] / eq.float().sum(dim=4,
                                                            keepdim=True)
    return unblocks_2x(torch.where(eq, share, 0.0)).to(x.dtype)


_FWD = None


def _fwd_kernel():
    global _FWD
    if _FWD is not None:
        return _FWD
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def pool_fwd_kernel(x_ptr, out_ptr, D, H, W, C,
                        BLOCK_V: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        hp = H // 2
        wp = W // 2
        npool = (D // 2) * hp * wp
        pv = pid * BLOCK_V + tl.arange(0, BLOCK_V)
        cs = tl.arange(0, BLOCK_C)
        mask = (pv < npool)[:, None] & (cs < C)[None, :]
        pz = pv // (hp * wp)
        py = (pv // wp) % hp
        px = pv % wp
        m = tl.full([BLOCK_V, BLOCK_C], float("-inf"), tl.float32)
        for k in tl.static_range(8):
            z = 2 * pz + k // 4
            y = 2 * py + (k // 2) % 2
            x = 2 * px + k % 2
            vox = ((b * D + z).to(tl.int64) * H + y) * W + x
            v = tl.load(x_ptr + vox[:, None] * C + cs[None, :], mask=mask,
                        other=float("-inf"))
            m = tl.maximum(m, v.to(tl.float32))
        poff = (b.to(tl.int64) * npool + pv)[:, None] * C + cs[None, :]
        tl.store(out_ptr + poff, m.to(out_ptr.dtype.element_ty), mask=mask)

    _FWD = pool_fwd_kernel
    return _FWD


def _check(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5:
        raise ValueError(f"{what}: x must be (B, D, H, W, C), got "
                         f"{tuple(x.shape)}")
    d, h, w = x.shape[1:4]
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"{what}: the 2x pool needs even D, H, W, got "
                         f"{(d, h, w)}")


def _launch_shape(x: torch.Tensor, per_block: int):
    b, d, h, w, c = x.shape
    block_c = 1 << max(0, (c - 1).bit_length())
    block_v = max(1, per_block // block_c)
    n = (d // 2) * (h // 2) * (w // 2)
    return ((n + block_v - 1) // block_v, b), block_v, block_c


def _on_card(ts, what: str) -> None:
    if ts[0].device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ts[0].device}")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"{what} kernel got "
                        f"{[str(t.dtype) for t in ts]}" + _build.BF16_ONLY)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} kernel takes contiguous tensors")


def max_pool2x(x: torch.Tensor) -> torch.Tensor:
    """B3 wrapper: (B, D, H, W, C) -> (B, D/2, H/2, W/2, C)."""
    _check(x, "max_pool2x")
    if x.device.type == "cpu":
        return max_pool2x_plain(x)
    _on_card([x], "max_pool2x")
    b, d, h, w, c = x.shape
    out = torch.empty((b, d // 2, h // 2, w // 2, c), dtype=x.dtype,
                      device=x.device)
    # ~1024 elements per child load, read for each of the eight children
    grid, block_v, block_c = _launch_shape(x, 1024)
    _fwd_kernel()[grid](x, out, d, h, w, c, BLOCK_V=block_v,
                        BLOCK_C=block_c, num_warps=4)
    max_pool2x.launches += 1
    return out


max_pool2x.launches = 0


# the kernel's instances, as csrc/pool2x_bwd.cu builds them: channels a
# thread (8-, 4- and 2-byte accesses) -> the tiles a block takes by
# default (on an H100 blocks that walked more were slower, PERF.md)
BUILT = {4: 1, 2: 2, 1: 4}
THREADS = 256


class PoolBwdPlan(NamedTuple):
    """B9's decomposition of one call. A unit is one pooled voxel's eight
    children times `vec` channels (channel group u % groups of pooled
    voxel u // groups); a tile is `threads` units, thread t taking unit
    tile * threads + t; block x of batch item b walks that item's tiles x
    * tiles // blocks up to (x + 1) * tiles // blocks."""
    vec: int
    groups: int             # C / vec
    threads: int
    units: int              # a batch item's pooled voxels x groups
    tiles: int              # a batch item's tiles
    tiles_per_block: int    # the most a block walks
    grid: Tuple[int, int]   # (blocks a batch item, batch)


def plan_for(b: int, d: int, h: int, w: int, c: int, vec: int,
             blocks: Optional[int] = None) -> PoolBwdPlan:
    """The plan with `vec` channels a thread and `blocks` blocks a batch
    item, by default enough that each block takes BUILT[vec] tiles.
    Raises ValueError on what the kernel does not take."""
    if vec not in BUILT or c % vec:
        raise ValueError(f"vec {vec} is not one of {tuple(BUILT)} dividing "
                         f"C {c}")
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"the 2x pool needs even D, H, W, got {(d, h, w)}")
    groups = c // vec
    units = (d // 2) * (h // 2) * (w // 2) * groups
    if units >= 2 ** 31 - THREADS:
        raise ValueError(f"{units} units a batch item overflow the kernel's "
                         "32-bit unit index")
    tiles = max(1, math.ceil(units / THREADS))
    if blocks is None:
        blocks = math.ceil(tiles / BUILT[vec])
    blocks = max(1, min(blocks, tiles))
    return PoolBwdPlan(vec=vec, groups=groups, threads=THREADS, units=units,
                       tiles=tiles, tiles_per_block=math.ceil(tiles / blocks),
                       grid=(blocks, b))


def pool2x_bwd_plan(b: int, d: int, h: int, w: int, c: int,
                    aligned: bool = True) -> PoolBwdPlan:
    """B9's decomposition of a (b, d, h, w, c) call: 4 channels a thread
    (8-byte accesses) where C % 4 == 0, else 2 where C is even, else one;
    one channel a thread where x, g or dx is not 8-byte aligned."""
    vec = next(v for v in BUILT if c % v == 0) if aligned else 1
    return plan_for(b, d, h, w, c, vec)


_BWD = None


def _bwd_fn():
    global _BWD
    if _BWD is None:
        fn = _build.load("pool2x_bwd").fcd_pool2x_bwd
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 3 + [ci] * 10 + [vp]
        fn.restype = ci
        _BWD = fn
    return _BWD


def max_pool2x_bwd(x: torch.Tensor, g: torch.Tensor,
                   plan: Optional[PoolBwdPlan] = None) -> torch.Tensor:
    """B9 wrapper: x (B, D, H, W, C), g (B, D/2, H/2, W/2, C) -> dx. plan:
    another decomposition (`plan_for` of the call's shape), for the
    sweep."""
    _check(x, "max_pool2x_bwd")
    b, d, h, w, c = x.shape
    if tuple(g.shape) != (b, d // 2, h // 2, w // 2, c):
        raise ValueError(f"g {tuple(g.shape)} does not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return max_pool2x_bwd_plain(x, g)
    _on_card([x, g], "max_pool2x_bwd")
    dx = torch.empty_like(x)
    if plan is None:
        plan = pool2x_bwd_plan(b, d, h, w, c, all(
            t.data_ptr() % 8 == 0 for t in (x, g, dx)))
    elif plan != plan_for(b, d, h, w, c, plan.vec, plan.grid[0]):
        raise ValueError(f"plan {plan} does not fit {tuple(x.shape)}")
    if any(t.data_ptr() % (2 * plan.vec) for t in (x, g, dx)):
        raise ValueError(f"{plan.vec} channels a thread need "
                         f"{2 * plan.vec}-byte aligned tensors")
    err = _bwd_fn()(_build.ptr(x), _build.ptr(g), _build.ptr(dx), b, d, h, w,
                    c, plan.vec, plan.threads, plan.units, plan.tiles,
                    plan.grid[0], _build.stream())
    _build.check(err, "max_pool2x_bwd")
    max_pool2x_bwd.launches += 1
    return dx


max_pool2x_bwd.launches = 0


class MaxPool2x(torch.autograd.Function):
    """pooled = the 2x2x2 max pool; forward B3, backward B9 (even split)."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.save_for_backward(x)
        return max_pool2x(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool2x_bwd(x, g.to(x.dtype).contiguous())


def max_pool2x_op(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x max pool (`MaxPool2x`)."""
    return MaxPool2x.apply(x)
