"""K1: the weight gradient of the 3x3x3 "same" convolution.

Replaces `fcd_tpu/kernels/block_conv.py::blocked_conv_a2o_dw` and
`blocked_conv_o2a_dw` (B7) and `blocked_conv_s2d_dw` (B13). The CUDA
kernels are `fcd_tpu_torch/csrc/conv3d_wgrad.cu`; its header says what
bounds them on the card and what their design does about that.

    dW[tap, ci, co] = sum_{b, v} pro(x)[b, v + tap, ci] * g[b, v, co]

with zero padding outside the volume applied after the optional prologue
`pro(v) = bf16(leaky(v * scale[b, c] + shift[b, c]))` (B1's convention).
`tap = 9 * kz + 3 * ky + kx`, so `dW.reshape(3, 3, 3, ci, co)` is the
gradient of a flax (3, 3, 3, ci, co) kernel.

The reduction over the voxels is split into chunks of 4 x 8 x 8 voxel
tiles (`wgrad_plan`, a pure function of the shapes): each chunk's blocks
write a partial dW to a scratch buffer, and a second kernel adds the
partials in a fixed order (`sum_partials` is that order in plain
PyTorch), so dW is the same bits from run to run. One call counts one
launch, both kernels included.

CPU tensors take the plain PyTorch version; CUDA tensors launch the kernel
or raise. The kernel takes bf16 x and g.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from fcd_tpu_torch.kernels import _build

# blocked_conv_a2o_dw (pallas_call :1412); also blocked_conv_o2a_dw :1435
# and blocked_conv_s2d_dw :1626
REPLACES = "fcd_tpu/kernels/block_conv.py:1390"

Prologue = Tuple[torch.Tensor, torch.Tensor, float]

TILE = (4, 8, 8)         # the kernel's voxel tile (z, y, x)
SMS = 132                # H100 SXM streaming multiprocessors
SCRATCH_CAP = 16 << 20   # bytes of partial sums at most
MIN_SPLIT = 4            # chunks of a split at least
RUNS = 8                 # the second pass's runs of consecutive chunks


def apply_prologue(x: torch.Tensor, prologue: Prologue) -> torch.Tensor:
    """`leaky(x * scale[b, c] + shift[b, c])` in f32, rounded to x's dtype."""
    scale, shift, slope = prologue
    t = x.float() * scale.float()[:, None, None, None, :] \
        + shift.float()[:, None, None, None, :]
    return F.leaky_relu(t, slope).to(x.dtype)


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                       prologue: Optional[Prologue] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one f32 product per tap of
    the zero-padded (prologued) input against g. Returns (27, ci, co) f32."""
    a = apply_prologue(x, prologue) if prologue is not None else x
    b, d, h, w, ci = a.shape
    co = g.shape[-1]
    ap = F.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gm = g.float().reshape(-1, co)
    out = []
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                xs = ap[:, kz:kz + d, ky:ky + h, kx:kx + w].reshape(-1, ci)
                out.append(xs.t() @ gm)
    return torch.stack(out)


@dataclass(frozen=True)
class WgradPlan:
    """How one call splits its work: (ci tiles x co tiles) x chunks
    blocks; chunk k owns the voxel tiles k, k + chunks, k + 2 chunks, ...
    of the (b, tz, ty, tx) order, x fastest (per_chunk of them at most)."""
    ci_tile: int                 # 8, 16 or 32
    co_tile: int                 # 16 or 32
    n_ci: int
    n_co: int
    grid: Tuple[int, int, int]   # voxel tiles per batch item (z, y, x)
    tiles: int                   # over the batch
    per_chunk: int
    chunks: int
    scratch_bytes: int           # partial sums (0 with one chunk)

    @property
    def blocks(self) -> int:
        return self.chunks * self.n_ci * self.n_co


def blocks_per_sm(ci_tile: int, co_tile: int) -> int:
    """Resident blocks per SM the kernel is built for (its launch bounds:
    registers for 3 x (co_tile / 16) x (ci_tile / 8) accumulator tiles)."""
    tiles = (co_tile // 16) * (ci_tile // 8)
    return 3 if tiles <= 2 else 2 if tiles <= 4 else 1


def wgrad_plan(b: int, d: int, h: int, w: int, ci: int, co: int) -> WgradPlan:
    """The chunking of one K1 call. Chunks are asked for until the grid
    fills the SMs once with resident blocks, their partial sums held under
    SCRATCH_CAP. Where that allows fewer than MIN_SPLIT chunks (a dW over
    4 MiB: the widest convs of 4^3-8^3), the call runs as one chunk with
    dW tiled over the blocks: there the partials' traffic and the second
    pass cost more than two or three chunks gain (`wgrad_sweep` on an
    H100)."""
    ci_tile = 8 if ci <= 8 else 16 if ci <= 16 else 32
    co_tile = 16 if co <= 16 else 32
    n_ci, n_co = -(-ci // ci_tile), -(-co // co_tile)
    grid = tuple(-(-s // t) for s, t in zip((d, h, w), TILE))
    tiles = b * grid[0] * grid[1] * grid[2]
    dw_bytes = 4 * 27 * ci * co
    want = -(-SMS * blocks_per_sm(ci_tile, co_tile) // (n_ci * n_co))
    most = SCRATCH_CAP // dw_bytes
    chunks = 1 if most < MIN_SPLIT else min(tiles, want, most)
    per_chunk = -(-tiles // chunks)
    chunks = -(-tiles // per_chunk)
    return WgradPlan(ci_tile, co_tile, n_ci, n_co, grid, tiles, per_chunk,
                     chunks, dw_bytes * chunks if chunks > 1 else 0)


def chunk_voxels(plan: WgradPlan, shape: Tuple[int, int, int, int]
                 ) -> List[torch.Tensor]:
    """Per chunk, in chunk order, the flat (b, z, y, x) indices of the
    in-volume voxels its tiles cover, tile by tile as the kernel walks
    them (shape = (b, d, h, w))."""
    b, d, h, w = shape
    gz, gy, gx = plan.grid
    t = torch.arange(plan.tiles)
    tile = (t // (gx * gy * gz), (t // (gx * gy)) % gz, (t // gx) % gy,
            t % gx)

    def axis(k, n):   # (tiles, n) coordinates along one axis
        return tile[k][:, None] * n + torch.arange(n)

    z, y, x = (axis(k, n) for k, n in zip((1, 2, 3), TILE))
    z, y, x = z[:, :, None, None], y[:, None, :, None], x[:, None, None, :]
    inside = (z < d) & (y < h) & (x < w)
    flat = ((tile[0][:, None, None, None] * d + z) * h + y) * w + x
    walk = (torch.arange(k, plan.tiles, plan.chunks)
            for k in range(plan.chunks))
    return [flat[ts][inside[ts]] for ts in walk]


def sum_partials(part: torch.Tensor) -> torch.Tensor:
    """The second pass in plain f32 PyTorch, in the kernel's order: RUNS
    runs of consecutive chunks, each summed in chunk order, then the runs
    in order. part: (chunks, ...)."""
    chunks = part.shape[0]
    per = -(-chunks // RUNS)
    runs = []
    for s in range(RUNS):
        acc = torch.zeros_like(part[0])
        for c in range(s * per, min(chunks, (s + 1) * per)):
            acc = acc + part[c]
        runs.append(acc)
    total = runs[0]
    for r in runs[1:]:
        total = total + r
    return total


def conv3d_wgrad_chunked(x: torch.Tensor, g: torch.Tensor,
                         prologue: Optional[Prologue] = None,
                         plan: Optional[WgradPlan] = None) -> torch.Tensor:
    """The kernel's reduction in plain PyTorch: each chunk's partial dW
    (the plain product over that chunk's voxels alone), then the partials
    added by `sum_partials`."""
    b, d, h, w, ci = x.shape
    co = g.shape[-1]
    plan = plan or wgrad_plan(b, d, h, w, ci, co)
    if plan.chunks == 1:
        return conv3d_wgrad_plain(x, g, prologue)
    flat = g.reshape(-1, co)
    parts = []
    for idx in chunk_voxels(plan, (b, d, h, w)):
        gk = torch.zeros_like(flat)
        gk[idx] = flat[idx]
        parts.append(conv3d_wgrad_plain(x, gk.reshape(g.shape), prologue))
    return sum_partials(torch.stack(parts))


def bind(lib: ctypes.CDLL):
    """The typed C entry point of a library built from conv3d_wgrad.cu."""
    fn = lib.fcd_conv3d_wgrad
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp, vp, *[ci] * 14, vp]
    fn.restype = ci
    return fn


_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = bind(_build.load("conv3d_wgrad"))
    return _FN


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor,
                 prologue: Optional[Prologue] = None) -> torch.Tensor:
    """K1 wrapper. x: (B, D, H, W, ci); g: (B, D, H, W, co); prologue:
    (scale, shift, slope) with (B, ci) affines, or None. Returns
    (27, ci, co) f32."""
    if x.dim() != 5 or g.dim() != 5 or x.shape[:4] != g.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be "
                         "(B, D, H, W, C) tensors on one grid")
    if x.device != g.device:
        raise ValueError("x and g must be on one device")
    b, d, h, w, ci = x.shape
    co = g.shape[-1]
    if prologue is not None:
        for t in prologue[:2]:
            if tuple(t.shape) != (b, ci):
                raise ValueError(f"prologue affine must be ({b}, {ci})")
    if x.device.type == "cpu":
        return conv3d_wgrad_plain(x, g, prologue)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_wgrad: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_wgrad kernel got {x.dtype} x and "
                        f"{g.dtype} g" + _build.BF16_ONLY)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv3d_wgrad kernel takes contiguous x and g")
    if b * d * h * w >= 2 ** 31:
        raise ValueError("conv3d_wgrad kernel takes under 2^31 voxels")
    scale = shift = None
    slope = 0.0
    if prologue is not None:
        # f32, contiguous and 16-byte aligned: the kernel reads float4s
        scale, shift = (t.to(device=x.device, dtype=torch.float32).contiguous()
                        for t in prologue[:2])
        scale, shift = (t if t.data_ptr() % 16 == 0 else t.clone()
                        for t in (scale, shift))
        slope = float(prologue[2])
    plan = wgrad_plan(b, d, h, w, ci, co)
    dw = torch.empty((27, ci, co), dtype=torch.float32, device=x.device)
    part = (torch.empty((plan.chunks, 27, ci, co), dtype=torch.float32,
                        device=x.device) if plan.chunks > 1 else None)
    vec_x = ci % 8 == 0 and x.data_ptr() % 16 == 0
    vec_g = co % 8 == 0 and g.data_ptr() % 16 == 0
    err = _fn()(_build.ptr(x), _build.ptr(g), _build.ptr(scale),
                _build.ptr(shift), slope, _build.ptr(part), _build.ptr(dw),
                b, d, h, w, ci, co, plan.ci_tile, plan.co_tile, *plan.grid,
                plan.chunks, int(vec_x), int(vec_g), _build.stream())
    _build.check(err, "conv3d_wgrad")
    conv3d_wgrad.launches += 1
    return dw


conv3d_wgrad.launches = 0
