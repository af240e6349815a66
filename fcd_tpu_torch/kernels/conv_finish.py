"""The finishing pass of B1's row-parallel split.

Stands beside `fcd_tpu/kernels/block_conv.py::_fused8_call` (B1): where
tensor parallelism (`parallel/tp.py`) splits a 3x3x3 conv over the ranks'
input channels, each rank runs B1's partial instance
(`block_conv.conv3x3_partial`), the ranks' f32 partials are summed, and
this pass does what B1's epilogue does on one device: it rounds the sum to
the activation dtype and takes the per-(b, c) f32 sum and sum of squares
of the unrounded values (ROADMAP C3's rounding points). The CUDA kernel is
`fcd_tpu_torch/csrc/conv_finish.cu`; its header says what bounds it and
why it has two plans.

`conv_finish(s, dtype)` takes the plain version for a CPU tensor; a CUDA
tensor launches the kernel (f32 in, bf16 out) or raises. `finish_plan`
(pure Python) picks the plan: one launch, the blocks of a batch item one
thread-block cluster, up to ONE_LAUNCH elements a batch item; above it a
grid of about TARGET_BLOCKS blocks and a second kernel that adds their
rows in order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from fcd_tpu_torch.kernels import _build

REPLACES = "fcd_tpu/kernels/block_conv.py:909"  # B1's epilogue, split off
VEC = 4                  # channels a thread: one float4
THREADS = 512            # a block of the streaming kernel
CHUNK_BYTES = 16384      # a bulk copy, at most (the source's CHUNK)
MAX_C = 1024
MAX_CLUSTER = 16         # the largest (non-portable) cluster on an H100
TARGET_BLOCKS = 132      # two launches: one block on each of the H100's SMs
# one launch up to level 4 at fs16 (16^3 x 64 = 2^18 elements, 1 MB): a
# cluster's blocks share one GPC, and above it two launches over the whole
# card are faster (the source's header)
ONE_LAUNCH = 2 ** 18
# the input bytes a block of the one-launch cluster takes, at least
CLUSTER_BYTES = 2 * CHUNK_BYTES


class FinishPlan(NamedTuple):
    rows: int      # voxels a block
    runs: int      # blocks a batch item
    cluster: int   # the one launch's cluster (== runs), or 0: two launches


def conv_finish_plain(s: torch.Tensor, dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s rounded to dtype, per-(b, c) sum, sum of squares) of an f32
    (B, D, H, W, C) sum."""
    s = s.float()
    return (s.to(dtype).contiguous(), s.sum(dim=(1, 2, 3)),
            s.square().sum(dim=(1, 2, 3)))


def finish_plan(b: int, nvox: int, c: int, one_launch: Optional[bool] = None,
                cluster: Optional[int] = None, blocks: Optional[int] = None,
                max_cluster: int = MAX_CLUSTER) -> FinishPlan:
    """The kernel's grid for a (b, nvox, c) sum. One launch (by default
    where nvox * c <= ONE_LAUNCH): `cluster` blocks a batch item (by
    default one a CLUSTER_BYTES of input, at most max_cluster and nvox),
    each taking an equal run of voxels. Two launches: enough runs a batch
    item for about `blocks` (TARGET_BLOCKS) blocks, at most one a voxel."""
    if c % VEC or not 0 < c <= MAX_C:
        raise ValueError(f"conv_finish takes C a multiple of {VEC} up to "
                         f"{MAX_C}, got {c}")
    if one_launch is None:
        one_launch = nvox * c <= ONE_LAUNCH
    if one_launch:
        if cluster is None:
            cluster = min(max_cluster, nvox,
                          -(-nvox * c * 4 // CLUSTER_BYTES))
        if not 0 < cluster <= MAX_CLUSTER:
            raise ValueError(f"a cluster of 1-{MAX_CLUSTER} blocks, got "
                             f"{cluster}")
        return FinishPlan(-(-nvox // cluster), cluster, cluster)
    runs = max(1, min(nvox, -(-(blocks or TARGET_BLOCKS) // b)))
    rows = -(-nvox // runs)
    return FinishPlan(rows, -(-nvox // rows), 0)


_FN = {}


def _fn(name: str):
    if name not in _FN:
        fn = getattr(_build.load("conv_finish"), name)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 5 + [ci] * 6 + [vp] if name == "fcd_conv_finish"
                       else [ci])
        fn.restype = ci
        _FN[name] = fn
    return _FN[name]


_LIMIT = {}


def cluster_limit(device: torch.device) -> int:
    """The largest cluster the one-launch plan takes on `device`:
    MAX_CLUSTER where the card can place such a cluster of the kernel's
    blocks (cudaOccupancyMaxActiveClusters), else the portable 8."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    if key not in _LIMIT:
        with torch.cuda.device(key):
            n = _fn("fcd_conv_finish_max_clusters")(MAX_CLUSTER)
        if n < 0:
            _build.check(-n, "conv_finish cluster query")
        _LIMIT[key] = MAX_CLUSTER if n > 0 else 8
    return _LIMIT[key]


def conv_finish(s: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                plan: Optional[FinishPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The finishing pass on an f32 (B, D, H, W, C) sum: the plain version
    for a CPU tensor, the CUDA kernel (bf16 out) for a CUDA one, under
    `plan` (`finish_plan`'s by default)."""
    if s.dim() != 5:
        raise ValueError(f"the sum must be (B, D, H, W, C), got "
                         f"{tuple(s.shape)}")
    if s.device.type == "cpu":
        return conv_finish_plain(s, dtype)
    if s.device.type != "cuda":
        raise ValueError(f"conv_finish: unsupported device {s.device}")
    if s.dtype != torch.float32 or dtype != torch.bfloat16:
        raise TypeError(f"conv_finish kernel takes an f32 sum to bf16, got "
                        f"{s.dtype} to {dtype}" + _build.BF16_ONLY)
    if not s.is_contiguous() or s.data_ptr() % 16:
        raise ValueError("conv_finish kernel takes a contiguous, 16-byte "
                         "aligned sum")
    b, c = s.shape[0], s.shape[-1]
    nvox = s.shape[1] * s.shape[2] * s.shape[3]
    if c % VEC or c > MAX_C or nvox >= 2 ** 31:
        raise ValueError(f"conv_finish kernel takes C a multiple of {VEC} "
                         f"up to {MAX_C} and under 2^31 voxels, got "
                         f"{tuple(s.shape)}")
    if plan is None:
        plan = finish_plan(b, nvox, c, max_cluster=cluster_limit(s.device))
    y = torch.empty(s.shape, dtype=torch.bfloat16, device=s.device)
    tot = torch.empty((2, b, c), dtype=torch.float32, device=s.device)
    part = (None if plan.cluster else
            torch.empty((2, plan.runs, b, c), dtype=torch.float32,
                        device=s.device))
    err = _fn("fcd_conv_finish")(
        _build.ptr(s), _build.ptr(y), _build.ptr(tot[0]), _build.ptr(tot[1]),
        _build.ptr(part), b, nvox, c, plan.rows, plan.runs, plan.cluster,
        _build.stream())
    _build.check(err, "conv_finish")
    conv_finish.launches += 1
    return y, tot[0], tot[1]


conv_finish.launches = 0
