#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (`fcd_tpu_torch`), one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch device name) and
   builds the CUDA kernels from `fcd_tpu_torch/csrc/` into `build/`, one
   nvcc per source, all at once.
2. Holds every kernel of the main path against its plain PyTorch version on
   the card, in bf16, at the main path's shapes, and times kernel, plain
   version and (where one exists) the library call with CUDA events after
   a warm-up, beside the bound max(operations / 989e12, bytes / 3.35e12).
   B1 (conv3d), K1 (conv3d_wgrad), B4 (upsample2x, at the five decoders'
   shapes at batch 1 and the two largest at batch 4) and their library
   calls (cuDNN) are timed by the device time of every kernel, copy and
   fill one call launches (torch.profiler: for B1 the weight packing and
   the statistics' sum with the conv, for K1 its second pass), with each
   call's wall time per call beside it, and so are sw_exit and `acc * inv`;
   their build reports give each instance's registers and spills and the
   library's HGMMA (B1) or HMMA (K1, B4, B5, K3/K4) count (0 fails). K1,
   K2, K4, B4 and B5 must give the same bits from two calls. K2 runs as
   the train step calls it (one Finale.backward, which must launch its two
   kernels and nothing else) at six of the step's 23 calls, its d_ys and
   d_rs bit-equal to the plain version's, timed by the device time of all
   one call launches; its build report counts 16-byte loads. B5 runs at
   the four DSA levels and at the widths of feature size 8 (level 3) and
   feature size 32 with project size 128 (levels 3-6): phase A's sums,
   its finishing pass (phase B's operands), phase B and the whole op
   against their plain versions and
   the f32 reference, each phase timed by the device time of all one
   main-path call launches, and one dsa_attention call must launch exactly
   its three kernels. K3 and K4 run at the same four levels at the train
   step's batch 4 with dropout 0.1, timed alike (SDPA and its backward
   too); one K3 call must launch one kernel, one K4 call its two. B2 and
   the gated paths' kernels (B3, B9, B15) are timed alike; B9 runs at the
   gated train step's two calls, bit-equal, on tied and random inputs.
3. Drives the inference path: ModelTrainer(default params, device="cuda")
   .inference on a seeded 182x218x182x2 volume (8 patches of 128^3, fs16
   MS_DSA_NET), with every launch counter set to 0 just before and read
   just after, and holds one patch's logits against the port's own fp32
   forward on the CPU.
4. Drives the training path: ModelTrainer(DiceCELoss, device="cuda")
   .train_step on a seeded 4x128^3x2 batch (the JAX package's train
   benchmark, bench.py:82-150): one warm-up step, then timed steps with
   the counters set to 0 just before and read just after (they must equal
   the per-step counts derived from the model), finite losses; then one
   step at batch 1 x 64^3 (full widths) held against the port's fp32 CPU
   step from the same weights; whether two such steps from one state give
   bit-equal parameters (reported); then a profile of one train step with
   K1's, B4's, K3's, K4's and K2's shares of its device time. Then the
   source paper's total-variation regularised training (tv_loss_weight
   0.1, as README's example, with the border band excluded) at 4x128^3,
   its launch counts read as the default path's, and ms/step of the
   default, the gated (below) and the TV path measured in turns.
5. Drives the segmentation CLI: writes a seeded synthetic subject (T1,
   FLAIR and a lesion label, NIfTI, on a 176x240x256 grid at (1.0, 0.9375,
   0.9375) mm with an LAS affine) and the seeded fs16 model's weights as a
   checkpoint in the JAX package's format under build/, then runs
   fcd_tpu_torch.cli.infer.run_inference on the card (RAS, 1 mm
   resampling to 176x225x240, 18 patches of 128^3, softmax, inverse
   resampling, post-processing, native-space save, Dice/IoU), with the
   counters set to 0 just before and read just after; checks the saved
   mask, holds the logits bit for bit against a direct
   ModelTrainer.inference of the same preprocessed array, and prints the
   seconds per phase.
6. Drives the JAX package's kernel-choosing gates (`params['perf_flags']`,
   fcd_tpu_torch/flags.py) through the same entry points, from the same
   weights: with the levels-1-2 pool in a pass of its own
   (FCD_FINALE_POOL=0, FCD_FINALE_TRAIN=0) the inference's logits bit for
   bit against the default run's, and a train step at 4x128^3 plus the
   1x64^3 check against the fp32 CPU step; with FCD_FUSED_HEAD=1 the
   inference's logits against the default run's (the fused head rounds
   once). Each with its launch counts (B3, B9, B15), and ms/volume and
   ms/step timed in turns against the default path on the same card.
   The 1x64^3 check against the fp32 CPU step then runs three more times:
   with the TV term, with GeneralizedDiceFocalLoss plus the boundary term,
   and with gradient_accumulation_steps 2 over two micro-steps. Later
   phases run the default gates.
7. Holds the train batch's augmentation (data/augment.py::apply_augment,
   PyTorch on the card) at 4x128^3x2 against the same function on the
   CPU, on the same draws and noise with every transform on: bit-equal
   without the rotation; with it the image within 1e-5 and the labels
   equal; timed by device time beside its bytes bound.
8. Drives the training CLI (`python -m fcd_tpu_torch.cli.train`, through
   cli.train.main) at the default model's full width on a seeded
   synthetic set written under build/ (3 train, 1 val, 1 test subject,
   160x192x160 at 1 mm RAS, 8 patches a volume): 2 epochs of 4x128^3
   steps with augmentation (every transform in the second), validation,
   best and latest checkpoints, the CSV, the test without and with
   post-processing; the counters set to 0 just before and read just
   after, split by phase and held to the per-step and per-volume counts;
   seconds per epoch and phase and the test metrics printed; then a
   resume to 3 epochs. `--emission_tracking` is on: the run's
   train_emission.csv must hold the JAX package's columns and the card's
   power limit as its envelope.
9. Drives SegResNet_DSA (fs16, P 64, 4 heads, 'parallel', pixelshuffle,
   bf16; B1, K1, B2, K2, B5, K3/K4) through the same entry points:
   ModelTrainer.inference on the seeded volume (launches per patch and
   per volume), one patch against the fp32 CPU forward, the 4x128^3 train
   step (launches per step, finite losses), a profile of a patch and of a
   step, a 1x64^3 step against the fp32 CPU step (the loss within 1e-3),
   and cli.train for two epochs (finite losses, the CSV).
10. Drives, each as one 128^3 patch forward against the fp32 CPU one and
   one 4x128^3 train step with its launches held to the model's counts:
   segresnet_deeper (level 4 at C 256, P 64: K3/K4's wide instances),
   MS_DSA_NET with sa_type 'serial' and 'channel', MS_DSA_NET_PS, BaseUNet
   and SegResNetVAE_DSA (its VAE loss finite). B5 in 'serial', 'spatial'
   and 'channel' and K3/K4 at C15's widths are held to their plain
   versions among the kernel phases (1.).
11. Drives `use_amp=False` (ROADMAP C18): a trainer built so turns TF32
   off (an f32-route conv against an f64 conv within 1e-5); MS_DSA_NET's
   inference on the seeded volume through the JAX package's f32 route
   (launches per patch: B5's f32 instances, 12 a phase, and nothing else;
   no sw_entry), one patch against the CPU's f32 route at rel 1e-4, the
   4x128^3 step (K3/K4's f32 instances, 12 each; peak memory), profiles
   of a patch and a step, and a 1x64^3 step against the CPU's f32 step
   (the loss within 1e-4, each module's gradient within max(1e-2, twice
   its movement under a 1e-5 input change), C10's rule). B5's and
   K3/K4's f32 instances are held to their plain versions at rel 1e-5
   at the four levels among the kernel phases (1.); both multiply on the
   tensor cores as 3xTF32, so the SASS of B5's f32 phase A and phase B
   kernels and of K3/K4's wide kernels must hold HMMA (f32_sass_report),
   and their bounds are taken at 3xTF32's rate (PEAK_3XTF32).
12. Drives UNETR++ (fs16, bf16): inference on the seeded volume (B1 46,
   B2 23, B5 21 a phase per patch; batch norms calibrated first), one
   patch against the fp32 CPU forward, the 4x128^3 step (B1 91, K1 46,
   B2 23, K2 23, K3 21, K4 21) and its profile; then with use_amp=False
   one patch forward (B5 f32 21 a phase) against the CPU's f32 route.
13. Drives the rest of the model zoo (ROADMAP A7), each model through
   the factory at full width (bf16): UNet and VNet (no kernel on their
   path; VNet's batch norms calibrated first) and UNETR and SwinUNETR
   (res blocks on B1 and B2, up blocks on B4; K1 and K2 in training): one
   128^3 patch forward against the fp32 CPU forward, a 4x128^3 train step
   (finite loss, peak memory), both with their launches held to the
   model's counts (`a7_counts`) and profiled (whole traces), and a 1x64^3
   step against the fp32 CPU step (the loss within 1e-3, or within twice
   the port's bf16 CPU step's distance where bf16 itself lies further,
   as UNETR's does); UNETR's and
   SwinUNETR's patch forwards also through the f32 route (against the
   CPU's f32 route) and the f16 route (against the fp32 CPU forward),
   both launching no kernel. The kernel phases (1.) hold B1, B2, B4, K1
   and K2 at these models' new widths (`zoo_width_phases`: SwinUNETR's
   C 24-384 and B4 384 -> 192, UNETR's B4 768 -> 128).
14. Drives the data mesh (`parallel/`, `mesh_run`, after the training CLI):
   two ranks on the card over gloo (NCCL refuses two ranks on one GPU),
   each with the launch counters set to 0 just before and read just after
   its sharded `ModelTrainer.inference` of the 182x218x182x2 volume (its 4
   patches' counts) and its data-parallel step at a global 4 x 128^3
   (one step's counts); each rank's patch logits bit-equal to the
   single-rank engine's, the volume within rel 1e-6 (argmax >= 0.99999),
   the DP step's loss within rel 1e-5 of the single-rank step's and its
   gradients by train_check's group rule against a nudged single-rank
   step, two DP steps bit-equal; then rank 0 alone over NCCL, every result
   bit-equal to the single-rank path. `python3 chip_smoke.py --mesh` runs
   this phase alone (no result line).
15. Drives the model axis (`parallel/tp.py`, `tp_run`, after the mesh):
   two gloo ranks on the card as a (1, 2) ("data", "model") mesh, the
   default MS_DSA_NET (fs16, P 64, bf16, the kernel route) sharded by the
   Megatron pairing. Each rank's TP eval forward of one 128^3 patch
   against the one-card forward (the patch tolerances), and one TP train
   step at 1 x 128^3 against the one-card step (the loss within 1e-3, the
   gathered gradients by the group rule against a nudged one-card step),
   each with the counters set to 0 just before and read just after (B1's
   partial instance and the finishing pass at the 35 row-parallel convs,
   B1 at the rest); every parameter the same bits on both ranks after the
   step; ms/patch and ms/step of a second call printed. B1's partial
   instance and the finishing pass are held to their plain versions, and
   B1, K1, B4 at the shard widths, among the kernel phases (1.;
   `tp_width_phases`). `python3 chip_smoke.py --tp` runs this phase alone.
16. Counts the default model's forward FLOPs at its patch
   (`utils/profiling.py::get_model_flops`, on the CPU) and prints a
   StepTimer's ms and MFU over patch forwards on the card.
17. Prints the seconds from start to the result, the `kernels` JSON line,
   the card line, and last {"ok": true, "device": {...}}.

Any failed phase exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --kernels upsample2x,sw_exit
    python3 chip_smoke.py --kernels dsa_phase_a,dsa_phase_b
    python3 chip_smoke.py --kernels spatial_attn_fwd,spatial_attn_bwd
    python3 chip_smoke.py --kernels finale_bwd,sw_entry
    python3 chip_smoke.py --kernels max_pool2x_bwd
    python3 chip_smoke.py --kernels dsa_phase_a_f32,spatial_attn_fwd_f32
    python3 chip_smoke.py --kernels zoo_widths
    python3 chip_smoke.py --kernels tp_widths

builds the kernels and runs only the named kernels' phases (checks and
times; no main path and no result line); `--mesh` the mesh phase alone,
`--tp` the TP phase alone.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import os
import subprocess
import sys
import time

PEAK_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
# H100 SXM dense TF32 tensor-core rate over the three products 3xTF32
# takes for one f32 product (hi.hi + hi.lo + lo.hi): the f32 rate of the
# kernels that multiply f32 on the tensor cores
PEAK_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def timed_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls after one warm-up call (CUDA
    events; the host clock on a CPU tensor run)."""
    import torch

    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def device_times(fn, iters: int) -> dict:
    """Mean device ms per call of each kernel, copy and fill that `fn`
    launches, by name, over `iters` calls after a warm-up call
    (torch.profiler). Where a call's host work outlasts its device work,
    CUDA events around back-to-back calls time the host; this times the
    card. On a CPU run: {"host": the host clock per call}."""
    import torch

    from fcd_tpu_torch.kernels._sweep import whole_trace

    if not torch.cuda.is_available():
        return {"host": timed_ms(fn, iters)}
    fn()
    torch.cuda.synchronize()
    out = {}
    for e in whole_trace(fn, iters)[0]:
        out[e.name] = (out.get(e.name, 0.0)
                       + e.time_range.elapsed_us() / iters / 1e3)
    return out


def time_on_device(ph, call, key: str, iters: int) -> None:
    """ph.ms: the device time of all one call of `call` launches (whole
    traces), ph.kernel_ms: that of the kernels named like `key`, ph.call_ms:
    the wall per call. Fails where the card ran no such kernel."""
    import torch

    times = device_times(call, iters)
    ph.ms = sum(times.values())
    ph.kernel_ms = sum(v for k, v in times.items() if key in k or k == "host")
    if torch.cuda.is_available() and ph.kernel_ms == 0:
        raise AssertionError(f"{ph.kernel} {ph.label}: the profiler saw no "
                             f"{key} on the card")
    ph.call_ms = timed_ms(call, iters)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def rel_err(got, want) -> tuple:
    """(max |got - want|, that over max |want|), in f64."""
    g, w = got.double(), want.double()
    abs_err = float((g - w).abs().max())
    return abs_err, abs_err / max(float(w.abs().max()), 1e-30)


class Phase:
    """One kernel at one main-path shape: error against its plain version,
    times, and the bound."""

    def __init__(self, kernel, label, flops, nbytes, peak=PEAK_FLOPS):
        self.kernel, self.label = kernel, label
        self.flops, self.bytes = float(flops), float(nbytes)
        self.peak = peak   # the operations' rate: bf16 tensor cores, or f32
        self.abs_err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        # where `ms` and `library_ms` are device times: each call's wall
        # time, and the share of `ms` in the kernel itself
        self.call_ms = self.library_call_ms = self.kernel_ms = None

    @property
    def bound_ms(self) -> float:
        return max(self.flops / self.peak, self.bytes / PEAK_BYTES) * 1e3

    @property
    def bound_by(self) -> str:
        return ("operations" if self.flops / self.peak >= self.bytes / PEAK_BYTES
                else "bytes")

    def check_equal(self, name, got, want):
        """Bit-equal (the kernels whose plain version does the same
        arithmetic)."""
        a, _ = rel_err(got, want)
        self.abs_err = max(self.abs_err, a)
        ok = got.dtype == want.dtype and torch_equal(got, want)
        print(f"  {self.kernel} {self.label} {name}: max_abs_err {a:.3e}, "
              f"bit-equal {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{self.kernel} {self.label} {name}: not "
                                 "bit-equal to the plain version")

    def check(self, name, got, want, tol):
        a, r = rel_err(got, want)
        self.abs_err = max(self.abs_err, a)
        ok = r <= tol
        print(f"  {self.kernel} {self.label} {name}: max_abs_err {a:.3e} "
              f"rel {r:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{self.kernel} {self.label} {name}: rel "
                                 f"{r:.3e} > {tol:g}")

    def report(self):
        lib = ("n/a" if self.library_ms is None
               else f"{self.library_ms:.4f} ms")
        share = self.bound_ms / self.ms if self.ms > 0 else 0.0
        call = ""
        if self.call_ms is not None:
            call = (f" device ({self.kernel_ms:.4f} in the kernel; wall "
                    f"{self.call_ms:.4f} per call)")
            lib += (f" device (wall {self.library_call_ms:.4f} per call)"
                    if self.library_call_ms is not None else "")
        print(f"  {self.kernel} {self.label}: kernel {self.ms:.4f} ms{call}, "
              f"plain {self.plain_ms:.4f} ms, library {lib}, bound "
              f"{self.bound_ms:.4f} ms ({self.bound_by}), roofline share "
              f"{100 * share:.2f}%", flush=True)


_SASS = {}


def sass_of(lib: str) -> str:
    """The SASS of library `lib` (cuobjdump -sass), dumped once a run."""
    from fcd_tpu_torch.kernels import _build

    if lib not in _SASS:
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
        path = _build.build_all([lib])[lib]
        sass = subprocess.run([cuobjdump, "-sass", str(path)],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            raise AssertionError(f"cuobjdump failed: {sass.stderr.strip()}")
        _SASS[lib] = sass.stdout
    return _SASS[lib]


def dump_sass(libs) -> None:
    """sass_of for every library of `libs` at once, one cuobjdump each."""
    from concurrent.futures import ThreadPoolExecutor

    libs = [lib for lib in dict.fromkeys(libs) if lib not in _SASS]
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        for lib, text in zip(libs, pool.map(sass_of, libs)):
            _SASS[lib] = text


def build_report(name, kernels, args, instr) -> int:
    """One CUDA library's build on the card: each instance of `kernels`
    (one name or several; template arguments named `args`), with its
    registers, shared memory and spills (nvcc -Xptxas -v, kept beside the
    library), and the count of `instr` instructions in the library's SASS.
    Fails if that count is 0: the kernel must multiply on the tensor cores
    (HGMMA, HMMA), or, with no products, move 16 or 8 bytes a load
    (LDG.E.128, LDG.E.64)."""
    import re

    from fcd_tpu_torch.kernels import _build

    kernels = (kernels,) if isinstance(kernels, str) else kernels
    shown = None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            vals = re.findall(r"L[ib](\d+)E", m.group(1))
            kernel = next((k for k in kernels if k in m.group(1)), None)
            shown = (f"{kernel}<" + ", ".join(
                f"{a}={v}" for a, v in zip(args, vals)) + ">"
                if kernel else m.group(1))
        elif shown and ("spill" in line or "Used" in line
                        or "arning" in line):
            print(f"  ptxas {shown}: {line.strip()}")
    n = sum(bool(re.search(rf"\b{instr}\b", line))
            for line in sass_of(name).splitlines())
    print(f"{name} library: {n} {instr} instructions in its SASS "
          f"{'ok' if n else 'FAIL'}", flush=True)
    if n == 0:
        raise AssertionError(f"{name} has no {instr} instruction")
    return n


# -- kernel phases ------------------------------------------------------------

def _randn(shape, gen, dev, scale=1.0, dtype=None):
    import torch

    t = torch.randn(shape, generator=gen, device=dev) * scale
    return t if dtype is None else t.to(dtype)


def conv_phase(label, dev, gen, grid, parts_c, cout, *, prologue=False,
               shortcut=False, iters=20):
    """B1 at one shape: parts_c input widths summed into cout outputs.
    `ms` and `library_ms` are the device time of all that one conv3x3 and
    one cuDNN call launch (the packing of the weights and the statistics'
    sum included); at the small grids a call's host work (packing,
    allocating, the ctypes call) outlasts that, and `call_ms` and
    `library_call_ms` time each call's wall."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels.block_conv import conv3x3, conv3x3_plain

    bf = torch.bfloat16
    nvox = grid[0] * grid[1] * grid[2]
    parts = [_randn((1, *grid, c), gen, dev, dtype=bf) for c in parts_c]
    std = (2.0 / (27 * cout)) ** 0.5
    ws = [_randn((3, 3, 3, c, cout), gen, dev, std, bf) for c in parts_c]
    wr = ([_randn((c, cout), gen, dev, (2.0 / cout) ** 0.5, bf)
           for c in parts_c] if shortcut else None)
    pro = None
    if prologue:
        c0 = parts_c[0]
        pro = (torch.rand((1, c0), generator=gen, device=dev) + 0.5,
               _randn((1, c0), gen, dev, 0.1), 0.01)
    kw = dict(shortcut=wr, prologue=pro, want_stats=True)
    cin = sum(parts_c)
    flops = 2 * nvox * 27 * cin * cout + (2 * nvox * cin * cout if shortcut else 0)
    nbytes = 2 * nvox * cin + 2 * 27 * cin * cout + 2 * nvox * cout \
        + ((2 * cin * cout + 2 * nvox * cout) if shortcut else 0)
    ph = Phase("conv3d", label, flops, nbytes)
    got = conv3x3(parts, ws, **kw)
    want = conv3x3_plain(parts, ws, **kw)
    ph.check("y", got.y, want.y, 2e-2)
    ph.check("y stats", torch.stack([got.ysum, got.ysq]),
             torch.stack([want.ysum, want.ysq]), 1e-3)
    if shortcut:
        ph.check("r", got.r, want.r, 2e-2)
        ph.check("r stats", torch.stack([got.rsum, got.rsq]),
                 torch.stack([want.rsum, want.rsq]), 1e-3)
    def call():
        return conv3x3(parts, ws, **kw)

    times = device_times(call, iters)
    ph.ms = sum(times.values())
    ph.kernel_ms = sum(v for k, v in times.items()
                       if "conv3d_kernel" in k or k == "host")
    if ph.kernel_ms == 0:
        raise AssertionError(f"conv3d {label}: the profiler saw no "
                             "conv3d_kernel on the card")
    ph.call_ms = timed_ms(call, iters)
    ph.plain_ms = timed_ms(lambda: conv3x3_plain(parts, ws, **kw), 2)
    # library yardstick, timed only: cuDNN bf16 conv of the concatenated input
    xin = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
    wlib = torch.cat(ws, dim=3).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)

    def library():
        return F.conv3d(xin, wlib, padding=1)

    ph.library_ms = sum(device_times(library, iters).values())
    ph.library_call_ms = timed_ms(library, iters)
    ph.report()
    return ph


def finale_phase(label, dev, gen, grid, c, iters=10, pool=True):
    """B2 at one shape, with the pool (or without it, as the UNETR blocks
    call it), timed by the device time of one call."""
    import torch

    from fcd_tpu_torch.kernels.pool import finale_pool, finale_pool_plain

    bf = torch.bfloat16
    nvox = grid[0] * grid[1] * grid[2]
    y2 = _randn((1, *grid, c), gen, dev, dtype=bf)
    r = _randn((1, *grid, c), gen, dev, dtype=bf)
    aff = [_randn((1, c), gen, dev) for _ in range(4)]
    ph = Phase("finale_pool", label, 8 * nvox * c,
               3 * 2 * nvox * c + (2 * nvox * c // 8 if pool else 0)
               + 16 * c)
    got = finale_pool(y2, r, *aff, 0.01, pool=pool)
    want = finale_pool_plain(y2, r, *aff, 0.01, pool=pool)
    for name, g_, w_ in zip(("out", "pooled"), got if pool else (got,),
                            want if pool else (want,)):
        ph.check(name, g_, w_, 1e-2)
    time_on_device(ph, lambda: finale_pool(y2, r, *aff, 0.01, pool=pool),
                   "finale_kernel", iters)
    ph.plain_ms = timed_ms(
        lambda: finale_pool_plain(y2, r, *aff, 0.01, pool=pool), iters)
    ph.report()
    return ph


def upsample_phase(label, dev, gen, batch, grid, ci, co, iters=20):
    """B4 at one decoder's shape (batch, coarse grid, ci -> co), with the
    model's f32 kernel and no bias, as the decoders call it. `ms` and
    `library_ms` are the device time of all that one call and one
    F.conv_transpose3d launch, the kernel alone and each call's wall
    beside them."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels.upsample import (
        upsample2x,
        upsample2x_plain,
        upsample_plan,
    )

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    x = _randn((batch, *grid, ci), gen, dev, dtype=bf)
    k = _randn((2, 2, 2, ci, co), gen, dev, (2.0 / (8 * co)) ** 0.5)
    ph = Phase("upsample2x", label, 2 * nvox * ci * 8 * co,
               2 * nvox * ci + 4 * 8 * ci * co + 2 * 8 * nvox * co)
    plan = upsample_plan(batch, *grid, ci, co)
    print(f"  upsample2x {label}: tile {plan.bm}x{plan.bn}, {plan.blocks} "
          "blocks")
    got = upsample2x(x, k)
    ph.check("out", got, upsample2x_plain(x, k), 2e-2)
    check_repeatable(ph, [got], [upsample2x(x, k)])

    def call():
        return upsample2x(x, k)

    times = device_times(call, iters)
    ph.ms = sum(times.values())
    ph.kernel_ms = sum(v for n, v in times.items()
                       if "upsample_kernel" in n or n == "host")
    if ph.kernel_ms == 0:
        raise AssertionError(f"upsample2x {label}: the profiler saw no "
                             "upsample_kernel on the card")
    ph.call_ms = timed_ms(call, iters)
    ph.plain_ms = timed_ms(lambda: upsample2x_plain(x, k), iters)
    # library yardstick, timed only: cuDNN's bf16 transposed conv
    xin = x.permute(0, 4, 1, 2, 3)
    wlib = torch.flip(k.to(bf), dims=(0, 1, 2)).permute(3, 4, 0, 1, 2) \
        .contiguous(memory_format=torch.channels_last_3d)

    def library():
        return F.conv_transpose3d(xin, wlib, stride=2)

    ph.library_ms = sum(device_times(library, iters).values())
    ph.library_call_ms = timed_ms(library, iters)
    ph.report()
    return ph


# the five decoders' upsamples of a 128^3 patch (coarse grid, ci, co), fs16
DECODERS = (("dec5", 4, 256, 128), ("dec4", 8, 128, 64), ("dec3", 16, 64, 32),
            ("dec2", 32, 32, 32), ("dec1", 64, 32, 16))


def upsample_phases(dev, gen, small=False):
    """B4 at every decoder's shape at batch 1 (a patch forward), and the
    train step's two largest at batch 4."""
    cut = (lambda g: max(2, g // 16)) if small else (lambda g: g)
    out = []
    for batch in (1, 4):
        for name, g, ci, co in DECODERS:
            if batch == 4 and name not in ("dec2", "dec1"):
                continue
            out.append(upsample_phase(
                f"{name} {batch}x{g}^3x{ci}->{2 * g}^3x{co}", dev, gen,
                batch, (cut(g),) * 3, ci, co))
    return out


def dsa_work(n, c, p, h, es, sa_type="parallel"):
    """(operations, bytes) of B5's phase A and of its phase B at one
    shape, tokens of `es` bytes: per sa_type, phase A projects the slots
    it stages (q, k and v_sa; 'channel' no v_sa), takes each head's
    CH x CH block of q^T k (2 n C CH in all) and the EF products, and
    writes q^T k (h x CH x CH values), q2, k2, kp and vp; phase B reads
    abig (h x CH x CH) and does the products its type has: the channel
    attention ('parallel', 'channel'; 'serial' on the spatial output) and
    the scores and s vp^T (all but 'channel')."""
    ch = c // h
    na = 3 if p else 2
    ca = sa_type != "spatial"
    flops_a = 2 * n * c * c * na + 2 * n * c * ch + 2 * 2 * n * c * p
    bytes_a = es * n * c + 4 * n * c + es * n * p + na * es * c * c \
        + 8 * c + 4 * (c * ch + 2 * c + 2 * c * p)
    flops_b = 2 * n * c * c * 2 + 2 * n * c * ch * ca + 2 * 2 * n * c * p
    bytes_b = es * n * c + 4 * n * c + 2 * es * c * c + 4 * c \
        + es * c * ch + 2 * es * c * p + 12 * c + es * n * c
    return flops_a, bytes_a, flops_b, bytes_b


def dsa_phase(label, dev, gen, n, c, p, h=4, iters=10, sa_type="parallel",
              dtype=None):
    """B5 at one level's shape in one sa_type, batch 1, with the model's
    f32 weights and EF (none, and P = 0, for 'channel'): phase A's sums
    and, with the temperatures, the finishing pass's phase-B operands
    against the plain versions, phase B against its plain version, the
    whole op against the f32 einsum reference, each of them twice
    bit-equal; on the card, one dsa_attention call is exactly the three B5
    kernels. `ms` is the device time of all one main-path call of the
    phase launches (phase A with its finishing pass), the kernels alone
    and the wall per call beside it. dtype torch.float32: the f32
    instances (C18) on f32 tokens, held at F32_REL, their bound at
    3xTF32's rate (PEAK_3XTF32); torch.float16: the f16 instances (C20,
    libdsa_f16), held as the bf16 ones."""
    import torch

    from fcd_tpu_torch.kernels import dsa_attention as dk

    bf = torch.bfloat16 if dtype is None else dtype
    f32 = bf == torch.float32
    tol, tol_whole = (F32_REL, F32_REL) if f32 else (2e-2, 5e-2)
    sfx, es = {torch.float32: ("_f32", 4), torch.float16: ("_f16", 2)}.get(
        bf, ("", 2))
    names = DSA_F32_KERNELS if f32 else DSA_KERNELS
    ns = dk.num_slots(sa_type)
    if sa_type == "channel":
        p = 0
    x = _randn((1, n, c), gen, dev, dtype=bf)
    w = _randn((c, ns * c), gen, dev, (6.0 / ((ns + 1) * c)) ** 0.5)
    ef = (None if p == 0 else
          (torch.rand((n, p), generator=gen, device=dev) * 2 - 1) / p ** 0.5)
    t1 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
    t2 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
    tok = (1.0 + _randn((c,), gen, dev, 0.1), _randn((c,), gen, dev, 0.1),
           _randn((n, c), gen, dev, 0.1))
    gamma = _randn((c,), gen, dev)
    temps = (t1, t2)
    flops_a, bytes_a, flops_b, bytes_b = dsa_work(n, c, p, h, es, sa_type)
    peak = PEAK_3XTF32 if f32 else PEAK_FLOPS
    pa = Phase("dsa_phase_a" + sfx, label, flops_a, bytes_a, peak)
    pb = Phase("dsa_phase_b" + sfx, label, flops_b, bytes_b, peak)
    plan = (dk.dsa_plan_f32 if f32 else dk.dsa_plan)(n, c, p, h)
    print(f"  dsa {label}: tile {plan.tile}, phase A {plan.a_blocks} blocks "
          f"({plan.chunks} chunks of {plan.per_chunk} tiles a head, "
          f"{plan.groups} column group(s)), phase B "
          f"{plan.b_blocks} blocks, shared memory {plan.smem_a} / "
          f"{plan.smem_b} bytes")
    mode = dict(sa_type=sa_type)

    def phase_a():
        return dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps, **mode)

    ka = dk.dsa_phase_a(x, w, ef, *tok, h, **mode)
    wa = dk.dsa_phase_a_plain(x, w, ef, *tok, h, **mode)
    for name, g_, w_ in zip(ka._fields, ka, wa):
        if g_.numel():
            pa.check(name, g_, w_, tol)
    check_repeatable(pa, ka, dk.dsa_phase_a(x, w, ef, *tok, h, **mode))
    ops = phase_a()
    for name, g_, w_ in zip(ops._fields, ops, dk.dsa_glue(wa, t1, t2, h, bf)):
        if g_.numel():
            pa.check(f"finishing pass {name}", g_, w_, tol)
    check_repeatable(pa, ops, phase_a())

    def phase_b():
        return dk.dsa_phase_b(x, w, *ops, gamma, *tok, h, **mode)

    kb = phase_b()
    pb.check("out", kb, dk.dsa_phase_b_plain(x, w, *ops, gamma, *tok, h,
                                             **mode), tol)
    check_repeatable(pb, [kb], [phase_b()])
    # the whole op against the f32 einsum math; bf16 rounding of the
    # kernels' intermediates sets the tolerance
    args = (x, w, ef, t1, t2, *tok, gamma, h)
    whole = dk.dsa_attention(*args, **mode)
    op = Phase("dsa_attention", label, 0, 0)
    op.check("whole op vs f32 einsum reference", whole,
             dk.dsa_reference(*args, **mode), tol_whole)
    check_repeatable(op, [whole], [dk.dsa_attention(*args, **mode)])
    if dev.type == "cuda":
        launched = device_kernels(lambda: dk.dsa_attention(*args, **mode))
        ok = len(launched) == 3 and all(
            k in e for k, e in zip(names, launched))
        print(f"  dsa_attention {label}: one call launches {launched} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dsa_attention {label}: launches "
                                 f"{launched}, not the three B5 kernels")

    for ph, call, key, plain in (
            (pa, phase_a, names[0][:-len("_kernel")],
             lambda: dk.dsa_glue(dk.dsa_phase_a_plain(x, w, ef, *tok, h,
                                                      **mode),
                                 t1, t2, h, bf)),
            (pb, phase_b, names[2][:-len("_kernel")],
             lambda: dk.dsa_phase_b_plain(x, w, *ops, gamma, *tok, h,
                                          **mode))):
        times = device_times(call, iters)
        ph.ms = sum(times.values())
        ph.kernel_ms = sum(v for k, v in times.items()
                           if key in k or k == "host")
        if ph.kernel_ms == 0:
            raise AssertionError(f"{key} {label}: the profiler saw no "
                                 f"{key} kernel on the card")
        ph.call_ms = timed_ms(call, iters)
        ph.plain_ms = timed_ms(plain, iters)
        ph.report()
        if dev.type == "cuda":
            print(f"  {key} {label} by kernel: " + ", ".join(
                f"{k} {sum(v for n_, v in times.items() if k in n_):.4f} ms"
                for k in names if any(k in n_ for n_ in times)))
    return [pa, pb]


# the B5 kernels one dsa_attention call launches, in order (bf16, f32)
DSA_KERNELS = ("dsa_phase_a_kernel", "dsa_phase_a_finish",
               "dsa_phase_b_kernel")
DSA_F32_KERNELS = ("dsa_f32_phase_a_kernel", "dsa_f32_phase_a_finish",
                   "dsa_f32_phase_b_kernel")
# the f32 instances (C18) against their plain versions: the same f32
# function on both sides, its sums taken in another order
F32_REL = 1e-5
# K3's kernel, then K4's, in launch order: the 16-bit tensor-core
# instances (two for K4), and the wide ones, which are also every f32
# instance (three: the row blocks, the token sums, the finishing pass)
SPATTN_KERNELS = ("spatial_attn_fwd_kernel", "spatial_attn_bwd_kernel",
                  "spatial_attn_bwd_finish")
SPATTN_WIDE_KERNELS = ("spatial_attn_fwd_kernel_wide",
                       "spatial_attn_bwd_kernel_wide",
                       "spatial_attn_bwd_sums_wide",
                       "spatial_attn_bwd_finish")
# the DSA levels of a 128^3 patch (fs16, 4 heads): (name, N, C, P)
DSA_LEVELS = (("level3", 32768, 32, 64), ("level4", 4096, 64, 64),
              ("level5", 512, 128, 64), ("level6", 64, 256, 32))


# the widths B5 takes beyond the default model's (C16), at their levels'
# 128^3 token counts: the two extremes of MS_DSA_NET at 4 heads, feature
# size 8 at level 3 (C 16, head width 4, project size 16) and feature
# size 32 with project size 128 (levels 3-5 at P 128, level 6 at C 512,
# head width 128, whose weights stream)
DSA_WIDTHS = (("fs8 level3", 32768, 16, 16),
              ("fs32 P128 level3", 32768, 64, 128),
              ("fs32 P128 level4", 4096, 128, 128),
              ("fs32 P128 level5", 512, 256, 128),
              ("fs32 level6", 64, 512, 32))


# SegResNet_DSA's attention levels on a 128^3 patch (fs16, P 64): level 2
# at 32^3, level 3 at 16^3
SEGRES_LEVELS = (("segresnet_dsa level2", 32768, 64, 64),
                 ("segresnet_dsa level3", 4096, 128, 64))
# where B5's other sa_types are held to their plain versions: SegResNet_DSA's
# two levels and MS_DSA_NET's levels 3 and 6
MODE_LEVELS = SEGRES_LEVELS + (DSA_LEVELS[0], DSA_LEVELS[3])
OTHER_SA_TYPES = ("serial", "spatial", "channel")


def dsa_phases(dev, gen, small=False):
    """B5 at the four levels' shapes, at DSA_WIDTHS and at SegResNet_DSA's
    levels ('parallel'), and in the other three sa_types at MODE_LEVELS
    (`small`: at most 512 tokens)."""
    out = []
    cases = [(name, n, c, p, "parallel")
             for name, n, c, p in DSA_LEVELS + DSA_WIDTHS + SEGRES_LEVELS]
    cases += [(name, n, c, p, t) for t in OTHER_SA_TYPES
              for name, n, c, p in MODE_LEVELS]
    for name, n, c, p, t in cases:
        pp = 0 if t == "channel" else p
        mode = "" if t == "parallel" else f" {t}"
        out += dsa_phase(f"{name}{mode} N={n} C={c} P={pp}", dev, gen,
                         min(n, 512) if small else n, c, p, sa_type=t)
    return out


def dsa_f32_phases(dev, gen, small=False):
    """B5's f32 instances (C18) at the four levels' shapes, batch 1, in
    'parallel': the shapes the f32 route of MS_DSA_NET gives them, and of
    UNETR++, whose EPA levels are the same four (`small`: at most 512
    tokens)."""
    import torch

    return [ph for name, n, c, p in DSA_LEVELS
            for ph in dsa_phase(f"{name} f32 N={n} C={c} P={p}", dev, gen,
                                min(n, 512) if small else n, c, p,
                                dtype=torch.float32)]


def device_kernels(fn, calls: int = 3) -> list:
    """The names of the device ops one call of fn launches, in order: the
    first of `calls` calls in a whole trace. Two one-call traces can agree
    and still both lack the same op (the profiler has dropped a call's
    first kernel twice running), so the trace is of several calls, held to
    a one-call trace by `whole_trace`'s count rule, and every call in it
    must launch the same ops in the same order."""
    import torch

    from fcd_tpu_torch.kernels._sweep import whole_trace

    fn()
    torch.cuda.synchronize()
    names = [e.name for e in sorted(whole_trace(fn, calls)[0],
                                    key=lambda e: e.time_range.start)]
    per = len(names) // calls
    if any(names[i] != names[i % per] for i in range(len(names))):
        raise AssertionError(f"{calls} calls launched different ops in "
                             f"turn: {names}")
    return names[:per]


def wgrad_phase(label, dev, gen, batch, grid, parts_c, cout, *,
                prologue=False, iters=5):
    """K1 at one conv's shape: one call per input part. Each part's dW
    against the plain version, and two calls bit-equal (the partial sums
    are added in a fixed order). `ms` and `library_ms` are the device time
    of all that the calls launch (K1: the products and the second pass;
    cuDNN's conv3d_weight per part), each call's wall time beside them."""
    import torch
    from torch.nn.grad import conv3d_weight

    from fcd_tpu_torch.kernels.conv_wgrad import (
        apply_prologue,
        conv3d_wgrad,
        conv3d_wgrad_plain,
        wgrad_plan,
    )

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    xs = [_randn((batch, *grid, c), gen, dev, dtype=bf) for c in parts_c]
    g = _randn((batch, *grid, cout), gen, dev, dtype=bf)
    pro = None
    if prologue:
        c0 = parts_c[0]
        pro = (torch.rand((batch, c0), generator=gen, device=dev) + 0.5,
               _randn((batch, c0), gen, dev, 0.1), 0.01)
    cin = sum(parts_c)
    ph = Phase("conv3d_wgrad", label, 2 * nvox * 27 * cin * cout,
               2 * nvox * (cin + cout) + 4 * 27 * cin * cout)

    def run(fn):
        return [fn(x, g, pro if i == 0 else None) for i, x in enumerate(xs)]

    got, again, want = run(conv3d_wgrad), run(conv3d_wgrad), \
        run(conv3d_wgrad_plain)
    for i, x in enumerate(xs):
        plan = wgrad_plan(batch, *grid, x.shape[-1], cout)
        print(f"  conv3d_wgrad {label} part {i}: {plan.blocks} blocks, "
              f"{plan.chunks} chunks of {plan.per_chunk} tiles, scratch "
              f"{plan.scratch_bytes / 2 ** 20:.2f} MiB")
        # f32 sums of bf16 products over the voxels in another order
        ph.check(f"dW part {i}", got[i], want[i], 1e-3)
    check_repeatable(ph, got, again)
    del got, again, want

    def call():
        return run(conv3d_wgrad)

    times = device_times(call, iters)
    ph.ms = sum(times.values())
    ph.kernel_ms = sum(v for k, v in times.items()
                       if "wgrad_mma_kernel" in k or k == "host")
    if ph.kernel_ms == 0:
        raise AssertionError(f"conv3d_wgrad {label}: the profiler saw no "
                             "wgrad_mma_kernel on the card")
    ph.call_ms = timed_ms(call, iters)
    ph.plain_ms = timed_ms(lambda: run(conv3d_wgrad_plain), 1)
    # library yardstick, timed only: cuDNN bf16 weight gradient per part
    # (of the already-prologued input)
    ins = [(apply_prologue(x, pro) if i == 0 and pro else x).permute(
        0, 4, 1, 2, 3) for i, x in enumerate(xs)]
    go = g.permute(0, 4, 1, 2, 3)

    def library():
        return [conv3d_weight(x, (cout, x.shape[1], 3, 3, 3), go, padding=1)
                for x in ins]

    ph.library_ms = sum(device_times(library, iters).values())
    ph.library_call_ms = timed_ms(library, iters)
    ph.report()
    return ph


def check_repeatable(ph, got, again):
    """A kernel's outputs from two calls on the same inputs: the same bits
    (its sums are taken in a fixed order)."""
    same = all(torch_equal(a, b) for a, b in zip(got, again))
    print(f"  {ph.kernel} {ph.label}: two calls bit-equal "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{ph.kernel} {ph.label}: two calls differ")


# K2's two kernels, in launch order
FINALE_BWD_KERNELS = ("finale_bwd_kernel", "finale_bwd_finish")


def finale_bwd_phase(label, dev, gen, batch, grid, c, mode, *, tied=False,
                     batch_norm=False, iters=10):
    """K2 at one shape, called as the train step calls it: one
    `Finale.backward` (mode `none`: no pooled output; `even` or `chain`:
    the pool's tie split). Random non-dyadic affines, so d_ys and d_rs
    must be the plain version's bits whatever the rounding of t; `tied`:
    small integers through dyadic affines, exact in f32, so that the pool's
    2x2x2 blocks hold exact ties (the chain split must then differ from
    the even one); `batch_norm`: a transformer block's affines, the batch
    norm's (C,) rows expanded over the batch and the identity shortcut's
    sr = 1, br = 0. The sums are checked to 1e-3 (1e-4 tied) of their max.
    `ms` is the device time of all one call launches (the kernel alone and
    the wall per call beside it), and one call must be K2's two kernels."""
    import types

    import torch

    from fcd_tpu_torch.kernels.finale import (
        Finale,
        finale_bwd,
        finale_bwd_plan,
        finale_grads_plain,
    )

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    pooled = mode != "none"
    if tied:
        ys = torch.randint(-2, 3, (batch, *grid, c), generator=gen,
                           device=dev).to(bf)
        rs = torch.randint(-1, 2, (batch, *grid, c), generator=gen,
                           device=dev).to(bf)
        s2 = torch.full((batch, c), 0.5, device=dev)
        b2 = torch.randint(-8, 9, (batch, c), generator=gen, device=dev) / 8.0
        sr, br = torch.ones_like(s2), torch.zeros_like(s2)
    else:
        ys = _randn((batch, *grid, c), gen, dev, dtype=bf)
        rs = _randn((batch, *grid, c), gen, dev, dtype=bf)
        rows = 1 if batch_norm else batch
        s2 = (torch.rand((rows, c), generator=gen, device=dev) + 0.5).expand(
            batch, c)
        b2 = _randn((rows, c), gen, dev, 0.1).expand(batch, c)
        if batch_norm:
            sr, br = torch.ones(batch, c, device=dev), torch.zeros(
                batch, c, device=dev)
        else:
            sr = torch.rand((batch, c), generator=gen, device=dev) + 0.5
            br = _randn((batch, c), gen, dev, 0.1)
    gp = _randn((batch, *grid, c), gen, dev, dtype=bf)
    gq = (_randn((batch, *(v // 2 for v in grid), c), gen, dev, dtype=bf)
          if pooled else None)
    tie = "even" if mode == "none" else mode
    args = (ys, rs, s2, b2, sr, br, gp, gq, 0.01, tie)
    # reads ys, rs, gp (and gq), writes d_ys and d_rs; the affines and the
    # three sums; "before": a call that writes dt alone and leaves its two
    # scalings to PyTorch
    pool_bytes = 2 * nvox * c // 8 if pooled else 0
    ph = Phase("finale_bwd", label, 17 * nvox * c,
               10 * nvox * c + pool_bytes + 28 * batch * c)
    before = (8 * nvox * c + pool_bytes + 28 * batch * c) / PEAK_BYTES * 1e3
    plan = finale_bwd_plan(batch, *grid, c, mode)
    print(f"  finale_bwd {label}: {plan.vec} channel(s) a thread, "
          f"{plan.grid[0]}x{plan.grid[1]} blocks of {plan.threads}, at most "
          f"{plan.tiles_per_block} tiles a block")
    got, want = finale_bwd(*args), finale_grads_plain(*args)
    ph.check_equal("d_ys", got[0], want[0])
    ph.check_equal("d_rs", got[1], want[1])
    tol = 1e-4 if tied else 1e-3
    for name, g_, w_ in zip(("sum dt*ys", "sum dt", "sum dt*rs"), got[2:],
                            want[2:]):
        ph.check(name, g_, w_, tol)
    check_repeatable(ph, got, finale_bwd(*args))
    if tied and mode == "chain":
        even = finale_grads_plain(*args[:-1], "even")
        moved = float((want[0] != even[0]).float().mean())
        print(f"  finale_bwd {label}: chain and even split differ at "
              f"{100 * moved:.2f}% of d_ys")
        if moved == 0:
            raise AssertionError("the tied inputs do not tell chain from even")
    del got, want
    ctx = types.SimpleNamespace(saved_tensors=(ys, rs, s2, b2, sr, br),
                                slope=0.01, pool=pooled, tie=tie)

    def call():
        return Finale.backward(ctx, gp, gq)

    if dev.type == "cuda":
        launched = device_kernels(call)
        ok = len(launched) == 2 and all(
            k in e for k, e in zip(FINALE_BWD_KERNELS, launched))
        print(f"  finale_bwd {label}: one Finale.backward launches "
              f"{launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"finale_bwd {label}: launches {launched}, "
                                 f"not {list(FINALE_BWD_KERNELS)}")
    times = device_times(call, iters)
    ph.ms = sum(times.values())
    ph.kernel_ms = sum(v for k, v in times.items()
                       if FINALE_BWD_KERNELS[0] in k or k == "host")
    ph.call_ms = timed_ms(call, iters)
    ph.plain_ms = timed_ms(lambda: finale_grads_plain(*args), 2)
    ph.report()
    print(f"  finale_bwd {label}: bound of a call that writes dt alone "
          f"{before:.4f} ms")
    return ph


def finale_bwd_phases(dev, gen, small=False):
    """K2 at the train step's batch 4 (`small`: batch 1, small grids): the
    two largest calls, enc2, the tied chain split at enc3, a level-3
    transformer block and enc6."""
    s = (lambda *g: tuple(max(2, v // 16) for v in g)) if small else \
        (lambda *g: g)
    b = 1 if small else TRAIN_BATCH
    return [
        finale_bwd_phase("enc1 4x128^3x16 +pool, even", dev, gen, b,
                         s(128, 128, 128), 16, "even"),
        finale_bwd_phase("dec[4] 4x128^3x16", dev, gen, b, s(128, 128, 128),
                         16, "none"),
        finale_bwd_phase("enc2 4x64^3x32 +pool, even", dev, gen, b,
                         s(64, 64, 64), 32, "even"),
        finale_bwd_phase("enc3 4x32^3x64 +pool, chain, tied inputs", dev, gen,
                         b, s(32, 32, 32) if small else (32, 32, 32), 64,
                         "chain", tied=True),
        finale_bwd_phase("level-3 transformer 4x32^3x32, batch norm, sr = 1",
                         dev, gen, b, s(32, 32, 32) if small else (32, 32, 32),
                         32, "none", batch_norm=True),
        finale_bwd_phase("enc6 4x4^3x512", dev, gen, b, (4, 4, 4), 512, "none"),
    ]


def zoo_width_phases(dev, gen, small=False):
    """B1, B2, B4, K1 and K2 at the widths SwinUNETR (feature size 24: C
    24, 48, 96, 192, 384) and UNETR (its bottleneck's B4, ci 768) give
    them, at those models' grids: the image's 2 -> 24 and the last
    decoder's 24 + 24 at 128^3, the 8^3 and 4^3 levels at 192 and 384;
    B4 at SwinUNETR's deepest and shallowest decoders and UNETR's d4; K1
    and K2 at the train step's batch 4 (`small`: batch 1, small grids)."""
    s = (lambda *g: tuple(max(2, v // 16) for v in g)) if small else \
        (lambda *g: g)
    b = 1 if small else TRAIN_BATCH
    return [
        conv_phase("swin enc0.conv1 128^3x2->24 +shortcut+stats", dev, gen,
                   s(128, 128, 128), [2], 24, shortcut=True),
        conv_phase("swin enc0.conv2 128^3x24->24 +prologue+stats", dev, gen,
                   s(128, 128, 128), [24], 24, prologue=True),
        conv_phase("swin out.conv1 128^3x(24+24)->24 +shortcut+stats", dev,
                   gen, s(128, 128, 128), [24, 24], 24, shortcut=True),
        conv_phase("swin d1.conv1 32^3x(48+48)->48 +shortcut+stats", dev,
                   gen, s(32, 32, 32), [48, 48], 48, shortcut=True),
        conv_phase("swin d3.conv1 8^3x(192+192)->192 +shortcut+stats", dev,
                   gen, (8, 8, 8), [192, 192], 192, shortcut=True),
        conv_phase("swin dec4.conv2 4^3x384->384 +prologue+stats", dev, gen,
                   (4, 4, 4), [384], 384, prologue=True),
        finale_phase("swin out 128^3x24", dev, gen, s(128, 128, 128), 24,
                     pool=False),
        finale_phase("swin dec4 4^3x384", dev, gen, (4, 4, 4), 384,
                     pool=False),
        upsample_phase("unetr d4 1x8^3x768->16^3x128", dev, gen, 1,
                       (8, 8, 8), 768, 128),
        upsample_phase("swin d3 1x4^3x384->8^3x192", dev, gen, 1, (4, 4, 4),
                       384, 192),
        upsample_phase("swin out 1x64^3x24->128^3x24", dev, gen, 1,
                       s(64, 64, 64), 24, 24),
        wgrad_phase("swin enc1.conv2 4x64^3 24->24 +prologue", dev, gen, b,
                    s(64, 64, 64), [24], 24, prologue=True),
        wgrad_phase("swin out.conv1 4x128^3 (24+24)->24", dev, gen, b,
                    s(128, 128, 128), [24, 24], 24),
        wgrad_phase("swin d2.conv1 4x16^3 (96+96)->96", dev, gen, b,
                    (16, 16, 16), [96, 96], 96),
        wgrad_phase("swin dec4.conv2 4x4^3 384->384 +prologue", dev, gen, b,
                    (4, 4, 4), [384], 384, prologue=True),
        finale_bwd_phase("swin out 4x128^3x24", dev, gen, b,
                         s(128, 128, 128), 24, "none"),
        finale_bwd_phase("swin d1 4x32^3x48", dev, gen, b, s(32, 32, 32), 48,
                         "none"),
        finale_bwd_phase("swin dec4 4x4^3x384", dev, gen, b, (4, 4, 4), 384,
                         "none"),
    ]


PEAK_F32 = 67e12   # H100 SXM float32 outside the tensor cores


def partial_phase(label, dev, gen, grid, c, cout, *, prologue=True,
                  iters=20):
    """B1's partial instance (tensor parallelism's row-parallel conv) at
    one shard width: c of the input channels into the whole cout, f32
    out. Against its plain version (f32 products of the bf16 operands:
    only the order of the sums differs), two calls bit-equal; the
    yardstick is cuDNN's bf16 conv of the same slice."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels.block_conv import (
        conv3x3_partial,
        conv3x3_partial_plain,
    )

    bf = torch.bfloat16
    nvox = grid[0] * grid[1] * grid[2]
    x = _randn((1, *grid, c), gen, dev, dtype=bf)
    w = _randn((3, 3, 3, c, cout), gen, dev, (2.0 / (27 * cout)) ** 0.5, bf)
    pro = None
    if prologue:
        pro = (torch.rand((1, c), generator=gen, device=dev) + 0.5,
               _randn((1, c), gen, dev, 0.1), 0.01)
    ph = Phase("conv3d_partial", label, 2 * nvox * 27 * c * cout,
               2 * nvox * c + 2 * 27 * c * cout + 4 * nvox * cout)
    got = conv3x3_partial(x, w, pro)
    ph.check("y (f32)", got, conv3x3_partial_plain(x, w, pro), 1e-4)
    check_repeatable(ph, [got], [conv3x3_partial(x, w, pro)])
    time_on_device(ph, lambda: conv3x3_partial(x, w, pro), "conv3d_kernel",
                   iters)
    ph.plain_ms = timed_ms(lambda: conv3x3_partial_plain(x, w, pro), 2)
    xin = x.permute(0, 4, 1, 2, 3)
    wlib = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)

    def library():
        return F.conv3d(xin, wlib, padding=1)

    ph.library_ms = sum(device_times(library, iters).values())
    ph.library_call_ms = timed_ms(library, iters)
    ph.report()
    return ph


def finish_phase(label, dev, gen, grid, c, iters=20):
    """The finishing pass at one shape: an f32 sum rounded to bf16, with
    its per-(b, c) sums. y bit-equal to the plain version's (the same
    round to nearest), the sums within f32 rounding, two calls bit-equal.
    No one library call computes the three outputs (null)."""
    import torch

    from fcd_tpu_torch.kernels.conv_finish import (
        conv_finish,
        conv_finish_plain,
    )

    n = grid[0] * grid[1] * grid[2] * c
    s = _randn((1, *grid, c), gen, dev) + 0.3
    ph = Phase("conv_finish", label, 3 * n, 6 * n + 8 * c, peak=PEAK_F32)
    got = conv_finish(s)
    want = conv_finish_plain(s, torch.bfloat16)
    ph.check_equal("y", got[0], want[0])
    ph.check("sums", torch.stack(got[1:]), torch.stack(want[1:]), 1e-5)
    check_repeatable(ph, got, conv_finish(s))
    time_on_device(ph, lambda: conv_finish(s), "conv_finish_kernel", iters)
    ph.plain_ms = timed_ms(lambda: conv_finish_plain(s, torch.bfloat16),
                           iters)
    ph.report()
    return ph


def tp_width_phases(dev, gen, small=False):
    """The kernels of the tensor-parallel patch at MS_DSA_NET fs16 over a
    model axis of 2 (`tp_run`): B1's partial instance and the finishing
    pass at the row-parallel convs' shapes (enc1's conv2, the level-3
    transformers' conv1, enc6's conv2), and B1, K1 and B4 at the shard
    widths (conv1 and the shortcut with half the output channels; conv2's
    data gradient into half the input channels and its weight gradient on
    them; the up-blocks' transposed conv with half the outputs)."""
    s = (lambda *g: tuple(max(2, v // 16) for v in g)) if small else \
        (lambda *g: g)
    return [
        partial_phase("enc1.conv2 128^3x8->16 +prologue", dev, gen,
                      s(128, 128, 128), 8, 16),
        partial_phase("level3 tb.conv1 32^3x16->32", dev, gen,
                      s(32, 32, 32), 16, 32, prologue=False),
        partial_phase("enc6.conv2 4^3x256->512 +prologue", dev, gen,
                      (4, 4, 4), 256, 512),
        finish_phase("enc1 1x128^3x16", dev, gen, s(128, 128, 128), 16),
        finish_phase("level3 1x32^3x32", dev, gen, s(32, 32, 32), 32),
        finish_phase("enc6 1x4^3x512", dev, gen, (4, 4, 4), 512),
        conv_phase("tp enc1.conv1 128^3x2->8 +shortcut+stats", dev, gen,
                   s(128, 128, 128), [2], 8, shortcut=True),
        conv_phase("tp dec1.conv1 128^3x(16+16)->8 +shortcut+stats", dev,
                   gen, s(128, 128, 128), [16, 16], 8, shortcut=True),
        conv_phase("tp enc1.conv2 dgrad 128^3x16->8", dev, gen,
                   s(128, 128, 128), [16], 8),
        wgrad_phase("tp enc1.conv2 1x128^3 8->16 +prologue", dev, gen, 1,
                    s(128, 128, 128), [8], 16, prologue=True),
        wgrad_phase("tp enc1.conv1 1x128^3 2->8", dev, gen, 1,
                    s(128, 128, 128), [2], 8),
        upsample_phase("tp dec1 1x64^3x32->128^3x8", dev, gen, 1,
                       s(64, 64, 64), 32, 8),
        upsample_phase("tp dec5 1x4^3x256->8^3x64", dev, gen, 1, (4, 4, 4),
                       256, 64),
    ]


def pool2x_phase(label, dev, gen, batch, grid, c, iters=10):
    """B3 at one shape, bit-equal to its plain version (a max is exact),
    timed by the device time of one call (its library call alike)."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels.pool2x import max_pool2x, max_pool2x_plain

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    x = _randn((batch, *grid, c), gen, dev, dtype=bf)
    ph = Phase("max_pool2x", label, 7 * nvox * c // 8,
               2 * nvox * c + 2 * nvox * c // 8)
    ph.check_equal("pooled", max_pool2x(x), max_pool2x_plain(x))
    time_on_device(ph, lambda: max_pool2x(x), "pool_fwd_kernel", iters)
    ph.plain_ms = timed_ms(lambda: max_pool2x_plain(x), iters)
    # library yardstick, timed only: max_pool3d of the channels-last view
    xin = x.permute(0, 4, 1, 2, 3)

    def library():
        return F.max_pool3d(xin, 2, 2)

    ph.library_ms = sum(device_times(library, iters).values())
    ph.library_call_ms = timed_ms(library, iters)
    ph.report()
    return ph


def pool2x_bwd_phase(label, dev, gen, batch, grid, c, *, tied=False,
                     iters=20):
    """B9 at one shape, bit-equal to its plain version (one f32 division
    per tied child): on `tied` inputs (small integers, so that blocks hold
    2- and 3-way ties) or random ones; timed by the device time of one
    call. It launches one kernel, `pool2x_bwd_kernel`; torch has no call
    that splits ties evenly (ROADMAP C1), so no library yardstick."""
    import torch

    from fcd_tpu_torch.kernels.pool2x import (
        max_pool2x_bwd,
        max_pool2x_bwd_plain,
        pool2x_bwd_plan,
    )
    from fcd_tpu_torch.ops.layers import blocks_2x

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    pgrid = tuple(v // 2 for v in grid)
    x = (torch.randint(-3, 4, (batch, *grid, c), generator=gen,
                       device=dev).to(bf) if tied
         else _randn((batch, *grid, c), gen, dev, dtype=bf))
    g = _randn((batch, *pgrid, c), gen, dev, dtype=bf)
    if tied:
        xb = blocks_2x(x.float())
        ties = (xb == xb.amax(dim=4, keepdim=True)).sum(dim=4)
        hist = torch.bincount(ties.flatten(), minlength=9)[1:].tolist()
        print(f"  max_pool2x_bwd {label}: blocks by ties 1..8 {hist}")
        if min(hist[1], hist[2]) == 0:
            raise AssertionError("the inputs hold no 2- or 3-way ties")
        del xb, ties
    plan = pool2x_bwd_plan(batch, *grid, c)
    print(f"  max_pool2x_bwd {label}: {plan.vec} channel(s) a thread, "
          f"{plan.grid[0]}x{plan.grid[1]} blocks of {plan.threads}, "
          f"{plan.tiles_per_block} tile(s) a block")
    # x read, g read once, dx written
    ph = Phase("max_pool2x_bwd", label, 4 * nvox * c,
               2 * nvox * c + 2 * nvox * c // 8 + 2 * nvox * c)
    ph.check_equal("dx", max_pool2x_bwd(x, g), max_pool2x_bwd_plain(x, g))
    time_on_device(ph, lambda: max_pool2x_bwd(x, g), "pool2x_bwd_kernel",
                   iters)
    ph.plain_ms = timed_ms(lambda: max_pool2x_bwd_plain(x, g), 2)
    ph.report()
    return ph


def pool2x_bwd_phases(dev, gen, small=False):
    """B9 at the gated train step's two calls (`small`: batch 1, small
    grids): encoder 1 on tied inputs, encoder 2."""
    s = (lambda *g: tuple(max(2, v // 16) for v in g)) if small else \
        (lambda *g: g)
    b = 1 if small else TRAIN_BATCH
    return [
        pool2x_bwd_phase("enc1 train 4x128^3x16, tied inputs", dev, gen, b,
                         s(128, 128, 128), 16, tied=True),
        pool2x_bwd_phase("enc2 train 4x64^3x32", dev, gen, b, s(64, 64, 64),
                         32),
    ]


def finale_head_phase(label, dev, gen, grid, c, o, iters=10):
    """B15 at one shape: rel 1e-2 of max|logit| against its plain version
    (the same activations and products; f32 sums in another order)."""
    import torch

    from fcd_tpu_torch.kernels.finale_head import (
        finale_head,
        finale_head_plain,
    )

    bf = torch.bfloat16
    nvox = grid[0] * grid[1] * grid[2]
    y2 = _randn((1, *grid, c), gen, dev, dtype=bf)
    r = _randn((1, *grid, c), gen, dev, dtype=bf)
    aff = [_randn((1, c), gen, dev) for _ in range(4)]
    w = _randn((c, o), gen, dev, (2.0 / o) ** 0.5)
    bias = _randn((o,), gen, dev)
    args = (y2, r, *aff, w, bias, 0.01)
    ph = Phase("finale_head", label, nvox * (5 * c + 2 * c * o + o),
               2 * 2 * nvox * c + 2 * nvox * o + 4 * (4 * c + c * o + o))
    ph.check("logits", finale_head(*args), finale_head_plain(*args), 1e-2)
    time_on_device(ph, lambda: finale_head(*args), "finale_head_kernel",
                   iters)
    ph.plain_ms = timed_ms(lambda: finale_head_plain(*args), iters)
    ph.report()
    return ph


CLI_SHAPE = (176, 225, 240)   # the CLI phase's volume after RAS and 1 mm


def sw_io_phases(dev, gen, shape=CLI_SHAPE, c=2, o=2, roi=128, iters=20):
    """B17 (sw_entry) and B6 (sw_exit) at the CLI phase's preprocessed
    shape (no pad at roi 128), bit-equal to their plain versions; then once
    each with a pad and a crop, checked only."""
    import torch

    from fcd_tpu_torch.kernels.sw_io import (
        entry_group,
        entry_pad,
        sw_entry,
        sw_entry_plain,
        sw_exit,
        sw_exit_plain,
    )

    bf = torch.bfloat16
    roi3 = (roi,) * 3
    nvox = shape[0] * shape[1] * shape[2]
    vol = _randn((*shape, c), gen, dev, 3.0)
    pe = Phase("sw_entry", f"{shape}x{c} f32 -> bf16", nvox * c,
               4 * nvox * c + 2 * nvox * c)
    pe.check_equal("out", sw_entry(vol, roi3, bf), sw_entry_plain(vol, roi3, bf))
    # padded along D; and along W by an odd lead pad (bw C = 2: two
    # elements a unit), each also to f32
    for part in (vol[:shape[0] * 4 // 7], vol[:, :, :roi - 3]):
        part = part.contiguous()
        pw = max(part.shape[2], roi)
        bw = entry_pad(part.shape[:3], roi3)[2][0]
        for dtype in (bf, torch.float32):
            pe.check_equal(f"out, padded {tuple(part.shape)} to {dtype}, "
                           f"{entry_group(c, part.shape[2], pw, bw)} elements "
                           f"a unit", sw_entry(part, roi3, dtype),
                           sw_entry_plain(part, roi3, dtype))
    print(f"  sw_entry: {entry_group(c, shape[2], max(shape[2], roi), 0)} "
          "elements a unit at the main shape")

    def entry():
        return sw_entry(vol, roi3, bf)

    # timed as sw_exit is: the device time of one call
    pe.ms = pe.kernel_ms = sum(device_times(entry, iters).values())
    pe.call_ms = timed_ms(entry, iters)
    pe.plain_ms = timed_ms(lambda: sw_entry_plain(vol, roi3, bf), iters)
    pe.report()

    acc = _randn((*shape, o), gen, dev)
    inv = torch.rand((*shape, 1), generator=gen, device=dev) + 0.1
    px = Phase("sw_exit", f"{shape}x{o} f32 * coverage", nvox * o,
               nvox * (4 * o + 4) + 4 * nvox * o)
    start = (0, 0, 0)
    px.check_equal("out", sw_exit(acc, inv, start, shape),
                   sw_exit_plain(acc, inv, start, shape))
    # an odd x corner (one voxel a float2) and an even one (two a float4)
    for corner in ((1, 2, 3), (2, 2, 2)):
        crop = tuple(v - 2 * k for v, k in zip(shape, corner))
        px.check_equal(f"out, cropped at {corner} to {crop}",
                       sw_exit(acc, inv, corner, crop),
                       sw_exit_plain(acc, inv, corner, crop))
    # the kernel and its yardstick alike: the device time of one call
    px.ms = sum(device_times(lambda: sw_exit(acc, inv, start, shape),
                             iters).values())
    px.plain_ms = timed_ms(lambda: sw_exit_plain(acc, inv, start, shape), iters)
    # library yardstick, timed only: acc[crop] * inv[crop] (no crop here)
    px.library_ms = sum(device_times(lambda: acc * inv, iters).values())
    px.report()
    return [pe, px]


def spatial_attn_phases(label, dev, gen, batch, n, c, p, h=4, rate=0.1,
                        iters=10, dtype=None):
    """K3 and K4 at one level's shape, with dropout: the kernels and the
    plain versions draw the same hash bits, so they agree elementwise; two
    K4 calls give the same bits; on the card one K3 call is one device
    kernel and one K4 call its two. `ms` and `library_ms` (SDPA, and SDPA's
    backward alone) are the device time of all one call launches, the
    kernels alone and the wall per call beside them. dtype torch.float32:
    the f32 instances (C18) on f32 operands, held at F32_REL, dkpb and
    dvpb in f32 as the train step asks, f32 SDPA as the library call,
    the bound at 3xTF32's rate (PEAK_3XTF32); torch.float16: the f16 instances (C20),
    held as the bf16 ones, f16 SDPA as the library call."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels import spatial_attn as sa

    bf = torch.bfloat16 if dtype is None else dtype
    f32 = bf == torch.float32
    tol, sfx, es = {torch.float32: (F32_REL, "_f32", 4),
                    torch.float16: (2e-2, "_f16", 2)}.get(bf, (2e-2, "", 2))
    hp = h * p
    ch = c // h
    qn = _randn((batch, n, c), gen, dev, n ** -0.5, bf)
    kp = _randn((batch, h, ch, p), gen, dev, 2.0)
    vp = _randn((batch, h, ch, p), gen, dev)
    eye = torch.eye(h, device=dev)
    kpb = torch.einsum("bhcp,hg->bhcgp", kp, eye).reshape(batch, c, hp).to(bf)
    vpb = torch.einsum("bhcp,hg->bgphc", vp, eye).reshape(batch, hp, c).to(bf)
    g = _randn((batch, n, c), gen, dev, dtype=bf)
    key = sa.dropout_key(SEED, 3)
    keep = sa.keep_mask(batch, n, hp, key, rate, dev).float().mean()
    plan = (sa.spatial_attn_plan_f32 if f32 else sa.spatial_attn_plan)(
        n, c, p, h, batch)
    names = SPATTN_WIDE_KERNELS if plan.wide else SPATTN_KERNELS
    print(f"  spatial_attn {label}: keep fraction {float(keep):.5f} at rate "
          f"{rate}; K3 {plan.fwd_grid} blocks of {plan.per_block} units "
          f"(16 tokens x {plan.cols} columns), K4 split by {plan.split}, "
          f"{plan.head_block} heads a block, {plan.bwd_grid} blocks "
          f"({plan.chunks} chunks of {plan.tile}-token tiles), partials "
          f"{plan.partial_bytes / 2 ** 20:.2f} MiB, shared memory "
          f"{plan.smem_fwd} / {plan.smem_bwd} bytes")
    if abs(float(keep) - (1 - rate)) > 0.01 * (1 - rate):
        raise AssertionError(f"dropout keeps {float(keep)}, not {1 - rate}")
    mm = 2 * batch * n * c * hp
    peak = PEAK_3XTF32 if f32 else PEAK_FLOPS
    pf = Phase("spatial_attn_fwd" + sfx, label, 2 * mm,
               es * (2 * batch * n * c + 2 * batch * c * hp), peak)
    # as SpatialAttn.backward calls it: dkpb and dvpb in kpb's dtype
    pb = Phase("spatial_attn_bwd" + sfx, label, 5 * mm,
               es * (3 * batch * n * c + 4 * batch * c * hp), peak)
    if f32:
        qn, kpb, vpb, g = (t.float() for t in (qn, kpb, vpb, g))

    def fwd():
        return sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate)

    def bwd():
        return sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate,
                                   dtypes=(bf, bf))

    pf.check("out", fwd(), sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                                     rate), tol)
    check_repeatable(pf, [fwd()], [fwd()])
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    # both stores of the finishing pass: bf16 (the main path's) and f32
    # (the wrapper's default); the f32 instances' main path is f32
    got = bwd()
    kind = str(bf).replace("torch.", "")
    for name, g_, w_ in zip(("dqn", f"dkpb {kind}", f"dvpb {kind}"), got,
                            want):
        pb.check(name, g_, w_, tol)
    check_repeatable(pb, got, bwd())
    if not f32:
        got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
        for name, g_, w_ in zip(("dkpb f32", "dvpb f32"), got[1:], want[1:]):
            pb.check(name, g_, w_, tol)
    del got, want
    if dev.type == "cuda":
        for ph, call, kernels in ((pf, fwd, names[:1]),
                                  (pb, bwd, names[1:])):
            launched = device_kernels(call)
            ok = len(launched) == len(kernels) and all(
                k in e for k, e in zip(kernels, launched))
            print(f"  {ph.kernel} {label}: one call launches {launched} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{ph.kernel} {label}: launches "
                                     f"{launched}, not {list(kernels)}")
    # library yardstick, timed only: the same per-head attention through
    # SDPA (its own dropout stream), q (B, h, N, c), k and v (B, h, P, c);
    # and K4's: the backward of that SDPA call alone (its forward once,
    # the graph kept), with the cotangent in SDPA's layout
    q4 = qn.reshape(batch, n, h, ch).transpose(1, 2)
    k4 = kp.transpose(2, 3).to(bf)
    v4 = vp.transpose(2, 3).to(bf)
    g4 = g.reshape(batch, n, h, ch).transpose(1, 2)
    kernel_keys = ("spatial_attn_fwd", "spatial_attn_bwd")   # every kernel
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*ins, dropout_p=rate, scale=1.0)

        def library_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate,
                                                  scale=1.0)

        def library_bwd():
            return torch.autograd.grad(out, ins, g4, retain_graph=True)

        for ph, call, kernel, plain, library in (
                (pf, fwd, kernel_keys[0],
                 lambda: sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                                   rate), library_fwd),
                (pb, bwd, kernel_keys[1],
                 lambda: sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key,
                                                   rate), library_bwd)):
            times = device_times(call, iters)
            ph.ms = sum(times.values())
            ph.kernel_ms = sum(v for k, v in times.items()
                               if kernel in k or k == "host")
            if ph.kernel_ms == 0:
                raise AssertionError(f"{ph.kernel} {label}: the profiler saw "
                                     f"no {kernel} on the card")
            ph.call_ms = timed_ms(call, iters)
            ph.plain_ms = timed_ms(plain, 2)
            ph.library_ms = sum(device_times(library, iters).values())
            ph.library_call_ms = timed_ms(library, iters)
            ph.report()
            if dev.type == "cuda":
                print(f"  {ph.kernel} {label} by kernel: " + ", ".join(
                    f"{k} {sum(v for n_, v in times.items() if k in n_):.4f}"
                    f" ms" for k in names if any(k in n_ for n_ in times)))
        del out, ins
    return [pf, pb]


# C15: the widths past the tensor-core instances, run by the wide ones at
# their levels' 128^3 token counts: segresnet_deeper's level 4 (C 256, P
# 64), MS_DSA_NET fs32's level 6 (C 512, P 32) and fs32 project-128's
# level 5 (C 256, P 128)
C15_WIDTHS = (("segresnet_deeper level4", 512, 256, 64),
              ("fs32 level6", 64, 512, 32),
              ("fs32 P128 level5", 512, 256, 128))


def spatial_attn_levels(dev, gen, small=False):
    """K3 and K4 at the four levels' shapes, SegResNet_DSA's two and
    C15_WIDTHS, at the train step's batch 4 (`small`: batch 1, at most
    512 tokens)."""
    out = []
    for name, n, c, p in DSA_LEVELS + SEGRES_LEVELS + C15_WIDTHS:
        b, n = (1, min(n, 512)) if small else (TRAIN_BATCH, n)
        out += spatial_attn_phases(f"{name} {b}xN={n} C={c} hP={4 * p}",
                                   dev, gen, b, n, c, p)
    return out


def dsa_f16_phases(dev, gen, small=False):
    """B5's f16 instances (C20) at the four levels' shapes and at fs32 P128
    level 5 (a wide head), batch 1, in 'parallel' (`small`: at most 512
    tokens)."""
    import torch

    return [ph for name, n, c, p in DSA_LEVELS + DSA_WIDTHS[3:4]
            for ph in dsa_phase(f"{name} f16 N={n} C={c} P={p}", dev, gen,
                                min(n, 512) if small else n, c, p,
                                dtype=torch.float16)]


def spatial_attn_f16_levels(dev, gen, small=False):
    """K3 and K4's f16 instances (C20) at the four levels' shapes and at
    fs32 P128 level 5 (the wide instances), batch 4 (`small`: batch 1, at
    most 512 tokens)."""
    import torch

    out = []
    for name, n, c, p in DSA_LEVELS + C15_WIDTHS[2:]:
        b, n = (1, min(n, 512)) if small else (TRAIN_BATCH, n)
        out += spatial_attn_phases(f"{name} f16 {b}xN={n} C={c} hP={4 * p}",
                                   dev, gen, b, n, c, p, dtype=torch.float16)
    return out


def spatial_attn_f32_levels(dev, gen, small=False):
    """K3 and K4's f32 instances (C18) at the four levels' shapes at the
    train step's batch 4 (`small`: batch 1, at most 512 tokens)."""
    import torch

    out = []
    for name, n, c, p in DSA_LEVELS:
        b, n = (1, min(n, 512)) if small else (TRAIN_BATCH, n)
        out += spatial_attn_phases(f"{name} f32 {b}xN={n} C={c} hP={4 * p}",
                                   dev, gen, b, n, c, p, dtype=torch.float32)
    return out


def kernel_phases(dev, gen, small: bool = False):
    """Every kernel at its main-path shapes (`small`: tiny shapes for a CPU
    rehearsal of the script's control flow)."""
    s = (lambda *g: tuple(max(2, v // 16) for v in g)) if small else \
        (lambda *g: g)
    phases = [
        conv_phase("enc1.conv2 128^3x16->16 +prologue+stats", dev, gen,
                   s(128, 128, 128), [16], 16, prologue=True),
        conv_phase("dec2.conv1 64^3x(32+32)->32 +shortcut+stats", dev, gen,
                   s(64, 64, 64), [32, 32], 32, shortcut=True),
        conv_phase("enc6.conv1 4^3x256->512 +shortcut+stats", dev, gen,
                   (4, 4, 4), [256], 512, shortcut=True),
        # the largest weights (14.2 MB): B1's widest loss to cuDNN
        conv_phase("enc6.conv2 4^3x512->512 +prologue+stats", dev, gen,
                   (4, 4, 4), [512], 512, prologue=True),
        # the largest launch, and the image's C = 2 (the scalar loader)
        conv_phase("dec1.conv1 128^3x(16+16)->16 +shortcut+stats", dev, gen,
                   s(128, 128, 128), [16, 16], 16, shortcut=True),
        conv_phase("enc1.conv1 128^3x2->16 +shortcut+stats", dev, gen,
                   s(128, 128, 128), [2], 16, shortcut=True),
        finale_phase("enc1 128^3x16 +pool", dev, gen, s(128, 128, 128), 16),
    ]
    phases += upsample_phases(dev, gen, small)
    phases += dsa_phases(dev, gen, small)
    # the training path's kernels at batch 4 x 128^3 shapes
    b = 1 if small else 4
    phases += [
        wgrad_phase("enc1.conv2 4x128^3 16->16 +prologue", dev, gen, b,
                    s(128, 128, 128), [16], 16, prologue=True),
        wgrad_phase("dec1.conv1 4x128^3 (16+16)->16", dev, gen, b,
                    s(128, 128, 128), [16, 16], 16),
        wgrad_phase("enc6.conv1 4x4^3 256->512", dev, gen, b, (4, 4, 4),
                    [256], 512),
        # one per regime: the image's C = 2, the 64^3 level at 32 -> 32,
        # a mid level, and the widest dW (28 MB)
        wgrad_phase("enc1.conv1 4x128^3 2->16", dev, gen, b,
                    s(128, 128, 128), [2], 16),
        wgrad_phase("enc2.conv2 4x64^3 32->32 +prologue", dev, gen, b,
                    s(64, 64, 64), [32], 32, prologue=True),
        wgrad_phase("enc4.conv2 4x16^3 128->128 +prologue", dev, gen, b,
                    (16, 16, 16), [128], 128, prologue=True),
        wgrad_phase("enc6.conv2 4x4^3 512->512 +prologue", dev, gen, b,
                    (4, 4, 4), [512], 512, prologue=True),
    ]
    phases += finale_bwd_phases(dev, gen, small)
    phases += zoo_width_phases(dev, gen, small)
    phases += spatial_attn_levels(dev, gen, small)
    # the f32 route's kernels (C18), and the f16 instances (C20)
    phases += dsa_f32_phases(dev, gen, small)
    phases += spatial_attn_f32_levels(dev, gen, small)
    phases += dsa_f16_phases(dev, gen, small)
    phases += spatial_attn_f16_levels(dev, gen, small)
    phases += sw_io_phases(dev, gen, s(*CLI_SHAPE), roi=8 if small else 128)
    # the gated paths' kernels (FCD_FINALE_POOL=0 / FCD_FINALE_TRAIN=0,
    # FCD_FUSED_HEAD=1)
    phases += [
        pool2x_phase("enc1 eval 1x128^3x16", dev, gen, 1, s(128, 128, 128),
                     16),
        pool2x_phase("enc2 train 4x64^3x32", dev, gen, b, s(64, 64, 64), 32),
    ]
    phases += pool2x_bwd_phases(dev, gen, small)
    phases.append(finale_head_phase("dec1 1x128^3x16 -> 2", dev, gen,
                                    s(128, 128, 128), 16, 2))
    phases += tp_width_phases(dev, gen, small)
    return phases


# -- the main path ---------------------------------------------------------------

def counters():
    from fcd_tpu_torch.kernels import (
        block_conv,
        conv_finish,
        conv_wgrad,
        dsa_attention,
        finale,
        finale_head,
        pool,
        pool2x,
        spatial_attn,
        sw_io,
        upsample,
    )

    return {"conv3d": block_conv.conv3x3,
            "conv3d_wgrad": conv_wgrad.conv3d_wgrad,
            "finale_pool": pool.finale_pool, "finale_bwd": finale.finale_bwd,
            "upsample2x": upsample.upsample2x,
            "dsa_phase_a": dsa_attention.dsa_phase_a,
            "dsa_phase_b": dsa_attention.dsa_phase_b,
            "dsa_phase_a_f32": dsa_attention.PHASE_A_F32,
            "dsa_phase_b_f32": dsa_attention.PHASE_B_F32,
            "dsa_phase_a_f16": dsa_attention.PHASE_A_F16,
            "dsa_phase_b_f16": dsa_attention.PHASE_B_F16,
            "spatial_attn_fwd": spatial_attn.spatial_attn_fwd,
            "spatial_attn_bwd": spatial_attn.spatial_attn_bwd,
            "spatial_attn_fwd_f32": spatial_attn.FWD_F32,
            "spatial_attn_bwd_f32": spatial_attn.BWD_F32,
            "spatial_attn_fwd_f16": spatial_attn.FWD_F16,
            "spatial_attn_bwd_f16": spatial_attn.BWD_F16,
            "sw_entry": sw_io.sw_entry, "sw_exit": sw_io.sw_exit,
            "max_pool2x": pool2x.max_pool2x,
            "max_pool2x_bwd": pool2x.max_pool2x_bwd,
            "finale_head": finale_head.finale_head,
            "conv3d_partial": block_conv.conv3x3_partial,
            "conv_finish": conv_finish.conv_finish}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


# launches per 128^3 patch: 23 res blocks x 2 convs, 23 finales, 5
# upsamples, 12 DSA calls (4 levels x 3 layers) per phase
PER_PATCH = {"conv3d": 46, "conv3d_wgrad": 0, "finale_pool": 23,
             "finale_bwd": 0, "upsample2x": 5, "dsa_phase_a": 12,
             "dsa_phase_b": 12, "dsa_phase_a_f32": 0, "dsa_phase_b_f32": 0,
             "dsa_phase_a_f16": 0, "dsa_phase_b_f16": 0,
             "spatial_attn_fwd": 0, "spatial_attn_bwd": 0,
             "spatial_attn_fwd_f32": 0, "spatial_attn_bwd_f32": 0,
             "spatial_attn_fwd_f16": 0, "spatial_attn_bwd_f16": 0,
             "sw_entry": 0, "sw_exit": 0, "max_pool2x": 0,
             "max_pool2x_bwd": 0, "finale_head": 0,
             "conv3d_partial": 0, "conv_finish": 0}
# and per volume: the engine's entry and exit
PER_VOLUME = {"sw_entry": 1, "sw_exit": 1}

# the gated paths: encoders 1-2 pool in a pass of their own (B3; B9 in
# training), or the last decoder's finale runs fused with the head (B15)
POOL_GATES = {"FCD_FINALE_POOL": "0", "FCD_FINALE_TRAIN": "0"}
HEAD_GATES = {"FCD_FUSED_HEAD": "1"}


def per_volume(n_patches: int, perf_flags=None, per_patch=None,
               entry: bool = True) -> dict:
    """Launches of one sliding-window inference over n_patches patches
    under perf_flags (POOL_GATES, HEAD_GATES or the defaults), of
    MS_DSA_NET or of the model whose `per_patch` counts are given;
    `entry` False: the volume entry of use_amp=False (a pad, no B17)."""
    patch = dict(PER_PATCH if per_patch is None else per_patch)
    if perf_flags == POOL_GATES:
        patch["max_pool2x"] = 2
    elif perf_flags == HEAD_GATES:
        patch["finale_pool"] -= 1
        patch["finale_head"] = 1
    out = {k: v * n_patches for k, v in patch.items()}
    out.update(PER_VOLUME)
    if not entry:
        out["sw_entry"] = 0
    return out


def per_train_step(perf_flags=None) -> dict:
    """Launches of one MS_DSA_NET train step, from the model's structure:
    6 encoders (the first convolves the image, which needs no gradient),
    4 levels x 3 transformer conv blocks (one part each) and 5
    decoders (two parts: upsample and skip).
    Forward: 2 convs, 1 finale per block; 5 upsamples; one spatial tail
    per transformer. Backward: per block, conv2's data gradient and one
    per conv1 part whose input needs one (B1), one weight gradient per
    part of conv1 and one for conv2 (K1), the finale's (K2); the
    spatial tails' (K4). The upsample backward is two matmuls. Under
    POOL_GATES encoders 1-2 also pool in a pass of their own (B3, B9)."""
    own_pass = 2 if perf_flags == POOL_GATES else 0   # encoders 1-2
    return unet_step(6, 4 * 3, 5, own_pass=own_pass)


def unet_step(enc, tb, dec, upsample=True, spatial=True, own_pass=0):
    """per_train_step's count for a U-Net of `enc` encoders, `tb`
    transformer conv blocks and `dec` decoders (MS_DSA_NET, MS_DSA_NET_PS:
    upsample False, its pixelshuffle convs are F.conv3d; BaseUNet: tb 0;
    spatial False for sa_type 'channel')."""
    blocks = enc + tb + dec
    dgrad = 1 + 2 * (enc - 1) + 2 * tb + 3 * dec
    out = {k: 0 for k in PER_PATCH}
    out.update(conv3d=2 * blocks + dgrad,
               conv3d_wgrad=2 * enc + 2 * tb + 3 * dec,
               finale_pool=blocks, finale_bwd=blocks,
               upsample2x=dec if upsample else 0,
               spatial_attn_fwd=tb if spatial else 0,
               spatial_attn_bwd=tb if spatial else 0,
               max_pool2x=own_pass, max_pool2x_bwd=own_pass)
    return out


def unet_patch(enc, tb, dec, upsample=True):
    """PER_PATCH's count for such a U-Net: two convs and a finale a block,
    one upsample a decoder (the transposed conv), both B5 phases a
    transformer."""
    out = dict(PER_PATCH)
    out.update(conv3d=2 * (enc + tb + dec), finale_pool=enc + tb + dec,
               upsample2x=dec if upsample else 0, dsa_phase_a=tb,
               dsa_phase_b=tb)
    return out


def segres_counts(blocks_down=(1, 2, 2, 4), blocks_up=(1, 1, 1), levels=2,
                  layers=3, vae=False, spatial=True):
    """(per patch, per train step) launches of a SegResNet_DSA-family model
    (pixelshuffle): two B1 convs a ResBlock and a transformer's conv block,
    a finale (B2) a transformer, both B5 phases a transformer at eval;
    in training one data gradient (B1) and one weight gradient (K1) a
    conv (every block input needs a gradient: convInit's output does), a
    K2 a finale, K3 and K4 a transformer (not for 'channel'). The VAE
    branch runs the decoder's ResBlocks a second time in training."""
    res, tb = sum(blocks_down) + sum(blocks_up), levels * layers
    patch = dict(PER_PATCH)
    patch.update(conv3d=2 * (res + tb), finale_pool=tb, upsample2x=0,
                 dsa_phase_a=tb, dsa_phase_b=tb)
    again = sum(blocks_up) if vae else 0
    step = {k: 0 for k in PER_PATCH}
    step.update(conv3d=4 * (res + tb + again),
                conv3d_wgrad=2 * (res + tb + again), finale_pool=tb,
                finale_bwd=tb, spatial_attn_fwd=tb if spatial else 0,
                spatial_attn_bwd=tb if spatial else 0)
    return patch, step


# bf16 activations rounded through ~50 layers against an fp32 forward: on
# an H100 this seeded patch measured rel 2.3e-2 to 2.5e-2 and argmax
# agreement 0.9988; the limits leave 2x margin on the error
PATCH_REL_TOL = 0.05
PATCH_ARGMAX_AGREE = 0.99


def redraw_attention(model, seed):
    """gamma (1e-6) and the zero pos-embed of every transformer block
    redrawn from a seeded generator, so that the DSA path contributes to
    the logits a check compares."""
    import torch

    from fcd_tpu_torch.ops.attention import TransformerBlock

    gen = torch.Generator().manual_seed(seed)
    blocks = [m for m in model.modules() if isinstance(m, TransformerBlock)]
    with torch.no_grad():
        for blk in blocks:
            blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape, generator=gen))
            blk.pos_embed.copy_(0.1 * torch.randn(blk.pos_embed.shape,
                                                  generator=gen))


def calibrate_batch_norms(model, x) -> None:
    """The running statistics of the model's batch norms (its transformers'
    conv branches) set to the batch statistics of x: one train-mode
    forward with momentum 0 and dropout off, then the model's own momentum
    and rates back. A trained model has such statistics; the init's are
    placeholders (mean 0, var 1). In SegResNet_DSA the transformers sit
    on the residual stream, and under the placeholders each one's conv
    branch grows the stream ~2.4x in std, six times over: bf16's rounding
    on that range then flips the argmax of ~1% of a random-weight patch
    against the fp32 forward (0.98958 on an H100, 0.98968 in bf16 on the
    CPU: the rounding, not the kernels); with the statistics of another
    patch of the volume, 0.99310 on the CPU in bf16."""
    import torch

    from fcd_tpu_torch.ops.attention import ChannelDropout3d
    from fcd_tpu_torch.ops.layers import BatchNorm

    saved = {}
    for m in model.modules():
        if isinstance(m, BatchNorm):
            saved[m] = ("momentum", m.momentum)
            m.momentum = 0.0
        elif hasattr(m, "dropout_rate"):
            saved[m] = ("dropout_rate", m.dropout_rate)
        elif isinstance(m, ChannelDropout3d):
            saved[m] = ("rate", m.rate)
    dropout_off(model)
    model.train()
    with torch.no_grad():
        model(x)
    model.eval()
    for m, (name, value) in saved.items():
        setattr(m, name, value)


def slice_run(dev, card, params=None, vol_shape=(182, 218, 182),
              per_patch=None, calibrate=False):
    """ModelTrainer.inference on a seeded volume: ms/volume, launches per
    volume (held to `per_patch` x patches + the engine's entry and exit;
    MS_DSA_NET's by default), one patch against the fp32 CPU forward.
    `calibrate`: the batch norms' running statistics from the volume's
    last patch first (calibrate_batch_norms)."""
    import numpy as np
    import torch

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.infer.sliding_window import dense_patch_starts
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params() if params is None else params
    trainer = ModelTrainer(params, device=dev)
    # weights from the trainer's seeded initialisation, the attention's
    # redrawn
    redraw_attention(trainer.model, SEED + 1)
    vol = np.random.RandomState(SEED).standard_normal(
        (*vol_shape, params["chans_in"])).astype(np.float32)
    roi = (params["patch_size"],) * 3
    if calibrate:
        calibrate_batch_norms(trainer.model, torch.from_numpy(
            vol[-roi[0]:, -roi[1]:, -roi[2]:])[None].to(dev))
    n_patches = len(dense_patch_starts(vol_shape, roi, params["sw_overlap"]))

    t0 = time.perf_counter()
    trainer.inference(vol)
    sync(dev)
    first_s = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    out = trainer.inference(vol)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()

    print(f"slice: ModelTrainer.inference ({params['model_type']}) "
          f"{vol_shape}x{params['chans_in']} "
          f"volume, {n_patches} patches of {roi}: {ms:.1f} ms/volume, "
          f"{1e3 / ms:.3f} vol/s on {card} (first call, incl. JIT: "
          f"{first_s:.1f} s)", flush=True)
    if tuple(out.shape) != (*vol_shape, params["chans_out"]) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"logits {tuple(out.shape)} {out.dtype}: not "
                             "finite f32 of the volume's shape")
    want = per_volume(n_patches, per_patch=per_patch,
                      entry=trainer.entry_dtype == torch.bfloat16)
    print(f"  launches {launches} (expected {want}; per patch "
          f"{ {k: v for k, v in (per_patch or PER_PATCH).items() if v} })")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    # one patch: the card's logits against the port's fp32 CPU forward
    patch = torch.from_numpy(vol[:roi[0], :roi[1], :roi[2]])[None]
    patch_check(dev, trainer, patch)
    return launches, trainer, patch, vol, out


def patch_check(dev, trainer, patch, label=""):
    """One patch: the card's logits (trainer.predict) against the port's
    fp32 CPU forward of the same weights; rel <= PATCH_REL_TOL and argmax
    agreement >= PATCH_ARGMAX_AGREE. A trainer that computes in f32 (the
    f32 route, C18) is held against the f32 route on the CPU (its model
    copied, route and all) at F32_PATCH_REL_TOL and F32_ARGMAX_AGREE; one
    that computes in f16 (C20) against the fp32 CPU forward at
    F16_PATCH_REL_TOL and F16_ARGMAX_AGREE."""
    import torch

    f32 = trainer.compute_dtype == torch.float32
    rel_tol, agree_min = {
        torch.float32: (F32_PATCH_REL_TOL, F32_ARGMAX_AGREE),
        torch.float16: (F16_PATCH_REL_TOL, F16_ARGMAX_AGREE)}.get(
            trainer.compute_dtype, (PATCH_REL_TOL, PATCH_ARGMAX_AGREE))
    roi = tuple(patch.shape[1:4])
    with torch.no_grad():
        got = trainer.predict(patch.to(dev)).float().cpu()
        cpu_model = copy.deepcopy(trainer.model).cpu()
        cpu_model.compute_dtype = torch.float32
        cpu_model.eval()
        t0 = time.perf_counter()
        want_logits = cpu_model(patch)
        if isinstance(want_logits, tuple):   # a VAE model: (logits, None)
            want_logits = want_logits[0]
        cpu_s = time.perf_counter() - t0
    a, r = rel_err(got, want_logits)
    agree = float((got.argmax(-1) == want_logits.argmax(-1)).float().mean())
    ok = r <= rel_tol and agree >= agree_min
    route = "f32 route" if f32 else "fp32"
    print(f"  {label}patch {roi} vs {route} CPU forward ({cpu_s:.1f} s): "
          f"max_abs_err {a:.3e} rel {r:.3e} (tol {rel_tol}), argmax "
          f"agreement {agree:.5f} (min {agree_min}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}card logits disagree with the fp32 CPU "
                             "forward")


# The f32 route on the card (cuDNN's convs in IEEE f32, B5's f32 instances)
# against the same route on the CPU: the same f32 function, sums taken in
# other orders through ~50 layers
F32_PATCH_REL_TOL = 1e-4
F32_ARGMAX_AGREE = 0.999
# f16 activations (3 more mantissa bits than bf16) through the same ~50
# layers against the fp32 forward: on an H100 this seeded patch measured
# rel 3.504e-3 and argmax agreement 0.99983; ~3x margin on the error
F16_PATCH_REL_TOL = 1e-2
F16_ARGMAX_AGREE = 0.999


# The fused head adds its f32 bias before one rounding, the default head
# rounds the product and then the sum with the bias in bf16: the logits
# differ by up to about one bf16 ulp of the logits' scale.
HEAD_REL_TOL = 1e-2
HEAD_ARGMAX_AGREE = 0.999


def gated_inference_run(dev, card, base, vol, want) -> dict:
    """ModelTrainer.inference under POOL_GATES and under HEAD_GATES, with
    the default run's weights (`base`, its logits `want`) on the same
    volume. Returns {path: launch counts}."""
    import torch

    from fcd_tpu_torch.infer.sliding_window import dense_patch_starts
    from fcd_tpu_torch.train.trainer import ModelTrainer

    roi = (base.params["patch_size"],) * 3
    n_patches = len(dense_patch_starts(vol.shape[:3], roi,
                                       base.params["sw_overlap"]))
    out = {}
    trainers = {"default": base}
    for path, gates in (("inference, pool in its own pass", POOL_GATES),
                        ("inference, fused head", HEAD_GATES)):
        params = copy.deepcopy(base.params)
        params["perf_flags"] = dict(gates)
        trainer = ModelTrainer(params, device=dev)
        trainer.model.load_state_dict(base.model.state_dict())
        trainer.inference(vol)
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        got = trainer.inference(vol)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        print(f"gated: {path} (perf_flags {gates}): {ms:.1f} ms/volume, "
              f"{1e3 / ms:.3f} vol/s on {card}", flush=True)
        expect = per_volume(n_patches, gates)
        print(f"  launches {launches} (expected {expect})")
        if dev.type == "cuda" and launches != expect:
            raise AssertionError(f"{path}: launch counts {launches} != "
                                 f"{expect}")
        if gates == POOL_GATES:
            same = torch_equal(got, want)
            a, _ = rel_err(got, want)
            print(f"  logits vs the default path: bit-equal {same} "
                  f"(max_abs_err {a:.3e}) {'ok' if same else 'FAIL'}",
                  flush=True)
            if not same:
                raise AssertionError(f"{path}: logits differ from the "
                                     "default path's")
        else:
            a, r = rel_err(got, want)
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            ok = r <= HEAD_REL_TOL and agree >= HEAD_ARGMAX_AGREE
            print(f"  logits vs the default path: max_abs_err {a:.3e} rel "
                  f"{r:.3e} (tol {HEAD_REL_TOL}), argmax agreement "
                  f"{agree:.6f} (min {HEAD_ARGMAX_AGREE}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{path}: logits disagree with the "
                                     "default path's")
        out[path] = launches
        trainers[path] = trainer
        del got
    times = {n: [] for n in trainers}
    for name in (list(trainers) + list(trainers)[::-1]) * 2:
        sync(dev)
        t0 = time.perf_counter()
        trainers[name].inference(vol)
        sync(dev)
        times[name].append((time.perf_counter() - t0) * 1e3)
    print(f"inference A/B on {card}, ms/volume in turns: " + "; ".join(
        f"{n} {[round(t, 1) for t in ts]}" for n, ts in times.items()),
        flush=True)
    return out


# -- the segmentation CLI -------------------------------------------------------

CLI_NATIVE = (176, 240, 256)           # native grid of the synthetic subject
CLI_SPACING = (1.0, 0.9375, 0.9375)    # mm; x points left (LAS)


def write_subject(root: str, params, shape=CLI_NATIVE, seed=SEED + 4):
    """A seeded synthetic subject: smooth T1 and FLAIR volumes and a
    spherical lesion label as NIfTI on an LAS grid, so that the RAS flip,
    the 1 mm resampling and its inverse all do work. Returns its affine."""
    import numpy as np
    from scipy import ndimage

    from fcd_tpu_torch.data import nifti

    rng = np.random.RandomState(seed)
    d = os.path.join(root, "sub01")
    os.makedirs(d, exist_ok=True)
    aff = np.diag([-CLI_SPACING[0], CLI_SPACING[1], CLI_SPACING[2], 1.0])
    aff[:3, 3] = (90.0, -126.0, -72.0)
    coarse = tuple(v // 8 for v in shape)
    images = []
    for seq in params["seq"].split("+"):
        img = ndimage.zoom(rng.normal(size=coarse), 8, order=1) * 40 + 100
        images.append(img.astype(np.float32))
        nifti.save(os.path.join(d, f"{seq}.nii.gz"), images[-1], aff)
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    c = [v // 2 for v in shape]
    gt = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) < \
        (shape[0] // 8) ** 2
    nifti.save(os.path.join(d, "gt_reg.nii.gz"), gt.astype(np.uint8), aff)
    return aff, np.stack(images, axis=-1)


# The CLI's logits against a direct ModelTrainer.inference of the same
# array: bit-equal, since the forward takes its sums in a fixed order. A
# second direct run tells whether the forward is reproducible on this
# card; only if it is not are the logits held to the bf16 patch check's
# limits instead (a wrong array, weight or transform moves them by O(1)).
CLI_REL_TOL = PATCH_REL_TOL
CLI_ARGMAX_AGREE = PATCH_ARGMAX_AGREE
CLI_LESION_SHARE = 0.2   # of a patch, through the head bias (see cli_run)


def cli_run(dev, card, params=None, native_shape=CLI_NATIVE):
    """fcd_tpu_torch.cli.infer.run_inference on the card, on one synthetic
    subject and the seeded model (fs16 by default) written as a checkpoint.
    Returns the launch counts of the run."""
    import shutil

    import numpy as np
    import torch

    from fcd_tpu_torch.cli import infer as cli
    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.data import nifti
    from fcd_tpu_torch.data.preprocess import scale_channels
    from fcd_tpu_torch.infer.sliding_window import dense_patch_starts
    from fcd_tpu_torch.postproc import native
    from fcd_tpu_torch.train.checkpoint import save_checkpoint
    from fcd_tpu_torch.weights import export_flax_variables

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    params = get_default_params() if params is None else params
    params["chans_in"] = len(params["seq"].split("+"))
    aff, images = write_subject(os.path.join(root, "data"), params,
                                native_shape)
    # the seeded model, with gamma and the pos-embed redrawn as in the
    # inference slice, written in the JAX package's checkpoint format. At
    # random weights the mask would be empty; the head bias is shifted so
    # that CLI_LESION_SHARE of a central patch (fp32 on the CPU) is lesion,
    # so the mask, the post-processing and Dice/IoU have something to do.
    model = cli.ModelTrainer(params, device="cpu").model
    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for stack in model.transformers:
            for blk in stack:
                blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape, generator=gen))
                blk.pos_embed.copy_(0.1 * torch.randn(blk.pos_embed.shape,
                                                      generator=gen))
        roi = (params["patch_size"],) * 3
        lo = [(s - r) // 2 for s, r in zip(native_shape, roi)]
        patch = scale_channels(images[lo[0]:lo[0] + roi[0], lo[1]:lo[1] + roi[1],
                                      lo[2]:lo[2] + roi[2]])
        logit = model(torch.from_numpy(patch)[None])
        margin = (logit[..., 1] - logit[..., 0]).flatten()
        model.head_bias[1] -= torch.quantile(margin, 1 - CLI_LESION_SHARE)
    ckpt = os.path.join(root, "model.msgpack")
    save_checkpoint(ckpt, export_flax_variables(model), epoch=0)

    # keep what the CLI's engine got and gave, for the direct call below
    seen = []
    engine = cli.ModelTrainer.inference

    def inference(self, volume):
        out = engine(self, volume)
        seen.append((np.array(volume, copy=True), out.clone()))
        return out

    cli.ModelTrainer.inference = inference
    timings = {}
    try:
        reset_counts()
        t0 = time.perf_counter()
        metrics = cli.run_inference(os.path.join(root, "data"),
                                    os.path.join(root, "out"), ckpt, params,
                                    device=dev, timings=timings)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        cli.ModelTrainer.inference = engine
    (volume, logits), = seen
    t = timings["sub01"]
    print(f"cli: run_inference, one subject {native_shape} native -> "
          f"{volume.shape} at 1 mm: {wall:.2f} s in all on {card}; per phase "
          + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
          + f"; post-processing path {native.backend()}", flush=True)

    seg = nifti.load(os.path.join(root, "out", "sub01", "sub01_seg.nii.gz"))
    if seg.data.shape != native_shape or not np.array_equal(seg.affine, aff) \
            or not set(np.unique(seg.data)) <= {0.0, 1.0}:
        raise AssertionError(f"saved mask {seg.data.shape}, affine "
                             f"{seg.affine.tolist()}: not a 0/1 native mask")
    m = metrics["sub01"]
    print(f"  mask {seg.data.shape} of {int(seg.data.sum())} voxels, Dice "
          f"{m['dice']:.4f}, IoU {m['iou']:.4f}")
    if not (math.isfinite(m["dice"]) and math.isfinite(m["iou"])) or \
            seg.data.sum() == 0:
        raise AssertionError(f"empty mask or Dice/IoU not finite: {m}")
    n_patches = len(dense_patch_starts(volume.shape[:3], roi,
                                       params["sw_overlap"]))
    want = per_volume(n_patches)
    print(f"  launches {launches} (expected {want}, {n_patches} patches)")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"cli launch counts {launches} != {want}")

    trainer = cli.ModelTrainer(params, device=dev)
    trainer.load_model(ckpt)
    direct = trainer.inference(volume)
    again = trainer.inference(volume)
    same = torch_equal(direct, logits)
    a, r = rel_err(logits, direct)
    a2, r2 = rel_err(again, direct)
    cls = direct.argmax(-1)
    agree = float((logits.argmax(-1) == cls).float().mean())
    agree2 = float((again.argmax(-1) == cls).float().mean())
    reproducible = torch_equal(again, direct)
    ok = same or (not reproducible and r <= CLI_REL_TOL
                  and agree >= CLI_ARGMAX_AGREE)
    print(f"  logits {tuple(logits.shape)} vs a direct ModelTrainer.inference"
          f" of the same array: bit-equal {same}, max_abs_err {a:.3e} rel "
          f"{r:.3e} (tol {CLI_REL_TOL}), argmax agreement {agree:.6f} (min "
          f"{CLI_ARGMAX_AGREE}); a second direct run: bit-equal "
          f"{reproducible}, max_abs_err {a2:.3e} rel {r2:.3e}, "
          f"argmax agreement {agree2:.6f} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the CLI's logits differ from direct inference")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# -- the training CLI ---------------------------------------------------------

AUG_SHAPE = (4, 128, 128, 128, 2)   # the train step's batch
AUG_REL_TOL = 1e-5                  # the rotated image, card against CPU


def _sphere_labels(shape, dev, radius):
    """(B, D, H, W, 1) f32 labels: a ball of `radius` voxels about each
    sample's centre, shifted by 4 voxels a sample."""
    import torch

    b, d, h, w = shape[:4]
    out = torch.zeros((b, d, h, w, 1), device=dev)
    zz, yy, xx = torch.meshgrid(*(torch.arange(n, device=dev, dtype=torch.float32)
                                  for n in (d, h, w)), indexing="ij")
    for i in range(b):
        c = [n / 2 + 4 * i - 6 for n in (d, h, w)]
        out[i, ..., 0] = (((zz - c[0]) ** 2 + (yy - c[1]) ** 2
                           + (xx - c[2]) ** 2) < radius ** 2).float()
    return out


def augment_phase(dev, gen, shape=AUG_SHAPE, iters=5):
    """`apply_augment` (data/augment.py, PyTorch on the card) at the train
    step's batch against the same function on the CPU, on the same draws
    and noise, with every transform on: without the rotation the images
    and labels bit-equal, with it (a nonzero angle a sample) the image
    within AUG_REL_TOL and the labels equal. Timed by the device time of
    all one call launches, beside the bytes bound (images, labels and
    noise read once, images and labels written once). Returns ms."""
    import torch

    from fcd_tpu_torch.data.augment import apply_augment, draw_augment

    b = shape[0]
    images = torch.randn(shape, generator=gen, device=dev)
    labels = _sphere_labels(shape, dev, shape[1] / 5)
    noise = torch.randn(shape, generator=gen, device=dev)
    base = draw_augment(b, shape[1:4], torch.Generator().manual_seed(SEED + 6),
                        1.0, 1.0)
    on = torch.ones(b, dtype=torch.bool)
    host = [t.cpu() for t in (images, labels, noise)]
    for rotate in (False, True):
        draws = base._replace(rotate=on if rotate else ~on, shift_on=on,
                              noise_on=on, dropout_on=on, gridmask_on=on)
        gi, gl = apply_augment(images, labels, draws, noise)
        wi, wl = apply_augment(*host[:2], draws, host[2])
        a, r = rel_err(gi.cpu(), wi)
        label_ok = torch_equal(gl.cpu(), wl)
        image_ok = r <= AUG_REL_TOL if rotate else torch_equal(gi.cpu(), wi)
        what = ("rotation (angles " + ", ".join(
            f"{float(x):.3f}" for x in draws.angle) + "), "
                if rotate else "no rotation, ")
        print(f"augment {shape}: {what}flips {draws.flip.int().tolist()}, "
              f"shift, noise, dropout, GridMask on: image max_abs_err "
              f"{a:.3e} rel {r:.3e} ({'tol ' + str(AUG_REL_TOL) if rotate else 'bit-equal'}) "
              f"{'ok' if image_ok else 'FAIL'}, labels equal "
              f"{'ok' if label_ok else 'FAIL'}", flush=True)
        if not (image_ok and label_ok):
            raise AssertionError("apply_augment on the card disagrees with "
                                 "the CPU")
    if dev.type != "cuda":
        return 0.0

    def per_call(fn):
        """Mean device ms of one call over `iters` traces of one call each
        (a trace of several back-to-back calls of this chain of small ops
        did not hold each op `iters` times on the card)."""
        return sum(sum(device_times(fn, 1).values())
                   for _ in range(iters)) / iters

    ms = per_call(lambda: apply_augment(images, labels, draws, noise))
    n = images.numel()
    nbytes = 4 * (n + n // shape[-1] + n) + 4 * (n + n // shape[-1])
    bound = nbytes / PEAK_BYTES * 1e3
    devgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    drawn = per_call(lambda: apply_augment(images, labels, draws,
                                           generator=devgen))
    wall = timed_ms(lambda: apply_augment(images, labels, draws, noise),
                    iters)
    print(f"augment {shape}: {ms:.4f} ms device (wall {wall:.4f} per call), "
          f"noise drawn on the card {drawn:.4f} ms device; bound "
          f"{bound:.4f} ms (bytes), roofline share {100 * bound / ms:.2f}% "
          f"on {card_line()}", flush=True)
    return ms


TRAIN_CLI_SHAPE = (160, 192, 160)   # 1 mm RAS: 8 patches of 128^3
TRAIN_CLI_SPLIT = (("sub01", "train"), ("sub02", "train"), ("sub03", "train"),
                   ("sub04", "val"), ("sub05", "test"))
# max probabilities 1.0: the ramp (scheduled_probs) gives 0 in the first
# of two epochs and 0.5 in the second, so every transform runs there
TRAIN_CLI_KWARGS = ("max_epochs=2", "keep_latest_model=True",
                    "coarse_dropout_max_prob=1.0", "gridmask_max_prob=1.0")


def write_train_set(root: str, params, shape=TRAIN_CLI_SHAPE) -> str:
    """TRAIN_CLI_SPLIT's subjects: seeded smooth T1 and FLAIR volumes, the
    FLAIR brighter in a spherical lesion whose label is saved beside
    them, NIfTI at 1 mm RAS; and the split file. Returns its path."""
    import numpy as np
    from scipy import ndimage

    from fcd_tpu_torch.data import nifti

    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for i, (subj, _) in enumerate(TRAIN_CLI_SPLIT):
        rng = np.random.RandomState(SEED + 10 + i)
        d = os.path.join(root, subj, "anat")
        os.makedirs(d, exist_ok=True)
        c = [rng.randint(n // 3, 2 * n // 3) for n in shape]
        gt = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) < 12 ** 2
        for j, seq in enumerate(params["seq"].split("+")):
            img = ndimage.zoom(rng.normal(size=tuple(n // 8 for n in shape)),
                               8, order=1) * 40 + 100 + 60 * j * gt
            nifti.save(os.path.join(d, f"{seq}.nii.gz"), img.astype(np.float32))
        nifti.save(os.path.join(d, "gt_reg.nii.gz"), gt.astype(np.uint8))
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        f.write("".join(f"{s} {k}\n" for s, k in TRAIN_CLI_SPLIT))
    return split


def _csv_rows(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    keys = lines[0].split(",")
    return keys, [dict(zip(keys, line.split(","))) for line in lines[1:]]


def train_cli_run(dev, card, kwargs=TRAIN_CLI_KWARGS, device=None,
                  shape=TRAIN_CLI_SHAPE, per_step=None, per_patch=None,
                  resume=True):
    """`python -m fcd_tpu_torch.cli.train` (cli.train.main) on the card at
    the default model's full width, on a seeded synthetic set written under
    build/ (3 train, 1 val, 1 test subject of TRAIN_CLI_SHAPE): 2 epochs of
    4 x 128^3 steps with augmentation, validation and the best and latest
    checkpoints, then the test without and with post-processing; the
    counters set to 0 just before and read just after. Prints the launch
    counts by phase (held to the per-step and per-volume counts), seconds
    per epoch and phase, and the test metrics; checks finite losses, the
    CSV, the checkpoints, that every transform ran in the second epoch, and
    that a resume with max_epochs=3 appends epoch 3 (with `resume`). The
    counts are held to `per_step` and `per_patch` (MS_DSA_NET's by
    default). Returns the counts."""
    import shutil

    import numpy as np

    from fcd_tpu_torch.cli import train as cli_train
    from fcd_tpu_torch.cli.args import parse_kwargs
    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.infer.sliding_window import dense_patch_starts
    from fcd_tpu_torch.train import trainer as trainer_mod

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_cli")
    shutil.rmtree(root, ignore_errors=True)
    params = parse_kwargs(get_default_params(), list(kwargs))
    data = os.path.join(root, "data")
    split = write_train_set(data, params, shape)
    out = os.path.join(root, "runs")
    argv = ["--data_dir", data, "--split_file", split, "--splits", "train",
            "val", "test", "--save_dir", out, "--prefix", "smoke",
            "--emission_tracking"]
    argv += ["--device", str(device)] if device is not None else []

    # launch counts by phase, and the augmentation's draws, read around the
    # trainer's methods
    by_phase = {"train steps": {}, "validation": {}, "test": {}}
    draws_seen = []
    cls = trainer_mod.ModelTrainer
    orig = (cls.train_step, cls.evaluate, trainer_mod.draw_augment)

    def counted(fn, phase_of):
        def run(*a, **k):
            before = read_counts()
            res = fn(*a, **k)
            acc = by_phase[phase_of(k)]
            for name, v in read_counts().items():
                acc[name] = acc.get(name, 0) + v - before[name]
            return res
        return run

    def recorded(*a, **k):
        draws_seen.append(orig[2](*a, **k))
        return draws_seen[-1]

    cls.train_step = counted(orig[0], lambda k: "train steps")
    cls.evaluate = counted(orig[1], lambda k: "validation" if k.get(
        "desc", "validation") == "validation" else "test")
    trainer_mod.draw_augment = recorded
    timings = {}
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer = cli_train.main(argv + ["--kwargs", *kwargs], timings)
        sync(dev)
        total_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        cls.train_step, cls.evaluate, trainer_mod.draw_augment = orig
    run_dir = trainer.save_dir
    roi = (params["patch_size"],) * 3
    n_patches = len(dense_patch_starts(shape, roi, params["sw_overlap"]))
    steps = sum(t["n_steps"] for t in timings.values())
    epochs = len(timings)
    step = per_train_step() if per_step is None else per_step
    vol = per_volume(n_patches, per_patch=per_patch)
    want = {"train steps": {k: steps * v for k, v in step.items()},
            "validation": {k: epochs * v for k, v in vol.items()},
            "test": {k: 2 * v for k, v in vol.items()}}
    print(f"train_cli: cli.train.main, {params['model_type']} "
          f"fs{params['feature_size']} "
          f"P{params['project_size']}, {epochs} epochs of {steps // epochs} "
          f"steps at {params['batch_size'] * params['samples_per_case']}x"
          f"{roi[0]}^3, validation and test volumes {shape} "
          f"({n_patches} patches): {total_s:.1f} s on {card}", flush=True)
    for phase, counts in by_phase.items():
        ok = counts == want[phase]
        print(f"  launches, {phase}: {counts} (expected {want[phase]}) "
              f"{'ok' if ok else 'FAIL'}")
        if dev.type == "cuda" and not ok:
            raise AssertionError(f"train_cli {phase}: launch counts {counts} "
                                 f"!= {want[phase]}")
    for epoch, t in sorted(timings.items()):
        print(f"  epoch {epoch + 1}: steps {t['steps']:.3f} s "
              f"({t['n_steps']} steps), validation {t['validation']:.3f} s, "
              f"checkpoints and log {t['save_log']:.3f} s")
    for post, metrics in sorted(trainer.test_metrics.items()):
        print(f"  test {'with' if post else 'without'} post-processing: "
              + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    if sorted(trainer.test_metrics) != [False, True]:
        raise AssertionError("train_cli: the test did not run twice")
    second = [d for d in draws_seen[steps // epochs:]]
    ran = {name: any(bool(getattr(d, name).any()) for d in second)
           for name in ("flip", "rotate", "shift_on", "noise_on", "dropout_on",
                        "gridmask_on")}
    print(f"  transforms drawn in epoch 2: {ran}")
    if not all(ran.values()):
        raise AssertionError(f"train_cli: not every transform ran in epoch 2 "
                             f"({ran})")
    keys, rows = _csv_rows(os.path.join(run_dir, "training_log.csv"))
    losses = [float(r[k]) for r in rows for k in ("train_loss", "val_loss")]
    files = {n: os.path.exists(os.path.join(run_dir, n))
             for n in ("best_model.msgpack", "latest_model.msgpack")}
    ok = (len(rows) == 2 and all(np.isfinite(losses)) and all(files.values())
          and keys[:4] == ["epoch", "train_loss", "val_loss", "ema_val_loss"])
    print(f"  CSV {keys}: {len(rows)} epochs, losses {losses}, checkpoints "
          f"{files} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("train_cli: the CSV, the losses or the "
                             "checkpoints are not as expected")
    # --emission_tracking: the JAX columns, the card's power limit
    with open(os.path.join(run_dir, "train_emission.csv")) as f:
        emission = list(csv.reader(f))
    envelope = ("power.limit of" if dev.type == "cuda" else "cpu envelope")
    ok = (len(emission) == 2 and emission[0][3] == "assumed_device_power_w"
          and envelope in emission[1][-1])
    print(f"  train_emission.csv: {dict(zip(emission[0], emission[1]))} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("train_cli: the emissions CSV is not as "
                             "expected")
    if not resume:
        return launches
    resume = argv[:argv.index("--splits")] + [
        "--splits", "train", "val", "--save_dir", run_dir, "--resume"] + (
        ["--device", str(device)] if device is not None else [])
    t0 = time.perf_counter()
    cli_train.main(resume + ["--kwargs", *[
        "max_epochs=3" if k.startswith("max_epochs") else k for k in kwargs]])
    # as the JAX trainer does, a resumed run starts the CSV anew (its
    # header and the new epochs): epoch 3 must be there
    _, rows = _csv_rows(os.path.join(run_dir, "training_log.csv"))
    ok = [r["epoch"] for r in rows][-1:] == ["3"]
    print(f"  resume with max_epochs=3 ({time.perf_counter() - t0:.1f} s): "
          f"epochs in the CSV {[r['epoch'] for r in rows]} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("train_cli: the resume did not append epoch 3")
    return launches


PROFILE_KEYS = ("conv3d_kernel", "wgrad_mma_kernel", "wgrad_sum_kernel",
                "finale_bwd",
                "finale_kernel", "upsample_kernel", "dsa_phase_a",
                "dsa_phase_b", "dsa_f32_phase_a", "dsa_f32_phase_b",
                "spatial_attn_fwd", "spatial_attn_bwd",
                "sw_entry_kernel", "sw_exit_kernel", "pool_fwd_kernel",
                "pool2x_bwd_kernel", "finale_head_kernel")


def profile_run(label, fn, dev) -> dict:
    """Where one call of fn spends the card's time: device time by kernel
    (torch.profiler) and the device's idle share of the synchronised wall
    time, after a warm-up call, from a whole trace only (`whole_trace`:
    a trace of one call is kept when another one agrees with it op for
    op, up to ten tries): with none the phase fails and prints no
    breakdown. Returns {kernel key: device ms}; on a CPU run {} (not
    measured)."""
    from fcd_tpu_torch.kernels._sweep import whole_trace

    if dev.type != "cuda":
        print(f"profile: {label}: no card, not measured")
        return {}
    fn()
    sync(dev)
    events, wall_s = whole_trace(fn, 1, tries=10, cpu=True)
    by_name = {}
    for e in events:
        key = next((k for k in PROFILE_KEYS if k in e.name), e.name[:60])
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    busy, wall_us = sum(us for _, us in by_name.values()), wall_s * 1e6
    print(f"profile: {label}, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share "
          f"{100 * max(0.0, 1 - busy / wall_us):.1f}%, "
          f"{len(events)} device kernels (a whole trace)")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% {n:5d}x {key}")
    return {k: us / 1e3 for k, (_, us) in by_name.items()}


def print_share(prof, label, keys) -> None:
    """The device ms of `keys` in a profile_run result, and their share of
    its device-busy time."""
    if prof:
        ms, busy = sum(prof.get(k, 0.0) for k in keys), sum(prof.values())
        print(f"  {label}: {ms:.3f} ms of {busy:.2f} ms device busy "
              f"({100 * ms / busy:.1f}%)")


# -- the training path ---------------------------------------------------------

TRAIN_BATCH, TRAIN_STEPS = 4, 3


# the source paper's total-variation regularised training, as README's
# example sets it, with the border band excluded (so the binary dilation
# runs on the card); and the rest of the loss family and the optimizer
# options, held against the CPU in train_check
TV_PARAMS = {"tv_loss_weight": 0.1, "tvloss_exclude_borders": True}
GDF_PARAMS = {"loss": "GeneralizedDiceFocalLoss", "boundaryloss_weight": 0.1}
ACCUM_PARAMS = {"gradient_accumulation_steps": 2}


def train_params(patch_size=128, perf_flags=None, extra=None):
    from fcd_tpu_torch.config import get_default_params

    params = get_default_params()
    params.update(patch_size=patch_size, loss="DiceCELoss",
                  perf_flags=dict(perf_flags or {}))
    params.update(extra or {})
    return params


def train_batch(dev, batch, size, chans):
    """A seeded batch made on the device, as bench.py makes its batch:
    uniform images, labels rand > 0.95."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.rand((batch, size, size, size, chans), generator=gen,
                   device=dev)
    y = (torch.rand((batch, size, size, size, 1), generator=gen,
                    device=dev) > 0.95).float()
    return x, y


def train_run(dev, card, perf_flags=None, extra=None, per_step=None):
    """The train step at batch 4 x 128^3 (under perf_flags, with the params
    in `extra`): warm-up, then timed steps with the launch counters read
    around them, held to `per_step` (MS_DSA_NET's per_train_step by
    default)."""
    import torch

    from fcd_tpu_torch.train.schedule import epoch_lr
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = train_params(perf_flags=perf_flags, extra=extra)
    trainer = ModelTrainer(params, device=dev)
    lr = epoch_lr(params, params["warmup_epochs"])
    x, y = train_batch(dev, TRAIN_BATCH, params["patch_size"],
                       params["chans_in"])
    with torch.enable_grad():
        t0 = time.perf_counter()
        losses = [trainer.train_step(x, y, lr)]
        sync(dev)
        first_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(trainer.train_step(x, y, lr))
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        launches = read_counts()
    vals = [float(v) for v in losses]
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else 0.0)
    print(f"train: ModelTrainer.train_step (perf_flags "
          f"{params['perf_flags']}{', ' + str(extra) if extra else ''}), "
          f"batch {TRAIN_BATCH}x{params['patch_size']}^3x"
          f"{params['chans_in']}, {params['loss']}, AdamW lr {lr:g}: "
          f"{ms:.1f} ms/step, "
          f"{TRAIN_BATCH * 1e3 / ms:.3f} patches/s on {card} (first step, "
          f"incl. JIT: {first_s:.1f} s; peak memory {peak_gb:.1f} GB); "
          f"losses {[round(v, 5) for v in vals]}", flush=True)
    if not all(torch.isfinite(torch.tensor(vals))):
        raise AssertionError(f"train losses not finite: {vals}")
    want = {k: v * TRAIN_STEPS for k, v in (
        per_train_step(perf_flags) if per_step is None else per_step).items()}
    print(f"  launches over {TRAIN_STEPS} steps {launches} (expected {want})")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    return launches, trainer, (x, y, lr)


def train_ab(card, trainers, batch, rounds=2) -> dict:
    """ms/step of each trainer ({path: trainer}) measured in turns on one
    card, A B C C B A per round, TRAIN_STEPS synchronised steps a turn."""
    import torch

    x, y, lr = batch
    names = list(trainers)
    times = {n: [] for n in names}
    with torch.enable_grad():
        for name in (names + names[::-1]) * rounds:
            sync(x.device)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                trainers[name].train_step(x, y, lr)
            sync(x.device)
            times[name].append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
    print(f"train A/B on {card}, ms/step in turns: " + "; ".join(
        f"{n} {[round(t, 1) for t in ts]}" for n, ts in times.items()),
        flush=True)
    return times


# The card's train step (bf16) against the port's fp32 CPU step from the
# same weights, dropout off, at batch 1 x 64^3 (full widths). At random
# weights this model's bf16 gradients are chaotic in the deep layers: on
# the CPU, a 1e-6 change of the input moves the port's own bf16 gradients
# by rel-L2 0.48 at encoder 5, and its bf16 step differs from its fp32 step
# by 0.70 there (cosine 0.76), but by 0.016 at the last decoder. So the
# check holds each parameter group of the card's step to twice the
# distance from fp32 of the port's bf16 CPU step (the kernels' plain
# versions at the kernels' precision), and the loss, the head and the last
# decoder to fixed limits: the values an H100 run measured, with 2x margin.
TRAIN_CHECK_SIZE = 64
TRAIN_LOSS_REL_TOL = 1e-3          # measured 3.7e-4
TRAIN_HEAD_REL_L2_TOL = 3e-3       # head, measured 1.4e-3
TRAIN_LAST_DEC_REL_L2_TOL = 3.4e-2  # decoders.4, measured 1.7e-2
GROUP_MARGIN = 2.0
# zoo_train_check's loss limit where TRAIN_LOSS_REL_TOL is not bf16's own
# distance. UNETR's bf16 step lies ~1.5e-3 from its f32 step in both
# packages, kernels or none: 1.59e-3 on an H100 and 1.53e-3 for the port's
# bf16 CPU step from the same weights and batch; on a CPU batch
# (scripts/zoo_bf16_distance.py) the JAX package's bf16 step 1.513e-3 and
# the port's 1.569e-3 from the same weights. 2x the card's reading.
ZOO_LOSS_REL_TOL = {"UNETR": 3.2e-3}


def _groups(model):
    """{parameter group: [parameters]}: each encoder, embed level,
    transformer level and decoder, and the head."""
    out = {}
    for name, prm in model.named_parameters():
        parts = name.split(".")
        key = ".".join(parts[:2]) if parts[0] in (
            "encoders", "embeds", "transformers", "decoders") else "head"
        out.setdefault(key, []).append(prm)
    return out


def _module_groups(model):
    """{parameter group: [parameters]} of a model with a weight table: each
    top-level flax module; a group of one value (UNet's PReLU_k slopes)
    joins the group before it, since one value has no direction for a
    cosine to measure."""
    from fcd_tpu_torch.weights import model_entries

    out = {}
    for coll, path, t, _ in model_entries(model):
        if coll == "params":
            out.setdefault(path[0], []).append(t)
    merged = {}
    for key, prms in out.items():
        if sum(p.numel() for p in prms) == 1 and merged:
            merged[list(merged)[-1]].extend(prms)
        else:
            merged[key] = prms
    return merged


def _grad_distance(model, ref, groups=_groups) -> dict:
    """{group: (rel-L2, cosine)} of model's gradients against ref's, the
    groups `groups(model)`, on the CPU."""
    import torch

    out = {}
    mg, rg = groups(model), groups(ref)
    for key in mg:
        g = torch.cat([p.grad.float().cpu().ravel() for p in mg[key]])
        w = torch.cat([p.grad.float().cpu().ravel() for p in rg[key]])
        out[key] = (float((g - w).norm() / w.norm()),
                    float(torch.dot(g, w) / (g.norm() * w.norm())))
    return out


def group_rule(d_card, d_bf16, floor=1e-3):
    """(ok, one text a group): each group of the card's step within
    GROUP_MARGIN times the port's bf16 CPU step's distance from the fp32
    step (rel-L2, plus `floor`, and 1 - cosine, plus 1e-4)."""
    ok, lines = True, []
    for key, (rel, cos) in d_card.items():
        ref_rel, ref_cos = d_bf16[key]
        good = (math.isfinite(rel) and math.isfinite(cos)
                and rel <= GROUP_MARGIN * ref_rel + floor
                and 1 - cos <= GROUP_MARGIN * (1 - ref_cos) + 1e-4)
        ok = ok and good
        lines.append(f"{key} {rel:.2e}/{cos:.5f} (bf16 CPU {ref_rel:.2e}/"
                     f"{ref_cos:.5f}){'' if good else ' FAIL'}")
    return ok, lines


def train_check(dev, perf_flags=None, extra=None) -> None:
    """One train step on the card (bf16) against the port's fp32 CPU step
    from the same weights, batch 1 x 64^3 at full widths, all three under
    perf_flags and the params in `extra`; the port's bf16 CPU step gives
    the distance bf16 arithmetic itself takes. With gradient accumulation
    (k micro-steps) each trainer takes k steps on the batch, and the last
    loss and the accumulated gradient are compared."""
    import torch

    from fcd_tpu_torch.train.trainer import ModelTrainer

    size = TRAIN_CHECK_SIZE
    params = train_params(size, perf_flags, extra)
    micro = params["gradient_accumulation_steps"]
    trainers = [ModelTrainer(params, device=d) for d in (dev, "cpu", "cpu")]
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for stack in trainers[0].model.transformers:
            for blk in stack:
                blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape,
                                                  generator=gen))
                blk.pos_embed.copy_(0.1 * torch.randn(blk.pos_embed.shape,
                                                      generator=gen))
    for tr in trainers[1:]:
        tr.model.load_state_dict(trainers[0].model.state_dict())
    trainers[2].model.compute_dtype = torch.bfloat16
    for tr in trainers:
        for stack in tr.model.transformers:
            for blk in stack:
                blk.dsa.dropout_rate = 0.0
                blk.dropout.rate = 0.0
    x, y = train_batch(dev, 1, size, params["chans_in"])
    with torch.enable_grad():
        card, fp32, bf16 = (
            [float(tr.train_step(x if i == 0 else x.cpu(),
                                 y if i == 0 else y.cpu(), 1e-4))
             for _ in range(micro)][-1]
            for i, tr in enumerate(trainers))
    d_card = _grad_distance(trainers[0].model, trainers[1].model)
    d_bf16 = _grad_distance(trainers[2].model, trainers[1].model)
    rel_loss = abs(card - fp32) / abs(fp32)
    ok = math.isfinite(card) and rel_loss <= TRAIN_LOSS_REL_TOL
    ok = ok and d_card["head"][0] <= TRAIN_HEAD_REL_L2_TOL
    ok = ok and d_card["decoders.4"][0] <= TRAIN_LAST_DEC_REL_L2_TOL
    good, lines = group_rule(d_card, d_bf16)
    ok = ok and good
    steps = "step" if micro == 1 else f"step x {micro} micro-steps"
    print(f"train check (perf_flags {params['perf_flags']}"
          f"{', ' + str(extra) if extra else ''}; {params['loss']}): "
          f"1x{size}^3 {steps}, card bf16 vs CPU fp32: loss "
          f"{card:.6f} vs {fp32:.6f} rel {rel_loss:.2e} (tol "
          f"{TRAIN_LOSS_REL_TOL}; the bf16 CPU step {bf16:.6f}); grads "
          f"rel-L2/cosine per group, head {d_card['head'][0]:.2e} (tol "
          f"{TRAIN_HEAD_REL_L2_TOL}), decoders.4 {d_card['decoders.4'][0]:.2e} "
          f"(tol {TRAIN_LAST_DEC_REL_L2_TOL}), every group within "
          f"{GROUP_MARGIN}x the bf16 CPU step's distance "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print("  " + ", ".join(lines))
    if not ok:
        raise AssertionError("the card's train step disagrees with the fp32 "
                             "CPU step")


def train_repro(dev) -> bool:
    """Two train steps from one state (two trainers from the same seeded
    weights, the same batch, the same dropout seeds), batch 1 x 64^3 at
    full widths: whether every parameter after the step, and the loss,
    are the same bits. Reported; the groups that differ are named."""
    import torch

    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = train_params(TRAIN_CHECK_SIZE)
    x, y = train_batch(dev, 1, TRAIN_CHECK_SIZE, params["chans_in"])
    losses, models = [], []
    with torch.enable_grad():
        for _ in range(2):
            tr = ModelTrainer(params, device=dev)
            losses.append(tr.train_step(x, y, 1e-4))
            models.append(tr.model)
            sync(dev)
    groups = [_groups(m) for m in models]
    differ = [k for k in groups[0]
              if not all(torch_equal(a, b) for a, b in zip(groups[0][k],
                                                           groups[1][k]))]
    same = not differ and torch_equal(losses[0], losses[1])
    print(f"train repro: two 1x{TRAIN_CHECK_SIZE}^3 steps from one state, "
          f"same seeds: parameters and loss bit-equal {same}"
          + ("" if same else f"; differ: loss "
             f"{not torch_equal(losses[0], losses[1])}, groups {differ}"),
          flush=True)
    return same


# -- the DSA model family -------------------------------------------------------

SEGRES = {"model_type": "SegResNet_DSA"}       # fs16, P 64, parallel
SEGRES_PATCH, SEGRES_STEP = segres_counts()


def dropout_off(model):
    """Every dropout of a model at rate 0: each module's `dropout_rate`
    (the DSA's attention dropout; UNETR's tokens, attention and MLP;
    SwinUNETR's blocks) and every ChannelDropout3d (the transformers' conv
    branch, SegResNet's after convInit, UNet's and VNet's)."""
    from fcd_tpu_torch.ops.attention import ChannelDropout3d

    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
        elif isinstance(m, ChannelDropout3d):
            m.rate = 0.0


def zoo_train_check(dev, extra) -> None:
    """One 1 x 64^3 train step of the model in `extra` on the card (bf16)
    against the port's fp32 CPU step from the same weights, dropout off,
    with train_check's rule: the loss within TRAIN_LOSS_REL_TOL (the
    model's ZOO_LOSS_REL_TOL where it has one), and each top-level module's
    gradient within GROUP_MARGIN times the distance the port's bf16 CPU
    step (the kernels' plain versions) takes from fp32 (group_rule)."""
    import torch

    from fcd_tpu_torch.train.trainer import ModelTrainer

    size = TRAIN_CHECK_SIZE
    params = train_params(size, extra=extra)
    trainers = [ModelTrainer(params, device=d, verbose=False)
                for d in (dev, "cpu", "cpu")]
    redraw_attention(trainers[0].model, SEED + 3)
    for tr in trainers[1:]:
        tr.model.load_state_dict(trainers[0].model.state_dict())
    trainers[2].model.compute_dtype = torch.bfloat16
    for tr in trainers:
        dropout_off(tr.model)
    x, y = train_batch(dev, 1, size, params["chans_in"])
    with torch.enable_grad():
        card, fp32, bf16 = (
            float(tr.train_step(x if i == 0 else x.cpu(),
                                y if i == 0 else y.cpu(), 1e-4))
            for i, tr in enumerate(trainers))
    d_card, d_bf16 = (_grad_distance(tr.model, trainers[1].model,
                                     _module_groups)
                      for tr in (trainers[0], trainers[2]))
    rel_loss = abs(card - fp32) / abs(fp32)
    tol = ZOO_LOSS_REL_TOL.get(params["model_type"], TRAIN_LOSS_REL_TOL)
    good, lines = group_rule(d_card, d_bf16)
    ok = math.isfinite(card) and rel_loss <= tol and good
    print(f"train check ({params['model_type']}; {params['loss']}): 1x{size}^3 "
          f"step, card bf16 vs CPU fp32: loss {card:.6f} vs {fp32:.6f} rel "
          f"{rel_loss:.2e} (tol {tol}; the bf16 CPU step {bf16:.6f}, rel "
          f"{abs(bf16 - fp32) / abs(fp32):.2e}); grads rel-L2/cosine per "
          f"module, every module within {GROUP_MARGIN}x the bf16 CPU step's "
          f"distance {'ok' if ok else 'FAIL'}", flush=True)
    print("  " + ", ".join(lines))
    if not ok:
        raise AssertionError(f"{params['model_type']}: the card's train step "
                             "disagrees with the fp32 CPU step")


def segresnet_dsa_run(dev, card) -> dict:
    """SegResNet_DSA (fs16, P 64, 4 heads, parallel, blocks (1, 2, 2, 4) /
    (1, 1, 1), pixelshuffle, bf16) through the entry points: inference on
    the seeded volume (launches per patch and per volume), one patch
    against the fp32 CPU forward, the 4 x 128^3 train step (launches per
    step, finite losses), the profiles of a patch and a step, a 1 x 64^3
    step against the fp32 CPU step, and cli.train for two epochs.
    Returns {path: launch counts}."""
    import torch

    params = train_params(extra=SEGRES)
    launches, trainer, patch, vol, _ = slice_run(
        dev, card, params, per_patch=SEGRES_PATCH, calibrate=True)
    by_path = {"segresnet_dsa inference": launches}
    del vol
    x = patch.to(dev)
    profile_run(f"SegResNet_DSA, one {tuple(patch.shape[1:4])} patch "
                "forward", lambda: trainer.predict(x), dev)
    del trainer, x
    torch.cuda.empty_cache()
    by_path["segresnet_dsa train"], trainer, batch = train_run(
        dev, card, extra=SEGRES, per_step=SEGRES_STEP)
    with torch.enable_grad():
        prof = profile_run(f"SegResNet_DSA, one train step, batch "
                           f"{TRAIN_BATCH}x128^3",
                           lambda: trainer.train_step(*batch), dev)
    print_share(prof, "K3 + K4 in the step", ("spatial_attn_fwd",
                                              "spatial_attn_bwd"))
    print_share(prof, "B1 + K1 in the step", ("conv3d_kernel",
                                              "wgrad_mma_kernel",
                                              "wgrad_sum_kernel"))
    del trainer, batch
    torch.cuda.empty_cache()
    zoo_train_check(dev, SEGRES)
    torch.cuda.empty_cache()
    by_path["segresnet_dsa train_cli"] = train_cli_run(
        dev, card, kwargs=TRAIN_CLI_KWARGS + ("model_type=SegResNet_DSA",),
        per_step=SEGRES_STEP, per_patch=SEGRES_PATCH, resume=False)
    return by_path


# the other models driven on the card, each as one patch forward against
# the fp32 CPU one and one train step: (label, params, the kernels its
# forward and step must launch, (per patch, per step) counts or None)
ZOO_RUNS = (
    ("segresnet_deeper", {"model_type": "SegResNet_DSA",
                          "segresnet_deeper": True},
     segres_counts((1, 2, 2, 4, 4), (2, 2, 2, 2))),
    ("MS_DSA_NET serial", {"sa_type": "serial"},
     (PER_PATCH, unet_step(6, 12, 5))),
    ("MS_DSA_NET channel", {"sa_type": "channel"},
     (PER_PATCH, unet_step(6, 12, 5, spatial=False))),
    ("MS_DSA_NET_PS", {"model_type": "MS_DSA_NET_PS"},
     (unet_patch(6, 12, 5, upsample=False),
      unet_step(6, 12, 5, upsample=False))),
    ("BaseUNet", {"model_type": "BaseUNet"},
     (unet_patch(6, 0, 5), unet_step(6, 0, 5))),
    ("SegResNetVAE_DSA", {"model_type": "SegResNetVAE_DSA"},
     segres_counts(vae=True)),
)


def patch_run(dev, card, label, params, patch, other, want, seed):
    """One patch forward of a trainer built from `params` (its seeded
    weights, the attention redrawn from `seed`, a model with a batch norm
    calibrated on `other` first): a warm-up, then one timed forward with
    the launches held to `want`, and the logits against the CPU forward by
    patch_check. Returns (launch counts, trainer)."""
    from fcd_tpu_torch.ops.layers import BatchNorm
    from fcd_tpu_torch.train.trainer import ModelTrainer

    trainer = ModelTrainer(params, device=dev, verbose=False)
    redraw_attention(trainer.model, seed)
    if any(isinstance(m, BatchNorm) for m in trainer.model.modules()):
        calibrate_batch_norms(trainer.model, other.to(dev))
    xp = patch.to(dev)
    trainer.predict(xp)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    trainer.predict(xp)
    sync(dev)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd = read_counts()
    ok = dev.type != "cuda" or fwd == want
    print(f"{label}: patch forward {fwd_ms:.1f} ms on {card}; launches "
          f"{ {k: v for k, v in fwd.items() if v} } {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{label}: launches {fwd} != {want}")
    patch_check(dev, trainer, patch, f"{label}: ")
    return fwd, trainer


def zoo_run(dev, card, label, extra, counts, batch=TRAIN_BATCH,
            full=False, routes=False) -> dict:
    """One model of ZOO_RUNS (or A7_RUNS) at full width on a 128^3 patch:
    a patch forward against the fp32 CPU forward (patch_run) and one train
    step of `batch` x 128^3 (finite loss; a VAE model's VAE loss finite
    too), the launches of each held to `counts`. `full`: also profiles of
    the patch and the step, the step's peak memory, the 1 x 64^3 step
    against the fp32 CPU step (zoo_train_check); `routes`: the f32 and f16
    routes' patch forwards, no launch in either (patch_run). Returns
    {path: launch counts}."""
    import numpy as np
    import torch

    params = train_params(extra=extra)
    size = params["patch_size"]
    rs = np.random.RandomState(SEED + 6)
    patch, other = (torch.from_numpy(rs.standard_normal(
        (1, size, size, size, params["chans_in"])).astype(np.float32))
        for _ in range(2))
    want_fwd, want_step = counts
    fwd, trainer = patch_run(dev, card, f"zoo {label}", params, patch, other,
                             want_fwd, SEED + 7)
    if full:
        xp = patch.to(dev)
        profile_run(f"{label}, one {size}^3 patch forward",
                    lambda: trainer.predict(xp), dev)
        del xp
    x, y = train_batch(dev, batch, size, params["chans_in"])
    with torch.enable_grad():
        trainer.train_step(x, y, 1e-4)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(x, y, 1e-4))
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        step = read_counts()
        peak_gb = (torch.cuda.max_memory_allocated() / 1e9
                   if dev.type == "cuda" else 0.0)
        if full:
            profile_run(f"{label}, one train step, batch {batch}x{size}^3",
                        lambda: trainer.train_step(x, y, 1e-4), dev)
    vae = None
    if params["model_returns_vaeloss"]:
        trainer.model.train()
        with torch.no_grad():
            vae = float(trainer.model(x)[1])
        trainer.model.eval()
    ok = (math.isfinite(loss) and (vae is None or math.isfinite(vae))
          and (dev.type != "cuda" or step == want_step))
    print(f"zoo {label}: train step {batch}x{size}^3 {step_ms:.1f} ms on "
          f"{card} (peak memory {peak_gb:.1f} GB); loss {loss:.5f}"
          + ("" if vae is None else f", VAE loss {vae:.5f}")
          + f"; launches { {k: v for k, v in step.items() if v} } "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"zoo {label}: loss not finite or launches "
                             f"{step} != {want_step}")
    out = {f"{label} forward": fwd, f"{label} step": step}
    if not full:
        return out
    del trainer, x, y
    torch.cuda.empty_cache()
    zoo_train_check(dev, extra)
    torch.cuda.empty_cache()
    if routes:
        none = {k: 0 for k in want_fwd}
        for route, rextra in (("f32", F32_PARAMS), ("f16", F16_PARAMS)):
            out[f"{label} {route} forward"], trainer = patch_run(
                dev, card, f"zoo {label} {route}",
                train_params(extra=dict(extra, **rextra)), patch, other,
                none, SEED + 7)
            del trainer
            torch.cuda.empty_cache()
    return out


def a7_counts(enc, dec):
    """(per patch, per train step) launches of UNETR or SwinUNETR (bf16)
    from its structure: `enc` res blocks on one input (UnetrBasicBlock;
    the first, on the image, whose input needs no gradient) and `dec` up
    blocks (B4, then a res block on [upsampled, skip]): `unet_step` /
    `unet_patch` without transformers. UNETR: the image's block, the PrUp
    stacks' three and four up blocks; SwinUNETR: enc0-enc3, dec4 and five
    up blocks. Their attention, LayerNorms, Dense layers, patch embeds and
    PrUp transposed convs are library ops."""
    return unet_patch(enc, 0, dec), unet_step(enc, 0, dec)


NO_LAUNCHES = ({k: 0 for k in PER_PATCH}, {k: 0 for k in PER_PATCH})
# ROADMAP A7, each through the factory at full width: UNet and VNet run no
# kernel at the defaults (FCD_FAST_CONV off); UNETR and SwinUNETR also run
# their f32 and f16 patches
A7_RUNS = (
    ("UNet", {"model_type": "UNET"}, NO_LAUNCHES, False),
    ("VNet", {"model_type": "VNET"}, NO_LAUNCHES, False),
    ("UNETR", {"model_type": "UNETR"}, a7_counts(4, 4), True),
    ("SwinUNETR", {"model_type": "SWINUNETR"}, a7_counts(5, 5), True),
)


# -- C18: use_amp=False on the card, and UNETR++ ------------------------------

F32_PARAMS = {"use_amp": False}
# the f32 route's launches: B5's f32 instances at eval (phase A with its
# finishing pass and phase B, one count each a DSA call), K3/K4's in
# training, and none of the bf16-only kernels; the volume leaves through
# sw_exit (per_volume, entry False)
F32_PATCH = dict({k: 0 for k in PER_PATCH}, dsa_phase_a_f32=12,
                 dsa_phase_b_f32=12)
F32_STEP = dict({k: 0 for k in PER_PATCH}, spatial_attn_fwd_f32=12,
                spatial_attn_bwd_f32=12)
# the f32 1 x 64^3 step against the f32 route on the CPU: the loss, and
# each top-level module's gradient within max(F32_GRAD_FLOOR, twice the
# CPU step's own movement under 1e-5 input noise), C10's rule. The loss
# limit lies between the readings on an H100: IEEE f32 0 (MS_DSA_NET) and
# 1.303e-7 (UNETR++), the same step in TF32 5.354e-5 and 4.138e-5
F32_LOSS_REL_TOL = 1e-6
F32_GRAD_FLOOR = 1e-2
F32_CONV_REL_TOL = 1e-5   # an f32-route conv against an f64 conv


def unetrpp_counts(epa=21, blocks=2):
    """(per patch, per train step) launches of UNETR++ (bf16) from its
    structure: `epa` EPA blocks (12 in the encoder, 9 in the decoders),
    each a DSA (both B5 phases at eval; K3 and K4 in training) and a
    batch-norm res block, and `blocks` full-resolution res blocks (the
    image's, 2 -> fs, and the last, fs -> fs). A res block is two B1 convs
    and a B2 finale; in training one K2 a finale, one K1 per conv (one
    part each), conv2's data gradient and conv1's where its input needs
    one (all but the image's block). The strided convs, the transposed
    convs and the GroupNorms are library ops."""
    res = epa + blocks
    patch = dict({k: 0 for k in PER_PATCH}, conv3d=2 * res, finale_pool=res,
                 dsa_phase_a=epa, dsa_phase_b=epa)
    step = dict({k: 0 for k in PER_PATCH}, conv3d=2 * res + 2 * res - 1,
                conv3d_wgrad=2 * res, finale_pool=res, finale_bwd=res,
                spatial_attn_fwd=epa, spatial_attn_bwd=epa)
    return patch, step


UNETRPP = {"model_type": "unetrpp"}
UNETRPP_PATCH, UNETRPP_STEP = unetrpp_counts()
UNETRPP_F32_PATCH = dict({k: 0 for k in PER_PATCH}, dsa_phase_a_f32=21,
                         dsa_phase_b_f32=21)


def tf32_check(dev) -> None:
    """A use_amp=False trainer on the card holds to IEEE f32 inside its
    `numerics` scope, whatever the caller allows: with TF32 allowed around
    it, building the trainer leaves the flags as they were, inside the
    scope both are off and an f32-route conv (cuDNN) stays within
    F32_CONV_REL_TOL of an f64 conv, and after it the flags are back. The
    same conv with TF32 allowed is printed beside it (~1e-3 where cuDNN
    takes a TF32 algorithm)."""
    import torch

    from fcd_tpu_torch.ops.layers import conv3d
    from fcd_tpu_torch.train.trainer import ModelTrainer

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = _randn((1, 64, 64, 64, 32), gen, dev)
    k = _randn((3, 3, 3, 32, 32), gen, dev, 0.05)
    want = conv3d(x.double(), k.double())
    with tf32_allowed():
        _, tf32 = rel_err(conv3d(x, k), want)
        trainer = ModelTrainer(train_params(64, extra=F32_PARAMS),
                               device=dev, verbose=False)
        kept = tf32_flags() == (True, True)
        with trainer.numerics():
            off = tf32_flags() == (False, False)
            _, ieee = rel_err(conv3d(x, k), want)
        back = tf32_flags() == (True, True)
    ok = kept and off and back and ieee <= F32_CONV_REL_TOL
    print(f"tf32 check: with TF32 allowed, a use_amp=False trainer leaves "
          f"the flags {'ok' if kept else 'FAIL'}, turns them off in its "
          f"numerics scope {'ok' if off else 'FAIL'} and restores them "
          f"{'ok' if back else 'FAIL'}; conv 1x64^3x32 vs f64 in the scope: "
          f"rel {ieee:.3e} (tol {F32_CONV_REL_TOL}), with TF32 allowed "
          f"{tf32:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the f32 route's conv is not IEEE f32, or the "
                             "trainer leaves the TF32 flags changed")


def tf32_flags():
    import torch

    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def tf32_allowed():
    """TF32 allowed in cuDNN and matmuls for the block (main() turns both
    off for the run; they are off again after it)."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32 = matmul.allow_tf32 = False


def f32_train_check(dev, extra=F32_PARAMS) -> None:
    """One 1 x 64^3 train step of the f32 route on the card against the f32
    route on the CPU from the same weights, dropout off, with TF32 allowed
    around it (the trainer's `numerics` scope is what holds it to f32):
    the loss within F32_LOSS_REL_TOL, and each top-level module's gradient
    (rel-L2) within max(F32_GRAD_FLOOR, twice the CPU step's movement when
    the input moves by 1e-5 of itself). A control, the same step on the
    card with the scope switched off (TF32), is printed beside it with the
    number of modules whose gradient it would put outside the rule: the
    loss limit lies between the two sides' readings."""
    import numpy as np
    import torch

    from fcd_tpu_torch.ops.layers import use_plain_route
    from fcd_tpu_torch.train.trainer import ModelTrainer
    from fcd_tpu_torch.weights import model_entries

    size = TRAIN_CHECK_SIZE
    params = train_params(size, extra=extra)
    trainers = [ModelTrainer(params, device=d, verbose=False)
                for d in (dev, "cpu", "cpu", dev)]
    redraw_attention(trainers[0].model, SEED + 3)
    for tr in trainers[1:3]:
        use_plain_route(tr.model)
    for tr in trainers[1:]:
        tr.model.load_state_dict(trainers[0].model.state_dict())
    for tr in trainers:
        dropout_off(tr.model)
    trainers[3]._numerics = {}   # the control: the same step in TF32
    x, y = train_batch(dev, 1, size, params["chans_in"])
    noise = torch.from_numpy(np.random.RandomState(SEED + 5).standard_normal(
        x.shape).astype(np.float32))
    xn = x.cpu() * (1 + 1e-5 * noise)
    with torch.enable_grad(), tf32_allowed():
        card = float(trainers[0].train_step(x, y, 1e-4))
        control = float(trainers[3].train_step(x, y, 1e-4))
        cpu = float(trainers[1].train_step(x.cpu(), y.cpu(), 1e-4))
        trainers[2].train_step(xn, y.cpu(), 1e-4)
    groups = {}
    for entries in zip(*(model_entries(tr.model) for tr in trainers)):
        if any(t.grad is None for _, _, t, _ in entries):
            continue
        key = entries[0][1][0]
        bucket = groups.setdefault(key, ([], [], [], []))
        for lst, (_, _, t, _) in zip(bucket, entries):
            lst.append(t.grad.float().cpu().ravel())
    lines = []
    rel_loss = abs(card - cpu) / abs(cpu)
    rel_control = abs(control - cpu) / abs(cpu)
    ok = math.isfinite(card) and rel_loss <= F32_LOSS_REL_TOL
    worst = worst_control = 0.0
    control_out = 0
    for key, (g, w, m, tc) in groups.items():
        g, w, m, tc = (torch.cat(v) for v in (g, w, m, tc))
        scale = float(w.norm())
        if scale == 0.0:   # a module whose output is constant (a 1-voxel
            scale = 1.0    # instance norm): its gradient is 0 on both sides
        rel = float((g - w).norm()) / scale
        moved = float((m - w).norm()) / scale
        tol = max(F32_GRAD_FLOOR, 2 * moved)
        good = math.isfinite(rel) and rel <= tol
        ok = ok and good
        worst = max(worst, rel)
        rel_c = float((tc - w).norm()) / scale
        worst_control = max(worst_control, rel_c)
        control_out += rel_c > tol
        lines.append(f"{key} {rel:.2e} (moved {moved:.2e})"
                     + ("" if good else " FAIL"))
    print(f"f32 train check ({params['model_type']}): 1x{size}^3 step, card "
          f"f32 route vs CPU f32 route: loss {card:.9f} vs {cpu:.9f} rel "
          f"{rel_loss:.3e} (tol {F32_LOSS_REL_TOL}; control in TF32 "
          f"{control:.9f}, rel {rel_control:.3e}); grads rel-L2 per module, "
          f"worst {worst:.2e} (control {worst_control:.2e}, outside the rule "
          f"in {control_out} of {len(groups)} modules), each within "
          f"max({F32_GRAD_FLOOR}, 2x its movement under 1e-5 input noise) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print("  " + ", ".join(lines))
    if not ok:
        raise AssertionError(f"{params['model_type']}: the card's f32 step "
                             "disagrees with the CPU's f32 route")


def f32_run(dev, card) -> dict:
    """C18 through the entry points: ModelTrainer(use_amp=False) on the
    card, MS_DSA_NET fs16: the TF32 check, inference of the seeded volume
    (launches per patch: B5's f32 instances x 12 and nothing else; one
    patch against the f32 route on the CPU), a patch forward's profile,
    the 4 x 128^3 train step (K3/K4's f32 instances x 12; ms/step, peak
    memory), its profile and the 1 x 64^3 step against the CPU's f32
    step. Returns {path: launch counts}."""
    import torch

    tf32_check(dev)
    torch.cuda.empty_cache()
    params = train_params(extra=F32_PARAMS)
    launches, trainer, patch, vol, _ = slice_run(dev, card, params,
                                                 per_patch=F32_PATCH)
    by_path = {"f32 inference": launches}
    del vol
    x = patch.to(dev)
    prof = profile_run(f"f32 route, one {tuple(patch.shape[1:4])} patch "
                       "forward", lambda: trainer.predict(x), dev)
    print_share(prof, "B5 f32 in the patch", ("dsa_f32_phase_a",
                                               "dsa_f32_phase_b"))
    del trainer, x
    torch.cuda.empty_cache()
    by_path["f32 train"], trainer, batch = train_run(
        dev, card, extra=F32_PARAMS, per_step=F32_STEP)
    with torch.enable_grad():
        prof = profile_run(f"f32 route, one train step, batch "
                           f"{TRAIN_BATCH}x128^3",
                           lambda: trainer.train_step(*batch), dev)
    print_share(prof, "K3 + K4 f32 in the step (the wide kernels' f32 "
                "instances)", ("spatial_attn_fwd", "spatial_attn_bwd"))
    del trainer, batch
    torch.cuda.empty_cache()
    f32_train_check(dev)
    torch.cuda.empty_cache()
    return by_path


def unetrpp_run(dev, card) -> dict:
    """UNETR++ (fs16, 128^3, 4 heads, EPA projections 64/64/64/32) through
    the entry points: in bf16 ModelTrainer.inference on the seeded volume
    (launches per patch: B1, B2, B5; the batch norms' statistics
    calibrated first, calibrate_batch_norms), one patch against the fp32
    CPU forward, the 4 x 128^3 train step (B1, K1, B2, K2, K3, K4); then,
    with use_amp=False, one patch forward (B5's f32 instances) against the
    f32 route on the CPU. Returns {path: launch counts}."""
    import numpy as np
    import torch

    params = train_params(extra=UNETRPP)
    launches, trainer, patch, vol, _ = slice_run(
        dev, card, params, per_patch=UNETRPP_PATCH, calibrate=True)
    by_path = {"unetrpp inference": launches}
    del trainer, vol
    torch.cuda.empty_cache()
    by_path["unetrpp train"], trainer, batch = train_run(
        dev, card, extra=UNETRPP, per_step=UNETRPP_STEP)
    with torch.enable_grad():
        prof = profile_run(f"UNETR++, one train step, batch "
                           f"{TRAIN_BATCH}x128^3",
                           lambda: trainer.train_step(*batch), dev)
    print_share(prof, "K3 + K4 in the step", ("spatial_attn_fwd",
                                              "spatial_attn_bwd"))
    del trainer, batch
    torch.cuda.empty_cache()
    f32 = train_params(extra=dict(UNETRPP, **F32_PARAMS))
    size = f32["patch_size"]
    other = torch.from_numpy(np.random.RandomState(SEED + 6).standard_normal(
        (1, size, size, size, f32["chans_in"])).astype(np.float32))
    fwd, _ = patch_run(dev, card, "unetrpp f32", f32, patch, other,
                       UNETRPP_F32_PATCH, SEED + 1)
    by_path["unetrpp f32 forward"] = fwd
    return by_path


# -- C20: compute_dtype='float16' on the card ----------------------------------

F16_PARAMS = {"compute_dtype": "float16"}
# the f16 route's launches: B5's f16 instances at eval, K3/K4's in
# training, none of the bf16-only kernels; the volume enters through B17
# in bf16 (the JAX trainer's use_amp entry) and leaves through sw_exit
F16_PATCH = dict({k: 0 for k in PER_PATCH}, dsa_phase_a_f16=12,
                 dsa_phase_b_f16=12)
F16_STEP = dict({k: 0 for k in PER_PATCH}, spatial_attn_fwd_f16=12,
                spatial_attn_bwd_f16=12)
# the f16 1 x 64^3 step against the port's fp32 CPU step (the plain
# route's branches in f32): the loss, measured on an H100 at rel 5.294e-5
# (the bf16 step's 3.69e-4 is held at 1e-3); ~5x margin
F16_LOSS_REL_TOL = 2.5e-4


def f16_train_check(dev) -> None:
    """One 1 x 64^3 train step of the f16 route on the card against the
    same route's branches in f32 on the CPU from the same weights, dropout
    off: the loss within F16_LOSS_REL_TOL, every gradient finite; each
    top-level module's gradient distance (rel-L2) is printed."""
    import torch

    from fcd_tpu_torch.ops.layers import use_plain_route
    from fcd_tpu_torch.train.trainer import ModelTrainer
    from fcd_tpu_torch.weights import model_entries

    size = TRAIN_CHECK_SIZE
    params = train_params(size, extra=F16_PARAMS)
    trainers = [ModelTrainer(params, device=d, verbose=False)
                for d in (dev, "cpu")]
    redraw_attention(trainers[0].model, SEED + 3)
    use_plain_route(trainers[1].model)
    trainers[1].model.load_state_dict(trainers[0].model.state_dict())
    for tr in trainers:
        dropout_off(tr.model)
    x, y = train_batch(dev, 1, size, params["chans_in"])
    with torch.enable_grad():
        card = float(trainers[0].train_step(x, y, 1e-4))
        cpu = float(trainers[1].train_step(x.cpu(), y.cpu(), 1e-4))
    groups = {}
    for (_, key, g, _), (_, _, w, _) in zip(
            *(model_entries(tr.model) for tr in trainers)):
        if g.grad is None:
            continue
        bucket = groups.setdefault(key[0], ([], []))
        bucket[0].append(g.grad.float().cpu().ravel())
        bucket[1].append(w.grad.float().ravel())
    rel_loss = abs(card - cpu) / abs(cpu)
    ok = math.isfinite(card) and rel_loss <= F16_LOSS_REL_TOL
    dists = {}
    for key, (g, w) in groups.items():
        g, w = torch.cat(g), torch.cat(w)
        ok = ok and bool(torch.isfinite(g).all())
        dists[key] = float((g - w).norm()) / max(float(w.norm()), 1e-30)
    print(f"f16 train check ({params['model_type']}): 1x{size}^3 step, card "
          f"f16 vs CPU fp32: loss {card:.6f} vs {cpu:.6f} rel "
          f"{rel_loss:.3e} (tol {F16_LOSS_REL_TOL}); grads finite, rel-L2 "
          f"per module, worst {max(dists.values()):.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print("  " + ", ".join(f"{k} {v:.2e}" for k, v in dists.items()))
    if not ok:
        raise AssertionError("the card's f16 step disagrees with the fp32 "
                             "CPU step")


def f16_run(dev, card) -> dict:
    """C20 through the entry points: ModelTrainer(compute_dtype='float16')
    on the card, MS_DSA_NET fs16: inference of the seeded volume (launches:
    B5's f16 instances x 12 a patch, one bf16 sw_entry and one sw_exit a
    volume; one patch against the fp32 CPU forward), a patch forward's
    profile, the 4 x 128^3 train step (K3/K4's f16 instances x 12; ms/step,
    peak memory), its profile and the 1 x 64^3 step against the fp32 CPU
    step. Returns {path: launch counts}."""
    import torch

    params = train_params(extra=F16_PARAMS)
    launches, trainer, patch, vol, _ = slice_run(dev, card, params,
                                                 per_patch=F16_PATCH)
    by_path = {"f16 inference": launches}
    del vol
    x = patch.to(dev)
    prof = profile_run(f"f16 route, one {tuple(patch.shape[1:4])} patch "
                       "forward", lambda: trainer.predict(x), dev)
    print_share(prof, "B5 f16 in the patch", ("dsa_phase_a", "dsa_phase_b"))
    del trainer, x
    torch.cuda.empty_cache()
    by_path["f16 train"], trainer, batch = train_run(
        dev, card, extra=F16_PARAMS, per_step=F16_STEP)
    with torch.enable_grad():
        prof = profile_run(f"f16 route, one train step, batch "
                           f"{TRAIN_BATCH}x128^3",
                           lambda: trainer.train_step(*batch), dev)
    print_share(prof, "K3 + K4 f16 in the step", ("spatial_attn_fwd",
                                                  "spatial_attn_bwd"))
    del trainer, batch
    torch.cuda.empty_cache()
    f16_train_check(dev)
    torch.cuda.empty_cache()
    return by_path


# -- the data mesh (parallel/) --------------------------------------------------

# The card holds one rank per process. Two ranks share it over gloo (NCCL
# refuses two ranks on one GPU); then rank 0 also runs a one-rank mesh over
# NCCL, so that code path runs on the card too. Nothing here measures a
# speed-up: two ranks on one card share its SMs.
MESH_RANKS = 2
MESH_BATCH = 4                 # the DP step's global batch, 2 a rank
MESH_LOSS_REL_TOL = 1e-5
# the sharded volume against the single-rank engine: the same patch logits
# (bit-equal), blended in another order (each rank's accumulator, then one
# sum), so within f32 rounding of the up-to-8 overlapping terms
MESH_VOL_REL_TOL = 1e-6
MESH_ARGMAX_AGREE = 0.99999
# The DP step's gradients against the single-rank step's: each group by
# train_check's rule (`group_rule`), the reference distance being the
# single-rank step's own under a rounding-level change of the input
# (x (1 + 1e-6), the same seeds). The DP step changes the order of the
# batch sums (instance-norm statistics under other tilings at batch 2,
# batch-norm sums over the ranks, the gradients' sum), and at random
# weights bf16 amplifies any such change chaotically in the deep layers
# (train_check's note: rel-L2 0.48 at encoder 5 from a 1e-6 input change).
# The rule's rel-L2 floor is bf16's epsilon, not 1e-3: the weights' bf16
# copies take bf16 gradients, so each rank's gradient is rounded to bf16
# before the sum over the ranks, where the single-rank step rounds the
# whole batch's once (the head, which the nudge leaves bit-equal, reads
# 2.14e-3 on an H100).
MESH_NUDGE = 1e-6
MESH_GRAD_FLOOR = 2.0 ** -8
MESH_SMALL = dict(feature_size=4, project_size=16, patch_size=32)


def _recording(predict, store):
    """predict, each call's logits kept in `store` (in call order)."""
    def run(patches):
        out = predict(patches)
        store.append(out.detach().clone())
        return out
    return run


def _same_model(a, b) -> bool:
    return all(torch_equal(p, q) for p, q in zip(
        list(a.parameters()) + list(a.buffers()),
        list(b.parameters()) + list(b.buffers())))


def mesh_rank(small: bool = False) -> dict:
    """One rank of the mesh phase (run by `parallel.mesh.launch` over gloo,
    every rank on the one card). The sharded engine (ModelTrainer.inference
    under the mesh: the default fs16 bf16 MS_DSA_NET on the 182x218x182x2
    volume) against the single-rank engine (mesh_data=1) in this process,
    with the launch counts of the sharded call; one data-parallel step at a
    global MESH_BATCH x 128^3 (DiceCE, AdamW, dropout on) against the
    single-rank step from the same state, its launch counts, a second DP
    step from that state (bit-equal), and the single-rank step on the
    nudged input (the reference distance). Then rank 0 runs both paths on a
    one-rank mesh over NCCL, which must give the single-rank bits. `small`:
    fs4 / patch 32 on the CPU, gloo throughout (a rehearsal; no launch
    counts)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.infer.sliding_window import dense_patch_starts
    from fcd_tpu_torch.parallel.mesh import make_mesh
    from fcd_tpu_torch.parallel.sw import patch_shares
    from fcd_tpu_torch.train.schedule import epoch_lr
    from fcd_tpu_torch.train.trainer import ModelTrainer

    torch.set_grad_enabled(False)
    card = torch.cuda.is_available() and not small
    dev = (torch.device("cuda", torch.cuda.current_device()) if card
           else torch.device("cpu"))
    sizes = MESH_SMALL if small else {}
    vol_shape = (40, 48, 40) if small else (182, 218, 182)

    def trainer(params, mesh_data=-1, mesh=None):
        tr = ModelTrainer(dict(params, mesh_data=mesh_data), device=dev,
                          verbose=False, mesh=mesh)
        redraw_attention(tr.model, SEED + 1)
        return tr

    # -- the sharded engine -------------------------------------------------
    params = get_default_params()
    params.update(sizes)
    mesh_tr, alone = trainer(params), trainer(params, 1)
    mesh = mesh_tr.mesh
    out = {"rank": mesh.rank, "size": mesh.size}
    vol = np.random.RandomState(SEED).standard_normal(
        (*vol_shape, params["chans_in"])).astype(np.float32)
    roi = (params["patch_size"],) * 3
    n = len(dense_patch_starts(vol_shape, roi, params["sw_overlap"]))
    per_dev, _ = patch_shares(n, params["sw_batch_size"], mesh.size)
    mine, ref = [], []
    mesh_tr.predict = _recording(mesh_tr.predict, mine)
    alone.predict = _recording(alone.predict, ref)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    got = mesh_tr.inference(vol)
    sync(dev)
    out["mesh_ms"] = (time.perf_counter() - t0) * 1e3
    out["inference_counts"] = read_counts()
    t0 = time.perf_counter()
    want = alone.inference(vol)
    sync(dev)
    out["single_ms"] = (time.perf_counter() - t0) * 1e3
    lo = mesh.rank * per_dev
    out["patches"] = (len(mine), per_dev, n)
    out["patches_equal"] = len(mine) == per_dev and all(
        torch_equal(a, ref[lo + i]) for i, a in enumerate(mine[:n - lo]))
    out["volume_rel"] = float((got - want).abs().max() / want.abs().max())
    out["argmax_agree"] = float(
        (got.argmax(-1) == want.argmax(-1)).float().mean())
    out["finite"] = bool(torch.isfinite(got).all())
    out["per_volume"] = per_volume(per_dev)
    del mesh_tr, alone, got, mine, ref

    # -- the data-parallel step ---------------------------------------------
    tparams = train_params(**({"patch_size": 32} if small else {}))
    tparams.update(sizes)
    lr = epoch_lr(tparams, tparams["warmup_epochs"])
    x, y = train_batch(dev, MESH_BATCH, tparams["patch_size"],
                       tparams["chans_in"])
    mesh_t, alone_t = trainer(tparams), trainer(tparams, 1)
    again, nudged = trainer(tparams), trainer(tparams, 1)
    with torch.enable_grad():
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        loss = mesh_t.train_step(x, y, lr)
        sync(dev)
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        out["step_counts"] = read_counts()
        t0 = time.perf_counter()
        single = alone_t.train_step(x, y, lr)
        sync(dev)
        out["single_step_ms"] = (time.perf_counter() - t0) * 1e3
        loss2 = again.train_step(x, y, lr)
        nudge = nudged.train_step(x * (1 + MESH_NUDGE), y, lr)
    out["loss"], out["single_loss"] = float(loss), float(single)
    out["nudged_loss"] = float(nudge)
    out["grads"] = _grad_distance(mesh_t.model, alone_t.model)
    out["ref_grads"] = _grad_distance(nudged.model, alone_t.model)
    out["repro"] = torch_equal(loss, loss2) and _same_model(mesh_t.model,
                                                            again.model)
    out["per_step"] = per_train_step()
    del mesh_t, alone_t, again, nudged
    if card:
        torch.cuda.empty_cache()

    # -- one rank over NCCL -------------------------------------------------
    group = dist.new_group([0], backend="gloo" if small else "nccl")
    if mesh.rank == 0:
        one = make_mesh(1, group=group, device=dev)
        tr1 = trainer(params, mesh=one)
        vol1 = tr1.inference(vol)
        t1, s1 = trainer(tparams, mesh=one), trainer(tparams, 1)
        with torch.enable_grad():
            l1, ls = t1.train_step(x, y, lr), s1.train_step(x, y, lr)
        out["nccl"] = {
            "backend": one.backend,
            "volume_equal": torch_equal(vol1, want),
            "loss_equal": torch_equal(l1, ls),
            "grads_equal": all(torch_equal(a.grad, b.grad) for a, b in zip(
                t1.model.parameters(), s1.model.parameters())),
            "state_equal": _same_model(t1.model, s1.model)}
    dist.barrier()
    return out


def mesh_run(card, small=False) -> dict:
    """The mesh phase (`mesh_rank` on MESH_RANKS gloo ranks on the one
    card); fails unless every check holds. Returns each rank's launch
    counts by path."""
    from fcd_tpu_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    ranks = launch(mesh_rank, MESH_RANKS, small, backend="gloo",
                   **({"device_type": "cpu", "threads": 2} if small else
                      {"device_type": "cuda",
                       "devices": ["cuda:0"] * MESH_RANKS}))
    failures, by_path = [], {}
    for r in ranks:
        who = f"rank {r['rank']} of {r['size']}"
        rel = abs(r["loss"] - r["single_loss"]) / abs(r["single_loss"])
        nudged = abs(r["nudged_loss"] - r["single_loss"]) / abs(
            r["single_loss"])
        # a nan distance is 0 / 0: both steps' gradients exactly zero (a
        # 1-voxel level at the rehearsal's 32^3)
        good, lines = group_rule(
            {k: v for k, v in r["grads"].items() if not math.isnan(v[0])},
            r["ref_grads"], floor=MESH_GRAD_FLOOR)
        print(f"mesh ({who}, gloo): sharded inference {r['patches'][0]} of "
              f"{r['patches'][2]} patches, {r['mesh_ms']:.1f} ms (single "
              f"rank {r['single_ms']:.1f} ms); patch logits bit-equal "
              f"{r['patches_equal']}, volume rel {r['volume_rel']:.3e} (tol "
              f"{MESH_VOL_REL_TOL}), argmax agree {r['argmax_agree']:.6f}; "
              f"DP step {r['step_ms']:.1f} ms, the first in the process "
              f"(single rank {r['single_step_ms']:.1f} ms), loss "
              f"{r['loss']:.7f} vs {r['single_loss']:.7f} rel {rel:.2e} "
              f"(tol {MESH_LOSS_REL_TOL}; the nudged single-rank step "
              f"{nudged:.2e}), grads per group within {GROUP_MARGIN}x the "
              f"nudged step's distance + {MESH_GRAD_FLOOR:.2e} {good}, two "
              f"DP steps bit-equal "
              f"{r['repro']}", flush=True)
        print("  grads rel-L2/cosine per group, DP vs single rank (the "
              "nudged single-rank step): " + ", ".join(
                  line.replace("bf16 CPU ", "") for line in lines),
              flush=True)
        checks = {
            "patch logits": r["patches_equal"],
            "finite volume": r["finite"],
            "volume": (r["volume_rel"] <= MESH_VOL_REL_TOL and
                       r["argmax_agree"] >= MESH_ARGMAX_AGREE),
            "loss": rel <= MESH_LOSS_REL_TOL,
            "grads": good,
            "repro": r["repro"],
        }
        if "nccl" in r:
            exact = r["nccl"]
            print(f"mesh (rank 0 alone, {exact['backend']}): volume, loss, "
                  f"gradients and state bit-equal to the single-rank path: "
                  f"{exact['volume_equal']}, {exact['loss_equal']}, "
                  f"{exact['grads_equal']}, {exact['state_equal']}",
                  flush=True)
            checks.update({f"{exact['backend']} {k}": v
                           for k, v in exact.items() if k != "backend"})
        if not small:
            checks["inference launches"] = (r["inference_counts"]
                                            == r["per_volume"])
            checks["step launches"] = r["step_counts"] == r["per_step"]
            by_path[f"mesh inference, {who}"] = r["inference_counts"]
            by_path[f"mesh DP step, {who}"] = r["step_counts"]
        failures += [f"{who}: {k}" for k, ok in checks.items() if not ok]
    print(f"mesh: {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    if failures:
        raise AssertionError(f"mesh checks failed: {failures}")
    return by_path


# -- the model axis (tensor parallelism) ---------------------------------------

TP_SHAPE = (1, 2)      # (data, model): two gloo ranks on the one card
TP_BATCH = 1           # one 128^3 patch: a level-1 f32 partial is 128 MiB
# the row-parallel 3x3x3 convs of MS_DSA_NET: every res block's conv2 (6
# encoders, 12 transformer conv blocks, 5 decoders) and the transformers'
# conv1, which run B1's partial instance and the finishing pass in B1's
# place
TP_ROW_CONVS = 23 + 12
# The TP step against the one-card step: both bf16 on the kernel route,
# the same seeds, so the nudged one-card step (x (1 + MESH_NUDGE)) is the
# control. The loss within TP_LOSS_MARGIN times its distance (at least
# TP_LOSS_FLOOR). The rel-L2/cosine group rule cannot see a scaled
# gradient where bf16 chaos is large (rel-L2 0.2-0.5 in the deep groups),
# so each group's gradient norm is held too: |log(|g_tp| / |g_one|)|
# within GROUP_MARGIN times the nudged step's spread (the largest such
# log-ratio over the groups) plus MESH_GRAD_FLOOR; a gradient scaled by k
# reads |log k|.
TP_LOSS_MARGIN = 3.0
TP_LOSS_FLOOR = 1e-5


def _grad_norms(model, groups=_groups) -> dict:
    """{group: the L2 norm of its gradients}, on the CPU."""
    import torch

    return {key: float(torch.cat([p.grad.float().cpu().ravel()
                                  for p in ps]).norm())
            for key, ps in groups(model).items()}


def norm_rule(norms, ref, nudged):
    """(ok, spread, {group: log-ratio}): each group's gradient norm against
    the one-card step's (`ref`), within GROUP_MARGIN times the nudged
    step's spread plus MESH_GRAD_FLOOR (groups whose norm is 0 in `ref`
    left out)."""
    keys = [k for k in ref if ref[k] > 0]
    logs = {k: math.log(norms[k] / ref[k]) if norms[k] > 0 else math.inf
            for k in keys}
    spread = max(abs(math.log(nudged[k] / ref[k])) for k in keys)
    ok = all(abs(v) <= GROUP_MARGIN * spread + MESH_GRAD_FLOOR
             for v in logs.values())
    return ok, spread, logs


def tp_counts(per: dict) -> dict:
    """Launch counts of a patch forward or a train step under TP_SHAPE:
    `per`'s, the row-parallel convs moved from B1 to its split."""
    out = dict(per)
    out["conv3d"] -= TP_ROW_CONVS
    out["conv3d_partial"] = out["conv_finish"] = TP_ROW_CONVS
    return out


def _digests(model) -> list:
    import hashlib

    return [hashlib.sha1(p.detach().float().cpu().numpy().tobytes())
            .hexdigest() for p in model.parameters()]


def tp_rank(small: bool = False) -> dict:
    """One rank of the TP phase (`parallel.mesh.launch` over gloo, both
    ranks on the one card, a (1, 2) ("data", "model") mesh): MS_DSA_NET at
    full width (fs16, project 64, bf16, the kernel route) sharded by
    `parallel.tp` from the same state as a one-card trainer's. The TP eval
    forward of one 128^3 patch against the one-card forward, and one TP
    train step (DiceCE, AdamW, dropout on, the trainer's seeds) against
    the one-card step, its gradients gathered and held by group against
    the one-card step's own distance under a nudged input; the launch
    counts of the forward and the step, every parameter's digest after the
    step (the same on both ranks), and the ms of a second forward and a
    second step of each. `small`: fs4 / patch 32 on the CPU."""
    import torch

    from fcd_tpu_torch.parallel import tp
    from fcd_tpu_torch.train.schedule import epoch_lr
    from fcd_tpu_torch.train.trainer import ModelTrainer

    card = torch.cuda.is_available() and not small
    dev = (torch.device("cuda", torch.cuda.current_device()) if card
           else torch.device("cpu"))
    mesh = tp.make_tp_mesh(*TP_SHAPE, device=dev)
    params = train_params(**({"patch_size": 32} if small else {}))
    params.update(MESH_SMALL if small else {})

    def trainer():
        tr = ModelTrainer(dict(params, mesh_data=1), device=dev,
                          verbose=False)
        redraw_attention(tr.model, SEED + 1)
        return tr

    alone, sharded, nudged = trainer(), trainer(), trainer()
    x, y = train_batch(dev, TP_BATCH, params["patch_size"],
                       params["chans_in"])
    lr = epoch_lr(params, params["warmup_epochs"])
    out = {"rank": mesh.model.rank}

    def clock(fn):
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, (time.perf_counter() - t0) * 1e3

    def tp_forward():
        with tp.model_parallel(sharded.model):
            return sharded.model(x)

    # -- the eval forward -----------------------------------------------------
    tp.shard_variables_tp(sharded.model, mesh)
    with torch.no_grad():
        want, _ = clock(lambda: alone.model(x))
        reset_counts()
        got, out["first_fwd_ms"] = clock(tp_forward)
        out["fwd_counts"] = read_counts()
        _, out["fwd_ms"] = clock(tp_forward)
        _, out["single_fwd_ms"] = clock(lambda: alone.model(x))
    out["fwd_rel"] = float((got.float() - want.float()).abs().max()
                           / want.float().abs().max())
    out["fwd_agree"] = float((got.argmax(-1) == want.argmax(-1))
                             .float().mean())
    out["fwd_finite"] = bool(torch.isfinite(got).all())
    del got, want
    # -- one train step -------------------------------------------------------
    tp.gather_tp_state(sharded.model)
    sharded._train_setup()
    tp.shard_state_tp(sharded.model, mesh, sharded.optimizer)
    sharded._step_fn = tp.make_tp_train_step(
        sharded.model, sharded.loss_fn, sharded.optimizer, mesh)
    with torch.enable_grad():
        reset_counts()
        loss, out["first_step_ms"] = clock(
            lambda: sharded.train_step(x, y, lr))
        out["step_counts"] = read_counts()
        single = alone.train_step(x, y, lr)
        nudge = nudged.train_step(x * (1 + MESH_NUDGE), y, lr)
    tp.gather_tp_state(sharded.model, sharded.optimizer)
    out["loss"], out["single_loss"] = float(loss), float(single)
    out["nudged_loss"] = float(nudge)
    out["grads"] = _grad_distance(sharded.model, alone.model)
    out["ref_grads"] = _grad_distance(nudged.model, alone.model)
    out["norms"], out["single_norms"], out["nudged_norms"] = (
        _grad_norms(tr.model) for tr in (sharded, alone, nudged))
    out["digests"] = _digests(sharded.model)
    # the second step of each: ms/step
    tp.shard_state_tp(sharded.model, mesh, sharded.optimizer)
    with torch.enable_grad():
        _, out["step_ms"] = clock(lambda: sharded.train_step(x, y, lr))
        _, out["single_step_ms"] = clock(lambda: alone.train_step(x, y, lr))
    return out


def tp_run(card, small=False) -> dict:
    """The TP phase (`tp_rank` on two gloo ranks on the one card); fails
    unless every check holds. Returns each rank's launch counts by path."""
    from fcd_tpu_torch.parallel.mesh import launch

    n = TP_SHAPE[0] * TP_SHAPE[1]
    t0 = time.perf_counter()
    ranks = launch(tp_rank, n, small, backend="gloo",
                   **({"device_type": "cpu", "threads": 2} if small else
                      {"device_type": "cuda", "devices": ["cuda:0"] * n}))
    failures, by_path = [], {}
    fwd_want = tp_counts(PER_PATCH)
    step_want = tp_counts(per_train_step())
    for r in ranks:
        who = f"model rank {r['rank']} of {n}"
        rel = abs(r["loss"] - r["single_loss"]) / abs(r["single_loss"])
        nudged = abs(r["nudged_loss"] - r["single_loss"]) / abs(
            r["single_loss"])
        good, lines = group_rule(
            {k: v for k, v in r["grads"].items() if not math.isnan(v[0])},
            r["ref_grads"], floor=MESH_GRAD_FLOOR)
        loss_tol = max(TP_LOSS_MARGIN * nudged, TP_LOSS_FLOOR)
        norms_ok, spread, logs = norm_rule(r["norms"], r["single_norms"],
                                           r["nudged_norms"])
        print(f"tp ({who}, gloo, batch {TP_BATCH}x"
              f"{'32' if small else '128'}^3): forward "
              f"{r['fwd_ms']:.1f} ms/patch (the first {r['first_fwd_ms']:.1f};"
              f" one card {r['single_fwd_ms']:.1f}), rel {r['fwd_rel']:.3e} "
              f"(tol {PATCH_REL_TOL}), argmax agree {r['fwd_agree']:.6f}; "
              f"step {r['step_ms']:.1f} ms/step (the first "
              f"{r['first_step_ms']:.1f}; one card "
              f"{r['single_step_ms']:.1f}), loss {r['loss']:.7f} vs "
              f"{r['single_loss']:.7f} rel {rel:.2e} (tol {loss_tol:.2e}: "
              f"{TP_LOSS_MARGIN}x the nudged one-card step's {nudged:.2e}, "
              f"at least {TP_LOSS_FLOOR}), grads per group within "
              f"{GROUP_MARGIN}x the nudged step's distance + "
              f"{MESH_GRAD_FLOOR:.2e} {good}, gradient norms within "
              f"{GROUP_MARGIN}x the nudged step's spread {spread:.2e} + "
              f"{MESH_GRAD_FLOOR:.2e} {norms_ok}", flush=True)
        print("  grads rel-L2/cosine per group, TP vs one card (the nudged "
              "one-card step): " + ", ".join(
                  line.replace("bf16 CPU ", "") for line in lines),
              flush=True)
        print("  grad norm log-ratio per group, TP / one card: " + ", ".join(
            f"{k} {v:+.2e}" for k, v in logs.items()), flush=True)
        checks = {
            "finite forward": r["fwd_finite"],
            "forward": (r["fwd_rel"] <= PATCH_REL_TOL
                        and r["fwd_agree"] >= PATCH_ARGMAX_AGREE),
            "loss": rel <= loss_tol,
            "grads": good,
            "grad norms": norms_ok,
            "state equal on every rank": r["digests"] == ranks[0]["digests"],
        }
        if not small:
            print(f"  launches: forward {r['fwd_counts']}, step "
                  f"{r['step_counts']}", flush=True)
            checks["forward launches"] = r["fwd_counts"] == fwd_want
            checks["step launches"] = r["step_counts"] == step_want
            by_path[f"tp forward, {who}"] = r["fwd_counts"]
            by_path[f"tp step, {who}"] = r["step_counts"]
        failures += [f"{who}: {k}" for k, ok in checks.items() if not ok]
    print(f"tp: {time.perf_counter() - t0:.1f} s on {card}", flush=True)
    if failures:
        raise AssertionError(f"tp checks failed: {failures}")
    return by_path


def a6_run(dev, card, params=None) -> None:
    """`utils/profiling.py` on the card: the default model's (or
    `params`') forward FLOPs at its patch (`get_model_flops`, counted on
    the CPU) and a StepTimer's ms and MFU over patch forwards on the
    card."""
    import torch

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.train.trainer import ModelTrainer
    from fcd_tpu_torch.utils.profiling import (
        StepTimer,
        device_peak_flops,
        get_model_flops,
    )

    params = params or get_default_params()
    tr = ModelTrainer(params, device=dev, verbose=False)
    t0 = time.perf_counter()
    flops, n_params = get_model_flops(tr.model, params)
    count_s = time.perf_counter() - t0
    x = torch.rand((1, *(params["patch_size"],) * 3, params["chans_in"]),
                   device=dev)
    timer = StepTimer(flops, device=dev)
    tr.predict(x)
    for _ in range(5):
        timer.start()
        tr.predict(x)
        timer.stop()
    s = timer.summary()
    print(f"profiling: {params['model_type']} fs{params['feature_size']}, "
          f"{n_params} parameters, {flops:.4e} forward FLOPs a "
          f"{params['patch_size']}^3 patch (FlopCounterMode, counted on the "
          f"CPU in {count_s:.1f} s); StepTimer over 5 patch forwards: "
          f"{s['mean_step_s'] * 1e3:.3f} ms, MFU {s['mfu']:.4f} of "
          f"{device_peak_flops(dev) / 1e12:.0f} TFLOP/s on {card}",
          flush=True)
    if not (flops > 0 and 0 < s["mfu"] < 1):
        raise AssertionError(f"profiling: FLOPs {flops}, MFU {s['mfu']}")


def _sass_functions(lib, pick) -> dict:
    """{function: tensor-core instructions (HMMA, HGMMA, IMMA)} of the
    functions of library `lib` that `pick` takes, from its SASS."""
    import re

    counts, fn = {}, None
    for line in sass_of(lib).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if pick(fn):
                counts.setdefault(fn, 0)
        elif fn is not None and pick(fn) and re.search(
                r"\b(HMMA|HGMMA|IMMA)\b", line):
            counts[fn] += 1
    return counts


def f32_sass_report() -> None:
    """What runs on the tensor cores, from the SASS. B5's f32 instances
    (libdsa_f32, 3xTF32): HMMA (.tf32) in the phase A and phase B kernels;
    the finishing pass has no products. K3/K4's wide instances, rebuilt
    on the tensor cores: HMMA in every instance, the f32 ones (3xTF32) in
    libspatial_attn, the bf16 and f16 ones in libspatial_attn and
    libspatial_attn_f16 (m16n8k16). Fails on a function that breaks its
    rule."""
    dsa = _sass_functions("dsa_f32", lambda f: True)
    products = {f: n for f, n in dsa.items()
                if any(k in f for k in DSA_F32_KERNELS[::2])}
    wide = {}
    for lib in ("spatial_attn", "spatial_attn_f16"):
        wide.update({f"{lib}:{f}": n for f, n in _sass_functions(
            lib, lambda f: "_wide" in f).items()})
    f32 = {f: n for f, n in wide.items() if "_wideIf" in f}
    ok = (len(dsa) >= 3 and len(products) == 2 and all(products.values())
          and len(f32) >= 9 and len(wide) >= 27 and all(wide.values()))
    print(f"f32 instances of B5: {len(dsa)} functions, HMMA in phase A and "
          f"phase B ({', '.join(f'{n}' for n in products.values())}; "
          f"3xTF32); K3/K4's wide instances: {len(wide)} functions "
          f"({len(f32)} f32, 3xTF32), each with HMMA (fewest "
          f"{min(wide.values() or [0])}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"SASS: B5 f32 {dsa}; K3/K4 wide {wide}")


# TPU kernels whose function a kernel of the port computes (ROADMAP Queue
# B, "by function"): B12 padded27, B11, B12 aligned, B14 and B18 are B1's
# conv; B7's o2a form and B13 are K1's weight gradient; B8's forward is
# B2's finale; B16 is B4's upsample.
BY_FUNCTION = {
    "conv3d": ["fcd_tpu/kernels/block_conv.py:329",    # blocked_conv_s2d_padded27
               "fcd_tpu/kernels/block_conv.py:465",    # blocked_conv_s2d_fused
               "fcd_tpu/kernels/block_conv.py:1701",   # blocked_conv_s2d_aligned
               "fcd_tpu/kernels/block_conv.py:1732",   # _blocked_conv_s2d
               "fcd_tpu/kernels/block_conv.py:1116"],  # _halo_pad
    "conv3d_wgrad": ["fcd_tpu/kernels/block_conv.py:1435",  # blocked_conv_o2a_dw
                     "fcd_tpu/kernels/block_conv.py:1626"],  # blocked_conv_s2d_dw
    "finale_pool": ["fcd_tpu/kernels/finale.py:70"],         # finale_fwd_pallas
    "upsample2x": ["fcd_tpu/kernels/upsample.py:61"],        # upsample_s2d_pallas
}


def _dsa_width(label: str) -> str:
    """'C=.. P=.. head width ..' of a B5 phase's label (4 heads)."""
    c = int(label.split("C=")[1].split()[0])
    return f"C={c} P={label.split('P=')[1].split()[0]} head width {c // 4}"


def kernels_json(phases, by_path):
    """by_path: {path: launch counts of that path's run}; `launches` sums
    the paths, `launches_by_path` keeps them apart."""
    import fcd_tpu_torch.kernels.block_conv as b1
    import fcd_tpu_torch.kernels.conv_finish as fin
    import fcd_tpu_torch.kernels.conv_wgrad as k1
    import fcd_tpu_torch.kernels.dsa_attention as b5
    import fcd_tpu_torch.kernels.finale as k2
    import fcd_tpu_torch.kernels.finale_head as b15
    import fcd_tpu_torch.kernels.pool as b2
    import fcd_tpu_torch.kernels.pool2x as b3b9
    import fcd_tpu_torch.kernels.spatial_attn as k34
    import fcd_tpu_torch.kernels.sw_io as sw_io
    import fcd_tpu_torch.kernels.upsample as b4

    meta = {
        "conv3d": ("cuda", "fcd_tpu_torch/csrc/conv3d.cu", b1.REPLACES),
        "conv3d_wgrad": ("cuda", "fcd_tpu_torch/csrc/conv3d_wgrad.cu",
                         k1.REPLACES),
        "finale_pool": ("triton", "fcd_tpu_torch/kernels/pool.py",
                        b2.REPLACES),
        "finale_bwd": ("cuda", "fcd_tpu_torch/csrc/finale_bwd.cu",
                       k2.REPLACES),
        "upsample2x": ("cuda", "fcd_tpu_torch/csrc/upsample.cu", b4.REPLACES),
        "dsa_phase_a": ("cuda", "fcd_tpu_torch/csrc/dsa.cu", b5.REPLACES_A),
        "dsa_phase_b": ("cuda", "fcd_tpu_torch/csrc/dsa.cu", b5.REPLACES_B),
        "dsa_phase_a_f32": ("cuda", "fcd_tpu_torch/csrc/dsa_f32.cu",
                            b5.REPLACES_A),
        "dsa_phase_b_f32": ("cuda", "fcd_tpu_torch/csrc/dsa_f32.cu",
                            b5.REPLACES_B),
        # csrc/dsa.cu built with -DFCD_F16 (libdsa_f16)
        "dsa_phase_a_f16": ("cuda", "fcd_tpu_torch/csrc/dsa.cu",
                            b5.REPLACES_A),
        "dsa_phase_b_f16": ("cuda", "fcd_tpu_torch/csrc/dsa.cu",
                            b5.REPLACES_B),
        "spatial_attn_fwd": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                             k34.REPLACES_FWD),
        "spatial_attn_bwd": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                             k34.REPLACES_BWD),
        "spatial_attn_fwd_f32": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                                 k34.REPLACES_FWD),
        "spatial_attn_bwd_f32": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                                 k34.REPLACES_BWD),
        # csrc/spatial_attn.cu built with -DFCD_F16 (libspatial_attn_f16)
        "spatial_attn_fwd_f16": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                                 k34.REPLACES_FWD),
        "spatial_attn_bwd_f16": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                                 k34.REPLACES_BWD),
        "sw_entry": ("cuda", "fcd_tpu_torch/csrc/sw_io.cu",
                     sw_io.REPLACES_ENTRY),
        "sw_exit": ("cuda", "fcd_tpu_torch/csrc/sw_io.cu", sw_io.REPLACES_EXIT),
        "max_pool2x": ("triton", "fcd_tpu_torch/kernels/pool2x.py",
                       b3b9.REPLACES_FWD),
        "max_pool2x_bwd": ("cuda", "fcd_tpu_torch/csrc/pool2x_bwd.cu",
                           b3b9.REPLACES_BWD),
        "finale_head": ("cuda", "fcd_tpu_torch/csrc/finale_head.cu",
                        b15.REPLACES),
        # B1 split around tensor parallelism's all-reduce
        "conv3d_partial": ("cuda", "fcd_tpu_torch/csrc/conv3d.cu",
                           b1.REPLACES),
        "conv_finish": ("cuda", "fcd_tpu_torch/csrc/conv_finish.cu",
                        fin.REPLACES),
    }
    out = []
    for name, (route, source, replaces) in meta.items():
        mine = [p for p in phases if p.kernel == name]
        lib = [p.library_ms for p in mine]
        top = max(mine, key=lambda p: p.bound_ms)
        out.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "also_replaces": BY_FUNCTION.get(name, []),
            "launches": sum(c.get(name, 0) for c in by_path.values()),
            "launches_by_path": {k: c.get(name, 0)
                                 for k, c in by_path.items()},
            "max_abs_err": max(p.abs_err for p in mine),
            "ms": sum(p.ms for p in mine),
            "plain_ms": sum(p.plain_ms for p in mine),
            "bound_ms": sum(p.bound_ms for p in mine),
            "bound_by": top.bound_by,
            "library_ms": None if None in lib else sum(lib),
            **({"call_ms": sum(p.call_ms for p in mine),
                "library_call_ms": None if None in lib else sum(
                    p.library_call_ms for p in mine)}
               if mine[0].call_ms is not None else {}),
            "shapes": [p.label for p in mine],
            **({"widths": sorted({_dsa_width(p.label) for p in mine}),
                "sa_types": sorted({next((t for t in OTHER_SA_TYPES
                                          if f" {t} " in p.label),
                                         "parallel") for p in mine})}
               if name.startswith("dsa_") else {}),
            **({"c15_widths": [p.label for p in mine
                               if any(p.label.startswith(w[0])
                                      for w in C15_WIDTHS)]}
               if name.startswith("spatial_attn") else {}),
        })
    return {"kernels": out}


# the kernels on the tensor cores: (library, kernel, template arguments,
# the SASS instruction that must be in it)
BUILD_REPORTS = {
    "conv3d": ("conv3d", "conv3d_kernel", ("bn", "mt", "vec", "partial"),
               "HGMMA"),
    "conv3d_wgrad": ("conv3d_wgrad", "wgrad_mma_kernel", ("mi", "ni"),
                     "HMMA"),
    "upsample2x": ("upsample", "upsample_kernel", ("wm", "wn", "ni"), "HMMA"),
    "dsa": ("dsa", DSA_KERNELS, ("ch", "p"), "HMMA"),
    "spatial_attn": ("spatial_attn", SPATTN_KERNELS, ("c", "p", "co|hb"),
                     "HMMA"),
    "dsa_f16": ("dsa_f16", DSA_KERNELS, ("ch", "p"), "HMMA"),
    "spatial_attn_f16": ("spatial_attn_f16", SPATTN_KERNELS,
                         ("c", "p", "co|hb"), "HMMA"),
    # no products: their 16- and 8-byte loads instead
    "finale_bwd": ("finale_bwd", FINALE_BWD_KERNELS,
                   ("vec", "mode", "nt", "minb"), "LDG.E.128"),
    "max_pool2x_bwd": ("pool2x_bwd", "pool2x_bwd_kernel", ("vec",),
                       "LDG.E.64"),
}
# `--kernels NAME,...`: only these kernels' phases
ONLY_PHASES = {"upsample2x": upsample_phases, "sw_exit": sw_io_phases,
               "max_pool2x_bwd": pool2x_bwd_phases,
               "sw_entry": sw_io_phases, "finale_bwd": finale_bwd_phases,
               "dsa_phase_a": dsa_phases, "dsa_phase_b": dsa_phases,
               "spatial_attn_fwd": spatial_attn_levels,
               "spatial_attn_bwd": spatial_attn_levels,
               "dsa_phase_a_f32": dsa_f32_phases,
               "dsa_phase_b_f32": dsa_f32_phases,
               "spatial_attn_fwd_f32": spatial_attn_f32_levels,
               "spatial_attn_bwd_f32": spatial_attn_f32_levels,
               "dsa_phase_a_f16": dsa_f16_phases,
               "dsa_phase_b_f16": dsa_f16_phases,
               "spatial_attn_fwd_f16": spatial_attn_f16_levels,
               "spatial_attn_bwd_f16": spatial_attn_f16_levels,
               "zoo_widths": zoo_width_phases,
               "tp_widths": tp_width_phases}


def elapsed(t_start, what) -> None:
    """The run's seconds so far, as a section starts."""
    print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)


def kernels_only(dev, gen, names) -> int:
    """The phases of the named kernels (ONLY_PHASES) alone, each function
    once: checks and times, no main path and no result line."""
    for fn in dict.fromkeys(ONLY_PHASES[name] for name in names):
        fn(dev, gen)
    print(card_line())
    return 0


def main(argv=()) -> int:
    import torch

    only = []
    mesh_only = list(argv) in (["--mesh"], ["--tp"])
    if argv and not mesh_only:
        if len(argv) != 2 or argv[0] != "--kernels" or not set(
                argv[1].split(",")) <= set(ONLY_PHASES):
            print(f"usage: chip_smoke.py [--mesh | --tp | --kernels "
                  f"{'|'.join(ONLY_PHASES)}[,...]]", file=sys.stderr)
            return 2
        only = argv[1].split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fcd_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card} | torch: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} CUDA libraries in {time.perf_counter() - t0:.1f}"
          f" s ({', '.join(p.name for p in libs.values())})", flush=True)
    dump_sass([args[0] for args in BUILD_REPORTS.values()] + ["dsa_f32"])
    for args in BUILD_REPORTS.values():
        build_report(*args)
    f32_sass_report()

    print("kernels against their plain versions (bf16, main-path shapes):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if only:
        return kernels_only(dev, gen, only)
    if mesh_only:
        (mesh_run if argv[0] == "--mesh" else tp_run)(card)
        print(card_line())
        return 0
    elapsed(t_start, "kernel phases")
    phases = kernel_phases(dev, gen)
    torch.cuda.empty_cache()
    elapsed(t_start, "inference")
    launches, trainer, patch, vol, logits = slice_run(dev, card)
    by_path = {"inference": launches}
    by_path.update(gated_inference_run(dev, card, trainer, vol, logits))
    del vol, logits
    x = patch.to(dev)
    prof = profile_run(f"one {tuple(patch.shape[1:4])} patch forward",
                       lambda: trainer.predict(x), dev)
    print_share(prof, "B4 in the patch", ("upsample_kernel",))
    print_share(prof, "B5 in the patch", ("dsa_phase_a", "dsa_phase_b"))
    del trainer, x
    torch.cuda.empty_cache()
    elapsed(t_start, "train")
    by_path["train"], trainer, batch = train_run(dev, card)
    with torch.enable_grad():
        prof = profile_run(f"one train step, batch {TRAIN_BATCH}x128^3",
                           lambda: trainer.train_step(*batch), dev)
    print_share(prof, "K1 in the step", ("wgrad_mma_kernel",
                                         "wgrad_sum_kernel"))
    print_share(prof, "B4 in the step", ("upsample_kernel",))
    print_share(prof, "K3 in the step", ("spatial_attn_fwd",))
    print_share(prof, "K4 in the step", ("spatial_attn_bwd",))
    print_share(prof, "K2 in the step (all Finale.backward launches)",
                ("finale_bwd",))
    train_check(dev)
    train_repro(dev)
    torch.cuda.empty_cache()
    gated = "train, pool in its own pass"
    by_path[gated], gtrainer, _ = train_run(dev, card, POOL_GATES)
    tv = "train, TV-regularised"
    by_path[tv], tvtrainer, _ = train_run(dev, card, extra=TV_PARAMS)
    train_ab(card, {"default": trainer, gated: gtrainer, tv: tvtrainer},
             batch)
    with torch.enable_grad():
        for name, tr in ((gated, gtrainer), (tv, tvtrainer)):
            profile_run(f"one train step, batch {TRAIN_BATCH}x128^3, {name}",
                        lambda tr=tr: tr.train_step(*batch), dev)
    del trainer, gtrainer, tvtrainer, batch
    torch.cuda.empty_cache()
    for perf_flags, extra in ((POOL_GATES, None), (None, TV_PARAMS),
                              (None, GDF_PARAMS), (None, ACCUM_PARAMS)):
        train_check(dev, perf_flags, extra)
        torch.cuda.empty_cache()
    # the gates live in each trainer's model: a trainer built from the
    # default params runs the default path again
    from fcd_tpu_torch import flags

    defaults = flags.model_gates(flags.resolve({}))
    if defaults != {"pool_in_finale": (True, True), "fused_head": False,
                    "levels12_tie": "even"}:
        raise AssertionError(f"the default gates resolve to {defaults}")
    elapsed(t_start, "cli")
    by_path["cli"] = cli_run(dev, card)
    torch.cuda.empty_cache()
    elapsed(t_start, "augment")
    augment_phase(dev, gen)
    torch.cuda.empty_cache()
    elapsed(t_start, "train_cli")
    by_path["train_cli"] = train_cli_run(dev, card)
    torch.cuda.empty_cache()
    elapsed(t_start, "mesh")
    by_path.update(mesh_run(card))
    torch.cuda.empty_cache()
    elapsed(t_start, "tp")
    by_path.update(tp_run(card))
    torch.cuda.empty_cache()
    elapsed(t_start, "profiling")
    a6_run(dev, card)
    torch.cuda.empty_cache()
    elapsed(t_start, "segresnet_dsa and zoo")
    by_path.update(segresnet_dsa_run(dev, card))
    for label, extra, counts in ZOO_RUNS:
        torch.cuda.empty_cache()
        by_path.update(zoo_run(dev, card, label, extra, counts))
    torch.cuda.empty_cache()
    elapsed(t_start, "f32")
    by_path.update(f32_run(dev, card))
    torch.cuda.empty_cache()
    elapsed(t_start, "f16")
    by_path.update(f16_run(dev, card))
    torch.cuda.empty_cache()
    elapsed(t_start, "unetrpp")
    by_path.update(unetrpp_run(dev, card))
    for label, extra, counts, routes in A7_RUNS:
        torch.cuda.empty_cache()
        elapsed(t_start, f"zoo {label}")
        by_path.update(zoo_run(dev, card, label, extra, counts, full=True,
                               routes=routes))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to "
          f"the result, the build included", flush=True)
    print(json.dumps(kernels_json(phases, by_path)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
