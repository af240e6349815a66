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
   resume to 3 epochs.
9. Prints the `kernels` JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --kernels upsample2x,sw_exit
    python3 chip_smoke.py --kernels dsa_phase_a,dsa_phase_b
    python3 chip_smoke.py --kernels spatial_attn_fwd,spatial_attn_bwd
    python3 chip_smoke.py --kernels finale_bwd,sw_entry
    python3 chip_smoke.py --kernels max_pool2x_bwd

builds the kernels and runs only the named kernels' phases (checks and
times; no main path and no result line).
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

PEAK_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
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


def cuda_events(fn, iters: int, tries: int = 5) -> list:
    """The device events of `iters` calls of fn (torch.profiler), from a
    whole trace. On the card the profiler sometimes records no event, or
    drops some (PERF.md section 7), which would read as too little device
    time. So each try also traces one call, and the trace of `iters` calls
    is kept only when it holds each op `iters` times as often as that one
    call launched it. Fails after `tries` tries."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    seen = []
    for _ in range(tries):
        one = Counter(e.name for e in trace(1))
        events = trace(iters)
        got = Counter(e.name for e in events)
        if one and got == Counter({k: n * iters for k, n in one.items()}):
            if seen:
                print(f"  (the profiler dropped events in {len(seen)} "
                      "trace(s), taken again)")
            return events
        seen.append((sum(one.values()), sum(got.values())))
    raise AssertionError(f"no whole trace of {iters} calls in {tries} tries "
                         f"(ops in one call, in {iters} calls: {seen})")


def device_times(fn, iters: int) -> dict:
    """Mean device ms per call of each kernel, copy and fill that `fn`
    launches, by name, over `iters` calls after a warm-up call
    (torch.profiler). Where a call's host work outlasts its device work,
    CUDA events around back-to-back calls time the host; this times the
    card. On a CPU run: {"host": the host clock per call}."""
    import torch

    if not torch.cuda.is_available():
        return {"host": timed_ms(fn, iters)}
    fn()
    torch.cuda.synchronize()
    out = {}
    for e in cuda_events(fn, iters):
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

    def __init__(self, kernel, label, flops, nbytes):
        self.kernel, self.label = kernel, label
        self.flops, self.bytes = float(flops), float(nbytes)
        self.abs_err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        # where `ms` and `library_ms` are device times: each call's wall
        # time, and the share of `ms` in the kernel itself
        self.call_ms = self.library_call_ms = self.kernel_ms = None

    @property
    def bound_ms(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES) * 1e3

    @property
    def bound_by(self) -> str:
        return ("operations" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES
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
    lib = _build.build_all([name])[name]
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if sass.returncode != 0:
        raise AssertionError(f"cuobjdump failed: {sass.stderr.strip()}")
    n = sum(bool(re.search(rf"\b{instr}\b", line))
            for line in sass.stdout.splitlines())
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


def finale_phase(label, dev, gen, grid, c, iters=10):
    """B2 at one shape, with the pool, timed by the device time of one
    call."""
    import torch

    from fcd_tpu_torch.kernels.pool import finale_pool, finale_pool_plain

    bf = torch.bfloat16
    nvox = grid[0] * grid[1] * grid[2]
    y2 = _randn((1, *grid, c), gen, dev, dtype=bf)
    r = _randn((1, *grid, c), gen, dev, dtype=bf)
    aff = [_randn((1, c), gen, dev) for _ in range(4)]
    ph = Phase("finale_pool", label, 8 * nvox * c,
               3 * 2 * nvox * c + 2 * nvox * c // 8 + 16 * c)
    out, pooled = finale_pool(y2, r, *aff, 0.01, pool=True)
    out_p, pooled_p = finale_pool_plain(y2, r, *aff, 0.01, pool=True)
    ph.check("out", out, out_p, 1e-2)
    ph.check("pooled", pooled, pooled_p, 1e-2)
    time_on_device(ph, lambda: finale_pool(y2, r, *aff, 0.01, pool=True),
                   "finale_kernel", iters)
    ph.plain_ms = timed_ms(
        lambda: finale_pool_plain(y2, r, *aff, 0.01, pool=True), iters)
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


def dsa_phase(label, dev, gen, n, c, p, h=4, iters=10):
    """B5 at one level's shape, batch 1, with the model's f32 weights and
    EF: phase A's sums and, with the temperatures, the finishing pass's
    phase-B operands against the plain versions, phase B against its plain
    version, the whole op against the f32 einsum reference, each of them
    twice bit-equal; on the card, one dsa_attention call is exactly the
    three B5 kernels. `ms` is the device time of all one main-path call of
    the phase launches (phase A with its finishing pass), the kernels alone
    and the wall per call beside it."""
    import torch

    from fcd_tpu_torch.kernels import dsa_attention as dk

    bf = torch.bfloat16
    x = _randn((1, n, c), gen, dev, dtype=bf)
    w = _randn((c, 4 * c), gen, dev, (6.0 / (5 * c)) ** 0.5)
    ef = (torch.rand((n, p), generator=gen, device=dev) * 2 - 1) / p ** 0.5
    t1 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
    t2 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
    tok = (1.0 + _randn((c,), gen, dev, 0.1), _randn((c,), gen, dev, 0.1),
           _randn((n, c), gen, dev, 0.1))
    gamma = _randn((c,), gen, dev)
    temps = (t1, t2)
    ch = c // h
    # the work counts of the kernels this one replaced (the whole C x C of
    # q^T k), kept so that times compare like with like
    flops_a = 2 * n * c * c * 3 + 2 * n * c * c + 2 * 2 * n * c * p
    bytes_a = 2 * n * c + 4 * n * c + 2 * n * p + 3 * 2 * c * c + 8 * c \
        + 4 * (c * c + 2 * c + 2 * c * p)
    flops_b = 2 * n * c * c * 2 + 2 * n * c * ch + 2 * 2 * n * c * p
    bytes_b = 2 * n * c + 4 * n * c + 2 * 2 * c * c + 4 * c + 2 * c * c \
        + 2 * 2 * c * p + 12 * c + 2 * n * c
    pa = Phase("dsa_phase_a", label, flops_a, bytes_a)
    pb = Phase("dsa_phase_b", label, flops_b, bytes_b)
    plan = dk.dsa_plan(n, c, p, h)
    print(f"  dsa {label}: tile {plan.tile}, phase A {plan.a_blocks} blocks "
          f"({plan.chunks} chunks of {plan.per_chunk} tiles a head), phase B "
          f"{plan.b_blocks} blocks, shared memory {plan.smem_a} / "
          f"{plan.smem_b} bytes")

    def phase_a():
        return dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps)

    ka = dk.dsa_phase_a(x, w, ef, *tok, h)
    wa = dk.dsa_phase_a_plain(x, w, ef, *tok, h)
    for name, g_, w_ in zip(ka._fields, ka, wa):
        pa.check(name, g_, w_, 2e-2)
    check_repeatable(pa, ka, dk.dsa_phase_a(x, w, ef, *tok, h))
    ops = phase_a()
    for name, g_, w_ in zip(ops._fields, ops, dk.dsa_glue(wa, t1, t2, h, bf)):
        pa.check(f"finishing pass {name}", g_, w_, 2e-2)
    check_repeatable(pa, ops, phase_a())

    def phase_b():
        return dk.dsa_phase_b(x, w, *ops, gamma, *tok, h)

    kb = phase_b()
    pb.check("out", kb, dk.dsa_phase_b_plain(x, w, *ops, gamma, *tok, h),
             2e-2)
    check_repeatable(pb, [kb], [phase_b()])
    # the whole op against the f32 einsum math; bf16 rounding of the
    # kernels' intermediates sets the tolerance
    args = (x, w, ef, t1, t2, *tok, gamma, h)
    whole = dk.dsa_attention(*args)
    op = Phase("dsa_attention", label, 0, 0)
    op.check("whole op vs f32 einsum reference", whole,
             dk.dsa_reference(*args), 5e-2)
    check_repeatable(op, [whole], [dk.dsa_attention(*args)])
    if dev.type == "cuda":
        launched = device_kernels(lambda: dk.dsa_attention(*args))
        ok = len(launched) == 3 and all(
            k in e for k, e in zip(DSA_KERNELS, launched))
        print(f"  dsa_attention {label}: one call launches {launched} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dsa_attention {label}: launches "
                                 f"{launched}, not the three B5 kernels")

    for ph, call, key, plain in (
            (pa, phase_a, "dsa_phase_a",
             lambda: dk.dsa_glue(dk.dsa_phase_a_plain(x, w, ef, *tok, h),
                                 t1, t2, h, bf)),
            (pb, phase_b, "dsa_phase_b",
             lambda: dk.dsa_phase_b_plain(x, w, *ops, gamma, *tok, h))):
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
                for k in DSA_KERNELS if any(k in n_ for n_ in times)))
    return [pa, pb]


# the B5 kernels one dsa_attention call launches, in order
DSA_KERNELS = ("dsa_phase_a_kernel", "dsa_phase_a_finish",
               "dsa_phase_b_kernel")
# K3's kernel, then K4's two, in launch order
SPATTN_KERNELS = ("spatial_attn_fwd_kernel", "spatial_attn_bwd_kernel",
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


def dsa_phases(dev, gen, small=False):
    """B5 at the four levels' shapes and at DSA_WIDTHS (`small`: level 3
    at 512 tokens)."""
    out = []
    for name, n, c, p in DSA_LEVELS + DSA_WIDTHS:
        out += dsa_phase(f"{name} N={n} C={c} P={p}", dev, gen,
                         min(n, 512) if small else n, c, p)
    return out


def device_kernels(fn) -> list:
    """The names of the device ops one call of fn launches, in order."""
    import torch

    fn()
    torch.cuda.synchronize()
    return [e.name for e in sorted(cuda_events(fn, 1),
                                   key=lambda e: e.time_range.start)]


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
                        iters=10):
    """K3 and K4 at one level's shape, with dropout: the kernels and the
    plain versions draw the same hash bits, so they agree elementwise; two
    K4 calls give the same bits; on the card one K3 call is one device
    kernel and one K4 call its two. `ms` and `library_ms` (SDPA, and SDPA's
    backward alone) are the device time of all one call launches, the
    kernels alone and the wall per call beside them."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels import spatial_attn as sa

    bf = torch.bfloat16
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
    plan = sa.spatial_attn_plan(n, c, p, h, batch)
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
    pf = Phase("spatial_attn_fwd", label, 2 * mm,
               2 * (2 * batch * n * c + 2 * batch * c * hp))
    # as SpatialAttn.backward calls it: dkpb and dvpb in kpb's dtype (bf16)
    pb = Phase("spatial_attn_bwd", label, 5 * mm,
               2 * (3 * batch * n * c + 4 * batch * c * hp))

    def fwd():
        return sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate)

    def bwd():
        return sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate,
                                   dtypes=(bf, bf))

    pf.check("out", fwd(), sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                                     rate), 2e-2)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    # both stores of the finishing pass: bf16 (the main path's) and f32
    # (the wrapper's default)
    got = bwd()
    for name, g_, w_ in zip(("dqn", "dkpb bf16", "dvpb bf16"), got, want):
        pb.check(name, g_, w_, 2e-2)
    check_repeatable(pb, got, bwd())
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
    for name, g_, w_ in zip(("dkpb f32", "dvpb f32"), got[1:], want[1:]):
        pb.check(name, g_, w_, 2e-2)
    del got, want
    if dev.type == "cuda":
        for ph, call, names in ((pf, fwd, SPATTN_KERNELS[:1]),
                                (pb, bwd, SPATTN_KERNELS[1:])):
            launched = device_kernels(call)
            ok = len(launched) == len(names) and all(
                k in e for k, e in zip(names, launched))
            print(f"  {ph.kernel} {label}: one call launches {launched} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{ph.kernel} {label}: launches "
                                     f"{launched}, not {list(names)}")
    # library yardstick, timed only: the same per-head attention through
    # SDPA (its own dropout stream), q (B, h, N, c), k and v (B, h, P, c);
    # and K4's: the backward of that SDPA call alone (its forward once,
    # the graph kept), with the cotangent in SDPA's layout
    q4 = qn.reshape(batch, n, h, ch).transpose(1, 2)
    k4 = kp.transpose(2, 3).to(bf)
    v4 = vp.transpose(2, 3).to(bf)
    g4 = g.reshape(batch, n, h, ch).transpose(1, 2)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*ins, dropout_p=rate, scale=1.0)

        def library_fwd():
            return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=rate,
                                                  scale=1.0)

        def library_bwd():
            return torch.autograd.grad(out, ins, g4, retain_graph=True)

        for ph, call, kernel, plain, library in (
                (pf, fwd, SPATTN_KERNELS[0],
                 lambda: sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key,
                                                   rate), library_fwd),
                (pb, bwd, SPATTN_KERNELS[1],
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
        del out, ins
    return [pf, pb]


def spatial_attn_levels(dev, gen, small=False):
    """K3 and K4 at the four levels' shapes at the train step's batch 4
    (`small`: batch 1, level 3 at 512 tokens)."""
    out = []
    for name, n, c, p in DSA_LEVELS:
        b, n = (1, min(n, 512)) if small else (TRAIN_BATCH, n)
        out += spatial_attn_phases(f"{name} {b}xN={n} C={c} hP={4 * p}",
                                   dev, gen, b, n, c, p)
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
    phases += spatial_attn_levels(dev, gen, small)
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
    return phases


# -- the main path ---------------------------------------------------------------

def counters():
    from fcd_tpu_torch.kernels import (
        block_conv,
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
            "spatial_attn_fwd": spatial_attn.spatial_attn_fwd,
            "spatial_attn_bwd": spatial_attn.spatial_attn_bwd,
            "sw_entry": sw_io.sw_entry, "sw_exit": sw_io.sw_exit,
            "max_pool2x": pool2x.max_pool2x,
            "max_pool2x_bwd": pool2x.max_pool2x_bwd,
            "finale_head": finale_head.finale_head}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


# launches per 128^3 patch: 23 res blocks x 2 convs, 23 finales, 5
# upsamples, 12 DSA calls (4 levels x 3 layers) per phase
PER_PATCH = {"conv3d": 46, "conv3d_wgrad": 0, "finale_pool": 23,
             "finale_bwd": 0, "upsample2x": 5, "dsa_phase_a": 12,
             "dsa_phase_b": 12, "spatial_attn_fwd": 0, "spatial_attn_bwd": 0,
             "sw_entry": 0, "sw_exit": 0, "max_pool2x": 0,
             "max_pool2x_bwd": 0, "finale_head": 0}
# and per volume: the engine's entry and exit
PER_VOLUME = {"sw_entry": 1, "sw_exit": 1}

# the gated paths: encoders 1-2 pool in a pass of their own (B3; B9 in
# training), or the last decoder's finale runs fused with the head (B15)
POOL_GATES = {"FCD_FINALE_POOL": "0", "FCD_FINALE_TRAIN": "0"}
HEAD_GATES = {"FCD_FUSED_HEAD": "1"}


def per_volume(n_patches: int, perf_flags=None) -> dict:
    """Launches of one sliding-window inference over n_patches patches
    under perf_flags (POOL_GATES, HEAD_GATES or the defaults)."""
    patch = dict(PER_PATCH)
    if perf_flags == POOL_GATES:
        patch["max_pool2x"] = 2
    elif perf_flags == HEAD_GATES:
        patch["finale_pool"] -= 1
        patch["finale_head"] = 1
    out = {k: v * n_patches for k, v in patch.items()}
    out.update(PER_VOLUME)
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
    enc, tb, dec = 6, 4 * 3, 5
    blocks = enc + tb + dec
    dgrad = 1 + 2 * (enc - 1) + 2 * tb + 3 * dec
    own_pass = 2 if perf_flags == POOL_GATES else 0   # encoders 1-2
    return {"conv3d": 2 * blocks + dgrad,
            "conv3d_wgrad": 2 * enc + 2 * tb + 3 * dec,
            "finale_pool": blocks, "finale_bwd": blocks, "upsample2x": dec,
            "dsa_phase_a": 0, "dsa_phase_b": 0,
            "spatial_attn_fwd": tb, "spatial_attn_bwd": tb,
            "sw_entry": 0, "sw_exit": 0, "max_pool2x": own_pass,
            "max_pool2x_bwd": own_pass, "finale_head": 0}


# bf16 activations rounded through ~50 layers against an fp32 forward: on
# an H100 this seeded patch measured rel 2.3e-2 to 2.5e-2 and argmax
# agreement 0.9988; the limits leave 2x margin on the error
PATCH_REL_TOL = 0.05
PATCH_ARGMAX_AGREE = 0.99


def slice_run(dev, card, params=None, vol_shape=(182, 218, 182)):
    import numpy as np
    import torch

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.infer.sliding_window import dense_patch_starts
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params() if params is None else params
    trainer = ModelTrainer(params, device=dev)
    # weights from the trainer's seeded initialisation; gamma (1e-6) and the
    # zero pos-embed are redrawn from a seeded generator so that the DSA
    # path contributes to the logits the check below compares
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for stack in trainer.model.transformers:
            for blk in stack:
                blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape,
                                                  generator=gen))
                blk.pos_embed.copy_(0.1 * torch.randn(blk.pos_embed.shape,
                                                      generator=gen))
    vol = np.random.RandomState(SEED).standard_normal(
        (*vol_shape, params["chans_in"])).astype(np.float32)
    roi = (params["patch_size"],) * 3
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

    print(f"slice: ModelTrainer.inference {vol_shape}x{params['chans_in']} "
          f"volume, {n_patches} patches of {roi}: {ms:.1f} ms/volume, "
          f"{1e3 / ms:.3f} vol/s on {card} (first call, incl. JIT: "
          f"{first_s:.1f} s)", flush=True)
    if tuple(out.shape) != (*vol_shape, params["chans_out"]) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"logits {tuple(out.shape)} {out.dtype}: not "
                             "finite f32 of the volume's shape")
    want = per_volume(n_patches)
    print(f"  launches {launches} (expected {want})")
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    # one patch: the card's logits against the port's fp32 CPU forward
    patch = torch.from_numpy(vol[:roi[0], :roi[1], :roi[2]])[None]
    with torch.no_grad():
        got = trainer.model(patch.to(dev)).float().cpu()
        cpu_model = copy.deepcopy(trainer.model).cpu()
        cpu_model.compute_dtype = torch.float32
        t0 = time.perf_counter()
        want_logits = cpu_model(patch)
        cpu_s = time.perf_counter() - t0
    a, r = rel_err(got, want_logits)
    agree = float((got.argmax(-1) == want_logits.argmax(-1)).float().mean())
    ok = r <= PATCH_REL_TOL and agree >= PATCH_ARGMAX_AGREE
    print(f"  patch {roi} vs fp32 CPU forward ({cpu_s:.1f} s): max_abs_err "
          f"{a:.3e} rel {r:.3e} (tol {PATCH_REL_TOL}), argmax agreement "
          f"{agree:.5f} (min {PATCH_ARGMAX_AGREE}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("card logits disagree with the fp32 CPU forward")
    return launches, trainer, patch, vol, out


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
                  shape=TRAIN_CLI_SHAPE):
    """`python -m fcd_tpu_torch.cli.train` (cli.train.main) on the card at
    the default model's full width, on a seeded synthetic set written under
    build/ (3 train, 1 val, 1 test subject of TRAIN_CLI_SHAPE): 2 epochs of
    4 x 128^3 steps with augmentation, validation and the best and latest
    checkpoints, then the test without and with post-processing; the
    counters set to 0 just before and read just after. Prints the launch
    counts by phase (held to the per-step and per-volume counts), seconds
    per epoch and phase, and the test metrics; checks finite losses, the
    CSV, the checkpoints, that every transform ran in the second epoch, and
    that a resume with max_epochs=3 appends epoch 3. Returns the counts."""
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
            "val", "test", "--save_dir", out, "--prefix", "smoke"]
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
    want = {"train steps": {k: steps * v for k, v in per_train_step().items()},
            "validation": {k: epochs * v for k, v in per_volume(n_patches).items()},
            "test": {k: 2 * v for k, v in per_volume(n_patches).items()}}
    print(f"train_cli: cli.train.main, MS_DSA_NET fs{params['feature_size']} "
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
                "dsa_phase_b", "spatial_attn_fwd", "spatial_attn_bwd",
                "sw_entry_kernel", "sw_exit_kernel", "pool_fwd_kernel",
                "pool2x_bwd_kernel", "finale_head_kernel")


def profile_run(label, fn, dev) -> dict:
    """Where one call of fn spends the card's time: device time by kernel
    (torch.profiler) and the device's idle share of the synchronised wall
    time. Returns {kernel key: device ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k in PROFILE_KEYS if k in e.name), e.name[:60])
            n, us = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    if busy == 0:
        print(f"profile: {label}: the profiler recorded no device time; "
              "per-kernel breakdown not measured")
        return {}
    print(f"profile: {label}, wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share "
          f"{100 * max(0.0, 1 - busy / wall_us):.1f}%, "
          f"{sum(n for n, _ in by_name.values())} device kernels")
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


def train_run(dev, card, perf_flags=None, extra=None):
    """The train step at batch 4 x 128^3 (under perf_flags, with the params
    in `extra`): warm-up, then timed steps with the launch counters read
    around them."""
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
    want = {k: v * TRAIN_STEPS
            for k, v in per_train_step(perf_flags).items()}
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


def _grad_distance(model, ref) -> dict:
    """{group: (rel-L2, cosine)} of model's gradients against ref's."""
    import torch

    out = {}
    mg, rg = _groups(model), _groups(ref)
    for key in mg:
        g = torch.cat([p.grad.float().cpu().ravel() for p in mg[key]])
        w = torch.cat([p.grad.float().ravel() for p in rg[key]])
        out[key] = (float((g - w).norm() / w.norm()),
                    float(torch.dot(g, w) / (g.norm() * w.norm())))
    return out


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
    lines = []
    for key, (rel, cos) in d_card.items():
        ref_rel, ref_cos = d_bf16[key]
        good = (math.isfinite(rel) and math.isfinite(cos)
                and rel <= GROUP_MARGIN * ref_rel + 1e-3
                and 1 - cos <= GROUP_MARGIN * (1 - ref_cos) + 1e-4)
        ok = ok and good
        lines.append(f"{key} {rel:.2e}/{cos:.5f} (bf16 CPU {ref_rel:.2e}/"
                     f"{ref_cos:.5f}){'' if good else ' FAIL'}")
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
        "spatial_attn_fwd": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
                             k34.REPLACES_FWD),
        "spatial_attn_bwd": ("cuda", "fcd_tpu_torch/csrc/spatial_attn.cu",
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
            **({"widths": sorted({_dsa_width(p.label) for p in mine})}
               if name.startswith("dsa_") else {}),
        })
    return {"kernels": out}


# the kernels on the tensor cores: (library, kernel, template arguments,
# the SASS instruction that must be in it)
BUILD_REPORTS = {
    "conv3d": ("conv3d", "conv3d_kernel", ("bn", "mt", "vec"), "HGMMA"),
    "conv3d_wgrad": ("conv3d_wgrad", "wgrad_mma_kernel", ("mi", "ni"),
                     "HMMA"),
    "upsample2x": ("upsample", "upsample_kernel", ("wm", "wn", "ni"), "HMMA"),
    "dsa": ("dsa", DSA_KERNELS, ("ch", "p"), "HMMA"),
    "spatial_attn": ("spatial_attn", SPATTN_KERNELS, ("c", "p", "co|hb"),
                     "HMMA"),
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
               "spatial_attn_bwd": spatial_attn_levels}


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
    if argv:
        if len(argv) != 2 or argv[0] != "--kernels" or not set(
                argv[1].split(",")) <= set(ONLY_PHASES):
            print(f"usage: chip_smoke.py [--kernels "
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
    card = card_line()
    print(f"card: {card} | torch: {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} CUDA libraries in {time.perf_counter() - t0:.1f}"
          f" s ({', '.join(p.name for p in libs.values())})", flush=True)
    for args in BUILD_REPORTS.values():
        build_report(*args)

    print("kernels against their plain versions (bf16, main-path shapes):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if only:
        return kernels_only(dev, gen, only)
    phases = kernel_phases(dev, gen)
    torch.cuda.empty_cache()
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
    by_path["cli"] = cli_run(dev, card)
    torch.cuda.empty_cache()
    augment_phase(dev, gen)
    torch.cuda.empty_cache()
    by_path["train_cli"] = train_cli_run(dev, card)
    print(json.dumps(kernels_json(phases, by_path)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
