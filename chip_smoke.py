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
   B1 (conv3d), K1 (conv3d_wgrad) and their library calls (cuDNN) are
   timed by the device time of every kernel, copy and fill one call
   launches (torch.profiler: for B1 the weight packing and the statistics'
   sum with the conv, for K1 its second pass), with each call's wall time
   per call beside it; their build reports give each instance's registers
   and spills and the library's HGMMA (B1) or HMMA (K1) count (0 fails).
   K1, K2 and K4 sum in a fixed order: two calls must give the same bits.
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
   K1's share of its device time.
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
   Later phases run the default gates.
7. Prints the `kernels` JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
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


def device_times(fn, iters: int) -> dict:
    """Mean device ms per call of each kernel, copy and fill that `fn`
    launches, by name, over `iters` calls after a warm-up call
    (torch.profiler). Where a call's host work outlasts its device work,
    CUDA events around back-to-back calls time the host; this times the
    card. On a CPU run: {"host": the host clock per call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return {"host": timed_ms(fn, iters)}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = (out.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / iters / 1e3)
    if not out:
        raise AssertionError("the profiler saw no device work on the card")
    return out


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


def build_report(name, kernel, args, instr) -> int:
    """One CUDA library's build on the card: each instance of `kernel`
    (its template arguments named `args`), with its registers, shared
    memory and spills (nvcc -Xptxas -v, kept beside the library), and the
    count of `instr` instructions in the library's SASS. Fails if that
    count is 0: the kernel must multiply on the tensor cores."""
    import re

    from fcd_tpu_torch.kernels import _build

    shown = None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            vals = re.findall(r"L[ib](\d+)E", m.group(1))
            shown = (f"{kernel}<" + ", ".join(
                f"{a}={v}" for a, v in zip(args, vals)) + ">"
                if kernel in m.group(1) else m.group(1))
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
        raise AssertionError(f"{name} has no {instr}: it is off the tensor "
                             "cores")
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
    """B2 at one shape, with the pool."""
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
    ph.ms = timed_ms(lambda: finale_pool(y2, r, *aff, 0.01, pool=True), iters)
    ph.plain_ms = timed_ms(
        lambda: finale_pool_plain(y2, r, *aff, 0.01, pool=True), iters)
    ph.report()
    return ph


def upsample_phase(label, dev, gen, grid, ci, co, iters=10):
    """B4 at one shape (coarse grid, ci -> co)."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels.upsample import upsample2x, upsample2x_plain

    bf = torch.bfloat16
    nvox = grid[0] * grid[1] * grid[2]
    x = _randn((1, *grid, ci), gen, dev, dtype=bf)
    k = _randn((2, 2, 2, ci, co), gen, dev, (2.0 / (8 * co)) ** 0.5, bf)
    ph = Phase("upsample2x", label, 2 * nvox * ci * 8 * co,
               2 * nvox * ci + 2 * 8 * ci * co + 2 * 8 * nvox * co)
    ph.check("out", upsample2x(x, k), upsample2x_plain(x, k), 2e-2)
    ph.ms = timed_ms(lambda: upsample2x(x, k), iters)
    ph.plain_ms = timed_ms(lambda: upsample2x_plain(x, k), iters)
    xin = x.permute(0, 4, 1, 2, 3)
    wlib = torch.flip(k, dims=(0, 1, 2)).permute(3, 4, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    ph.library_ms = timed_ms(lambda: F.conv_transpose3d(xin, wlib, stride=2),
                             iters)
    ph.report()
    return ph


def dsa_phases(label, dev, gen, n, c, p, h=4, iters=10):
    """B5 phase A and phase B at one level's shape."""
    import torch

    from fcd_tpu_torch.kernels import dsa_attention as dk

    bf = torch.bfloat16
    x = _randn((1, n, c), gen, dev, dtype=bf)
    w_qkvv = _randn((c, 4 * c), gen, dev, (6.0 / (5 * c)) ** 0.5)
    ef = (torch.rand((n, p), generator=gen, device=dev) * 2 - 1) / p ** 0.5
    t1 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
    t2 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
    lns = 1.0 + _randn((c,), gen, dev, 0.1)
    lnb = _randn((c,), gen, dev, 0.1)
    pe = _randn((n, c), gen, dev, 0.1)
    gamma = _randn((c,), gen, dev)
    w4 = dk.split_qkvv(w_qkvv).to(bf).contiguous()
    efb = ef.to(bf)
    ch = c // h
    flops_a = 2 * n * c * c * 3 + 2 * n * c * c + 2 * 2 * n * c * p
    bytes_a = 2 * n * c + 4 * n * c + 2 * n * p + 3 * 2 * c * c + 8 * c \
        + 4 * (c * c + 2 * c + 2 * c * p)
    flops_b = 2 * n * c * c * 2 + 2 * n * c * ch + 2 * 2 * n * c * p
    bytes_b = 2 * n * c + 4 * n * c + 2 * 2 * c * c + 4 * c + 2 * c * c \
        + 2 * 2 * c * p + 12 * c + 2 * n * c
    pa = Phase("dsa_phase_a", label, flops_a, bytes_a)
    pb = Phase("dsa_phase_b", label, flops_b, bytes_b)

    ka = dk.dsa_phase_a(x, w4, efb, lns, lnb, pe)
    wa = dk.dsa_phase_a_plain(x, w4, efb, lns, lnb, pe)
    for name, g_, w_ in zip(ka._fields, ka, wa):
        pa.check(name, g_, w_, 2e-2)
    glue = dk.dsa_glue(ka, t1, t2, h, bf)
    kb = dk.dsa_phase_b(x, w4, *glue, gamma, lns, lnb, pe, h)
    wb = dk.dsa_phase_b_plain(x, w4, *glue, gamma, lns, lnb, pe, h)
    pb.check("out", kb, wb, 2e-2)
    # the whole op (phase A, glue, phase B) against the f32 einsum math;
    # bf16 rounding of the kernels' intermediates sets the tolerance
    Phase("dsa_attention", label, 0, 0).check(
        "whole op vs f32 einsum reference",
        dk.dsa_attention(x, w_qkvv, ef, t1, t2, lns, lnb, pe, gamma, h),
        dk.dsa_reference(x, w_qkvv, ef, t1, t2, lns, lnb, pe, gamma, h), 5e-2)

    pa.ms = timed_ms(lambda: dk.dsa_phase_a(x, w4, efb, lns, lnb, pe), iters)
    pa.plain_ms = timed_ms(
        lambda: dk.dsa_phase_a_plain(x, w4, efb, lns, lnb, pe), iters)
    pb.ms = timed_ms(
        lambda: dk.dsa_phase_b(x, w4, *glue, gamma, lns, lnb, pe, h), iters)
    pb.plain_ms = timed_ms(
        lambda: dk.dsa_phase_b_plain(x, w4, *glue, gamma, lns, lnb, pe, h),
        iters)
    pa.report()
    pb.report()
    return [pa, pb]


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


def finale_bwd_phase(label, dev, gen, batch, grid, c, iters=10):
    """K2 at one shape, with the pool cotangent. The affines are dyadic
    (s in {1/2, 1, 2}, b on a 1/16 grid), so the preactivation is exact
    in f32 whether or not a compiler contracts its multiply-adds, and the
    kernel and the plain version see the same bf16 ties."""
    import torch

    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_bwd_plain

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    pgrid = tuple(v // 2 for v in grid)
    ys = _randn((batch, *grid, c), gen, dev, dtype=bf)
    rs = _randn((batch, *grid, c), gen, dev, dtype=bf)
    gp = _randn((batch, *grid, c), gen, dev, dtype=bf)
    gq = _randn((batch, *pgrid, c), gen, dev, dtype=bf)

    def dyadic():
        return (2.0 ** torch.randint(-1, 2, (batch, c), generator=gen,
                                     device=dev).float(),
                torch.randint(-16, 17, (batch, c), generator=gen,
                              device=dev).float() / 16)

    s2, b2 = dyadic()
    sr, br = dyadic()
    args = (ys, rs, s2, b2, sr, br, gp, gq, 0.01)
    ph = Phase("finale_bwd", label, 15 * nvox * c,
               8 * nvox * c + 2 * nvox * c // 8 + 28 * batch * c)
    got, want = finale_bwd(*args), finale_bwd_plain(*args)
    ph.check("dt", got[0], want[0], 1e-2)
    for name, g_, w_ in zip(("sum dt*ys", "sum dt", "sum dt*rs"), got[1:],
                            want[1:]):
        ph.check(name, g_, w_, 1e-3)
    check_repeatable(ph, got, finale_bwd(*args))
    ph.ms = timed_ms(lambda: finale_bwd(*args), iters)
    ph.plain_ms = timed_ms(lambda: finale_bwd_plain(*args), 2)
    ph.report()
    return ph


def finale_bwd_chain_phase(label, dev, gen, batch, grid, c, iters=10):
    """K2's `chain` tie split (encoders 3-5) on tied inputs: small integers
    through dyadic affines, exact in f32, so that dt is bit-equal to the
    plain version's; the per-channel sums differ only in summation order."""
    import torch

    from fcd_tpu_torch.kernels.finale import finale_bwd, finale_bwd_plain

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    pgrid = tuple(v // 2 for v in grid)
    ys = torch.randint(-2, 3, (batch, *grid, c), generator=gen,
                       device=dev).to(bf)
    rs = torch.randint(-1, 2, (batch, *grid, c), generator=gen,
                       device=dev).to(bf)
    gp = _randn((batch, *grid, c), gen, dev, dtype=bf)
    gq = _randn((batch, *pgrid, c), gen, dev, dtype=bf)
    s2 = torch.full((batch, c), 0.5, device=dev)
    b2 = torch.randint(-8, 9, (batch, c), generator=gen, device=dev) / 8.0
    sr, br = torch.ones_like(s2), torch.zeros_like(s2)
    args = (ys, rs, s2, b2, sr, br, gp, gq, 0.01)
    ph = Phase("finale_bwd", label, 15 * nvox * c,
               8 * nvox * c + 2 * nvox * c // 8 + 28 * batch * c)
    got = finale_bwd(*args, tie="chain")
    want = finale_bwd_plain(*args, tie="chain")
    even = finale_bwd_plain(*args, tie="even")
    ph.check_equal("dt", got[0], want[0])
    for name, g_, w_ in zip(("sum dt*ys", "sum dt", "sum dt*rs"), got[1:],
                            want[1:]):
        ph.check(name, g_, w_, 1e-4)
    check_repeatable(ph, got, finale_bwd(*args, tie="chain"))
    moved = float((want[0] != even[0]).float().mean())
    print(f"  finale_bwd {label}: chain and even split differ at "
          f"{100 * moved:.2f}% of dt")
    if moved == 0:
        raise AssertionError("the tied inputs do not tell chain from even")
    ph.ms = timed_ms(lambda: finale_bwd(*args, tie="chain"), iters)
    ph.plain_ms = timed_ms(lambda: finale_bwd_plain(*args, tie="chain"), 2)
    ph.report()
    return ph


def pool2x_phase(label, dev, gen, batch, grid, c, iters=10):
    """B3 at one shape, bit-equal to its plain version (a max is exact)."""
    import torch
    import torch.nn.functional as F

    from fcd_tpu_torch.kernels.pool2x import max_pool2x, max_pool2x_plain

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    x = _randn((batch, *grid, c), gen, dev, dtype=bf)
    ph = Phase("max_pool2x", label, 7 * nvox * c // 8,
               2 * nvox * c + 2 * nvox * c // 8)
    ph.check_equal("pooled", max_pool2x(x), max_pool2x_plain(x))
    ph.ms = timed_ms(lambda: max_pool2x(x), iters)
    ph.plain_ms = timed_ms(lambda: max_pool2x_plain(x), iters)
    # library yardstick, timed only: max_pool3d of the channels-last view
    xin = x.permute(0, 4, 1, 2, 3)
    ph.library_ms = timed_ms(lambda: F.max_pool3d(xin, 2, 2), iters)
    ph.report()
    return ph


def pool2x_bwd_phase(label, dev, gen, batch, grid, c, iters=10):
    """B9 at one shape on inputs that hold exact ties (small integers):
    bit-equal to its plain version (one f32 division per tied child)."""
    import torch

    from fcd_tpu_torch.kernels.pool2x import (
        max_pool2x_bwd,
        max_pool2x_bwd_plain,
    )
    from fcd_tpu_torch.ops.layers import blocks_2x

    bf = torch.bfloat16
    nvox = batch * grid[0] * grid[1] * grid[2]
    pgrid = tuple(v // 2 for v in grid)
    x = torch.randint(-3, 4, (batch, *grid, c), generator=gen,
                      device=dev).to(bf)
    g = _randn((batch, *pgrid, c), gen, dev, dtype=bf)
    xb = blocks_2x(x.float())
    ties = (xb == xb.amax(dim=4, keepdim=True)).sum(dim=4)
    hist = torch.bincount(ties.flatten(), minlength=9)[1:].tolist()
    print(f"  max_pool2x_bwd {label}: blocks by ties 1..8 {hist}")
    if min(hist[1], hist[2]) == 0:
        raise AssertionError("the inputs hold no 2- or 3-way ties")
    ph = Phase("max_pool2x_bwd", label, 4 * nvox * c,
               2 * nvox * c + 2 * nvox * c // 8 + 2 * nvox * c)
    ph.check_equal("dx", max_pool2x_bwd(x, g), max_pool2x_bwd_plain(x, g))
    ph.ms = timed_ms(lambda: max_pool2x_bwd(x, g), iters)
    ph.plain_ms = timed_ms(lambda: max_pool2x_bwd_plain(x, g), 2)
    ph.report()
    return ph


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
    ph.ms = timed_ms(lambda: finale_head(*args), iters)
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
    short = vol[:shape[0] * 4 // 7].contiguous()   # padded along D
    pe.check_equal(f"out, padded {tuple(short.shape)}",
                   sw_entry(short, roi3, bf), sw_entry_plain(short, roi3, bf))
    pe.ms = timed_ms(lambda: sw_entry(vol, roi3, bf), iters)
    pe.plain_ms = timed_ms(lambda: sw_entry_plain(vol, roi3, bf), iters)
    pe.report()

    acc = _randn((*shape, o), gen, dev)
    inv = torch.rand((*shape, 1), generator=gen, device=dev) + 0.1
    px = Phase("sw_exit", f"{shape}x{o} f32 * coverage", nvox * o,
               nvox * (4 * o + 4) + 4 * nvox * o)
    start = (0, 0, 0)
    px.check_equal("out", sw_exit(acc, inv, start, shape),
                   sw_exit_plain(acc, inv, start, shape))
    corner = (1, 2, 3)
    crop = tuple(v - 2 * k for v, k in zip(shape, corner))
    px.check_equal(f"out, cropped to {crop}", sw_exit(acc, inv, corner, crop),
                   sw_exit_plain(acc, inv, corner, crop))
    px.ms = timed_ms(lambda: sw_exit(acc, inv, start, shape), iters)
    px.plain_ms = timed_ms(lambda: sw_exit_plain(acc, inv, start, shape), iters)
    # library yardstick, timed only: acc[crop] * inv[crop] (no crop here)
    px.library_ms = timed_ms(lambda: acc * inv, iters)
    px.report()
    return [pe, px]


def spatial_attn_phases(label, dev, gen, batch, n, c, p, h=4, rate=0.1,
                        iters=10):
    """K3 and K4 at one level's shape, with dropout: the kernels and the
    plain versions draw the same hash bits, so they agree elementwise."""
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
    print(f"  spatial_attn {label}: keep fraction {float(keep):.5f} at rate "
          f"{rate}")
    if abs(float(keep) - (1 - rate)) > 0.01 * (1 - rate):
        raise AssertionError(f"dropout keeps {float(keep)}, not {1 - rate}")
    mm = 2 * batch * n * c * hp
    pf = Phase("spatial_attn_fwd", label, 2 * mm,
               2 * (2 * batch * n * c + 2 * batch * c * hp))
    pb = Phase("spatial_attn_bwd", label, 5 * mm,
               2 * (3 * batch * n * c + 2 * batch * c * hp)
               + 4 * 2 * batch * c * hp)
    pf.check("out", sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate),
             sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate), 2e-2)
    got = sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate)
    want = sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate)
    for name, g_, w_ in zip(("dqn", "dkpb", "dvpb"), got, want):
        pb.check(name, g_, w_, 2e-2)
    check_repeatable(pb, got, sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key,
                                                  rate))
    pf.ms = timed_ms(lambda: sa.spatial_attn_fwd(qn, kpb, vpb, h, key, rate),
                     iters)
    pf.plain_ms = timed_ms(
        lambda: sa.spatial_attn_fwd_plain(qn, kpb, vpb, h, key, rate), 2)
    pb.ms = timed_ms(
        lambda: sa.spatial_attn_bwd(qn, kpb, vpb, g, h, key, rate), iters)
    pb.plain_ms = timed_ms(
        lambda: sa.spatial_attn_bwd_plain(qn, kpb, vpb, g, h, key, rate), 2)
    # library yardstick, timed only: the same per-head attention through
    # SDPA (its own dropout stream), q (B, h, N, c), k and v (B, h, P, c)
    q4 = qn.reshape(batch, n, h, ch).transpose(1, 2)
    k4 = kp.transpose(2, 3).to(bf)
    v4 = vp.transpose(2, 3).to(bf)
    pf.library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, dropout_p=rate, scale=1.0), iters)
    # and K4's: the backward of that SDPA call alone (its forward once,
    # the graph kept), with the cotangent in SDPA's layout
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*ins, dropout_p=rate, scale=1.0)
        g4 = g.reshape(batch, n, h, ch).transpose(1, 2)
        pb.library_ms = timed_ms(lambda: torch.autograd.grad(
            out, ins, g4, retain_graph=True), iters)
        del out, ins
    pf.report()
    pb.report()
    return [pf, pb]


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
        upsample_phase("dec1 64^3x32->128^3x16", dev, gen, s(64, 64, 64),
                       32, 16),
    ]
    phases += dsa_phases("level3 N=32768 C=32 P=64", dev, gen,
                         512 if small else 32768, 32, 64)
    phases += dsa_phases("level6 N=64 C=256 P=32", dev, gen, 64, 256, 32)
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
        finale_bwd_phase("enc1 4x128^3x16 +pool", dev, gen, b,
                         s(128, 128, 128), 16),
        finale_bwd_chain_phase("enc3 4x32^3x64 +pool, chain ties", dev, gen,
                               b, s(32, 32, 32) if small else (32, 32, 32),
                               64),
    ]
    phases += spatial_attn_phases("level3 4xN=32768 C=32 hP=256", dev, gen,
                                  b, 512 if small else 32768, 32, 64)
    phases += spatial_attn_phases("level6 4xN=64 C=256 hP=128", dev, gen, b,
                                  64, 256, 32)
    phases += sw_io_phases(dev, gen, s(*CLI_SHAPE), roi=8 if small else 128)
    # the gated paths' kernels (FCD_FINALE_POOL=0 / FCD_FINALE_TRAIN=0,
    # FCD_FUSED_HEAD=1)
    phases += [
        pool2x_phase("enc1 eval 1x128^3x16", dev, gen, 1, s(128, 128, 128),
                     16),
        pool2x_phase("enc2 train 4x64^3x32", dev, gen, b, s(64, 64, 64), 32),
        pool2x_bwd_phase("enc1 train 4x128^3x16, tied inputs", dev, gen, b,
                         s(128, 128, 128), 16),
        finale_head_phase("dec1 1x128^3x16 -> 2", dev, gen, s(128, 128, 128),
                          16, 2),
    ]
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


PROFILE_KEYS = ("conv3d_kernel", "wgrad_mma_kernel", "wgrad_sum_kernel",
                "finale_bwd_kernel",
                "finale_kernel", "upsample_kernel", "dsa_phase_a",
                "dsa_phase_b", "spatial_attn_fwd", "spatial_attn_bwd",
                "sw_entry_kernel", "sw_exit_kernel", "pool_fwd_kernel",
                "pool_bwd_kernel", "finale_head_kernel")


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
          f"{100 * max(0.0, 1 - busy / wall_us):.1f}%")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:14]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% {n:5d}x {key}")
    return {k: us / 1e3 for k, (_, us) in by_name.items()}


# -- the training path ---------------------------------------------------------

TRAIN_BATCH, TRAIN_STEPS = 4, 3


def train_params(patch_size=128, perf_flags=None):
    from fcd_tpu_torch.config import get_default_params

    params = get_default_params()
    params.update(patch_size=patch_size, loss="DiceCELoss",
                  perf_flags=dict(perf_flags or {}))
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


def train_run(dev, card, perf_flags=None):
    """The train step at batch 4 x 128^3 (under perf_flags): warm-up, then
    timed steps with the launch counters read around them."""
    import torch

    from fcd_tpu_torch.train.schedule import epoch_lr
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = train_params(perf_flags=perf_flags)
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
          f"{params['perf_flags']}), batch {TRAIN_BATCH}x"
          f"{params['patch_size']}^3x{params['chans_in']}, DiceCELoss, "
          f"AdamW lr {lr:g}: {ms:.1f} ms/step, "
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
    card, A B B A per round, TRAIN_STEPS synchronised steps a turn."""
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


def train_check(dev, perf_flags=None) -> None:
    """One train step on the card (bf16) against the port's fp32 CPU step
    from the same weights, batch 1 x 64^3 at full widths, all three under
    perf_flags; the port's bf16 CPU step gives the distance bf16
    arithmetic itself takes."""
    import torch

    from fcd_tpu_torch.train.trainer import ModelTrainer

    size = TRAIN_CHECK_SIZE
    params = train_params(size, perf_flags)
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
            float(tr.train_step(x if i == 0 else x.cpu(),
                                y if i == 0 else y.cpu(), 1e-4))
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
    print(f"train check (perf_flags {params['perf_flags']}): 1x{size}^3 "
          f"step, card bf16 vs CPU fp32: loss "
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
        "finale_bwd": ("triton", "fcd_tpu_torch/kernels/finale.py",
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
        "max_pool2x_bwd": ("triton", "fcd_tpu_torch/kernels/pool2x.py",
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
                "library_call_ms": sum(p.library_call_ms for p in mine)}
               if mine[0].call_ms is not None else {}),
            "shapes": [p.label for p in mine],
        })
    return {"kernels": out}


def main() -> int:
    import torch

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
    build_report("conv3d", "conv3d_kernel", ("bn", "mt", "vec"), "HGMMA")
    build_report("conv3d_wgrad", "wgrad_mma_kernel", ("mi", "ni"), "HMMA")

    print("kernels against their plain versions (bf16, main-path shapes):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phases = kernel_phases(dev, gen)
    torch.cuda.empty_cache()
    launches, trainer, patch, vol, logits = slice_run(dev, card)
    by_path = {"inference": launches}
    by_path.update(gated_inference_run(dev, card, trainer, vol, logits))
    del vol, logits
    x = patch.to(dev)
    profile_run(f"one {tuple(patch.shape[1:4])} patch forward",
                lambda: trainer.predict(x), dev)
    del trainer, x
    torch.cuda.empty_cache()
    by_path["train"], trainer, batch = train_run(dev, card)
    with torch.enable_grad():
        prof = profile_run(f"one train step, batch {TRAIN_BATCH}x128^3",
                           lambda: trainer.train_step(*batch), dev)
    if prof:
        k1 = prof.get("wgrad_mma_kernel", 0.0) + prof.get("wgrad_sum_kernel",
                                                          0.0)
        print(f"  K1 in the step: {k1:.3f} ms of {sum(prof.values()):.2f} ms "
              f"device busy ({100 * k1 / sum(prof.values()):.1f}%)")
    train_check(dev)
    train_repro(dev)
    torch.cuda.empty_cache()
    gated = "train, pool in its own pass"
    by_path[gated], gtrainer, _ = train_run(dev, card, POOL_GATES)
    train_ab(card, {"default": trainer, gated: gtrainer}, batch)
    with torch.enable_grad():
        profile_run(f"one train step, batch {TRAIN_BATCH}x128^3, {gated}",
                    lambda: gtrainer.train_step(*batch), dev)
    del trainer, gtrainer, batch
    torch.cuda.empty_cache()
    train_check(dev, POOL_GATES)
    torch.cuda.empty_cache()
    # the gates live in each trainer's model: a trainer built from the
    # default params runs the default path again
    from fcd_tpu_torch import flags

    defaults = flags.model_gates(flags.resolve({}))
    if defaults != {"pool_in_finale": (True, True), "fused_head": False,
                    "levels12_tie": "even"}:
        raise AssertionError(f"the default gates resolve to {defaults}")
    by_path["cli"] = cli_run(dev, card)
    print(json.dumps(kernels_json(phases, by_path)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
