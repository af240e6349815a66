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
3. Drives the main path: ModelTrainer(default params, device="cuda")
   .inference on a seeded 182x218x182x2 volume (8 patches of 128^3, fs16
   MS_DSA_NET), with every launch counter set to 0 just before and read
   just after, and holds one patch's logits against the port's own fp32
   forward on the CPU.
4. Prints the `kernels` JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
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


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


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

    @property
    def bound_ms(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES) * 1e3

    @property
    def bound_by(self) -> str:
        return ("operations" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES
                else "bytes")

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
        print(f"  {self.kernel} {self.label}: kernel {self.ms:.4f} ms, plain "
              f"{self.plain_ms:.4f} ms, library {lib}, bound "
              f"{self.bound_ms:.4f} ms ({self.bound_by}), roofline share "
              f"{100 * share:.2f}%", flush=True)


# -- kernel phases ------------------------------------------------------------

def _randn(shape, gen, dev, scale=1.0, dtype=None):
    import torch

    t = torch.randn(shape, generator=gen, device=dev) * scale
    return t if dtype is None else t.to(dtype)


def conv_phase(label, dev, gen, grid, parts_c, cout, *, prologue=False,
               shortcut=False, iters=5):
    """B1 at one shape: parts_c input widths summed into cout outputs."""
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
    ph.ms = timed_ms(lambda: conv3x3(parts, ws, **kw), iters)
    ph.plain_ms = timed_ms(lambda: conv3x3_plain(parts, ws, **kw), 2)
    # library yardstick, timed only: cuDNN bf16 conv of the concatenated input
    xin = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
    wlib = torch.cat(ws, dim=3).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    ph.library_ms = timed_ms(lambda: F.conv3d(xin, wlib, padding=1), iters)
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
        finale_phase("enc1 128^3x16 +pool", dev, gen, s(128, 128, 128), 16),
        upsample_phase("dec1 64^3x32->128^3x16", dev, gen, s(64, 64, 64),
                       32, 16),
    ]
    phases += dsa_phases("level3 N=32768 C=32 P=64", dev, gen,
                         512 if small else 32768, 32, 64)
    phases += dsa_phases("level6 N=64 C=256 P=32", dev, gen, 64, 256, 32)
    return phases


# -- the main path ---------------------------------------------------------------

def counters():
    from fcd_tpu_torch.kernels import block_conv, dsa_attention, pool, upsample

    return {"conv3d": block_conv.conv3x3, "finale_pool": pool.finale_pool,
            "upsample2x": upsample.upsample2x,
            "dsa_phase_a": dsa_attention.dsa_phase_a,
            "dsa_phase_b": dsa_attention.dsa_phase_b}


# launches per 128^3 patch: 23 res blocks x 2 convs, 23 finales, 5
# upsamples, 12 DSA calls (4 levels x 3 layers) per phase
PER_PATCH = {"conv3d": 46, "finale_pool": 23, "upsample2x": 5,
             "dsa_phase_a": 12, "dsa_phase_b": 12}


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

    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = trainer.inference(vol)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in cnt.items()}

    print(f"slice: ModelTrainer.inference {vol_shape}x{params['chans_in']} "
          f"volume, {n_patches} patches of {roi}: {ms:.1f} ms/volume, "
          f"{1e3 / ms:.3f} vol/s on {card} (first call, incl. JIT: "
          f"{first_s:.1f} s)", flush=True)
    if tuple(out.shape) != (*vol_shape, params["chans_out"]) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"logits {tuple(out.shape)} {out.dtype}: not "
                             "finite f32 of the volume's shape")
    want = {k: v * n_patches for k, v in PER_PATCH.items()}
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
    return launches, trainer, patch


def profile_patch(trainer, patch, dev) -> None:
    """Where one 128^3 patch forward spends the card's time: device time
    by kernel (torch.profiler) and the device's idle share of the
    synchronised wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = patch.to(dev)
    trainer.model(x)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.model(x)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k in ("conv3d_kernel", "finale_kernel",
                                    "upsample_kernel", "dsa_phase_a",
                                    "dsa_phase_b") if k in e.name),
                       e.name[:60])
            n, us = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    if busy == 0:
        print("profile: the profiler recorded no device time; per-kernel "
              "breakdown not measured")
        return
    print(f"profile: one {tuple(patch.shape[1:4])} patch forward, wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"share {100 * max(0.0, 1 - busy / wall_us):.1f}%")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}% {n:5d}x {key}")



def kernels_json(phases, launches):
    import fcd_tpu_torch.kernels.block_conv as b1
    import fcd_tpu_torch.kernels.dsa_attention as b5
    import fcd_tpu_torch.kernels.pool as b2
    import fcd_tpu_torch.kernels.upsample as b4

    meta = {
        "conv3d": ("cuda", "fcd_tpu_torch/csrc/conv3d.cu", b1.REPLACES),
        "finale_pool": ("triton", "fcd_tpu_torch/kernels/pool.py",
                        b2.REPLACES),
        "upsample2x": ("cuda", "fcd_tpu_torch/csrc/upsample.cu", b4.REPLACES),
        "dsa_phase_a": ("cuda", "fcd_tpu_torch/csrc/dsa.cu", b5.REPLACES_A),
        "dsa_phase_b": ("cuda", "fcd_tpu_torch/csrc/dsa.cu", b5.REPLACES_B),
    }
    out = []
    for name, (route, source, replaces) in meta.items():
        mine = [p for p in phases if p.kernel == name]
        lib = [p.library_ms for p in mine]
        top = max(mine, key=lambda p: p.bound_ms)
        out.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": max(p.abs_err for p in mine),
            "ms": sum(p.ms for p in mine),
            "plain_ms": sum(p.plain_ms for p in mine),
            "bound_ms": sum(p.bound_ms for p in mine),
            "bound_by": top.bound_by,
            "library_ms": None if None in lib else sum(lib),
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

    print("kernels against their plain versions (bf16, main-path shapes):")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    phases = kernel_phases(dev, gen)
    launches, trainer, patch = slice_run(dev, card)
    profile_patch(trainer, patch, dev)
    print(json.dumps(kernels_json(phases, launches)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
