"""Where K1's time goes, on the card (run from the repository root):

    python -m fcd_tpu_torch.kernels.wgrad_sweep

At the main path's K1 shapes (batch 4, the default config) it times, by
CUDA events over 20 calls of the kernel's C entry point (the products and
the second pass):

* `chunks`: the call under `wgrad_plan`'s chunk count and under others
  (1, 2, 4, ... and twice the plan's), to check the plan's rule;
* `parts`: builds copies of `csrc/conv3d_wgrad.cu` into
  build/fcd_tpu_torch/ with parts switched off (the prologue pass, the
  products' loop) and times each beside the full kernel (only the time is
  meaningful: their dW is wrong).

It prints the card's name and power limit first. Card only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from fcd_tpu_torch.kernels import _build
from fcd_tpu_torch.kernels.conv_wgrad import bind, wgrad_plan

# (b, grid, ci, co, prologue) of the main path's K1 calls, one per regime
SHAPES = [(4, 128, 16, 16, True), (4, 128, 16, 16, False),
          (4, 128, 2, 16, False), (4, 64, 32, 32, True),
          (4, 32, 64, 64, True), (4, 32, 32, 64, False),
          (4, 16, 128, 128, True), (4, 16, 64, 64, False),
          (4, 8, 128, 128, True), (4, 8, 128, 256, False),
          (4, 8, 256, 256, True), (4, 4, 256, 256, True),
          (4, 4, 512, 512, True)]
# parts of the source switched off: (name, text, replacement)
PARTS = [("no prologue pass", "    if (pro_in_place) {", "    if (false) {"),
         ("no products", "for (int ks = 0; ks < KSTEPS; ++ks) {",
          "for (int ks = 0; ks < 0; ++ks) {")]


def _case(gen, b, s, ci, co, pro):
    """Inputs of one call, and a function giving its entry-point arguments
    for a chunk count (None: the plan's)."""
    dev = torch.device("cuda")
    x = torch.randn((b, s, s, s, ci), generator=gen, device=dev).bfloat16()
    g = torch.randn((b, s, s, s, co), generator=gen, device=dev).bfloat16()
    sc = (torch.rand((b, ci), generator=gen, device=dev) + 0.5) if pro \
        else None
    sh = (torch.randn((b, ci), generator=gen, device=dev) * 0.1) if pro \
        else None
    plan = wgrad_plan(b, s, s, s, ci, co)
    dw = torch.empty((27, ci, co), device=dev)
    keep = {}

    def args(chunks=None):
        chunks = chunks or plan.chunks
        per = -(-plan.tiles // chunks)
        chunks = -(-plan.tiles // per)
        keep["part"] = torch.empty((chunks, 27, ci, co), device=dev)
        return chunks, (
            _build.ptr(x), _build.ptr(g), _build.ptr(sc), _build.ptr(sh),
            0.01, _build.ptr(keep["part"]), _build.ptr(dw), b, s, s, s, ci,
            co, plan.ci_tile, plan.co_tile, *plan.grid, chunks,
            int(ci % 8 == 0), int(co % 8 == 0), _build.stream())
    return plan, args


def _ms(fn, a, iters=20) -> float:
    if fn(*a) != 0:
        raise RuntimeError("conv3d_wgrad: launch failed")
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn(*a)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _variants():
    """{name: entry point} of the full kernel and of each part switched
    off, built at once."""
    src = (_build.CSRC / "conv3d_wgrad.cu").read_text()
    out = {"full": bind(_build.load("conv3d_wgrad"))}
    procs = []
    for name, old, new in PARTS:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in the source")
        stem = _build.BUILD_DIR / ("wgrad_sweep_" + name.replace(" ", "_"))
        stem.with_suffix(".cu").write_text(src.replace(old, new))
        procs.append((name, stem, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for name, stem, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log.decode()}")
        out[name] = bind(ctypes.CDLL(str(stem.with_suffix(".so"))))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wgrad_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    _build.build_all(["conv3d_wgrad"])
    fns = _variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, ci, co, pro in SHAPES:
        plan, args = _case(gen, b, s, ci, co, pro)
        label = (f"{b}x{s}^3 {ci}->{co}{' +prologue' if pro else ''} "
                 f"({plan.n_ci * plan.n_co} dW tiles, {plan.tiles} voxel "
                 f"tiles, plan {plan.chunks} chunks)")
        times = {}
        for want in sorted({1, 2, 4, 8, 16, 32, 64, 128, 256,
                            plan.chunks, 2 * plan.chunks}):
            if want <= plan.tiles:
                chunks, a = args(want)
                times.setdefault(chunks, _ms(fns["full"], a))
        print(f"chunks {label}: ms " + ", ".join(
            f"{c}: {t:.4f}" for c, t in sorted(times.items())), flush=True)
        _, a = args()
        print(f"parts {label}: ms " + ", ".join(
            f"{name} {_ms(fn, a):.4f}" for name, fn in fns.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
