"""B5 on the card, against another checkout of the port (run from the
repository root):

    python -m fcd_tpu_torch.kernels.dsa_sweep [--parent DIR] [--turns N]
    python -m fcd_tpu_torch.kernels.dsa_sweep --plans

At the four DSA levels of a 128^3 patch (batch 1, the model's f32 weights
and EF) it times each phase as the main path calls it, and the whole
`dsa_attention` call, by the device time of everything one call launches
(torch.profiler, 20 calls after a warm-up), with the count of device ops
and the wall per call beside it; then one patch forward of the default
MS_DSA_NET (seeded weights): its wall, device busy time, idle share,
device kernel count and B5's device time (every op one DSA call launches,
counted by name: the kernels' names carry `dsa_phase`); and the wall of
`ModelTrainer.inference` on a seeded 182x218x182 volume, three runs.

With --parent DIR (an unpacked checkout, e.g. the parent commit's `git
archive` under build/), the same measurements run for DIR's port and for
this one in separate processes, in turns (parent, this, this, parent for
--turns 2), on the same card. A checkout whose DSA wrappers take the
(4, C, C) split weights and leave the glue to PyTorch (the earlier port) is
driven through that interface: phase A (its casts, kernel and partial
sums), the glue, phase B. With --plans, this checkout's phases under
every token tile and chunk length instead (`plans`). Prints the card's
name and power limit first. Card only.
"""

from __future__ import annotations

import sys
import time

LEVELS = (("level3", 32768, 32, 64), ("level4", 4096, 64, 64),
          ("level5", 512, 128, 64), ("level6", 64, 256, 32))


def _device_ops(fn, iters):
    """{name: (launches, ms) per call} of the device ops fn launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / iters, us / iters / 1e3) for k, (n, us) in out.items()}


def _short(name: str) -> str:
    for k in ("dsa_phase_a_kernel", "dsa_phase_a_finish", "dsa_phase_b_kernel",
              "dsa_phase_a", "dsa_phase_b"):
        if k in name:
            return k
    return name[:40]


def plans(iters: int = 20) -> None:
    """Phase A (with its finishing pass) and phase B of this checkout under
    every token tile and chunk length at the four levels, by the device
    time of their B5 kernels; * marks dsa_plan's choice."""
    import torch

    from fcd_tpu_torch.kernels import dsa_attention as dk

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h = 4
    for name, n, c, p in LEVELS:
        x = torch.randn((1, n, c), generator=gen, device=dev).bfloat16()
        w = torch.randn((c, 4 * c), generator=gen, device=dev) * c ** -0.5
        ef = torch.randn((n, p), generator=gen, device=dev) * p ** -0.5
        temps = (torch.ones((h, 1, 1), device=dev),) * 2
        tok = (torch.ones(c, device=dev), torch.zeros(c, device=dev),
               torch.zeros((n, c), device=dev))
        gamma = torch.ones(c, device=dev)
        chosen = dk.dsa_plan(n, c, p, h)
        cells = []
        for tile in dk.TILES:
            for per_chunk in (1, 2, 4, 8, 16):
                try:
                    plan = dk.plan_for(n, c, p, h, 1, tile, per_chunk)
                except ValueError:  # shared memory
                    continue
                if plan.per_chunk != per_chunk:
                    continue
                ops = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps,
                                     plan=plan)
                ta = _device_ops(lambda: dk.dsa_phase_a(
                    x, w, ef, *tok, h, temperatures=temps, plan=plan), iters)
                mark = "*" if plan == chosen else ""
                split = "/".join(f"{ms:.4f}" for _, ms in ta.values())
                cells.append(f"T{tile}x{per_chunk}{mark} {plan.a_blocks} "
                             f"blocks A {split}")
            if not any(f"T{tile}x" in cell for cell in cells):
                continue
            plan = dk.plan_for(n, c, p, h, 1, tile, 1)
            tb = _device_ops(lambda: dk.dsa_phase_b(
                x, w, *ops, gamma, *tok, h, plan=plan), iters)
            cells.append(f"T{tile} B {sum(ms for _, ms in tb.values()):.4f}")
        print(f"{name} N={n} C={c} P={p}: " + " | ".join(cells), flush=True)


def _wall_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def measure(iters: int = 20) -> dict:
    """The measurements of the `fcd_tpu_torch` on sys.path."""
    import torch

    from fcd_tpu_torch.kernels import dsa_attention as dk

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    new = hasattr(dk, "dsa_plan")
    out = {"api": "per-head" if new else "split weights", "levels": {}}
    h, bf = 4, torch.bfloat16
    for name, n, c, p in LEVELS:
        x = (torch.randn((1, n, c), generator=gen, device=dev)).to(bf)
        w = torch.randn((c, 4 * c), generator=gen, device=dev) * c ** -0.5
        ef = torch.randn((n, p), generator=gen, device=dev) * p ** -0.5
        t1 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
        t2 = torch.rand((h, 1, 1), generator=gen, device=dev) + 0.5
        tok = (1 + 0.1 * torch.randn((c,), generator=gen, device=dev),
               0.1 * torch.randn((c,), generator=gen, device=dev),
               0.1 * torch.randn((n, c), generator=gen, device=dev))
        gamma = torch.randn((c,), generator=gen, device=dev)
        if new:
            ops = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=(t1, t2))
            calls = {
                "phase A": lambda: dk.dsa_phase_a(x, w, ef, *tok, h,
                                                  temperatures=(t1, t2)),
                "phase B": lambda: dk.dsa_phase_b(x, w, *ops, gamma, *tok,
                                                  h)}
        else:
            w4 = dk.split_qkvv(w)
            a = dk.dsa_phase_a(x, w4, ef, *tok)
            ops = dk.dsa_glue(a, t1, t2, h, bf)
            calls = {
                "phase A": lambda: dk.dsa_phase_a(x, w4, ef, *tok),
                "glue": lambda: dk.dsa_glue(a, t1, t2, h, bf),
                "phase B": lambda: dk.dsa_phase_b(x, w4, *ops, gamma, *tok,
                                                  h)}
        calls["whole op"] = lambda: dk.dsa_attention(x, w, ef, t1, t2, *tok,
                                                     gamma, h)
        row = {}
        for what, fn in calls.items():
            ops_ = _device_ops(fn, iters)
            row[what] = {
                "device_ms": sum(ms for _, ms in ops_.values()),
                "kernel_ms": sum(ms for k, (_, ms) in ops_.items()
                                 if "dsa_phase" in k),
                "device_ops": sum(m for m, _ in ops_.values()),
                "wall_ms": _wall_ms(fn, iters),
                "by_kernel": {_short(k): ms for k, (_, ms) in ops_.items()
                              if "dsa_phase" in k}}
        out["levels"][f"{name} N={n} C={c} P={p}"] = row
    out["patch"] = patch_forward()
    return out


def patch_forward() -> dict:
    """One 128^3 patch forward of the default model: wall, device busy,
    idle share, device kernels, B5's device time and launches; and the
    wall of ModelTrainer.inference on a seeded 182x218x182 volume (three
    runs after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    trainer = ModelTrainer(params, device=torch.device("cuda"))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for stack in trainer.model.transformers:
            for blk in stack:
                blk.gamma.copy_(0.1 * torch.randn(blk.gamma.shape,
                                                  generator=gen))
    s = params["patch_size"]
    x = torch.randn((1, s, s, s, params["chans_in"]), generator=gen).cuda()
    vol = torch.randn((182, 218, 182, params["chans_in"]),
                      generator=gen).numpy()
    trainer.inference(vol)
    volume = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.inference(vol)
        torch.cuda.synchronize()
        volume.append((time.perf_counter() - t0) * 1e3)
    walls = []
    for _ in range(3):
        trainer.predict(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.predict(x)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.predict(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    b5 = [e for e in ev if "dsa_phase" in e.name]
    return {"wall_ms_unprofiled": sorted(walls), "wall_ms_profiled": wall,
            "volume_ms": sorted(volume),
            "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "device_kernels": len(ev),
            "b5_ms": sum(e.time_range.elapsed_us() for e in b5) / 1e3,
            "b5_kernels": len(b5)}


def show(label: str, res: dict) -> None:
    """Print one checkout's measurements."""
    print(f"{label} ({res['api']}):", flush=True)
    for lvl, row in res["levels"].items():
        cells = [f"{what} {r['device_ms']:.4f} ms device ({r['kernel_ms']:.4f}"
                 f" in dsa kernels, {r['device_ops']:g} ops, wall "
                 f"{r['wall_ms']:.4f})" for what, r in row.items()]
        print(f"  {lvl}: " + " | ".join(cells))
        for what, r in row.items():
            if len(r["by_kernel"]) > 1:
                print(f"    {what} by kernel: " + ", ".join(
                    f"{k} {ms:.4f}" for k, ms in r["by_kernel"].items()))
    pf = res["patch"]
    print(f"  patch forward: wall {pf['wall_ms_profiled']:.2f} ms "
          f"profiled, unprofiled {', '.join(f'{w:.2f}' for w in pf['wall_ms_unprofiled'])} ms; "
          f"device busy {pf['device_busy_ms']:.3f} ms, idle "
          f"{100 * pf['idle_share']:.1f}%, {pf['device_kernels']} device "
          f"kernels; B5 {pf['b5_ms']:.3f} ms in {pf['b5_kernels']} "
          "kernels; ms/volume (182x218x182) "
          f"{', '.join(f'{v:.1f}' for v in pf['volume_ms'])}", flush=True)


def main(argv=None) -> int:
    # imported here: measure() runs in a child whose fcd_tpu_torch may
    # be an older checkout, without _sweep
    from fcd_tpu_torch.kernels import _sweep

    return _sweep.main(__doc__, __file__, plans, show, argv)


if __name__ == "__main__":
    sys.exit(main())
