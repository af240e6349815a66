"""B5 on the card, against another checkout of the port (run from the
repository root):

    python -m fcd_tpu_torch.kernels.dsa_sweep [--parent DIR] [--turns N]
    python -m fcd_tpu_torch.kernels.dsa_sweep --plans

At the four DSA levels of a 128^3 patch (batch 1, the model's f32 weights
and EF) it times each phase as the main path calls it, and the whole
`dsa_attention` call, by the device time of everything one call launches
(torch.profiler, 20 calls after a warm-up, from a whole trace: kept only
when it holds each op 20 times as often as a trace of one call, else
taken again), with the count of device ops and the wall per call beside
it: on bf16 tokens (the kernel route) and on f32 tokens (B5's f32
instances, the route of a model built with use_amp=False). Then one patch
forward of the default MS_DSA_NET (seeded weights) and of the same model
with use_amp=False: its wall, device busy time, idle share, device kernel
count and B5's device time (every op one DSA call launches, counted by
name: the kernels' names carry `dsa_phase` or `dsa_f32_phase`), from a
whole trace (a one-forward trace that another agrees with op for op);
and the wall of `ModelTrainer.inference` on
a seeded 182x218x182 volume (bf16), three runs.

With --parent DIR (an unpacked checkout, e.g. the parent commit's `git
archive` under build/), the same measurements run for DIR's port and for
this one in separate processes, in turns (parent, this, this, parent for
--turns 2), on the same card. A checkout whose DSA wrappers take the
(4, C, C) split weights and leave the glue to PyTorch (the earlier port) is
driven through that interface: phase A (its casts, kernel and partial
sums), the glue, phase B. With --plans, this checkout's phases under
every token tile and chunk length instead (`plans`; the f32 instances
also under every column-group count, `plans_f32`). Prints the card's
name and power limit first. Card only.
"""

from __future__ import annotations

import sys
import time

LEVELS = (("level3", 32768, 32, 64), ("level4", 4096, 64, 64),
          ("level5", 512, 128, 64), ("level6", 64, 256, 32))


def _device_ops(fn, iters):
    """{name: (launches, ms) per call} of the device ops fn launches, after
    a warm-up call, from a whole trace (`_sweep.whole_trace`)."""
    import torch

    from fcd_tpu_torch.kernels._sweep import whole_trace

    fn()
    torch.cuda.synchronize()
    out = {}
    for e in whole_trace(fn, iters)[0]:
        n, us = out.get(e.name, (0, 0.0))
        out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / iters, us / iters / 1e3) for k, (n, us) in out.items()}


def _b5(name: str) -> bool:
    return "dsa_phase" in name or "dsa_f32_phase" in name


def _short(name: str) -> str:
    for k in ("dsa_phase_a_kernel", "dsa_phase_a_finish", "dsa_phase_b_kernel",
              "dsa_f32_phase_a_kernel", "dsa_f32_phase_a_finish",
              "dsa_f32_phase_b_kernel", "dsa_phase_a", "dsa_phase_b"):
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
    plans_f32(iters)


def plans_f32(iters: int = 20) -> None:
    """The f32 instances' phases under every token tile, chunk length and
    column-group count (phase A) and heads a block (phase B) that
    `plan_for_f32` takes, at the four levels: phase A's kernel and
    finishing pass, and phase B, by device time; * marks dsa_plan_f32's
    choice."""
    import torch

    from fcd_tpu_torch.kernels import dsa_attention as dk

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h = 4
    for name, n, c, p in LEVELS:
        x = torch.randn((1, n, c), generator=gen, device=dev)
        w = torch.randn((c, 4 * c), generator=gen, device=dev) * c ** -0.5
        ef = torch.randn((n, p), generator=gen, device=dev) * p ** -0.5
        temps = (torch.ones((h, 1, 1), device=dev),) * 2
        tok = (torch.ones(c, device=dev), torch.zeros(c, device=dev),
               torch.zeros((n, c), device=dev))
        gamma = torch.ones(c, device=dev)
        chosen = dk.dsa_plan_f32(n, c, p, h)
        cells = []
        for tile in dk.TILES_F32:
            plan = None
            for per_chunk in (1, 2, 4, 8):
                for groups in (1, 2, 4, 8):
                    try:
                        plan = dk.plan_for_f32(n, c, p, h, 1, tile,
                                               per_chunk, groups)
                    except ValueError:
                        continue
                    if plan.per_chunk != per_chunk:
                        continue
                    ta = _device_ops(lambda: dk.dsa_phase_a(
                        x, w, ef, *tok, h, temperatures=temps, plan=plan),
                        iters)
                    mark = "*" if plan == chosen else ""
                    split = "/".join(f"{ms:.4f}" for _, ms in ta.values())
                    cells.append(f"T{tile}x{per_chunk}g{groups}{mark} "
                                 f"{plan.a_blocks} blocks A {split}")
            if plan is None:
                continue
            ops = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=temps)
            for hb in (1, 2, 4):
                try:
                    plan = dk.plan_for_f32(n, c, p, h, 1, tile, 1, hb=hb)
                except ValueError:
                    continue
                tb = _device_ops(lambda: dk.dsa_phase_b(
                    x, w, *ops, gamma, *tok, h, plan=plan), iters)
                mark = "*" if (tile, hb) == (chosen.tile, chosen.hb) else ""
                cells.append(f"T{tile}hb{hb}{mark} {plan.b_blocks} blocks B "
                             f"{sum(ms for _, ms in tb.values()):.4f}")
        print(f"f32 {name} N={n} C={c} P={p}: " + " | ".join(cells),
              flush=True)


def _wall_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _level_calls(dk, dtype, gen, dev, n, c, p, h, new):
    """{what: the call} at one level, tokens in `dtype`."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    x = randn(1, n, c).to(dtype)
    w = randn(c, 4 * c) * c ** -0.5
    ef = randn(n, p) * p ** -0.5
    t1, t2 = rand(h, 1, 1) + 0.5, rand(h, 1, 1) + 0.5
    tok = (1 + 0.1 * randn(c), 0.1 * randn(c), 0.1 * randn(n, c))
    gamma = randn(c)
    if new:
        ops = dk.dsa_phase_a(x, w, ef, *tok, h, temperatures=(t1, t2))
        calls = {
            "phase A": lambda: dk.dsa_phase_a(x, w, ef, *tok, h,
                                              temperatures=(t1, t2)),
            "phase B": lambda: dk.dsa_phase_b(x, w, *ops, gamma, *tok, h)}
    else:
        w4 = dk.split_qkvv(w)
        a = dk.dsa_phase_a(x, w4, ef, *tok)
        ops = dk.dsa_glue(a, t1, t2, h, dtype)
        calls = {
            "phase A": lambda: dk.dsa_phase_a(x, w4, ef, *tok),
            "glue": lambda: dk.dsa_glue(a, t1, t2, h, dtype),
            "phase B": lambda: dk.dsa_phase_b(x, w4, *ops, gamma, *tok, h)}
    calls["whole op"] = lambda: dk.dsa_attention(x, w, ef, t1, t2, *tok,
                                                 gamma, h)
    return calls


def measure(iters: int = 20) -> dict:
    """The measurements of the `fcd_tpu_torch` on sys.path."""
    import torch

    from fcd_tpu_torch.kernels import _build
    from fcd_tpu_torch.kernels import dsa_attention as dk

    # every library first: a process that builds one (nvcc) after it has
    # read a trace gets empty traces from then on
    _build.build_all()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    new = hasattr(dk, "dsa_plan")
    out = {"api": "per-head" if new else "split weights", "levels": {},
           "f32 levels": {}}
    h = 4
    f32 = hasattr(dk, "PHASE_A_F32")
    for key, dtype in (("levels", torch.bfloat16),
                       ("f32 levels", torch.float32)):
        if dtype == torch.float32 and not f32:
            continue
        for name, n, c, p in LEVELS:
            row = {}
            for what, fn in _level_calls(dk, dtype, gen, dev, n, c, p, h,
                                         new).items():
                ops_ = _device_ops(fn, iters)
                row[what] = {
                    "device_ms": sum(ms for _, ms in ops_.values()),
                    "kernel_ms": sum(ms for k, (_, ms) in ops_.items()
                                     if _b5(k)),
                    "device_ops": sum(m for m, _ in ops_.values()),
                    "wall_ms": _wall_ms(fn, iters),
                    "by_kernel": {_short(k): ms for k, (_, ms) in
                                  ops_.items() if _b5(k)}}
            out[key][f"{name} N={n} C={c} P={p}"] = row
    out["patch"] = patch_forward()
    if f32:
        out["f32 patch"] = patch_forward(use_amp=False)
    return out


def patch_forward(use_amp: bool = True) -> dict:
    """One 128^3 patch forward of the default model (use_amp=False: the
    f32 route, B5's f32 instances): wall, device busy, idle share, device
    kernels, B5's device time and launches of one forward, from a whole
    trace (`_sweep.whole_trace`, up to ten tries); with use_amp, the wall of
    ModelTrainer.inference on a seeded 182x218x182 volume (three runs
    after a warm-up)."""
    import torch

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.kernels._sweep import whole_trace
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params["use_amp"] = use_amp
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
    volume = []
    if use_amp:
        trainer.inference(vol)
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
    ev, wall = whole_trace(lambda: trainer.predict(x), 1, cpu=True,
                           tries=10)
    wall *= 1e3
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    b5 = [e for e in ev if _b5(e.name)]
    return {"wall_ms_unprofiled": sorted(walls), "wall_ms_profiled": wall,
            "volume_ms": sorted(volume),
            "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / wall),
            "device_kernels": len(ev),
            "b5_ms": sum(e.time_range.elapsed_us() for e in b5) / 1e3,
            "b5_kernels": len(b5)}


def show(label: str, res: dict) -> None:
    """Print one checkout's measurements."""
    print(f"{label} ({res['api']}):", flush=True)
    for key in ("levels", "f32 levels"):
        for lvl, row in res.get(key, {}).items():
            cells = [f"{what} {r['device_ms']:.4f} ms device "
                     f"({r['kernel_ms']:.4f} in dsa kernels, "
                     f"{r['device_ops']:g} ops, wall {r['wall_ms']:.4f})"
                     for what, r in row.items()]
            tag = " f32" if key == "f32 levels" else ""
            print(f"  {lvl}{tag}: " + " | ".join(cells))
            for what, r in row.items():
                if len(r["by_kernel"]) > 1:
                    print(f"    {what} by kernel: " + ", ".join(
                        f"{k} {ms:.4f}" for k, ms in r["by_kernel"].items()))
    for key in ("patch", "f32 patch"):
        if key not in res:
            continue
        pf = res[key]
        vol = (f"; ms/volume (182x218x182) "
               f"{', '.join(f'{v:.1f}' for v in pf['volume_ms'])}"
               if pf["volume_ms"] else "")
        print(f"  {key} forward: wall {pf['wall_ms_profiled']:.2f} ms "
              f"profiled, unprofiled "
              f"{', '.join(f'{w:.2f}' for w in pf['wall_ms_unprofiled'])} ms;"
              f" device busy {pf['device_busy_ms']:.3f} ms, idle "
              f"{100 * pf['idle_share']:.1f}%, {pf['device_kernels']} device "
              f"kernels; B5 {pf['b5_ms']:.3f} ms in {pf['b5_kernels']} "
              f"kernels (a whole trace){vol}", flush=True)


def main(argv=None) -> int:
    # imported here: measure() runs in a child whose fcd_tpu_torch may
    # be an older checkout, imported before this checkout's _sweep
    from fcd_tpu_torch.kernels import _sweep

    return _sweep.main(__doc__, __file__, plans, show, argv)


if __name__ == "__main__":
    sys.exit(main())
