"""K3 and K4 on the card, against another checkout of the port (run from
the repository root):

    python -m fcd_tpu_torch.kernels.spattn_sweep [--parent DIR] [--turns N]
    python -m fcd_tpu_torch.kernels.spattn_sweep --plans

At the four DSA levels of a 128^3 patch (batch 4, 4 heads, dropout 0.1,
as the train step calls them) in bf16, at the wide widths of `WIDE`
(C15) in bf16 and f16 (C20) and at the four levels in f32 (C18) it times
`spatial_attn_fwd` (K3) and `spatial_attn_bwd` (K4) by the device time
of everything one call launches (torch.profiler, 20 calls after a
warm-up, from a whole trace: `_sweep.whole_trace`), with the
kernels' share, the count of device ops and the wall per call beside
it, and beside each wide and f32 shape the library's yardstick in the
operands' type: SDPA per head (q (B, h, N, C), k and v (B, h, P, C)) and
its backward alone; then the train step of the default MS_DSA_NET at 4 x
128^3 (DiceCE, AdamW, seeded weights and batch): ms/step over three
synchronised steps, three times, and a step's device busy time, device
kernel count and K3's and K4's device time (every op whose name carries
`spatial_attn`) from a whole trace.

With --parent DIR (an unpacked checkout, e.g. the parent commit's `git
archive` under build/), the same measurements run for DIR's port and for
this one in separate processes, in turns (parent, this, this, parent for
--turns 2), on the same card. With --plans, this checkout's K3 and K4
under every plan `plan_for` takes instead (* marks spatial_attn_plan's
choice). Prints the card's name and power limit first. Card only.
"""

from __future__ import annotations

import sys
import time

from fcd_tpu_torch.kernels.dsa_sweep import _device_ops, _wall_ms

LEVELS = (("level3", 32768, 32, 64), ("level4", 4096, 64, 64),
          ("level5", 512, 128, 64), ("level6", 64, 256, 32))
# the widths past the tensor-core instances (C15, chip_smoke.C15_WIDTHS)
WIDE = (("segresnet_deeper level4", 512, 256, 64), ("fs32 level6", 64, 512, 32),
        ("fs32 P128 level5", 512, 256, 128))
BATCH, HEADS, RATE = 4, 4, 0.1


def _inputs(n, c, p, gen, bf=None):
    """The train DSA's operands: l2-scaled queries, block-diagonal kpb and
    vpb (chip_smoke.py's spatial_attn phases), a cotangent; bf16 unless
    `bf` names another dtype."""
    import torch

    dev, h = torch.device("cuda"), HEADS
    bf = torch.bfloat16 if bf is None else bf
    ch = c // h
    qn = (torch.randn((BATCH, n, c), generator=gen, device=dev)
          * n ** -0.5).to(bf)
    kp = torch.randn((BATCH, h, ch, p), generator=gen, device=dev) * 2.0
    vp = torch.randn((BATCH, h, ch, p), generator=gen, device=dev)
    eye = torch.eye(h, device=dev)
    kpb = torch.einsum("bhcp,hg->bhcgp", kp, eye).reshape(
        BATCH, c, h * p).to(bf)
    vpb = torch.einsum("bhcp,hg->bgphc", vp, eye).reshape(
        BATCH, h * p, c).to(bf)
    g = torch.randn((BATCH, n, c), generator=gen, device=dev).to(bf)
    return qn, kpb, vpb, g


def _row(fn, iters=20) -> dict:
    ops = _device_ops(fn, iters)
    return {"device_ms": sum(ms for _, ms in ops.values()),
            "kernel_ms": sum(ms for k, (_, ms) in ops.items()
                             if "spatial_attn" in k),
            "device_ops": sum(m for m, _ in ops.values()),
            "wall_ms": _wall_ms(fn, iters)}


def plans(iters: int = 20) -> None:
    """K3 under every units-a-block count and K4 under every tile, chunk
    count and heads a block that plan_for takes, at the four levels."""
    import torch

    from fcd_tpu_torch.kernels import spatial_attn as sa

    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    key = sa.dropout_key(0, 3)
    for name, n, c, p in LEVELS:
        qn, kpb, vpb, g = _inputs(n, c, p, gen)
        chosen = sa.spatial_attn_plan(n, c, p, HEADS, BATCH)
        cells = []
        for per_block in sorted({1, 2, 4, 8, 16, 32, 64,
                                 chosen.per_block}):
            plan = chosen._replace(per_block=per_block, fwd_blocks=-(
                -chosen.units // per_block))
            if per_block > chosen.units:
                continue
            ms = _row(lambda: sa.spatial_attn_fwd(qn, kpb, vpb, HEADS, key,
                                                  RATE, plan=plan), iters)
            mark = "*" if per_block == chosen.per_block else ""
            cells.append(f"K3 {per_block}u{mark} {plan.fwd_grid} blocks "
                         f"{ms['device_ms']:.4f}")
        print(f"{name} N={n} C={c} P={p}: " + " | ".join(cells), flush=True)
        cells = []
        for hb in sa.SHAPES[(c, p)]:
            for tile in sa.TILES:
                tiles = -(-n // tile)
                for chunks in sorted({1, 2, 4, 8, 16, 33, 66, 132,
                                      chosen.chunks}):
                    if chunks > tiles:
                        continue
                    try:
                        plan = sa.plan_for(n, c, p, HEADS, BATCH, tile,
                                           chunks, hb)
                    except ValueError:
                        continue
                    ms = _row(lambda: sa.spatial_attn_bwd(
                        qn, kpb, vpb, g, HEADS, key, RATE, plan=plan), iters)
                    mark = "*" if plan == chosen else ""
                    cells.append(f"K4 hb{hb} T{tile}x{chunks}{mark} "
                                 f"{plan.bwd_grid} blocks "
                                 f"{ms['device_ms']:.4f}")
        print(f"{name} N={n} C={c} P={p}: " + " | ".join(cells), flush=True)
        # what the dropout (the hash and the mask) costs: the chosen plan at
        # rate 0 against rate RATE
        cells = []
        for rate in (RATE, 0.0):
            f = _row(lambda: sa.spatial_attn_fwd(qn, kpb, vpb, HEADS, key,
                                                 rate), iters)
            b = _row(lambda: sa.spatial_attn_bwd(qn, kpb, vpb, g, HEADS, key,
                                                 rate), iters)
            cells.append(f"rate {rate}: K3 {f['device_ms']:.4f} K4 "
                         f"{b['device_ms']:.4f}")
        print(f"{name} N={n} C={c} P={p}: " + " | ".join(cells), flush=True)


def _sdpa_rows(qn, kpb, vpb, g, p) -> dict:
    """SDPA per head at the kernels' shape and dtype (the block-diagonal
    kpb and vpb read back as (B, h, P, C / h)), forward and its backward
    alone: the library's yardstick, timed only."""
    import torch
    import torch.nn.functional as F

    b, n, c = qn.shape
    h, ch = HEADS, c // HEADS
    q4 = qn.reshape(b, n, h, ch).transpose(1, 2).contiguous()
    k4 = torch.stack([kpb[:, j * ch:(j + 1) * ch, j * p:(j + 1) * p]
                      for j in range(h)], 1).transpose(2, 3).contiguous()
    v4 = torch.stack([vpb[:, j * p:(j + 1) * p, j * ch:(j + 1) * ch]
                      for j in range(h)], 1).contiguous()
    g4 = g.reshape(b, n, h, ch).transpose(1, 2).contiguous()
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*ins, dropout_p=RATE, scale=1.0)
        return {"SDPA": _row(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, dropout_p=RATE, scale=1.0)),
                "SDPA bwd": _row(lambda: torch.autograd.grad(
                    out, ins, g4, retain_graph=True))}


def measure() -> dict:
    """The measurements of the `fcd_tpu_torch` on sys.path."""
    import torch

    from fcd_tpu_torch.kernels import _build
    from fcd_tpu_torch.kernels import spatial_attn as sa

    # every library first: a process that builds one (nvcc) after it has
    # read a trace gets empty traces from then on
    _build.build_all()
    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    key = sa.dropout_key(0, 3)
    out = {"levels": {}}
    cases = ([(name, n, c, p, torch.bfloat16) for name, n, c, p in LEVELS]
             + [(name, n, c, p, dt) for dt in (torch.bfloat16, torch.float16)
                for name, n, c, p in WIDE]
             + [(name, n, c, p, torch.float32) for name, n, c, p in LEVELS])
    for name, n, c, p, dt in cases:
        qn, kpb, vpb, g = _inputs(n, c, p, gen, dt)
        row = {"K3": _row(lambda: sa.spatial_attn_fwd(qn, kpb, vpb, HEADS,
                                                      key, RATE)),
               "K4": _row(lambda: sa.spatial_attn_bwd(
                   qn, kpb, vpb, g, HEADS, key, RATE, dtypes=(dt, dt)))}
        if (name, n, c, p) in WIDE or dt == torch.float32:
            row.update(_sdpa_rows(qn, kpb, vpb, g, p))
        kind = str(dt).replace("torch.", "")
        out["levels"][f"{name} {kind} {BATCH}xN={n} C={c} P={p}"] = row
        del qn, kpb, vpb, g
    torch.cuda.empty_cache()
    out["step"] = train_step()
    return out


def train_step() -> dict:
    """ms/step of the default MS_DSA_NET at 4 x 128^3 (three runs of three
    synchronised steps after a warm-up step), and one step's profile from a
    whole trace (`_sweep.whole_trace`)."""
    import torch

    from fcd_tpu_torch.config import get_default_params
    from fcd_tpu_torch.kernels._sweep import whole_trace
    from fcd_tpu_torch.train.schedule import epoch_lr
    from fcd_tpu_torch.train.trainer import ModelTrainer

    params = get_default_params()
    params.update(patch_size=128, loss="DiceCELoss")
    dev = torch.device("cuda")
    trainer = ModelTrainer(params, device=dev)
    lr = epoch_lr(params, params["warmup_epochs"])
    gen = torch.Generator(device=dev).manual_seed(2)
    s, ch = params["patch_size"], params["chans_in"]
    x = torch.rand((BATCH, s, s, s, ch), generator=gen, device=dev)
    y = (torch.rand((BATCH, s, s, s, 1), generator=gen, device=dev)
         > 0.95).float()
    steps = []
    with torch.enable_grad():
        trainer.train_step(x, y, lr)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(x, y, lr)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3 / 3)
        ev, wall = whole_trace(lambda: trainer.train_step(x, y, lr), 1,
                               cpu=True, tries=10)
    wall *= 1e3
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3

    def named(key):
        return sum(e.time_range.elapsed_us() for e in ev
                   if key in e.name) / 1e3

    return {"ms_per_step": steps, "wall_ms_profiled": wall,
            "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "device_kernels": len(ev),
            "k3_ms": named("spatial_attn_fwd"),
            "k4_ms": named("spatial_attn_bwd"),
            "k4_kernels": sum("spatial_attn_bwd" in e.name for e in ev)}


def show(label: str, res: dict) -> None:
    """Print one checkout's measurements."""
    print(f"{label}:", flush=True)
    for lvl, row in res["levels"].items():
        print(f"  {lvl}: " + " | ".join(
            f"{k} {r['device_ms']:.4f} ms device ({r['kernel_ms']:.4f} in "
            f"spatial_attn kernels, {r['device_ops']:g} ops, wall "
            f"{r['wall_ms']:.4f})" for k, r in row.items()))
    st = res["step"]
    print(f"  train step 4x128^3: ms/step "
          f"{', '.join(f'{v:.1f}' for v in st['ms_per_step'])}; "
          f"profiled wall {st['wall_ms_profiled']:.2f} ms, device busy "
          f"{st['device_busy_ms']:.3f} ms, idle "
          f"{100 * st['idle_share']:.1f}%, {st['device_kernels']} device "
          f"kernels; K3 {st['k3_ms']:.3f} ms, K4 {st['k4_ms']:.3f} ms in "
          f"{st['k4_kernels']} kernels", flush=True)


def main(argv=None) -> int:
    # imported here: measure() runs in a child whose fcd_tpu_torch may
    # be an older checkout, imported before this checkout's _sweep
    from fcd_tpu_torch.kernels import _sweep

    return _sweep.main(__doc__, __file__, plans, show, argv)


if __name__ == "__main__":
    sys.exit(main())
