"""Whether the port's bf16 CPU train step, the reference that
chip_smoke.py's train checks scale their limits by, is right on the host
it runs on (ROADMAP C24).

chip_smoke.py's zoo_train_check holds the card's bf16 step to the fp32 CPU
step, each module's gradient within twice the distance the port's bf16 CPU
step takes from fp32. This script builds the trainers as zoo_train_check
builds them (seeded weights, dropout off, a seeded CPU batch of the same
kind) and takes the fp32 CPU step once and the bf16 CPU step `--repeats`
times with oneDNN (torch.backends.mkldnn) on and as often with it off,
printing for each bf16 step its seconds, its loss and each module's
rel-L2 / cosine from the fp32 step; a module further than 1 from fp32 also
gets its parameters' largest |gradient|. It also takes the library's own
bf16 CPU F.conv3d, forward and backward, at the deepest convs of UNet and
VNet against f32, oneDNN on and off: the port's `ops/layers.py` convs
take such a tensor in f32 (`_library_conv`), so the model steps show the
port and these lines the library.

    python scripts/cpu_bf16_reference.py [--repeats N] [--onednn both|on|off]
        [--convs-first] [UNET VNET ...]

ONEDNN_MAX_CPU_ISA in the environment caps the instruction set oneDNN
dispatches to (AVX512_CORE_BF16 or AVX512_CORE: no AMX, as on a host
whose CPU has none).

CPU only; a few GB at 1 x 64^3.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fcd_tpu_torch.train.trainer import ModelTrainer  # noqa: E402


def model_steps(model_type, repeats, modes):
    size = cs.TRAIN_CHECK_SIZE
    params = cs.train_params(size, extra={"model_type": model_type})
    ref = ModelTrainer(params, device="cpu", verbose=False)
    cs.redraw_attention(ref.model, cs.SEED + 3)
    cs.dropout_off(ref.model)
    start = {k: v.clone() for k, v in ref.model.state_dict().items()}
    x, y = cs.train_batch(torch.device("cpu"), 1, size, params["chans_in"])
    with torch.enable_grad():
        fp32 = float(ref.train_step(x, y, 1e-4))
    print(f"{model_type}: fp32 CPU loss {fp32:.6f}", flush=True)
    for onednn in modes:
        for r in range(repeats):
            tr = ModelTrainer(params, device="cpu", verbose=False)
            tr.model.load_state_dict(start)
            tr.model.compute_dtype = torch.bfloat16
            cs.dropout_off(tr.model)
            t0 = time.perf_counter()
            with torch.enable_grad(), torch.backends.mkldnn.flags(
                    enabled=onednn):
                loss = float(tr.train_step(x, y, 1e-4))
            sec = time.perf_counter() - t0
            d = cs._grad_distance(tr.model, ref.model, cs._module_groups)
            print(f"  bf16 CPU step, oneDNN {'on' if onednn else 'off'}, "
                  f"run {r}: {sec:.2f} s, loss {loss:.6f}; "
                  + ", ".join(f"{k} {a:.2e}/{b:.5f}"
                              for k, (a, b) in d.items()), flush=True)
            groups = cs._module_groups(tr.model)
            names = {id(p): n for n, p in tr.model.named_parameters()}
            for k, (a, _) in d.items():
                if not a <= 1.0:
                    print(f"    {k}: " + ", ".join(
                        f"{names[id(p)]} max|g| "
                        f"{p.grad.float().abs().max().item():.3e}"
                        for p in groups[k]), flush=True)


# (label, input shape channels-first, out channels, stride): the deepest
# strided and stride-1 convs of UNet (channels 16..512 over 64^3) and VNet
CONVS = (("UNet down 4", (1, 256, 4, 4, 4), 512, 2),
         ("UNet bottom", (1, 512, 2, 2, 2), 512, 1),
         ("UNet bottom residual", (1, 256, 2, 2, 2), 512, 1),
         ("VNet down 3", (1, 128, 8, 8, 8), 256, 2),
         ("VNet deepest", (1, 256, 4, 4, 4), 256, 1))


def conv_checks(repeats, modes):
    gen = torch.Generator().manual_seed(0)
    for label, shape, co, stride in CONVS:
        x = torch.randn(shape, generator=gen)
        w = torch.randn((co, shape[1], 3, 3, 3), generator=gen) * 0.05
        outs = {}
        for dt in (torch.float32, torch.bfloat16):
            for onednn in modes:
                for r in range(repeats if dt == torch.bfloat16 else 1):
                    xx = x.to(dt).clone().requires_grad_(True)
                    ww = w.to(dt).clone().requires_grad_(True)
                    with torch.backends.mkldnn.flags(enabled=onednn):
                        out = F.conv3d(xx, ww, stride=stride, padding=1)
                        g = torch.linspace(-1, 1, out.numel()).view(
                            out.shape).to(dt)
                        out.backward(g)
                    outs[(dt, onednn, r)] = (out.detach().float(), xx.grad.float(),
                                             ww.grad.float())
        base = outs[(torch.float32, modes[0], 0)]
        for key, val in outs.items():
            if key[0] != torch.bfloat16:
                continue
            rel = [float((a - b).norm() / b.norm()) for a, b in zip(val, base)]
            print(f"  conv {label}: bf16 oneDNN {'on' if key[1] else 'off'} "
                  f"run {key[2]}: rel-L2 out {rel[0]:.2e}, dx {rel[1]:.2e}, "
                  f"dw {rel[2]:.2e}", flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--onednn", choices=("both", "on", "off"), default="both",
                    help="the bf16 steps with oneDNN on, off, or both")
    ap.add_argument("--convs-first", action="store_true",
                    help="the single-conv checks before the model steps")
    ap.add_argument("models", nargs="*", default=["UNET", "VNET"])
    args = ap.parse_args(argv)
    modes = {"both": (True, False), "on": (True,), "off": (False,)}[args.onednn]
    print(f"torch {torch.__version__}, threads {torch.get_num_threads()}, "
          f"oneDNN {torch.backends.mkldnn.is_available()}; "
          f"CPU {torch.backends.cpu.get_cpu_capability()}, ONEDNN_MAX_CPU_ISA "
          f"{os.environ.get('ONEDNN_MAX_CPU_ISA', 'unset')}", flush=True)
    if args.convs_first:
        conv_checks(args.repeats, modes)
    for m in args.models:
        model_steps(m, args.repeats, modes)
    if not args.convs_first:
        conv_checks(args.repeats, modes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
