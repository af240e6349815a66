"""The JAX package's performance gates, as the port reads them.

Counterpart of `fcd_tpu/flags.py`: the same gate names, defaults, values
and descriptions (a params dict built for one package configures the
other), plus, for each gate, what it does in the port.

Users set gates through `params['perf_flags']` ({gate: value}); an
exported `FCD_*` variable wins over `perf_flags`, and `perf_flags` wins
over the default; an unknown key raises KeyError (`fcd_tpu/flags.py:
231-243`). Unlike the JAX package's `apply_perf_flags`, which writes
`os.environ` (so one trainer's flags would reach every later one in the
process), `resolve` only reads the environment: the model factory resolves
the gates once, when a trainer builds its model, and freezes what they
decide into the model (`models/ms_dsa_net.py`), which then behaves the
same for its whole life.

Most gates choose between TPU formulations of one function: the port
computes that function with one kernel whatever the gate's value, and the
knob table below names it. Three decisions change what the port runs
(`model_gates`):

* where encoders 1-2 pool (`pool_in_finale`): inside the block finale
  (B2 forward, K2 backward) or in a pass of their own (B3 forward, B9
  backward, `kernels/pool2x.py`);
* the fused segmentation head (`fused_head`): the last decoder's finale
  and the 1x1 head as one kernel, B15 (`csrc/finale_head.cu`), at eval;
* the tie split of the levels-1-2 pool's gradient (`levels12_tie`): the
  s2d pool's even split, or the `jnp.maximum` chain of the dense path.

`python -m fcd_tpu_torch.flags` prints the knob table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

Gates = Mapping[str, str]


@dataclass(frozen=True)
class Flag:
    default: str
    desc: str
    values: str = "0|1"
    status: str = "live"          # 'live' | 'dead-end' | 'infra'
    port: str = ""                # what the gate does in the port


_B1 = "B1 (`csrc/conv3d.cu`) computes this conv whatever the value"
_POOL12 = ("`0`: encoders 1-2 pool in a pass of their own, B3 forward and "
           "B9 backward (`kernels/pool2x.py`); the finale stays B2 / K2")

FLAGS: Dict[str, Flag] = {
    # ---- conv kernel formulation -----------------------------------------
    "FCD_CONV8": Flag(
        "1", "Half-offset 8-tap conv pair (2.37x FLOP redundancy) vs the "
        "27-tap fused kernels (8x) in the eval resblock.",
        port=f"TPU conv form; `0` selects B11's 27-tap form: {_B1}"),
    "FCD_CONV8_TRAIN": Flag(
        "1", "Differentiable 8-tap conv pair in the TRAIN path (vs the "
        "27-tap s2d form).",
        port=f"In training, {_POOL12}; the convs stay B1 / K1"),
    "FCD_CONV8_STATS": Flag(
        "1", "Kernel-emitted instance-norm statistics in training (custom "
        "VJPs expose the conv kernels' f32 accumulator sums; off = two "
        "XLA reduction passes).",
        port=f"In training, {_POOL12}; B1 emits the statistics either way"),
    "FCD_CONV8_PROLOGUE": Flag(
        "1", "TRAIN path: norm1 + leaky-relu fused into conv2's VMEM "
        "prologue via a custom VJP (the eval formulation) — the offset "
        "tensor's standalone norm/act/mask pass never runs in XLA; off = "
        "composed instance_norm_act_offset + conv8_o2a_stats.",
        port="Same function: B1's prologue applies norm1 + act either way"),
    "FCD_CONV8_VPAIR": Flag(
        "1", "In-VMEM W-lane pairing for the single-part a2o kernel: 4 "
        "aligned GEMMs at doubled contraction instead of 8 taps with "
        "misaligned sx=1 slices. Measured enc1 4.85 -> 3.50 ms/volume.",
        port=f"TPU lane layout of the conv: {_B1}"),
    "FCD_CONV8_VPAIR_MULTI": Flag(
        "0", "Extend in-VMEM W-pairing to the MULTI-part a2o kernels "
        "(decoder cat-parts). r2 A/B: flat + a finale fusion regression; "
        "kept for re-A/B as surrounding formulations change.",
        status="dead-end", port=f"TPU lane layout of the conv: {_B1}"),
    "FCD_CONV8_KD": Flag(
        "1", "Multi-row conv programs: kd outputs per grid step share "
        "their fetched input rows ((kd+1)/kd DMA instead of 2x).",
        port=f"TPU grid shape of the conv: {_B1}"),
    "FCD_A2O_PAD": Flag(
        "vmem", "a2o halo form: 'vmem' = depth-only pad + in-VMEM H/W "
        "halo; 'pad'/'dus'/'pallas' = full XLA-side halo pad variants "
        "(A/B'd on v5e: 8.66/8.16/6.49 vol/s vs vmem's 10.2+).",
        values="vmem|pad|dus|pallas",
        port="TPU halo form (`pallas` is B18): B1 zero-pads on its loads "
             "whatever the value"),
    "FCD_CONV8_PAIRED": Flag(
        "0", "HBM-paired W lanes (doubled input DMA). Lost to VPAIR on "
        "v5e; kept for reference.", status="dead-end",
        port=f"TPU lane layout of the conv: {_B1}"),
    "FCD_CONV8_CARRY": Flag(
        "0", "Row-carry a2o (each depth row fetched once, carried in VMEM "
        "scratch). Serializes Mosaic's double buffering: -5% end-to-end.",
        status="dead-end", port=f"TPU grid schedule of the conv: {_B1}"),
    "FCD_CONV8_DUALACC": Flag(
        "0", "Dual-accumulator form (full-width GEMMs + one accumulator "
        "shift-add). Slower in context: 8.76 vs 7.83 ms/patch.",
        status="dead-end", port=f"TPU accumulator form of the conv: {_B1}"),
    "FCD_S2D_CONV": Flag(
        "padded27", "27-tap kernel flavour for the non-conv8 paths.",
        values="padded27|aligned",
        port=f"TPU 27-tap flavour (B12 `padded27` / `aligned`): {_B1}"),
    "FCD_FAST_CONV": Flag(
        "0", "Route plain Conv3d through the blocked Pallas conv (the "
        "model-zoo wide path keeps XLA convs; s2d-resident blocks are "
        "the production fast path).",
        port="`1` routes the zoo's plain Conv3d through B14; MS_DSA_NET's "
             f"convs are B1's: {_B1}"),

    # ---- s2d residency / fused blocks ------------------------------------
    "FCD_S2D": Flag(
        "1", "s2d-resident residual blocks (lane-dense space-to-depth "
        "execution) where eligible; off = plain NDHWC XLA path.",
        port="`0`: encoders 1-2 pool as the dense path's `jnp.maximum` "
             "chain, whose gradient halves at each tied pair (K2's `chain` "
             "split, in the finale); no fused head"),
    "FCD_FUSED_BLOCK": Flag(
        "1", "Fused eval resblock (3 kernel passes instead of ~10 memory "
        "passes); off = composed s2d ops.",
        port="`0`: at eval, encoders 1-2 pool in a pass of their own (B3); "
             "no fused head; the blocks stay B1 + B2"),
    "FCD_FUSED_HEAD": Flag(
        "0", "Fuse the 1x1 segmentation head into the final decoder "
        "block's finale kernel. A/B: 6.97 vs 7.36 vol/s (16-lane store "
        "loses more than the saved passes).", status="dead-end",
        port="`1`: at eval, the last decoder's finale and the 1x1 head "
             "run as B15 (`csrc/finale_head.cu`): bias added in f32 before "
             "one rounding"),
    "FCD_PAD_CHAIN": Flag(
        "1", "Padded-depth chain on the eval path: producers (fused "
        "finales, the Pallas upsample, to_s2d entries) emit s2d tensors "
        "with their (+1, +1) zero depth pad in-pass; a2o/pool kernels "
        "consume them directly — the standalone depth-pad ops and the "
        "upsample d2s regroup copies disappear. Off = per-consumer pads.",
        port=_POOL12),
    "FCD_FUSED_DSA": Flag(
        "1", "Fused Pallas DSA attention kernel at eval (LayerNorm + "
        "qkvv + both attention branches); off = einsum path.",
        port="Same function: B5 (`csrc/dsa.cu`) at eval either way"),
    "FCD_DSA_V2": Flag(
        "1", "Tokens-resident DSA einsum path for training (bf16 tokens, "
        "fused projections); off = per-head layout path.",
        port="TPU layout of the train DSA: the port's train DSA either way"),

    # ---- pooling ----------------------------------------------------------
    "FCD_BLOCK_ENTRY_S2D": Flag(
        "reshape", "s2d form for inter-level block entries: 'conv' = "
        "one-hot stride-2 conv (the volume entry's 3x-faster lowering). "
        "A/B on v5e: 66.4 vs 64.6 ms/volume — the conv form wins only at "
        "volume scale; bit-identical.", values="reshape|conv",
        status="dead-end", port="TPU layout; no counterpart"),
    "FCD_FINALE_POOL": Flag(
        "1", "Fuse the encoder resblock finale + padded-chain emission + "
        "2x max pool into one Pallas pass (the pool's full re-read of the "
        "finale tensor never happens); off = separate finale fusion + "
        "pool kernel.", port=_POOL12),
    "FCD_FINALE_TRAIN": Flag(
        "1", "Differentiable fused TRAIN finale (norm2 affine + residual "
        "+ act + padded emission + pool): ONE Pallas pass per direction "
        "with a custom VJP emitting d_ys/d_rs and the affine-grad sums; "
        "off = composed XLA finale (~5 fusions per direction at level "
        "1/2).", port=f"In training, {_POOL12}"),
    "FCD_SPATTN_KERNEL": Flag(
        "1", "VMEM-resident spatial-attention tail (softmax + dropout + "
        "attn@V per token tile, custom VJP, hardware-PRNG dropout): the "
        "(B, N, h*P) attention matrix never round-trips HBM; off = the "
        "v2 einsum tail (XLA materializes it, 0.81 ms N-minor fusion at "
        "the level-3 train shape).",
        port="Same function: K3 / K4 (`csrc/spatial_attn.cu`) either way"),
    "FCD_POOL_FWD_KERNEL": Flag(
        "1", "Pallas rotation-tree max-pool forward (full-lane VPU "
        "reduction); off = lane-slice maximum.",
        port="Where encoders 1-2 pool in a pass of their own: B3 (Triton, "
             "`kernels/pool2x.py`) whatever the value"),
    "FCD_POOL_BWD_KERNEL": Flag(
        "1", "Pallas max-pool backward (one read-xs/write-dx pass); off = "
        "XLA compare/select chain.",
        port="Where encoders 1-2 pool in a pass of their own: B9 (Triton, "
             "`kernels/pool2x.py`) whatever the value"),

    # ---- sliding-window engine --------------------------------------------
    "FCD_SW_STATIC": Flag(
        "1", "Static-grid SW program (pre-gathered patches, pad-tree "
        "blend); 0 = dynamic-grid program (device-data starts — the "
        "bucketed engine's program).",
        port="The port runs the exact static engine; the outputs are "
             "identical either way"),
    "FCD_SW_EXIT": Flag(
        "mm", "Volume-exit depth-to-space form: MXU perm-matmul | "
        "reshape+transpose | one-hot conv.", values="mm|reshape|conv",
        port="TPU exit layout: `sw_exit` (B6) either way"),
    "FCD_SW_FLAT_EXIT": Flag(
        "1", "Fused Pallas exit emitting the flat (D, H, W*C) f32 volume "
        "(skips ~12 ms of XLA boundary-layout copies); off = 4-D exit.",
        port="TPU exit layout: `sw_exit` (B6) either way"),
    "FCD_SW_OUT_LAYOUT": Flag(
        "", "Force the SW jit output to the standard major-to-minor "
        "layout ('std'); default lets XLA choose. Measured neutral.",
        values="''|std", status="dead-end",
        port="XLA layout: no counterpart"),
    "FCD_ENTRY_SLICE": Flag(
        "1", "Volume-entry space_to_depth as W-pair lane packing (pure "
        "reshape) + stride-2 D/H slices + one lane concat, instead of the "
        "stride-2 one-hot conv. Bit-identical; 6.4 vs 86.6 ms standalone "
        "at the bench volume (the conv form's layout assignment is "
        "hostile at c=2 without a consumer constraint).",
        port="TPU entry layout: `sw_entry` (B17) either way"),
    "FCD_ENTRY_KERNEL": Flag(
        "0", "Pallas lane-permutation-GEMM volume entry. Mosaic rejects "
        "the lanes->sublane cast; 29.3 vs 5.2 ms/volume.",
        status="dead-end", port="TPU entry layout: `sw_entry` (B17) either way"),
    "FCD_UP_KERNEL": Flag(
        "0", "Pallas s2d upsample kernel; lost to the matmul regroup "
        "form.", status="dead-end",
        port="`1` is B16: B4 (`csrc/upsample.cu`) computes the upsample "
             "whatever the value"),

    # ---- trainer plumbing --------------------------------------------------
    "FCD_IMAGE_PREJIT": Flag(
        "1", "Image entry s2d as its own jit (decouples layout domains; "
        "~5 ms/step of in-step relayouts otherwise).",
        port="jit structure: eager PyTorch has none"),
    "FCD_LABEL_PREJIT": Flag(
        "1", "Label s2d transform as its own jit (same layout-domain "
        "lesson).", port="jit structure: eager PyTorch has none"),
    "FCD_EVAL_QUEUE": Flag(
        "4", "Streamed-eval in-flight window (volumes dispatched ahead "
        "of their metric fetch).", values="int>=1",
        port="The epoch loop's streamed evaluation (`ModelTrainer."
        "evaluate`): the volumes in flight before a loss and mask are "
        "fetched"),
    "FCD_RBG_DROPOUT": Flag(
        "1", "Per-step dropout keys use the TPU hardware RBG PRNG instead "
        "of threefry: the level-3 spatial-attention dropout's counter-"
        "based bit-generation fusions (~3 ms/step at batch 4x128^3) "
        "become hardware RNG ops. Same Bernoulli distribution, different "
        "random stream. A/B'd 141.4 -> 138.6 ms pipelined.",
        port="TPU random stream: the port draws its own (ROADMAP C2)"),

    # ---- infra -------------------------------------------------------------
    "FCD_TPU_COMPILE_CACHE": Flag(
        "1", "Persistent XLA compilation cache.", status="infra",
        port="XLA cache: nothing to cache"),
    "FCD_MNI152_PATH": Flag(
        "", "Path to an MNI152 template for FSL registration.",
        values="path", status="infra",
        port="FSL `--preprocess`: not ported (ROADMAP A6)"),
}


def resolve(perf_flags: Optional[Mapping[str, object]] = None,
            environ: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """Every gate's value: an exported variable wins, then `perf_flags`,
    then the default. Unknown `perf_flags` keys raise KeyError. Reads the
    environment (`environ`, default os.environ) and writes nothing."""
    env = os.environ if environ is None else environ
    perf_flags = dict(perf_flags or {})
    for k in perf_flags:
        if k not in FLAGS:
            raise KeyError(f"unknown perf flag {k!r}; known: {sorted(FLAGS)}")
    return {name: (env[name] if name in env
                   else str(perf_flags[name]) if name in perf_flags
                   else f.default)
            for name, f in FLAGS.items()}


def get(name: str, gates: Optional[Gates] = None) -> str:
    """A gate's value in `gates` (a `resolve` result), or, without them,
    the exported variable or the default. Unknown names raise KeyError."""
    if name not in FLAGS:
        raise KeyError(f"unknown perf flag {name!r}")
    if gates is None:
        return os.environ.get(name, FLAGS[name].default)
    return gates[name]


def on(name: str, gates: Optional[Gates] = None) -> bool:
    """Boolean gates: anything but '0' / '' counts as on."""
    return get(name, gates) not in ("0", "")


def pool_in_finale(gates: Gates, train: bool) -> bool:
    """Whether encoders 1-2 pool inside their block finale.

    At eval: FCD_PAD_CHAIN, FCD_FUSED_BLOCK and FCD_FINALE_POOL all on
    (`fcd_tpu/ops/blocks.py:73-82` `_pad_chain_ok`, `fcd_tpu/models/
    ms_dsa_net.py:165-173` `fuse_pool`). In training: FCD_PAD_CHAIN,
    FCD_CONV8_TRAIN, FCD_CONV8_STATS, FCD_FINALE_TRAIN and
    FCD_FINALE_POOL all on (`ops/blocks.py:73-82, 252, 291-293`,
    `ops/s2d_ops.py:703-707` `_finale_train_use_pallas`). Otherwise the
    JAX package pools in a pass of its own (`max_pool_2x_s2d_exit`,
    B3 / B9). At levels 3-5 it always pools outside any kernel (a
    `jnp.maximum` chain, `models/ms_dsa_net.py:210-212`); the port pools
    those levels inside the finale with K2's `chain` split whatever the
    gates, since values and gradients are the same."""
    names = ["FCD_PAD_CHAIN", "FCD_FINALE_POOL"]
    names += (["FCD_CONV8_TRAIN", "FCD_CONV8_STATS", "FCD_FINALE_TRAIN"]
              if train else ["FCD_FUSED_BLOCK"])
    return all(on(n, gates) for n in names)


def fused_head(gates: Gates) -> bool:
    """Whether the last decoder's finale and the 1x1 head run fused (B15),
    at eval only: FCD_S2D, FCD_FUSED_BLOCK and FCD_FUSED_HEAD all on
    (`fcd_tpu/models/ms_dsa_net.py:321-325`; FCD_S2D through `use_s2d1`,
    `ops/blocks.py:44`)."""
    return all(on(n, gates) for n in ("FCD_S2D", "FCD_FUSED_BLOCK",
                                      "FCD_FUSED_HEAD"))


def levels12_tie(gates: Gates) -> str:
    """How the levels-1-2 pool's gradient splits among tied maxima:
    `even` through the s2d pool's custom VJP (`fcd_tpu/ops/s2d_ops.py:
    237-252`), or, with FCD_S2D=0, `chain` through the dense path's
    `jnp.maximum` chain (`models/ms_dsa_net.py:187-190, 200-203`,
    `ops/layers.py::max_pool_2x`)."""
    return "even" if on("FCD_S2D", gates) else "chain"


def model_gates(gates: Gates) -> Dict[str, object]:
    """MS_DSA_NET's frozen gate attributes from resolved gates."""
    return {"pool_in_finale": (pool_in_finale(gates, False),
                               pool_in_finale(gates, True)),
            "fused_head": fused_head(gates),
            "levels12_tie": levels12_tie(gates)}


def knob_table_markdown() -> str:
    """Markdown table of every gate with what it does in the port
    (`python -m fcd_tpu_torch.flags`)."""
    rows = ["| Gate | Default | Values | Status | What it selects | "
            "In the port |", "|---|---|---|---|---|---|"]
    for name in sorted(FLAGS):
        f = FLAGS[name]
        default = f.default if f.default else "''"
        rows.append(f"| `{name}` | `{default}` | {f.values} | {f.status} "
                    f"| {f.desc} | {f.port} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(knob_table_markdown())
