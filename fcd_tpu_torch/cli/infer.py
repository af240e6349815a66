"""Standalone inference CLI: checkpoint -> sliding-window -> native-space
NIfTI segmentations + per-subject Dice/IoU table.

Counterpart of `fcd_tpu/cli/infer.py`, step for step: load the checkpoint
(the JAX package's msgpack format, `train/checkpoint.py`), the test
transforms (NaN scrub, RAS + 1 mm spacing + percentile scale), the
sliding-window engine on the card, softmax (on the card, before the host
fetch), the inverse spatial transform back to the native grid, argmax,
optional post-processing, NIfTI save, and per-subject Dice/IoU with the
all-zero-GT edge case. `--preprocess` (FSL registration) is not ported yet
(ROADMAP.md, Queue A6): it needs the FSL binaries.

The data mesh comes through the trainer's `mesh_data` (`--kwargs
mesh_data=N`; -1, the default, takes every visible card), as in the JAX
CLI: resolved to more than one rank, `main` starts the ranks (one a card;
on the CPU N gloo ranks), each loads the subject and runs its share of the
patch grid, and rank 0 runs the host phases (softmax, inverse transform,
post-processing, save, the table).

Run: python -m fcd_tpu_torch.cli.infer --data_dir ... --checkpoint_path ...
--save_dir ... [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from fcd_tpu_torch import resolve_device
from fcd_tpu_torch.cli.args import parse_kwargs
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.data import nifti
from fcd_tpu_torch.data.manifest import get_data
from fcd_tpu_torch.data.preprocess import (
    invert_to_grid,
    replace_nan,
    resample_spacing,
    scale_channels,
)
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.parallel.mesh import join_env_group, launch, mesh_size
from fcd_tpu_torch.postproc.segment import post_process_prediction
from fcd_tpu_torch.train.trainer import ModelTrainer


def run_inference(
    data_dir: str,
    save_dir: str,
    checkpoint_path: str,
    params: Dict,
    preprocess: bool = False,
    postprocess: bool = True,
    subjects=None,
    device=None,
    timings: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Segment every subject of data_dir into save_dir/<subject>/
    <subject>_seg.nii.gz and return {subject: {dice, iou}}. device: CUDA
    unless "cpu" is asked for (`resolve_device`). timings, when given, is
    filled with each subject's seconds per phase (load_preprocess,
    inference, softmax_invert, postprocess, save), the card synchronised
    at each boundary."""
    dev = resolve_device(device)
    if preprocess:
        raise NotImplementedError(
            "--preprocess (FSL registration, fcd_tpu/data/fsl.py) is not "
            "ported yet: it needs the FSL binaries (ROADMAP.md, Queue A6)")
    os.makedirs(save_dir, exist_ok=True)

    def clock() -> float:
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    trainer = ModelTrainer(params, device=dev)
    lead = trainer.lead          # rank 0 (or the only process)
    if checkpoint_path and os.path.exists(checkpoint_path):
        trainer.load_model(checkpoint_path, with_optimizer=False)
        if lead:
            print(f"pretrained model {checkpoint_path} loaded")
    elif lead:
        print("no pretrained model found")

    entries = get_data(data_dir, params, subjects)
    metrics: Dict[str, Dict[str, float]] = {}

    for entry in entries:
        subj = entry.get("subject", "subject")
        t0 = clock()
        # -- test transforms: RAS + Spacing 1mm + percentile scale ----------
        raw_imgs = [nifti.load(p) for p in entry["image"]]
        orig_shape = raw_imgs[0].data.shape
        orig_affine = raw_imgs[0].affine

        chans = []
        cur_affine = None
        for img in raw_imgs:
            data, aff = nifti.to_ras(replace_nan(img.data), img.affine)
            data, aff = resample_spacing(data, aff, (1.0, 1.0, 1.0), order=1)
            chans.append(data)
            cur_affine = aff
        image = scale_channels(np.stack(chans, axis=-1))
        t1 = clock()

        # -- inference -------------------------------------------------------
        logits = trainer.inference(image)
        t2 = clock()
        if not lead:             # the host phases are rank 0's
            continue
        probs = torch.softmax(logits, dim=-1).cpu().numpy()

        # -- inverse spatial transform (Invertd) + argmax ---------------------
        native_probs = invert_to_grid(probs, cur_affine, orig_shape, orig_affine,
                                      order=1)
        pred = np.argmax(native_probs, axis=-1).astype(np.float32)
        t3 = clock()
        if postprocess:
            onehot = np.stack([1.0 - pred, pred], axis=-1)[None]
            onehot = post_process_prediction(onehot, params["min_region_size"])
            pred = onehot[0, ..., 1]
        t4 = clock()

        # -- save native-space segmentation ----------------------------------
        out_dir = os.path.join(save_dir, subj)
        os.makedirs(out_dir, exist_ok=True)
        nifti.save(os.path.join(out_dir, f"{subj}_seg.nii.gz"),
                   pred.astype(np.uint8), orig_affine)
        if timings is not None:
            timings[subj] = {"load_preprocess": t1 - t0, "inference": t2 - t1,
                             "softmax_invert": t3 - t2, "postprocess": t4 - t3,
                             "save": clock() - t4}

        # -- per-subject Dice/IoU against the native-space label -------------
        if "label" in entry:
            gt = (nifti.load(entry["label"]).data > 0).astype(np.float32)
            if gt.sum() == 0:
                dice = iou = 1.0 if pred.sum() == 0 else 0.0
            else:
                inter = float((pred * gt).sum())
                union = float(((pred + gt) > 0).sum())
                denom = float(pred.sum() + gt.sum())
                dice = 2 * inter / denom if denom > 0 else np.nan
                iou = inter / union if union > 0 else np.nan
            metrics[subj] = {"dice": dice, "iou": iou}

    if metrics and lead:
        print("Subject, Dice, IOU")
        for name, m in metrics.items():
            print(f"{name}, {m['dice']:.4f}, {m['iou']:.4f}")
        print(
            f"Average Dice: {np.mean([m['dice'] for m in metrics.values()]):.4f}, "
            f"Average IOU: {np.mean([m['iou'] for m in metrics.values()]):.4f}"
        )
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description="FCD segmentation inference (CUDA)")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--model_type", type=str, default=None)
    parser.add_argument("--preprocess", action="store_true",
                        help="Run FSL registration first (not ported yet)")
    parser.add_argument("--no_postprocess", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--kwargs", nargs="*", help="key=value param overrides")
    args = parser.parse_args(argv)

    params = get_default_params()
    if args.model_type:
        params["model_type"] = args.model_type
    if args.kwargs:
        params = parse_kwargs(params, args.kwargs)
    _, params = get_model(params, return_model=False)
    params["chans_in"] = len(params["seq"].split("+"))

    call = (args.data_dir, args.save_dir, args.checkpoint_path, params)
    kw = dict(preprocess=args.preprocess,
              postprocess=not args.no_postprocess, device=args.device)
    dev = resolve_device(args.device)
    n_mesh = mesh_size(int(params.get("mesh_data", -1)), dev)
    if n_mesh > 1 and not join_env_group():
        return launch(_ranked_inference, n_mesh, call, kw,
                      device_type=dev.type)[0]
    return run_inference(*call, **kw)


def _ranked_inference(call, kw):
    """run_inference on a rank `launch` started: its own card, or the
    CPU."""
    return run_inference(*call, **{**kw, "device": (
        "cpu" if kw["device"] == "cpu" else None)})


if __name__ == "__main__":
    main()
