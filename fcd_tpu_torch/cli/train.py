"""Training and testing CLI: `python -m fcd_tpu_torch.cli.train ...`.

Counterpart of `fcd_tpu/cli/train.py::main` (:21-85): the default params
with the CLI's and --kwargs' overrides, chans_in from `seq`, a timestamped
save directory (the given one with --resume), then the train / val / test
splits of the split file: `ModelTrainer.train` (with the test at its end)
or, without a train split, `ModelTrainer.test` of a checkpoint without and
with post-processing. It runs on the card unless `--device cpu` is given.

Not ported: a data mesh over several cards (`--devices` resolving to more
than one card; ROADMAP Queue A8) and `--emission_tracking` (ROADMAP Queue
A6); both raise NotImplementedError.

Run: python -m fcd_tpu_torch.cli.train --data_dir D --split_file S
--splits train val test --save_dir O [--device cpu] [--kwargs k=v ...]
"""

from __future__ import annotations

import os
from datetime import datetime

import torch

from fcd_tpu_torch import resolve_device
from fcd_tpu_torch.cli.args import parse_args, parse_kwargs
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.data.manifest import read_split_file
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.train.trainer import ModelTrainer


def mesh_size(devices: int, device: torch.device) -> int:
    """The cards a data mesh would span (fcd_tpu/train/trainer.py:169-181:
    -1 takes all): the visible cards on a CUDA device, 1 on the CPU."""
    avail = torch.cuda.device_count() if device.type == "cuda" else 1
    return avail if devices < 0 else min(devices, avail)


def main(argv=None, timings=None) -> ModelTrainer:
    """Parse argv and run the requested splits; returns the trainer.
    `timings` goes to ModelTrainer.train (seconds per epoch and phase)."""
    params = get_default_params()
    args = parse_args(default_params=params, argv=argv)
    params["model_type"] = args.model_type
    if args.kwargs:
        params = parse_kwargs(params, args.kwargs)

    _, params = get_model(params, return_model=False)
    params["chans_in"] = len(params["seq"].split("+"))
    params["mesh_data"] = int(args.devices)
    if args.emission_tracking:
        raise NotImplementedError(
            "--emission_tracking (fcd_tpu/utils/energy.py) is not ported "
            "yet (ROADMAP.md, Queue A6)")
    dev = resolve_device(args.device)
    n_mesh = mesh_size(params["mesh_data"], dev)
    if n_mesh > 1:
        raise NotImplementedError(
            f"--devices {args.devices} resolves to a data mesh of {n_mesh} "
            "cards: the port trains on one card, and the data-parallel "
            "paths (fcd_tpu/parallel/) are ROADMAP.md Queue A8; pass "
            "--devices 1")

    trainer = ModelTrainer(params, device=dev)
    if args.checkpoint_path:
        trainer.load_model(args.checkpoint_path, with_optimizer=False)

    split_dict = read_split_file(args.split_file)
    requested = {s.lower() for s in args.splits}

    if "train" in requested:
        train_subjects = split_dict.get("train", [])
        val_subjects = split_dict.get("val", [])
        test_subjects = (split_dict.get("test", [])
                         if "test" in requested else [])
        if args.resume:
            save_dir = args.save_dir
        else:
            stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
            if args.prefix:
                stamp = f"{args.prefix}_{stamp}"
            save_dir = os.path.join(args.save_dir, params["model_type"],
                                    stamp)
        os.makedirs(save_dir, exist_ok=True)
        trainer.save_dir = save_dir
        trainer.train(args.data_dir, train_subjects, val_subjects, save_dir,
                      test_subjects, resume=args.resume, timings=timings)
    elif "test" in requested:
        test_subjects = split_dict.get("test", [])
        trainer.test(args.data_dir, test_subjects, post_process=False)
        trainer.test(args.data_dir, test_subjects, post_process=True)
    return trainer


if __name__ == "__main__":
    main()
