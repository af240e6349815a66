"""Training and testing CLI: `python -m fcd_tpu_torch.cli.train ...`.

Counterpart of `fcd_tpu/cli/train.py::main` (:21-85): the default params
with the CLI's and --kwargs' overrides, chans_in from `seq`, a timestamped
save directory (the given one with --resume), then the train / val / test
splits of the split file: `ModelTrainer.train` (with the test at its end)
or, without a train split, `ModelTrainer.test` of a checkpoint without and
with post-processing. It runs on the card unless `--device cpu` is given.

`--devices` (-1: every visible card) resolving to N > 1 trains on a data
mesh (`parallel/`): the command starts N ranks itself, one a card
(torch.multiprocessing spawn, a file store, NCCL), and they train as the
JAX package's mesh does; under torchrun it joins the group that is there.
On the CPU `--devices N` starts N gloo ranks and -1 stays one process.
The timestamped save directory is chosen once, before the ranks start.
Not ported: `--emission_tracking` (ROADMAP Queue A6) raises
NotImplementedError.

Run: python -m fcd_tpu_torch.cli.train --data_dir D --split_file S
--splits train val test --save_dir O [--device cpu] [--devices N]
[--kwargs k=v ...]
"""

from __future__ import annotations

import os
from datetime import datetime
from types import SimpleNamespace

import torch.distributed as dist

from fcd_tpu_torch import resolve_device
from fcd_tpu_torch.cli.args import parse_args, parse_kwargs
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.data.manifest import read_split_file
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.parallel.mesh import join_env_group, launch, mesh_size
from fcd_tpu_torch.train.trainer import ModelTrainer

__all__ = ["main", "mesh_size"]


def main(argv=None, timings=None):
    """Parse argv and run the requested splits; returns the trainer, or,
    when this call started the mesh's ranks, rank 0's `save_dir` and
    `test_metrics` as a namespace. `timings` gets ModelTrainer.train's
    seconds per epoch and phase (rank 0's under a mesh)."""
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
    if n_mesh > 1 and not join_env_group():
        out = launch(_run, n_mesh, args, params, _save_dir(args, params),
                     device_type=dev.type)[0]
        if timings is not None:
            timings.update(out.pop("timings"))
        return SimpleNamespace(**out)
    save_dir = _save_dir(args, params)
    if dist.is_initialized():        # torchrun's ranks take rank 0's stamp
        box = [save_dir]
        dist.broadcast_object_list(box, 0)
        save_dir = box[0]
    return _run(args, params, save_dir, timings, device=dev)


def _save_dir(args, params) -> str:
    """The run's directory: --save_dir itself with --resume, else a
    timestamped one below it."""
    if args.resume:
        return args.save_dir
    stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    if args.prefix:
        stamp = f"{args.prefix}_{stamp}"
    return os.path.join(args.save_dir or "", params["model_type"], stamp)


def _run(args, params, save_dir, timings=None, device=None):
    """The splits on this process's trainer. A rank that `launch` started
    (no `device`: its own card, or the CPU) returns what pickles: its
    save_dir, test_metrics and timings."""
    ranked = device is None
    if ranked:
        timings = {}
        device = "cpu" if args.device == "cpu" else None
    trainer = ModelTrainer(params, device=device)
    if args.checkpoint_path:
        trainer.load_model(args.checkpoint_path, with_optimizer=False)

    split_dict = read_split_file(args.split_file)
    requested = {s.lower() for s in args.splits}

    if "train" in requested:
        train_subjects = split_dict.get("train", [])
        val_subjects = split_dict.get("val", [])
        test_subjects = (split_dict.get("test", [])
                         if "test" in requested else [])
        os.makedirs(save_dir, exist_ok=True)
        trainer.save_dir = save_dir
        trainer.train(args.data_dir, train_subjects, val_subjects, save_dir,
                      test_subjects, resume=args.resume, timings=timings)
    elif "test" in requested:
        test_subjects = split_dict.get("test", [])
        trainer.test(args.data_dir, test_subjects, post_process=False)
        trainer.test(args.data_dir, test_subjects, post_process=True)
    if ranked:
        return {"save_dir": getattr(trainer, "save_dir", None),
                "test_metrics": trainer.test_metrics, "timings": timings}
    return trainer


if __name__ == "__main__":
    main()
