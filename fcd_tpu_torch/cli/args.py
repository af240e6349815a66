"""The training CLI's arguments and the typed key=value overrides of
--kwargs.

A copy of `fcd_tpu/cli/args.py` (:15-84): `parse_args` and
`validate_args` take the same flags under the same rules, plus
`--device` (cuda, the default, or cpu) as `cli/infer.py` has; in
`parse_kwargs` each value is coerced to the type of the default it
overrides, and unknown keys are warned about and skipped.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List


def parse_args(default_params: Dict[str, Any],
               argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train and Test Model for FCD Detection (CUDA).")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Path to dataset root directory")
    parser.add_argument("--split_file", type=str, required=True,
                        help="Path to split file")
    parser.add_argument("--splits", nargs="+",
                        default=["train", "val", "test"],
                        help="Which splits to load (any of: train, val, "
                        "test)")
    parser.add_argument("--checkpoint_path", type=str,
                        help="Path to model checkpoint")
    parser.add_argument("--save_dir", type=str, help="Output directory")
    parser.add_argument("--model_type", type=str,
                        default=default_params["model_type"])
    parser.add_argument("--devices", type=str, default="-1",
                        help="Number of cards for the data mesh (-1: all); "
                        "the port runs on one")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--prefix", type=str, default="")
    parser.add_argument("--emission_tracking", action="store_true",
                        help="Enable energy/emission estimation (not "
                        "ported yet)")
    parser.add_argument("--kwargs", nargs="*",
                        help="key=value pairs to override params")

    args = parser.parse_args(argv)
    validate_args(args)
    return args


def validate_args(args: argparse.Namespace) -> None:
    if not os.path.exists(args.data_dir):
        raise ValueError(f"--data_dir not found: {args.data_dir}")
    if not os.path.exists(args.split_file):
        raise ValueError(f"--split_file not found: {args.split_file}")

    valid_splits = {"train", "val", "test"}
    requested = {s.lower() for s in args.splits}
    invalid = requested - valid_splits
    if invalid:
        raise ValueError(f"Invalid split(s): {invalid}. Must be subset of "
                         f"{valid_splits}")

    if "train" in requested:
        if "val" not in requested:
            raise ValueError("--splits must include 'val' when using "
                             "'train'")
        if not args.save_dir:
            raise ValueError("--save_dir required when training")
    if args.resume and (not args.save_dir
                        or not os.path.exists(args.save_dir)):
        raise ValueError("--save_dir must exist when using --resume")
    if "test" in requested and not (args.checkpoint_path
                                    or "train" in requested):
        raise ValueError("--splits includes 'test' but no "
                         "--checkpoint_path or 'train' split provided")


def parse_kwargs(params: Dict[str, Any], kwargs_list: List[str]) -> Dict[str, Any]:
    if not kwargs_list:
        return params
    for kv in kwargs_list:
        if "=" not in kv:
            raise ValueError(f"Invalid kwargs format: {kv}. Use key=value")
        key, value = kv.split("=", 1)
        if key not in params:
            print(f"Warning: Unknown parameter '{key}'")
            continue
        try:
            orig_type = type(params[key])
            if orig_type is bool:
                params[key] = value.lower() in {"true", "1", "yes"}
            else:
                params[key] = orig_type(value)
        except Exception as e:
            raise ValueError(f"Cannot convert '{value}' for '{key}': {e}")
    return params
