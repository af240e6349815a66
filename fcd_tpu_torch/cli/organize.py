"""Dataset split management CLI (organize_data.py:172-258 contract).

Counterpart of `fcd_tpu/cli/organize.py` (host code, copied).

Run: python -m fcd_tpu_torch.cli.organize --data_dir ... [--organize|--deorganize|
--kfold K --output_dir ...|--save_split_only --assignments_file ...]
"""

from __future__ import annotations

import argparse
import os

from fcd_tpu_torch.data.organize import (
    deorganize_data,
    organize_data_splits,
    save_kfold_splits,
    save_split_assignments,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Manage dataset splits for FCD detection.")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--train_ratio", type=float, default=0.7)
    parser.add_argument("--val_ratio", type=float, default=0.1)
    parser.add_argument("--test_ratio", type=float, default=0.2)
    parser.add_argument("--assignments_file", type=str)
    parser.add_argument("--output_dir", type=str)
    parser.add_argument("--deorganize", action="store_true")
    parser.add_argument("--organize", action="store_true")
    parser.add_argument("--kfold", type=int)
    parser.add_argument("--save_split_only", action="store_true")
    args = parser.parse_args(argv)

    if args.deorganize and not (args.organize or args.kfold or args.save_split_only):
        deorganize_data(args.data_dir)
        print("Data deorganized.")
        return

    if args.save_split_only:
        if not args.assignments_file:
            raise ValueError("Specify --assignments_file to save split assignments.")
        split_dict = {}
        for split in ["train", "val", "test", "unlabeled"]:
            split_dir = os.path.join(args.data_dir, split)
            split_dict[split] = (
                sorted(d for d in os.listdir(split_dir)
                       if os.path.isdir(os.path.join(split_dir, d)))
                if os.path.exists(split_dir) else []
            )
        save_split_assignments(split_dict, args.assignments_file)
        print(f"Current split assignment saved to: {args.assignments_file}")
        return

    if args.kfold:
        if not args.output_dir:
            raise ValueError("Specify --output_dir to save k-fold split files")
        save_kfold_splits(args.data_dir, args.output_dir, k=args.kfold,
                          val_fraction=args.val_ratio, seed=args.seed)
        return

    if args.deorganize or args.organize:
        if args.deorganize:
            deorganize_data(args.data_dir)
            print("Data deorganized.")
        organize_data_splits(
            args.data_dir, train_ratio=args.train_ratio, val_ratio=args.val_ratio,
            test_ratio=args.test_ratio, seed=args.seed,
            assignments_file=args.assignments_file,
        )
        print("Data organized according to specified ratios.")
        return

    print("No action specified. Use --help to see available options.")


if __name__ == "__main__":
    main()
