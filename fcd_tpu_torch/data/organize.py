"""Dataset organization utilities: split directories, assignment files,
k-fold split generation.

Counterpart of `fcd_tpu/data/organize.py`, a copy on the port's own
`data/nifti.py`: the same seed gives the same splits and files.

Parity target: organize_data.py:8-169 — move subjects into
train/val/test/unlabeled directories (labeled = nonzero gt_reg),
save/load `<subject> <split>` assignment files, and generate k-fold
split files (10% of train as val per fold).
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Dict, List

import numpy as np

from fcd_tpu_torch.data import nifti

SPLITS = ["train", "val", "test", "unlabeled"]


def deorganize_data(data_dir: str) -> None:
    """Move subjects out of split directories back to the root."""
    for split in SPLITS:
        split_dir = os.path.join(data_dir, split)
        if not os.path.exists(split_dir):
            continue
        for name in os.listdir(split_dir):
            src = os.path.join(split_dir, name)
            if os.path.isdir(src):
                shutil.move(src, os.path.join(data_dir, name))


def save_split_assignments(split_dict: Dict[str, List[str]], output_file: str) -> None:
    with open(output_file, "w") as f:
        for split, subjects in split_dict.items():
            for subj in sorted(subjects):
                f.write(f"{subj} {split}\n")


def load_split_assignments(assignments_file: str) -> Dict[str, List[str]]:
    if not os.path.exists(assignments_file):
        raise FileNotFoundError(f"Split assignment file not found: {assignments_file}")
    split_dict: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    with open(assignments_file) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2 and parts[1] in split_dict:
                split_dict[parts[1]].append(parts[0])
    return split_dict


def organize_data_splits(
    data_dir: str,
    train_ratio: float = 0.7,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    seed: int = 42,
    assignments_file: str | None = None,
) -> Dict:
    """Partition subjects into split directories. Subjects without a
    (non-empty) gt_reg go to 'unlabeled'."""
    rng = random.Random(seed)
    split_dirs = {s: os.path.join(data_dir, s) for s in SPLITS}
    for d in split_dirs.values():
        os.makedirs(d, exist_ok=True)

    all_subjects = [
        d for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d)) and d not in SPLITS
    ]

    labeled, unlabeled = [], []
    for subject in all_subjects:
        label_file = os.path.join(data_dir, subject, "gt_reg.nii.gz")
        if os.path.exists(label_file):
            data = nifti.load(label_file).data
            (labeled if data.sum() > 0 else unlabeled).append(subject)
        else:
            unlabeled.append(subject)
    labeled, unlabeled = sorted(labeled), sorted(unlabeled)

    if assignments_file:
        loaded = load_split_assignments(assignments_file)
        train = [s for s in loaded.get("train", []) if s in labeled]
        val = [s for s in loaded.get("val", []) if s in labeled]
        test = [s for s in loaded.get("test", []) if s in labeled]
    else:
        rng.shuffle(labeled)
        n = len(labeled)
        n_train = int(n * train_ratio)
        n_val = int(n * val_ratio)
        train = labeled[:n_train]
        val = labeled[n_train : n_train + n_val]
        test = labeled[n_train + n_val :]

    def move(subjects, target):
        for s in subjects:
            src = os.path.join(data_dir, s)
            dst = os.path.join(target, s)
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.move(src, dst)

    move(train, split_dirs["train"])
    move(val, split_dirs["val"])
    move(test, split_dirs["test"])
    move(unlabeled, split_dirs["unlabeled"])

    split_dict = {"train": train, "val": val, "test": test, "unlabeled": unlabeled}
    assignment_path = os.path.join(data_dir, "split_assignments.txt")
    save_split_assignments(split_dict, assignment_path)

    summary = {
        "total_subjects": len(all_subjects),
        "labeled_subjects": len(labeled),
        "unlabeled_subjects": len(unlabeled),
        "train_subjects": len(train),
        "val_subjects": len(val),
        "test_subjects": len(test),
        "directories": split_dirs,
    }
    print("\nData Organization Summary:")
    for k, v in summary.items():
        print(f"{k}: {v}")
    print(f"\nSplit assignments saved to: {assignment_path}")
    return summary


def get_all_subjects(data_dir: str) -> List[str]:
    return sorted(
        d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d))
    )


def create_kfold_splits(
    data_dir: str, k: int = 5, val_fraction: float = 0.1, random_seed: int = 42
) -> List[Dict[str, List[str]]]:
    """k-fold train/val/test splits; val_fraction of each fold's train part
    becomes validation (organize_data.py:131-169, sklearn-KFold semantics)."""
    subjects = get_all_subjects(data_dir)
    n = len(subjects)
    rng = np.random.RandomState(random_seed)
    indices = rng.permutation(n)

    # sklearn KFold fold sizes: n % k folds of size n//k + 1, rest n//k
    fold_sizes = np.full(k, n // k, dtype=int)
    fold_sizes[: n % k] += 1

    splits = []
    start = 0
    for fs in fold_sizes:
        test_idx = indices[start : start + fs]
        train_idx = np.concatenate([indices[:start], indices[start + fs :]])
        start += fs
        train_subjects = [subjects[i] for i in sorted(train_idx)]
        test_subjects = [subjects[i] for i in sorted(test_idx)]
        n_val = max(1, int(len(train_subjects) * val_fraction))
        val_rng = random.Random(random_seed)
        val_subjects = val_rng.sample(train_subjects, n_val)
        train_final = [s for s in train_subjects if s not in val_subjects]
        splits.append({"train": train_final, "val": val_subjects, "test": test_subjects})
    return splits


def save_kfold_splits(data_dir: str, output_dir: str, k: int = 5,
                      val_fraction: float = 0.1, seed: int = 42) -> List[str]:
    splits = create_kfold_splits(data_dir, k=k, val_fraction=val_fraction,
                                 random_seed=seed)
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, split in enumerate(splits):
        path = os.path.join(output_dir, f"split{i + 1}.txt")
        save_split_assignments(split, path)
        paths.append(path)
        print(f"Saved fold {i + 1} assignments to: {path}")
    return paths
