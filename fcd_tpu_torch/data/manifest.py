"""Dataset manifest: subject discovery and split files.

A copy of `fcd_tpu/data/manifest.py`, kept so that the port never imports
the JAX package.

Same on-disk contract as the reference (reference: get_data.py:5-115):
subject directories containing `<seq>.nii.gz` volumes plus a
`gt_reg.nii.gz` label, and split files with `<subject> <split>` lines.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional


def get_data(
    data_dir: str,
    params: Dict[str, Any],
    subjects_list: Optional[List[str]] = None,
) -> List[Dict[str, Any]]:
    """Build the list of {image: [paths], label: path, subject: name} entries.

    Resolves multi-sequence inputs from ``params['seq']`` (e.g.
    't1_reg+flair_reg'), optionally a thickness map, and requires
    `gt_reg.nii.gz` next to the reference sequence.
    """
    seq_files = params["seq"].split("+")
    ref_seq = seq_files[0]
    data_dict: List[Dict[str, Any]] = []

    if subjects_list is None:
        subjects_list = sorted(
            d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d))
        )

    for subj in subjects_list:
        subj_dir = os.path.join(data_dir, subj)
        if not os.path.isdir(subj_dir):
            print(f"Warning: subject directory {subj_dir} not found, skipping.")
            continue

        ref_matches = glob.glob(
            os.path.join(subj_dir, f"**/{ref_seq}.nii.gz"), recursive=True
        )
        if not ref_matches:
            print(f"Warning: {ref_seq}.nii.gz not found for {subj}, skipping.")
            continue

        seq_dir = os.path.dirname(ref_matches[0])
        entry: Dict[str, Any] = {"image": [], "subject": subj}
        valid = True

        for seq in seq_files:
            seq_path = os.path.join(seq_dir, f"{seq}.nii.gz")
            if os.path.exists(seq_path):
                entry["image"].append(seq_path)
            else:
                print(f"Warning: {seq_path} not found, skipping {subj}.")
                valid = False
                break
        if not valid:
            continue

        if params.get("thickness", False):
            thickness_filename = params.get("thickness_filename", "thickness")
            thickness = os.path.join(seq_dir, f"{thickness_filename}.nii.gz")
            if os.path.exists(thickness):
                entry["image"].append(thickness)

        label_f = os.path.join(seq_dir, "gt_reg.nii.gz")
        if os.path.exists(label_f):
            entry["label"] = label_f
            data_dict.append(entry)
        else:
            print(f"Warning: gt_reg.nii.gz not found for {subj}, skipping.")

    return data_dict


def read_split_file(list_file: str) -> Dict[str, List[str]]:
    """Parse `<subject> <split>` lines into {split: [subjects]} (lowercased splits)."""
    split_dict: Dict[str, List[str]] = {}
    with open(list_file, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 2:
                continue
            subj, split = parts
            split_dict.setdefault(split.lower(), []).append(subj)
    return split_dict


def get_split_data(
    data_dir: str, list_file: str, split_name: str, params: Dict[str, Any]
) -> List[Dict[str, Any]]:
    """Manifest for a single split from a split file."""
    split_dict = read_split_file(list_file)
    subjects = split_dict.get(split_name.lower(), [])
    if not subjects:
        print(f"Warning: no subjects found for split '{split_name}' in {list_file}")
    return get_data(data_dir, params, subjects_list=subjects)
