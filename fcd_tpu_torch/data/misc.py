"""Small dataset housekeeping utilities.

Counterpart of `fcd_tpu/data/misc.py` (host code, copied).

Parity targets: copy_thicknessmaps.py:6-33 (thickness-map copier into
BIDS anat folders) and delete_folders.py:5-28 (bulk delete of listed
subject folders).
"""

from __future__ import annotations

import os
import shutil
from glob import glob
from typing import List


def copy_thickness_maps(source_root: str, destination_root: str) -> List[str]:
    """Copy `<subject>/thickness.nii.gz` into `<dest>/<subject>/anat/`."""
    copied = []
    for src_path in sorted(glob(os.path.join(source_root, "*", "thickness.nii.gz"))):
        subject_id = os.path.basename(os.path.dirname(src_path))
        dest_dir = os.path.join(destination_root, subject_id, "anat")
        dest_path = os.path.join(dest_dir, "thickness.nii.gz")
        os.makedirs(dest_dir, exist_ok=True)
        shutil.copy2(src_path, dest_path)
        copied.append(dest_path)
        print(f"Copied: {src_path} -> {dest_path}")
    return copied


def delete_folders(parent_dir: str, names_file: str) -> int:
    """Delete the subfolders of parent_dir listed (one per line) in names_file."""
    with open(names_file) as f:
        folder_names = [line.strip() for line in f if line.strip()]
    deleted = 0
    for name in folder_names:
        path = os.path.join(parent_dir, name)
        if os.path.isdir(path):
            try:
                shutil.rmtree(path)
                deleted += 1
                print(f"Deleted: {path}")
            except OSError as e:
                print(f"Error deleting {path}: {e}")
        else:
            print(f"Folder not found: {path}")
    return deleted
