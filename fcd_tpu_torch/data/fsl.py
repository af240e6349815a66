"""FSL registration stage (optional, external binaries).

Counterpart of `fcd_tpu/data/fsl.py` (host code, copied): the same command
strings, the same idempotence, the same error where `flirt` is missing;
the template path comes from the port's `flags.py` (FCD_MNI152_PATH).

Same shell contract as the reference's preprocessing
(preprocess_data.py:10-184): per subject, `fslreorient2std` -> optional
`robustfov` -> `flirt` T1->MNI152 (dof 12, corratio) with `convert_xfm`
matrix composition, then resampling of T1 / thickness (nearest) / FLAIR
(via a dof-6 mutualinfo FLAIR->T1 registration) / GT (nearest) into MNI
space, producing `t1_reg/flair_reg/gt_reg/thickness_reg.nii.gz`.
Idempotent (skips completed subjects) and parallel over subjects. The
training pipeline consumes already-registered NIfTIs, so this stage is
out of the parity-critical compute path.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from fcd_tpu_torch import flags as _fcd_flags

MNI152_PATH = _fcd_flags.get("FCD_MNI152_PATH")

_SEARCH = "-searchrx -90 90 -searchry -90 90 -searchrz -90 90"


def fsl_available() -> bool:
    return shutil.which("flirt") is not None


def _run(cmd: str) -> int:
    print(cmd, flush=True)
    return subprocess.call(cmd, shell=True)


def preprocess_subject_fsl(
    t1_path: str,
    flair_path: str,
    gt_path: Optional[str],
    thickness_path: Optional[str],
    save_dir: str,
    apply_robust_fov: bool = True,
    delete_intermediate_files: bool = True,
    mni152_path: Optional[str] = None,
) -> None:
    """Register one subject to MNI152 1mm (preprocess_data.py:10-118 contract)."""
    mni = mni152_path or MNI152_PATH
    os.makedirs(save_dir, exist_ok=True)
    t1_reg = os.path.join(save_dir, "t1_reg.nii.gz")
    fl_reg = os.path.join(save_dir, "flair_reg.nii.gz")
    gt_reg = os.path.join(save_dir, "gt_reg.nii.gz") if gt_path and os.path.exists(gt_path) else None
    th_reg = (
        os.path.join(save_dir, "thickness_reg.nii.gz")
        if thickness_path and os.path.exists(thickness_path) else None
    )

    done = (
        os.path.exists(t1_reg)
        and os.path.exists(fl_reg)
        and (gt_reg is None or os.path.exists(gt_reg))
        and (th_reg is None or os.path.exists(th_reg))
    )
    if done:
        print(f"Preprocessing already done for {t1_path}, skipping...")
    else:
        t1_std = os.path.join(save_dir, "t1_std.nii.gz")
        ori2std = os.path.join(save_dir, "ori2std.mat")
        _run(f"fslreorient2std -m {ori2std} {t1_path} {t1_std}")

        ori2mni = os.path.join(save_dir, "ori2mni.mat")
        if apply_robust_fov:
            t1_fov = os.path.join(save_dir, "t1_fov.nii.gz")
            fov2std = os.path.join(save_dir, "fov2std.mat")
            _run(f"robustfov -i {t1_std} -r {t1_fov} -m {fov2std}")
            fov2mni = os.path.join(save_dir, "fov2mni.mat")
            _run(
                f"flirt -in {t1_fov} -ref {mni} -out {t1_reg} -omat {fov2mni} "
                f"-dof 12 -cost corratio -bins 256 -interp trilinear {_SEARCH}"
            )
            std2fov = os.path.join(save_dir, "std2fov.mat")
            _run(f"convert_xfm -omat {std2fov} -inverse {fov2std}")
            ori2fov = os.path.join(save_dir, "ori2fov.mat")
            _run(f"convert_xfm -omat {ori2fov} -concat {std2fov} {ori2std}")
            _run(f"convert_xfm -omat {ori2mni} -concat {fov2mni} {ori2fov}")
        else:
            std2mni = os.path.join(save_dir, "std2mni.mat")
            _run(
                f"flirt -in {t1_std} -ref {mni} -out {t1_reg} -omat {std2mni} "
                f"-dof 12 -cost corratio -bins 256 -interp trilinear {_SEARCH}"
            )
            _run(f"convert_xfm -omat {ori2mni} -concat {std2mni} {ori2std}")

        _run(f"flirt -in {t1_path} -ref {mni} -out {t1_reg} -init {ori2mni} "
             f"-interp trilinear -applyxfm")

        if th_reg:
            _run(f"flirt -in {thickness_path} -ref {t1_reg} -out {th_reg} "
                 f"-init {ori2mni} -interp nearestneighbour -applyxfm")

        # FLAIR -> T1 (dof 6, mutual info), then compose into MNI
        fl_reg0 = os.path.join(save_dir, "flair_reg0.nii.gz")
        fl2t1 = os.path.join(save_dir, "mat_fl2t1.mat")
        _run(
            f"flirt -in {flair_path} -ref {t1_path} -out {fl_reg0} -omat {fl2t1} "
            f"-dof 6 -cost mutualinfo -bins 256 -interp trilinear {_SEARCH}"
        )
        fl2mni = os.path.join(save_dir, "mat_fl2mni.mat")
        _run(f"convert_xfm -omat {fl2mni} -concat {ori2mni} {fl2t1}")
        _run(f"flirt -in {flair_path} -ref {t1_reg} -out {fl_reg} -init {fl2mni} "
             f"-interp trilinear -applyxfm")

        if gt_reg:
            _run(f"flirt -in {gt_path} -ref {t1_reg} -out {gt_reg} -init {fl2mni} "
                 f"-interp nearestneighbour -applyxfm")

    if delete_intermediate_files:
        keep = {t1_reg, fl_reg, gt_reg, th_reg}
        for name in os.listdir(save_dir):
            path = os.path.join(save_dir, name)
            if path not in keep and os.path.isfile(path):
                os.remove(path)
                print(f"Deleted: {path}")


def _discover_subjects(data_dir: str) -> List[Tuple]:
    tasks = []
    for sub in sorted(os.listdir(data_dir)):
        sub_dir = os.path.join(data_dir, sub)
        if not os.path.isdir(sub_dir):
            continue
        t1 = (glob.glob(os.path.join(sub_dir, "**/*T1w.nii.gz"), recursive=True)
              + glob.glob(os.path.join(sub_dir, "**/t1_reg.nii.gz"), recursive=True))
        fl = (glob.glob(os.path.join(sub_dir, "**/*FLAIR.nii.gz"), recursive=True)
              + glob.glob(os.path.join(sub_dir, "**/flair_reg.nii.gz"), recursive=True))
        gt = (glob.glob(os.path.join(sub_dir, "**/*FLAIR_roi.nii.gz"), recursive=True)
              + glob.glob(os.path.join(sub_dir, "**/gt_reg.nii.gz"), recursive=True))
        th = glob.glob(os.path.join(sub_dir, "**/thickness.nii.gz"), recursive=True)
        if not t1 or not fl:
            continue
        tasks.append((sub, t1[0], fl[0], gt[0] if gt else None, th[0] if th else None))
    return tasks


def preprocess_dataset_fsl(
    data_dir: str, save_dir: str, apply_robust_fov: bool = True,
    delete_intermediate_files: bool = True, num_workers: int = -1,
    mni152_path: Optional[str] = None,
) -> None:
    """Parallel subject registration (preprocess_data.py:120-143)."""
    os.makedirs(save_dir, exist_ok=True)
    tasks = _discover_subjects(data_dir)
    if num_workers == -1:
        num_workers = os.cpu_count() or 1
    num_workers = max(1, min(num_workers, len(tasks)))

    def work(task):
        sub, t1, fl, gt, th = task
        preprocess_subject_fsl(
            t1, fl, gt, th, os.path.join(save_dir, sub),
            apply_robust_fov=apply_robust_fov,
            delete_intermediate_files=delete_intermediate_files,
            mni152_path=mni152_path,
        )

    with ThreadPoolExecutor(num_workers) as pool:
        list(pool.map(work, tasks))


def preprocess_ideas_dataset_fsl(
    data_root: str, save_dir: str, apply_robust_fov: bool = True,
    delete_intermediate_files: bool = True, num_workers: int = -1,
    mni152_path: Optional[str] = None,
) -> None:
    """IDEAS dataset layout variant (preprocess_data.py:145-184): bids/ +
    masks/ directories with `<id>_MaskInRawData.nii.gz` labels."""
    bids_dir = os.path.join(data_root, "bids")
    masks_dir = os.path.join(data_root, "masks")
    if not os.path.isdir(bids_dir) or not os.path.isdir(masks_dir):
        raise ValueError(f"'bids' or 'masks' directory not found in {data_root}")

    tasks = []
    for sub in sorted(os.listdir(bids_dir)):
        if not sub.startswith("sub-"):
            continue
        sub_id = sub.replace("sub-", "")
        anat = os.path.join(bids_dir, sub, "anat")
        t1 = os.path.join(anat, f"sub-{sub_id}_T1w.nii.gz")
        fl = os.path.join(anat, f"sub-{sub_id}_FLAIR.nii.gz")
        mask = os.path.join(masks_dir, sub_id, f"{sub_id}_MaskInRawData.nii.gz")
        if not os.path.exists(t1) or not os.path.exists(fl):
            print(f"Skipping sub-{sub_id}: missing modality")
            continue
        tasks.append((sub, t1, fl, mask if os.path.exists(mask) else None, None))

    print(f"num valid subjects : {len(tasks)}")
    if num_workers == -1:
        num_workers = os.cpu_count() or 1
    num_workers = max(1, min(num_workers, len(tasks)))

    def work(task):
        sub, t1, fl, gt, th = task
        preprocess_subject_fsl(
            t1, fl, gt, th, os.path.join(save_dir, sub),
            apply_robust_fov=apply_robust_fov,
            delete_intermediate_files=delete_intermediate_files,
            mni152_path=mni152_path,
        )

    with ThreadPoolExecutor(num_workers) as pool:
        list(pool.map(work, tasks))
