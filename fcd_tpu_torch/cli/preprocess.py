"""FSL preprocessing CLI (preprocess_data.py:187-217 contract).

Counterpart of `fcd_tpu/cli/preprocess.py` (host code, copied).

Run: python -m fcd_tpu_torch.cli.preprocess -d <raw> -s <out> [-t template]
[--ideas] [--no_robust_fov] [-k]
"""

from __future__ import annotations

import argparse

from fcd_tpu_torch.data.fsl import (
    fsl_available,
    preprocess_dataset_fsl,
    preprocess_ideas_dataset_fsl,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Preprocess MRI dataset using FSL.")
    parser.add_argument("--data_dir", "-d", type=str, required=True)
    parser.add_argument("--save_dir", "-s", type=str, required=True)
    parser.add_argument("--template_path", "-t", type=str,
                        default="./MNI152_T1_1mm.nii.gz")
    parser.add_argument("--keep_intermediate", "-k", action="store_true")
    parser.add_argument("--num_workers", type=int, default=-1)
    parser.add_argument("--no_robust_fov", action="store_true")
    parser.add_argument("--ideas", action="store_true")
    args = parser.parse_args(argv)

    if not fsl_available():
        raise RuntimeError(
            "FSL binaries (flirt/fslreorient2std) not found on PATH. "
            "This stage requires an FSL installation; training consumes "
            "already-registered NIfTIs and does not need it."
        )

    fn = preprocess_ideas_dataset_fsl if args.ideas else preprocess_dataset_fsl
    fn(
        args.data_dir, args.save_dir,
        apply_robust_fov=not args.no_robust_fov,
        delete_intermediate_files=not args.keep_intermediate,
        num_workers=args.num_workers,
        mni152_path=args.template_path,
    )


if __name__ == "__main__":
    main()
