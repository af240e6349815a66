"""NIfTI inspection CLI: header/affine/stats + optional mid-slice plot.

Counterpart of `fcd_tpu/cli/inspect.py` on the port's `data/nifti.py`;
matplotlib stays a lazy import (only `--plot` needs it).

Replaces the reference's ad-hoc inspection scratchpad (test.py:9-149) with
a proper tool: `python -m fcd_tpu_torch.cli.inspect <file.nii.gz> [--plot out.png]`.
"""

from __future__ import annotations

import argparse

import numpy as np

from fcd_tpu_torch.data import nifti


def inspect_nifti(path: str, plot: str | None = None) -> dict:
    img = nifti.load(path)
    data = img.data
    info = {
        "path": path,
        "shape": tuple(data.shape),
        "dtype_code": img.header.get("datatype"),
        "spacing_mm": tuple(round(s, 4) for s in img.spacing),
        "min": float(np.nanmin(data)),
        "max": float(np.nanmax(data)),
        "mean": float(np.nanmean(data)),
        "std": float(np.nanstd(data)),
        "nonzero_voxels": int((data != 0).sum()),
        "nan_voxels": int(np.isnan(data).sum()),
    }
    print("Affine Matrix:\n", np.array_str(img.affine, precision=4, suppress_small=True))
    for k, v in info.items():
        print(f"{k}: {v}")

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sx = data[data.shape[0] // 2, :, :]
        sy = data[:, data.shape[1] // 2, :]
        sz = data[:, :, data.shape[2] // 2]
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, sl, title in zip(
            axes, (sz, sy, sx),
            ("Axial View (Top-Down)", "Coronal View (Front)", "Sagittal View (Side)"),
        ):
            ax.imshow(np.asarray(sl).T, cmap="gray", origin="lower")
            ax.set_title(title)
            ax.axis("off")
        fig.savefig(plot, bbox_inches="tight", dpi=100)
        print(f"slices saved to {plot}")
    return info


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inspect a NIfTI volume.")
    parser.add_argument("file", type=str)
    parser.add_argument("--plot", type=str, default=None,
                        help="Save mid-slice views to this PNG")
    args = parser.parse_args(argv)
    inspect_nifti(args.file, args.plot)


if __name__ == "__main__":
    main()
