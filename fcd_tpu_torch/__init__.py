"""PyTorch/CUDA port of `fcd_tpu` for one NVIDIA H100.

Activations keep the JAX package's channels-last layout (B, D, H, W, C);
conv weights keep the flax (kd, kh, kw, Cin, Cout) layout. Every Pallas
kernel on the ported path has a hand-written Hopper kernel under
`kernels/` (CUDA C++ in `csrc/`, or Triton where stated), each beside a
plain PyTorch version that CPU tensors take.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Without a card and without an explicit CPU request this
    raises; it never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fcd_tpu_torch runs on a CUDA device; none is available. "
                "Pass device='cpu' to run the plain PyTorch path.")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
