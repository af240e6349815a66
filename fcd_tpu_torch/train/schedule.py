"""Learning-rate schedule: linear warmup then cosine annealing, stepped
per epoch. A copy of `fcd_tpu/train/schedule.py::epoch_lr` (torch
SequentialLR(LinearLR, CosineAnnealingLR) parity, reference
train.py:323-327)."""

from __future__ import annotations

import math
from typing import Any, Dict


def epoch_lr(params: Dict[str, Any], epoch: int) -> float:
    """LR at integer `epoch` (0-indexed):

    - epochs [0, warmup): LinearLR factor 0.1 -> 1.0 over warmup_epochs
    - epochs [warmup, max): cosine from base lr to min_lr over
      (max_epochs - warmup_epochs)
    """
    base = params["lr"]
    if params.get("adjust_lr_with_batch_size", False):
        base = base * params["batch_size"] * params["gradient_accumulation_steps"]
    warmup = params.get("warmup_epochs", 10)
    max_epochs = params.get("max_epochs", 300)
    min_lr = params.get("min_lr", 1e-6)

    if epoch < warmup:
        start_factor = 0.1
        factor = start_factor + (1.0 - start_factor) * epoch / warmup
        return base * factor
    t = epoch - warmup
    t_max = max(max_epochs - warmup, 1)
    return min_lr + (base - min_lr) * (1 + math.cos(math.pi * t / t_max)) / 2.0
