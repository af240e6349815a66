"""The optimizer and the train step.

Counterpart of `fcd_tpu/train/state.py::make_optimizer` (:31) and the
`make_train_step` body (:110-157) as the trainer calls it: bf16 forward
on the card (f32 master parameters), the loss in f32, backward, AdamW
with the learning rate set per call, and the batch-norm running
statistics, which the train-mode forward updates in place (the JAX step
returns them as its new `batch_stats`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch


def make_optimizer(params_cfg: Dict[str, Any],
                   model: torch.nn.Module) -> torch.optim.Optimizer:
    """AdamW over every parameter with optax `adamw`'s semantics: betas
    0.9 / 0.999, eps 1e-8 outside the square root, decoupled weight decay
    on every parameter (no mask). The learning rate is set per step."""
    if params_cfg.get("gradient_accumulation_steps", 1) > 1:
        raise NotImplementedError(
            "gradient_accumulation_steps > 1 (optax.MultiSteps) is queued in "
            "ROADMAP.md")
    return torch.optim.AdamW(model.parameters(), lr=params_cfg["lr"],
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=params_cfg.get("weight_decay", 1e-5))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def make_train_step(model: torch.nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """step(image, label, lr, seed=None) -> loss (a 0-d device tensor; no
    host sync). `seed` (an int) seeds the spatial-attention dropout hash
    of this step; the model's `dropout_rng.generator` draws the masks
    made in PyTorch."""

    def step(image: torch.Tensor, label: torch.Tensor, lr: float,
             seed: Optional[int] = None) -> torch.Tensor:
        model.train()
        if seed is not None:
            model.dropout_rng.seed = int(seed)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(image), label)
        loss.backward()
        set_lr(optimizer, lr)
        optimizer.step()
        return loss.detach()

    return step
