"""The optimizer and the train step.

Counterpart of `fcd_tpu/train/state.py::make_optimizer` (:31), the
`make_train_step` body (:110-157) as the trainer calls it and
`group_norms` (:188): bf16 forward on the card (f32 master parameters),
the loss in f32, backward, AdamW with the learning rate set per call, and
the batch-norm running statistics, which the train-mode forward updates
in place (the JAX step returns them as its new `batch_stats`).

With `gradient_accumulation_steps` k > 1 the optimizer is `MultiSteps`,
the semantics of `optax.MultiSteps(inject_hyperparams(adamw),
every_k_schedule=k)`: each call adds the micro-step's gradient into their
running mean (optax's `acc + (g - acc) / (n + 1)`); the parameters and
AdamW's state stay as they are on k - 1 calls, and on the k-th AdamW
takes the mean and the mean is reset. The forward's batch-norm statistics
(and the trainer's step count) move on every call, as in the JAX step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fcd_tpu_torch.weights import model_entries


def make_optimizer(params_cfg: Dict[str, Any], model: torch.nn.Module):
    """AdamW over every parameter with optax `adamw`'s semantics: betas
    0.9 / 0.999, eps 1e-8 outside the square root, decoupled weight decay
    on every parameter (no mask). The learning rate is set per step. With
    gradient_accumulation_steps > 1, wrapped in `MultiSteps`. The betas
    are their f32 values, as `inject_hyperparams` holds them: AdamW's
    1 - beta2 from 0.999 itself would scale the second moment by 1.3e-5
    more than optax does."""
    b1, b2 = (float(np.float32(b)) for b in (0.9, 0.999))
    opt = torch.optim.AdamW(model.parameters(), lr=params_cfg["lr"],
                            betas=(b1, b2), eps=1e-8,
                            weight_decay=params_cfg.get("weight_decay", 1e-5))
    accum = params_cfg.get("gradient_accumulation_steps", 1)
    return MultiSteps(opt, accum) if accum > 1 else opt


class MultiSteps:
    """`optax.MultiSteps(inner, every_k_schedule=k)` around a torch
    optimizer (the module docstring). `mini_step` counts the calls since
    the last update (0..k-1), `gradient_step` the updates, `acc_grads`
    holds each parameter's running mean (zeros until a gradient comes)."""

    def __init__(self, inner: torch.optim.Optimizer, k: int):
        self.inner, self.k = inner, int(k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc_grads = {p: torch.zeros_like(p) for p in self.params()}

    @property
    def param_groups(self):
        return self.inner.param_groups

    def params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        emit = n == self.k - 1
        for p in self.params():
            acc = self.acc_grads[p]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc = acc + (g - acc) / (n + 1)
            if emit:
                p.grad = acc
                self.acc_grads[p] = torch.zeros_like(p)
            else:
                self.acc_grads[p] = acc
        if emit:
            self.inner.step()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.k


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def group_norms(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{top-level flax module name: the global L2 norm of its parameters'
    gradients} (the wandb.watch analogue), as 0-d f32 device tensors; a
    parameter without a gradient counts as zeros."""
    sums: Dict[str, torch.Tensor] = {}
    for coll, path, t, _ in model_entries(model):
        if coll != "params":
            continue
        s = (t.grad.float().square().sum() if t.grad is not None
             else t.new_zeros((), dtype=torch.float32))
        sums[path[0]] = sums[path[0]] + s if path[0] in sums else s
    return {k: v.sqrt() for k, v in sums.items()}


def param_group_norms(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{top-level flax module name: the global L2 norm of its parameters}
    (the `pnorm_*` columns of the epoch log), as 0-d f32 tensors."""
    sums: Dict[str, torch.Tensor] = {}
    for coll, path, t, _ in model_entries(model):
        if coll != "params":
            continue
        s = t.detach().float().square().sum()
        sums[path[0]] = sums[path[0]] + s if path[0] in sums else s
    return {k: v.sqrt() for k, v in sums.items()}


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                    grad_norms: bool = False) -> Callable:
    """step(image, label, lr, seed=None, thickness=None) -> loss (a 0-d
    device tensor; no host sync), or (loss, group_norms) with grad_norms.
    `seed` (an int) seeds the spatial-attention dropout hash of this
    step; the model's `dropout_rng.generator` draws the masks made in
    PyTorch. `thickness` (B, D, H, W, 1) feeds the cortical term."""

    def step(image: torch.Tensor, label: torch.Tensor, lr: float,
             seed: Optional[int] = None,
             thickness: Optional[torch.Tensor] = None):
        model.train()
        if seed is not None:
            model.dropout_rng.seed = int(seed)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(image), label, thickness)
        loss.backward()
        norms = group_norms(model) if grad_norms else None
        set_lr(optimizer, lr)
        optimizer.step()
        if grad_norms:
            return loss.detach(), norms
        return loss.detach()

    return step
