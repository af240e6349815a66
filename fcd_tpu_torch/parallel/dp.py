"""Data-parallel training over a mesh of ranks.

Counterpart of `fcd_tpu/parallel/dp.py`. Under GSPMD the JAX step takes
the GLOBAL loss and the global batch-norm statistics of a batch sharded
over the mesh, so its data-parallel step computes the single-device step's
function (DP rel 0.0 in MULTICHIP_r05.json). A mean of per-rank losses
with per-rank statistics (plain DDP) is another function: the Dice losses
pool their sums over the batch. The port's step computes the JAX one:

- each rank runs the forward on its rows of the batch under `sharded`:
  batch norm adds its sums and counts over the ranks, dropout draws for
  the global batch and keeps the rank's rows, and the spatial-attention
  hash counts samples from the rank's offset;
- every rank assembles the global logits (`mesh.gather_batch`, exact) and
  applies the unchanged loss to them with the global labels, thickness map
  and sample mask; a VAE model's loss is the mean of the ranks' (equal
  batches);
- backward, then one all-reduce of the gradients flattened in parameter
  order (the same order every step, ROADMAP C9), and the same optimizer
  update on every rank, so the replicas stay bit-equal.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from fcd_tpu_torch.ops.layers import BatchNorm
from fcd_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    gather_batch,
    replicated,
)
from fcd_tpu_torch.train.state import MultiSteps, group_norms, set_lr


@contextlib.contextmanager
def sharded(model: torch.nn.Module, mesh: Mesh, local_batch: int):
    """For the block's duration `model` runs on this rank's `local_batch`
    rows of a global batch of mesh.size * local_batch: its batch norms
    take global statistics and its dropout the global batch's draws."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    rng = getattr(model, "dropout_rng", None)
    for m in norms:
        m.mesh = mesh
    if rng is not None:
        rng.shard = (mesh.rank * local_batch, mesh.size * local_batch)
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None
        if rng is not None:
            rng.shard = None


def all_reduce_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks: one all-reduce of
    the gradients flattened in parameter order. A parameter without a
    gradient (the same on every rank: one model, one branch) keeps none."""
    params = [p for p in model.parameters() if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(mesh, flat)
    at = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[at:at + n].view_as(p.grad))
        at += n


def replicate_state(model: torch.nn.Module, optimizer, mesh: Mesh) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank (the
    JAX `replicate_state`)."""
    for t in list(model.parameters()) + list(model.buffers()):
        replicated(mesh, t.data)
    if optimizer is None:
        return
    inner = getattr(optimizer, "inner", optimizer)
    for group in inner.param_groups:          # parameter order on every rank
        for p in group["params"]:
            if isinstance(optimizer, MultiSteps):
                replicated(mesh, optimizer.acc_grads[p])
            for v in inner.state.get(p, {}).values():
                if torch.is_tensor(v):
                    replicated(mesh, v)


def make_dp_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                       mesh: Mesh, *, model_returns_vaeloss: bool = False,
                       loss_vae_weight: float = 0.2, with_mask: bool = False,
                       grad_norms: bool = False,
                       grad_hook: Optional[Callable[[], None]] = None
                       ) -> Callable:
    """step(image_shard, label_shard, lr, seed=None, thickness=None,
    sample_mask=None) -> the global loss (a 0-d device tensor, the same on
    every rank), or (loss, group_norms) with grad_norms. The shards are
    this rank's rows of the global batch (`mesh.shard_batch`), equal on
    every rank. with_mask builds the ragged-batch variant: the global
    batch arrives padded to a multiple of the mesh with cyclic repeats,
    and `sample_mask` (this rank's rows of the (B,) 0/1 validity mask)
    leaves the padded samples out of the loss exactly. `grad_hook` runs
    after the gradients' all-reduce, before the update."""

    def step(image: torch.Tensor, label: torch.Tensor, lr: float,
             seed: Optional[int] = None,
             thickness: Optional[torch.Tensor] = None,
             sample_mask: Optional[torch.Tensor] = None):
        if with_mask != (sample_mask is not None):
            raise ValueError("the masked step takes a sample_mask and the "
                             "unmasked step none")
        model.train()
        if seed is not None:
            model.dropout_rng.seed = int(seed)
        optimizer.zero_grad(set_to_none=True)
        with sharded(model, mesh, image.shape[0]):
            out = model(image)
        vae = None
        if model_returns_vaeloss:
            out, vae = out
        logits = gather_batch(out, mesh)
        with torch.no_grad():
            target, thick, mask = (
                None if t is None else gather_batch(t, mesh)
                for t in (label, thickness, sample_mask))
        if mask is None:
            loss = loss_fn(logits, target, thick)
        else:
            loss = loss_fn(logits, target, thick, sample_mask=mask)
        if vae is not None:
            vae = gather_batch(vae.reshape(1), mesh).sum() / mesh.size
            loss = loss + loss_vae_weight * vae
        loss.backward()
        all_reduce_grads(model, mesh)
        if grad_hook is not None:
            grad_hook()
        norms = group_norms(model) if grad_norms else None
        set_lr(optimizer, lr)
        optimizer.step()
        if grad_norms:
            return loss.detach(), norms
        return loss.detach()

    return step
