"""Tensor parallelism (channel shards) over a ("data", "model") mesh.

Counterpart of `fcd_tpu/parallel/tp.py`. The JAX package annotates the
parameters with a Megatron pairing and lets GSPMD place the activations and
insert the collectives; the port stores each rank's shards and runs the
collectives itself, with the same pairing (`tp_spec_for`, a copy of the
JAX rule, applied to each parameter's flax path from `weights.py`'s
tables, so both packages shard the same leaves):

- a res block's conv1 and its 1x1 shortcut, the patch embeds, the up-
  blocks' transposed convs: column-parallel (output channels sharded);
- a res block's conv2, a transformer's conv1, its out-projection
  (`Conv3d_0`) and `qkvv`: row-parallel (input channels sharded);
- everything 1-D, and any leaf whose axis does not divide: replicated.

What runs where (`ops/blocks.py`, `ops/attention.py`, `ops/layers.py`,
`models/ms_dsa_net.py`, under `model_parallel`): a replicated value is
whole on every rank of the model axis and every rank applies the same
function to it. A column-parallel op reads it whole and writes its channel
shard; a row-parallel op reads a channel shard (its producer's, or a slice
of a replicated value) and writes an f32 partial sum, all-reduced into the
whole (for the 3x3x3 conv: B1's partial instance, the all-reduce, the
finishing pass, `ops/blocks.py::conv3x3_row_op`). A shard whose
consumer is replicated (the shortcut, the up-sample, the embeds) is
all-gathered. The collectives are the autograd functions of
`parallel/mesh.py`, so every replicated value's cotangent is whole on every
rank and a parameter's gradient is its shard's (a replicated parameter's
the same on every rank, never summed over the model axis). At eval a
row-sharded weight that a kernel reads whole (B5's `qkvv`) is gathered
once a forward.

The data axis runs as it runs alone: `make_tp_train_step` is
`dp.make_dp_train_step` on the mesh's data view under `model_parallel`, its
gradient all-reduce summing each shard over the ranks that hold it.
AdamW is elementwise, so a rank's sharded state is the shard of the full
state: `shard_state_tp` slices the parameters and the optimizer's moments
in place, `gather_tp_state` puts the full tree back (for checkpoints and
tests), and `load_flax_variables` then `shard_state_tp` gives a rank its
state from the JAX package's.

MS_DSA_NET and BaseUNet only (the models whose every sharded leaf sits in
a block that splits it), on the kernel route: another model, or one on the
plain route (f32 or f16 on the card), raises.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from fcd_tpu_torch.parallel.dp import make_dp_train_step
from fcd_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    _gather_last,
    channel_slice,
    gather_channels,
    make_mesh,
    shard_batch,
)
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET, BaseUNet
from fcd_tpu_torch.weights import model_entries

Spec = Tuple[Optional[str], ...]   # a PartitionSpec: () is replicated


def make_tp_mesh(n_data: int, n_model: int, device=None) -> Mesh:
    """The ("data", "model") mesh of n_data x n_model ranks (the running
    group's size must be their product): this rank's view."""
    return make_mesh(n_data * n_model, axes=("data", MODEL_AXIS),
                     device=device, shape=(n_data, n_model))


def tp_spec_for(path_names: Sequence[str], shape: Sequence[int],
                n_model: int) -> Spec:
    """The spec of one parameter leaf by its flax path and shape
    (`fcd_tpu/parallel/tp.py::tp_spec_for`, the same rule): replicated
    whenever the preferred axis does not divide over the model axis."""
    shape = tuple(shape)
    if len(shape) < 2 or n_model <= 1:
        return ()
    name = path_names[-1]
    parent = path_names[-2] if len(path_names) >= 2 else ""
    cin, cout = shape[-2], shape[-1]

    def col():
        if cout % n_model == 0 and cout >= 2 * n_model:
            return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
        return ()

    def row():
        if cin % n_model == 0 and cin >= 2 * n_model:
            return (None,) * (len(shape) - 2) + (MODEL_AXIS, None)
        return ()

    if name == "qkvv":
        return row()
    if name != "kernel":
        return ()
    in_transformer = any(p.startswith("TransformerBlock") for p in path_names)
    if parent == "Conv3d_1":
        return row()
    if parent == "Conv3d_0" and in_transformer:
        return row()
    return col()


def _flax_shape(t: torch.Tensor, is_1x1: bool) -> Tuple[int, ...]:
    return ((1, 1, 1) if is_1x1 else ()) + tuple(t.shape)


def tp_tree_shardings(model: torch.nn.Module, n_model: int
                      ) -> Dict[Tuple[str, ...], Spec]:
    """{flax path: spec} of every parameter of an unsharded `model` over a
    model axis of n_model ranks (the JAX function's tree of
    NamedShardings, by path)."""
    return {path: tp_spec_for(path, _flax_shape(t, one), n_model)
            for coll, path, t, one in model_entries(model)
            if coll == "params"}


@dataclass
class TPLayout:
    """How a model's parameters lie on the model axis: each sharded
    parameter's role ("col" or "row") and axis of the port tensor."""

    mesh: Mesh                                   # the model axis
    roles: Dict[int, str] = field(default_factory=dict)
    dims: Dict[int, int] = field(default_factory=dict)
    params: list = field(default_factory=list)

    def role(self, t: Optional[torch.Tensor]) -> Optional[str]:
        return None if t is None else self.roles.get(id(t))

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """Sharded parameter t gathered whole (its gradient back to the
        shard), for a kernel that reads it whole; replicated t as it is."""
        if self.role(t) is None:
            return t
        dim = self.dims[id(t)]
        return gather_channels(t.movedim(dim, -1), self.mesh) \
            .movedim(-1, dim).contiguous()


def _optimizer_tensors(optimizer, p: torch.Tensor):
    """(holder, key) of each optimizer tensor shaped like parameter p:
    AdamW's moments and MultiSteps' running gradient."""
    if optimizer is None:
        return []
    inner = getattr(optimizer, "inner", optimizer)
    out = [(st, k) for st in [inner.state.get(p, {})]
           for k, v in st.items()
           if torch.is_tensor(v) and v.shape == p.shape]
    acc = getattr(optimizer, "acc_grads", None)
    if acc is not None:
        out.append((acc, p))
    return out


@torch.no_grad()
def shard_state_tp(model: torch.nn.Module, mesh: Mesh,
                   optimizer=None) -> TPLayout:
    """Slice `model`'s parameters, their gradients and (with an optimizer)
    its tensors of each parameter in place into this rank's shards over
    `mesh.model`, and record the layout on the model (`model.tp_layout`)."""
    if getattr(model, "tp_layout", None) is not None:
        raise RuntimeError("the model is sharded already")
    if mesh.model is None:
        raise ValueError("tensor parallelism needs a ('data', 'model') mesh")
    if not isinstance(model, (MS_DSA_NET, BaseUNet)) or getattr(
            model, "upsample_mode", None) is not None:
        raise NotImplementedError(
            f"tensor parallelism runs MS_DSA_NET and BaseUNet (the blocks "
            f"that split their convs), not {type(model).__name__}")
    mm = mesh.model
    layout = TPLayout(mm)
    for coll, path, t, one in model_entries(model):
        if coll != "params":
            continue
        spec = tp_spec_for(path, _flax_shape(t, one), mm.size)
        if MODEL_AXIS not in spec:
            continue
        at = spec.index(MODEL_AXIS)
        dim = at - 3 if one else at
        rows = channel_slice(mm, t.shape[dim])

        def cut(v):
            return v.narrow(dim, rows.start, rows.stop - rows.start) \
                .contiguous().clone()

        for holder, key in _optimizer_tensors(optimizer, t):
            holder[key] = cut(holder[key])
        grad, t.grad = t.grad, None
        t.data = cut(t.data)
        if grad is not None:
            t.grad = cut(grad)
        layout.roles[id(t)] = "col" if at == len(spec) - 1 else "row"
        layout.dims[id(t)] = dim
        layout.params.append(t)
    model.tp_layout = layout
    return layout


# the JAX API's name for an inference model's variables (no optimizer)
shard_variables_tp = shard_state_tp


def _gather_dim(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return _gather_last(t.movedim(dim, -1).contiguous(), mesh) \
        .movedim(-1, dim).contiguous()


@torch.no_grad()
def gather_tp_state(model: torch.nn.Module, optimizer=None) -> None:
    """The inverse of `shard_state_tp`: every rank's parameters, their
    gradients and the optimizer's tensors whole again, the layout
    removed."""
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        raise RuntimeError("the model is not sharded")
    for t in layout.params:
        dim = layout.dims[id(t)]
        for holder, key in _optimizer_tensors(optimizer, t):
            holder[key] = _gather_dim(holder[key], dim, layout.mesh)
        grad, t.grad = t.grad, None
        t.data = _gather_dim(t.data, dim, layout.mesh)
        if grad is not None:
            t.grad = _gather_dim(grad, dim, layout.mesh)
    del model.tp_layout


@contextlib.contextmanager
def model_parallel(model: torch.nn.Module):
    """For the block's duration a sharded `model` runs its forwards (and
    the backwards of them) with the model axis's collectives: each of its
    modules sees the layout as `tp`."""
    layout = getattr(model, "tp_layout", None)
    if layout is None:
        raise RuntimeError("model_parallel needs a model sharded by "
                           "shard_state_tp")
    mods = list(model.modules())
    for m in mods:
        if getattr(m, "plain_route", False):
            raise NotImplementedError(
                "tensor parallelism runs the kernel route; a model on the "
                "plain route (f32 or f16 on the card) has none")
        m.tp = layout
    try:
        yield layout
    finally:
        for m in mods:
            m.__dict__.pop("tp", None)


def make_tp_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                       mesh: Mesh, **kw: Any) -> Callable:
    """step(image_shard, label_shard, lr, seed=None, ...) -> the global
    loss: `dp.make_dp_train_step` over the mesh's data axis (the image and
    label are this rank's rows, `mesh.shard_batch`) with the model's
    shards under `model_parallel`. The state must be sharded first
    (`shard_state_tp`)."""
    step = make_dp_train_step(model, loss_fn, optimizer, mesh, **kw)

    def tp_step(*args, **kwargs):
        with model_parallel(model):
            return step(*args, **kwargs)

    return tp_step


# the JAX API's name: this rank's rows of a global batch, the leading axis
# over "data", the rest whole on every rank of the model axis
shard_batch_tp = shard_batch
