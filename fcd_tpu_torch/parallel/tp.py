"""Tensor parallelism (channel shards) over a ("data", "model") mesh.

Counterpart of `fcd_tpu/parallel/tp.py`. The JAX package annotates the
parameters with a Megatron pairing and lets GSPMD place the activations and
insert the collectives; the port stores each rank's shards and runs the
collectives itself, with the same pairing (`tp_spec_for`, a copy of the
JAX rule, applied to each parameter's flax path from `weights.py`'s
tables, so both packages shard the same leaves):

- every `Conv3d_1` kernel (a res block's conv2, a SegResNet ResBlock's
  conv2, a UNet unit's second conv, UNETR++'s second down conv, the
  UNETR and SwinUNETR heads), and in a path that starts with
  TransformerBlock (MS_DSA_NET's) `Conv3d_0` (the out-projection and the
  conv block's conv1), and `qkvv`: row-parallel (input channels sharded);
- every other kernel (conv1s, shortcuts, embeds, strided and transposed
  convs, Dense layers): column-parallel (output channels sharded);
- everything 1-D, every leaf not named `kernel` or `qkvv` (pos-embeds,
  EF, relative position biases), and any leaf whose axis does not divide
  or is under twice the model axis: replicated.

The same module takes different roles in different models
(`TransformerBlock.conv8` is row-parallel in MS_DSA_NET and
column-parallel in SegResNet_DSA and UNETR++), so each split follows its
parameter's role, not a table of blocks: a module that may hold a sharded
parameter names it and the roles it runs in `tp_splits`, and
`shard_state_tp` raises, naming the module and the flax path, for a
sharded leaf that no module splits in its role.

What runs where (under `model_parallel`): a replicated value is whole on
every rank of the model axis and every rank applies the same function to
it. The general layers (`ops/layers.py::split_op`: `Conv3d`,
`ConvTranspose3d`, `Dense`, `UpSample`, `conv1x1`) hand on whole outputs:
column-parallel on the whole input, then gathered; row-parallel on the
input's channel slice, an f32 partial sum all-reduced into the whole and
rounded once. The res blocks keep the shard between a column-parallel
conv1 and a row-parallel conv2 where the norm between them is per
channel (`ops/blocks.py`, `models/segresnet.py`): for the 3x3x3 conv,
B1's partial instance, the all-reduce, the finishing pass
(`ops/blocks.py::conv3x3_row_op`); on the plain route `conv3d` on f32
operands, the all-reduce, one rounding (`conv3x3_row_plain`). A
column-parallel op's input gradient (the dual of a row-parallel forward)
is taken in f32 on both routes, summed and then rounded once
(`mesh.column_parallel`; B1 and B4 with `grad_sum=`, ROADMAP C23): one
device rounds each op's f32 accumulation, then adds the branches in the
compute type. The collectives are the autograd functions of `parallel/mesh.py`,
so every replicated value's cotangent is whole on every rank and a
parameter's gradient is its shard's (a replicated parameter's the same on
every rank, never summed over the model axis). At eval a row-sharded
weight that a kernel reads whole (B5's `qkvv`) is gathered once a
forward.

The data axis runs as it runs alone: `make_tp_train_step` is
`dp.make_dp_train_step` on the mesh's data view under `model_parallel`, its
gradient all-reduce summing each shard over the ranks that hold it. A
replicated parameter's gradient is the same function on every rank of the
model axis, but a library kernel that sums in a varying order can give it
other last bits on each rank (UNet at f32 on an H100: its ranks' logits
and states differed); the step takes its mean over the model axis (the
same bits on every rank, and the gradient itself where the ranks agree),
so the replicas stay bit-equal.
AdamW is elementwise, so a rank's sharded state is the shard of the full
state: `shard_state_tp` slices the parameters and the optimizer's moments
in place, `gather_tp_state` puts the full tree back (for checkpoints and
tests), and `load_flax_variables` then `shard_state_tp` gives a rank its
state from the JAX package's.

Every model type of the factory, on either route: the kernel route (bf16
on the card) and the plain route (f32 or f16 on the card, f32 in the
tests, the JAX package's TP test's `use_amp=False`).
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
    all_reduce_,
    channel_slice,
    gather_channels,
    make_mesh,
    shard_batch,
)
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


def _owners(model: torch.nn.Module) -> Dict[int, Tuple[str, Any, str]]:
    """{id(parameter): (module name, module, attribute)} of every parameter
    a module of `model` holds itself."""
    return {id(p): (name, m, attr) for name, m in model.named_modules()
            for attr, p in m._parameters.items() if p is not None}


def _check_split(owner, path, role: str) -> None:
    """Raise unless the module that holds a sharded leaf splits it in its
    role (`tp_splits`): no model runs a wrong function silently."""
    name, m, attr = owner
    if role not in getattr(type(m), "tp_splits", {}).get(attr, ()):
        raise NotImplementedError(
            f"{type(m).__name__} {name or '(the model)'!r} does not split "
            f"{attr!r} {role}-parallel, and the rule shards it (flax path "
            f"{'/'.join(path)})")


@torch.no_grad()
def shard_state_tp(model: torch.nn.Module, mesh: Mesh,
                   optimizer=None) -> TPLayout:
    """Slice `model`'s parameters, their gradients and (with an optimizer)
    its tensors of each parameter in place into this rank's shards over
    `mesh.model`, and record the layout on the model (`model.tp_layout`).
    Raises, before slicing anything, when a sharded leaf's module does not
    split it (`tp_splits`)."""
    if getattr(model, "tp_layout", None) is not None:
        raise RuntimeError("the model is sharded already")
    if mesh.model is None:
        raise ValueError("tensor parallelism needs a ('data', 'model') mesh")
    mm = mesh.model
    owners = _owners(model)
    plan = []
    for coll, path, t, one in model_entries(model):
        if coll != "params":
            continue
        spec = tp_spec_for(path, _flax_shape(t, one), mm.size)
        if MODEL_AXIS not in spec:
            continue
        at = spec.index(MODEL_AXIS)
        role = "col" if at == len(spec) - 1 else "row"
        _check_split(owners[id(t)], path, role)
        plan.append((t, at - 3 if one else at, role))
    layout = TPLayout(mm)
    for t, dim, role in plan:
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
        layout.roles[id(t)] = role
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
    shards under `model_parallel`, and the replicated parameters'
    gradients averaged over the model axis (the module docstring). The
    state must be sharded first (`shard_state_tp`)."""

    def even_replicas():
        layout = model.tp_layout
        grads = [p.grad for p in model.parameters()
                 if p.grad is not None and layout.role(p) is None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(layout.mesh, flat).div_(layout.mesh.size)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    step = make_dp_train_step(model, loss_fn, optimizer, mesh,
                              grad_hook=even_replicas, **kw)

    def tp_step(*args, **kwargs):
        with model_parallel(model):
            return step(*args, **kwargs)

    return tp_step


# the JAX API's name: this rank's rows of a global batch, the leading axis
# over "data", the rest whole on every rank of the model axis
shard_batch_tp = shard_batch
