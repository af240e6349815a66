"""The data mesh: one process per card in a torch.distributed group.

Counterpart of `fcd_tpu/parallel/mesh.py`. The JAX package is one
controller process with a `Mesh` over its local devices; the port runs one
process (a rank) per card, and `Mesh` is that rank's view of the group:
its rank, the world size, its device, the group and the backend (NCCL on
cards, gloo on the CPU, or gloo on cards where several ranks share one
card, which NCCL refuses). The JAX names stay where they help:
`data_sharding` / `shard_batch` give the rank its contiguous slice of the
leading axis, as `P("data")` lays a batch out, and `replicated`
broadcasts a tensor from rank 0, as `P()` replicates it.

Processes: `launch(fn, n, ...)` starts n ranks with torch.multiprocessing
(spawn), joins them into a group through a file store in a temporary
directory (no TCP port, so concurrent launches cannot clash, and no
network), runs `fn` on each and returns each rank's result. Under
`torchrun` (WORLD_SIZE set) `join_env_group` joins the group that is
there. A mesh that is asked for and cannot start raises: nothing carries
on quietly on one card.

The ("data", "model") mesh (`fcd_tpu/parallel/tp.py::make_tp_mesh`) lays
the ranks out as `np.reshape(ranks, (n_data, n_model))` does: rank r sits
at (r // n_model, r % n_model). Its `Mesh` is the rank's view of the DATA
axis (rank, size and group those of its data subgroup, the ranks that
share its model index), so the data-parallel code runs on it unchanged,
and `mesh.model` is its view of the MODEL axis (the ranks that share its
data index). Every rank creates every subgroup of both axes, in the same
order, as torch.distributed requires.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS = "data"
MODEL_AXIS = "model"
# the device `launch` gave this process's rank
_rank_device: Optional[torch.device] = None


@dataclass
class Mesh:
    """One rank's view of a 'data' mesh, or of a ("data", "model") mesh:
    rank, size and group are the data axis's; `model` is the rank's view of
    the model axis (a 1-D Mesh over its model subgroup) or None."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[Any] = None      # None: the default group
    axes: Tuple[str, ...] = (AXIS,)
    model: Optional["Mesh"] = None

    @property
    def shape(self):
        out = {AXIS: self.size}
        if self.model is not None:
            out[MODEL_AXIS] = self.model.size
        return out


def backend_for(device: torch.device, ranks_per_card: int = 1) -> str:
    """NCCL for one rank a card, gloo on the CPU or for ranks that share a
    card."""
    if torch.device(device).type == "cuda" and ranks_per_card == 1:
        return "nccl"
    return "gloo"


def mesh_size(devices: int, device: torch.device) -> int:
    """The ranks a data mesh of `devices` (-1: all) spans
    (fcd_tpu/train/trainer.py:177-188): on cards the visible ones, at most;
    on the CPU `devices` gloo ranks, and -1 one process (the counterpart of
    the JAX tests' virtual host devices is asked for by count)."""
    if torch.device(device).type != "cuda":
        return max(int(devices), 1)
    avail = torch.cuda.device_count()
    return avail if devices < 0 else min(devices, avail)


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = (AXIS,),
              device=None, group=None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over the running group (or `group`, a subgroup of it that
    this rank belongs to): n_devices None or -1 takes the whole group,
    another count must equal its size. `device` is this rank's (default:
    the card `launch` gave it, the current card under NCCL, else the
    CPU). With axes ("data", "model"), `shape` is (n_data, n_model) over
    the whole group (default: (size, 1), as the JAX `make_mesh` lays it
    out). Raises without a group."""
    axes = tuple(axes)
    if axes not in ((AXIS,), (AXIS, MODEL_AXIS)):
        raise ValueError(f"mesh axes {axes}: the port's meshes are "
                         f"({AXIS!r},) and ({AXIS!r}, {MODEL_AXIS!r})")
    if not dist.is_initialized():
        raise RuntimeError(
            "a data mesh needs a process group: start the ranks with "
            "fcd_tpu_torch.parallel.mesh.launch, the CLIs' --devices, or "
            "torchrun")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices >= 0 and n_devices != world:
        raise RuntimeError(f"a mesh of {n_devices} asked for in a group of "
                           f"{world} ranks")
    backend = str(dist.get_backend(group))
    if device is None:
        device = _rank_device or (
            torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))
    if axes == (AXIS,):
        return Mesh(dist.get_rank(group), world, torch.device(device),
                    backend, group)
    n_data, n_model = tuple(shape) if shape is not None else (world, 1)
    if group is not None or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh spans the whole "
                         f"group of {world} ranks")
    rank = dist.get_rank()
    grid = [list(range(i * n_model, (i + 1) * n_model))
            for i in range(n_data)]
    # every rank creates every subgroup, the data axis's first
    data_group, _ = dist.new_subgroups_by_enumeration(
        [list(col) for col in zip(*grid)], backend=backend)
    model_group, _ = dist.new_subgroups_by_enumeration(grid, backend=backend)
    dev = torch.device(device)
    model = Mesh(rank % n_model, n_model, dev, backend, model_group,
                 (MODEL_AXIS,))
    return Mesh(rank // n_model, n_data, dev, backend, data_group, axes,
                model)


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a leading axis of n, as P('data')
    shards it; n must divide over the mesh."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over the "
                         f"{mesh.size}-rank mesh")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of the leading axis of `batch` (a tensor or an
    array), a view where the type allows."""
    return batch[data_sharding(mesh, batch.shape[0])]


@torch.no_grad()
def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` made equal on every rank: the mesh's rank 0's value, broadcast
    in place. NCCL moves only card tensors, so a CPU tensor goes through
    the rank's card."""
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    if mesh.backend == "nccl" and t.device.type != "cuda":
        tmp = t.to(mesh.device)
        dist.broadcast(tmp, src, group=mesh.group)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src, group=mesh.group)
    return t


def all_reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place (not differentiable)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


# -- differentiable collectives ------------------------------------------------
#
# Two kinds of value cross the ranks in a data-parallel step, and their
# backward passes differ. A per-rank partial that every rank then uses in a
# computation of its own (batch-norm sums: each rank normalises its own
# activations with the global statistics) gets the cotangents of all those
# uses, so its backward all-reduces them. A rank's slice of a tensor that
# every rank then feeds to the SAME replicated computation (the logits into
# the global loss) gets one cotangent, which every rank already holds
# whole, so its backward takes the rank's slice of it: all-reducing would
# count it once per rank.


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(mesh, x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(ctx.mesh, g.contiguous().clone()), None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        n = x.shape[0]
        ctx.rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
        out = x.new_zeros((mesh.size * n, *x.shape[1:]),
                          dtype=torch.float32)
        out[ctx.rows] = x
        # one addend a element besides zeros: the sum is exact in any
        # order, and f32 holds a 16-bit x exactly
        return all_reduce_(mesh, out).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks; backward all-reduces the cotangent
    (each rank uses the sum in its own computation)."""
    return _AllReduceSum.apply(x, mesh)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal slices of a batch stacked in rank order into the
    global batch, bit for bit, on every rank; backward takes this rank's
    rows of the cotangent (every rank computes the same function of the
    global batch)."""
    return _GatherBatch.apply(x, mesh)



# -- model-axis collectives (the Megatron pairing, parallel/tp.py) ------------
#
# Under tensor parallelism a value on the model axis is either replicated
# (every rank holds it whole and applies the same function to it) or a
# channel shard (this rank's slice of the last axis; `channel_slice`). Four
# crossings join them; GSPMD inserts their like for the JAX package. Each
# backward keeps every replicated value's cotangent whole on every rank and
# a shard's cotangent on its rank:
#   replicated -> column-parallel op   identity;   backward all-reduces (each
#                                      rank's op saw only its output slice;
#                                      `column_parallel` in f32)
#   row-parallel partial -> replicated all-reduce (f32); backward identity
#   column-parallel shard -> replicated all-gather;  backward keeps the slice
#   replicated -> row-parallel shard   slice;      backward all-gathers


def channel_slice(mesh: Mesh, c: int) -> slice:
    """This rank's contiguous share of c channels over `mesh`."""
    if c % mesh.size:
        raise ValueError(f"{c} channels do not divide over {mesh.size} ranks")
    per = c // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _gather_last(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal slices of the last axis joined in rank order, bit
    for bit (one addend an element besides zeros, in f32)."""
    c = x.shape[-1]
    out = x.new_zeros((*x.shape[:-1], mesh.size * c), dtype=torch.float32)
    out[..., mesh.rank * c:(mesh.rank + 1) * c] = x
    return all_reduce_(mesh, out).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        return all_reduce_(ctx.mesh, g.float().contiguous()).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.dtype = x.dtype
        return all_reduce_(mesh, x.float().contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.cols = slice(mesh.rank * x.shape[-1],
                         (mesh.rank + 1) * x.shape[-1])
        return _gather_last(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.cols].contiguous(), None


class _SliceChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x[..., channel_slice(mesh, x.shape[-1])].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g.contiguous(), ctx.mesh), None


class _ColumnParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, op, mesh):
        ctx.op, ctx.mesh = op, mesh
        ctx.save_for_backward(x, w)
        return op(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        with torch.enable_grad():
            if ctx.needs_input_grad[0]:
                xf = x.detach().float().requires_grad_()
                wf = w.detach().to(x.dtype).float()   # as op rounds it
                dx, = torch.autograd.grad(ctx.op(xf, wf), xf, g.float())
                dx = all_reduce_(ctx.mesh, dx.contiguous()).to(x.dtype)
            if ctx.needs_input_grad[1]:
                wd = w.detach().requires_grad_()
                dw, = torch.autograd.grad(ctx.op(x.detach(), wd), wd, g)
        return dx, dw, None, None


def column_parallel(op: Callable, x: torch.Tensor, w: torch.Tensor,
                    mesh: Mesh) -> torch.Tensor:
    """`op(x, w)` (linear in x) of a replicated x and this rank's
    output-channel shard w, as one device runs it in x's dtype; backward:
    w's gradient as one device computes it, and x's the ranks' partials
    taken in f32 from x's dtype's values, summed over the model axis and
    rounded once, where one device rounds the op's f32 accumulation
    (`copy_to_model` would sum partials each rounded to x's dtype). The
    backward runs op again, in f32 and in x's dtype. An f32 x takes
    `copy_to_model`, which sums the same f32 partials."""
    if x.dtype == torch.float32:
        return op(copy_to_model(x, mesh), w)
    return _ColumnParallel.apply(x, w, op, mesh)


def model_sum(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(t): t summed over the ranks of `mesh` in place (not
    differentiable), the `grad_sum` a column-parallel kernel op (B1, B4)
    takes for its input's gradient: each rank's f32 share summed, then
    rounded once by the op."""
    return lambda t: all_reduce_(mesh, t)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated `x` entering a column-parallel op: the identity; its
    cotangent is summed over the model axis."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' partial results of a row-parallel op, in f32
    (the partials are never rounded before the sum); each rank's cotangent
    is the sum's."""
    return _ReduceFromModel.apply(x, mesh)


def gather_channels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A column-parallel output's channel shards joined into the whole
    tensor on every rank; backward keeps this rank's slice."""
    return _GatherChannels.apply(x, mesh)


def slice_channels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's channel slice of a replicated `x` (a row-parallel op's
    input, or a replicated parameter acting on a shard); backward joins
    the ranks' slices, so the replicated cotangent is whole everywhere."""
    return _SliceChannels.apply(x, mesh)

# -- processes ----------------------------------------------------------------

def join_env_group(backend: Optional[str] = None) -> bool:
    """Join the group torchrun describes (WORLD_SIZE, RANK, LOCAL_RANK,
    MASTER_ADDR/PORT in the environment). True when a group is there
    afterwards; False when the environment names none."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.cuda.is_available() and backend != "gloo"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method="env://")
    return True


def _rank_entry(rank: int, n: int, store: str, backend: str,
                devices: Sequence[str], out_dir: str,
                threads: Optional[int], fn: Callable, args: tuple) -> None:
    global _rank_device
    if threads is not None:
        torch.set_num_threads(threads)
    _rank_device = dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, device_type: str = "cuda",
           devices: Optional[Sequence[str]] = None,
           backend: Optional[str] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run fn(*args) on n ranks joined into one group and return each
    rank's result (fn and its results must pickle). On cards rank r takes
    cuda:r unless `devices` names each rank's card; the backend is NCCL,
    or gloo where ranks share a card or on the CPU. `threads` sets each
    CPU rank's intra-op threads. Raises when a rank fails or the group
    cannot start."""
    if n < 1:
        raise ValueError(f"a mesh of {n} ranks")
    if devices is None:
        devices = ([f"cuda:{r}" for r in range(n)]
                   if device_type == "cuda" else ["cpu"] * n)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices named for {n} ranks")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"a mesh of {n} cards asked for and CUDA is "
                               "not available")
        need = max(torch.device(d).index or 0 for d in devices) + 1
        if need > torch.cuda.device_count():
            raise RuntimeError(
                f"a mesh of {n} ranks on {sorted(set(devices))} asked for; "
                f"{torch.cuda.device_count()} card(s) visible")
        # every library built once, before the ranks would race to it
        from fcd_tpu_torch.kernels import _build

        _build.build_all()
    per_card = n // len(set(devices))
    backend = backend or backend_for(torch.device(devices[0]), per_card)
    with tempfile.TemporaryDirectory(prefix="fcd_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        torch.multiprocessing.start_processes(
            _rank_entry,
            args=(n, store, backend, list(devices), tmp, threads, fn, args),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]

