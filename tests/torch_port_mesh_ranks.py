"""The rank side of the data-mesh CPU tests (`test_torch_port_parallel.py`,
`test_torch_port_sharded_sw.py`).

`fcd_tpu_torch.parallel.mesh.launch` spawns gloo ranks that import this
module to find the function they run, so it imports torch, numpy and the
port only (no jax: the spawned ranks need none, and start faster). Each
function runs every check of one test module on its rank and returns
plain numbers and numpy arrays, rank 0's for the test to compare with the
JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.infer.sliding_window import sliding_window_inference
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.factory import get_model
from fcd_tpu_torch.parallel.dp import make_dp_train_step
from fcd_tpu_torch.parallel.mesh import data_sharding, make_mesh
from fcd_tpu_torch.parallel.sw import sharded_sliding_window_inference
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from fcd_tpu_torch.train.trainer import ModelTrainer
from fcd_tpu_torch.weights import export_flax_variables, load_flax_variables


def params_for(**kw):
    p = get_default_params()
    p.update(chans_in=2, chans_out=2, use_amp=False, **kw)
    return p


def linear_predictor(patches):
    """tests/test_sharded_sw.py's predictor."""
    c0, c1 = patches[..., 0], patches[..., 1]
    return torch.stack([2 * c0 - c1, c0 + c1], dim=-1)


def _model(settings, variables=None):
    model, params = get_model(params_for(**settings))
    model.reset_parameters(torch.Generator().manual_seed(0))
    if variables is not None:
        load_flax_variables(model, variables)
    model.dropout_rng.generator = torch.Generator().manual_seed(11)
    return model, params


def _grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()
            if p.grad is not None}


def _step(settings, variables, x, y, mesh=None, mask=None, lr=1e-3,
          seed=None):
    """(loss, the flax variables after one step, the gradients) of the
    single-device step on (x, y), or with `mesh` of the data-parallel
    step on this rank's rows."""
    model, params = _model(settings, variables)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    mask = None if mask is None else torch.as_tensor(mask)
    loss_fn = make_combined_loss(params)
    opt = make_optimizer(params, model)
    vae = params["model_returns_vaeloss"]
    with torch.enable_grad():
        if mesh is None:
            step = make_train_step(model, loss_fn, opt,
                                   model_returns_vaeloss=vae)
            loss = step(x, y, lr, seed)
        else:
            step = make_dp_train_step(model, loss_fn, opt, mesh,
                                      model_returns_vaeloss=vae,
                                      with_mask=mask is not None)
            rows = data_sharding(mesh, x.shape[0])
            loss = step(x[rows], y[rows], lr, seed,
                        sample_mask=None if mask is None else mask[rows])
    return float(loss), export_flax_variables(model), _grads(model)


def parallel_checks(cases):
    """Run on four ranks: the 2-rank cases on the subgroup of ranks 0 and
    1, the 4-rank ones on the whole group. `cases` maps a name to
    (ranks, settings, variables, x, y, mask, with_single). Returns
    {name: {"dp": rank's DP result, "single": single-device result}}."""
    torch.manual_seed(0)
    pair = dist.new_group([0, 1])
    meshes = {4: make_mesh(4)}
    if dist.get_rank() < 2:
        meshes[2] = make_mesh(2, group=pair)
    out = {}
    for name, (ranks, settings, variables, x, y, mask, single) in \
            cases.items():
        if ranks not in meshes:
            continue
        res = {"dp": _step(settings, variables, x, y, meshes[ranks], mask,
                           seed=5)}
        if single:
            res["single"] = _step(settings, variables, x, y, seed=5)
        out[name] = res
    dist.barrier()
    return out


def sharded_sw_checks(volumes, trainer_case):
    """Run on two ranks: the sharded engine over each of `volumes`
    ((volume, sw_batch, blend) with the linear predictor), and a small
    trainer's inference under the mesh (settings, variables, volume)
    beside the same trainer's single-device inference."""
    mesh = make_mesh(2)
    out = {"sw": [], "single": []}
    for vol, sw_batch, blend in volumes:
        kw = dict(roi_size=(16, 16, 16), out_channels=2, sw_batch=sw_batch,
                  overlap=0.25, blend=blend)
        t = torch.from_numpy(vol)
        out["sw"].append(sharded_sliding_window_inference(
            t, linear_predictor, mesh, **kw).numpy())
        out["single"].append(sliding_window_inference(
            t, linear_predictor, **kw).numpy())
    settings, variables, vol = trainer_case
    p = params_for(**settings)
    trainer = ModelTrainer(p, device="cpu", verbose=False)
    trainer.load_variables(variables)
    alone = ModelTrainer(dict(p, mesh_data=1), device="cpu", verbose=False)
    alone.load_variables(variables)
    out["trainer"] = trainer.inference(vol).numpy()
    out["trainer_single"] = alone.inference(vol).numpy()
    out["mesh"] = (trainer.mesh.rank, trainer.mesh.size)
    return out
