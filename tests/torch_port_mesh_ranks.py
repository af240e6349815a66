"""The rank side of the mesh CPU tests (`test_torch_port_parallel.py`,
`test_torch_port_sharded_sw.py`, `test_torch_port_tp.py`).

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
from fcd_tpu_torch.kernels.block_conv import conv3x3_op
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET
from fcd_tpu_torch.ops.blocks import conv3x3_row_op
from fcd_tpu_torch.ops.layers import use_plain_route
from fcd_tpu_torch.parallel import tp
from fcd_tpu_torch.parallel.mesh import channel_slice, data_sharding, make_mesh
from fcd_tpu_torch.parallel.sw import sharded_sliding_window_inference
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from fcd_tpu_torch.train.trainer import ModelTrainer
from fcd_tpu_torch.weights import (
    export_flax_grads,
    export_flax_variables,
    load_flax_variables,
)


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


def tp_model(img, variables, **kw):
    """The TP tests' MS_DSA_NET (one layer a level) with `variables`, its
    conv branch's channel dropout off (the JAX side makes it the
    identity)."""
    model = MS_DSA_NET(2, img, in_channels=2, num_layers=1, **kw)
    load_flax_variables(model, variables)
    for stack in model.transformers:
        for blk in stack:
            blk.dropout.rate = 0.0
    return model


def _split_conv(mm, case):
    """B1 split around the all-reduce on model axis `mm` against the whole
    conv: (y, ysum, ysq, dx, dw, dscale, dshift) of the split (the
    gradients of this rank's slices) and of `conv3x3_op` (sliced)."""
    x, w, scale, shift, gy, gsum, gsq = (torch.from_numpy(a) for a in case)
    cols = channel_slice(mm, x.shape[-1])
    out = {}
    for name in ("split", "whole"):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
        xx, ww, sc, sh = leaves
        if name == "split":
            xx, ww, sc, sh = (t.contiguous() for t in (
                xx[..., cols], ww[:, :, :, cols], sc[:, cols], sh[:, cols]))
            o = conv3x3_row_op(xx, ww, mm, prologue=(sc, sh, 0.01))
        else:
            o = conv3x3_op([xx], [ww], prologue=(sc, sh, 0.01),
                           want_stats=True)
        ((o.y * gy).sum() + (o.ysum * gsum).sum()
         + (o.ysq * gsq).sum()).backward()
        out[name] = [o.y.detach().numpy(), o.ysum.detach().numpy(),
                     o.ysq.detach().numpy(), leaves[0].grad[..., cols].numpy(),
                     leaves[1].grad[:, :, :, cols].numpy(),
                     leaves[2].grad[:, cols].numpy(),
                     leaves[3].grad[:, cols].numpy()]
    return out


def _column(mm, case):
    """`column_parallel` of a bf16 matmul (x replicated, w's output
    columns sharded over model axis `mm`), gathered, against the one-device
    matmul: (y, y whole, dx, dx of f32 sums rounded once, dw, dw whole's
    slice), as f32 arrays."""
    from fcd_tpu_torch.ops.layers import _matmul
    from fcd_tpu_torch.parallel.mesh import column_parallel, gather_channels

    x, w, g = (torch.from_numpy(a) for a in case)
    bf = torch.bfloat16
    cols = channel_slice(mm, w.shape[-1])
    xs = x.to(bf).requires_grad_(True)
    ws = w[:, cols].clone().requires_grad_(True)
    out = gather_channels(column_parallel(_matmul, xs, ws, mm), mm)
    out.backward(g.to(bf))
    xw, ww = x.to(bf).requires_grad_(True), w.clone().requires_grad_(True)
    whole = _matmul(xw, ww)
    whole.backward(g.to(bf))
    exact = (g.to(bf).float() @ w.to(bf).float().t()).to(bf)
    return [t.detach().float().numpy() for t in (
        out, whole, xs.grad, exact, ws.grad, ww.grad[:, cols])]


def tp_checks(img, variables, x, y, lr, conv_case, shape=(2, 4),
              column_case=None):
    """Run on n_data x n_model ranks: `_tp_route` on the kernel route (the
    kernels' plain versions here) and on the plain route, the mesh
    coordinates, B1 split around the all-reduce on the model axis
    (`_split_conv`) and a bf16 `column_parallel` matmul (`_column`)."""
    torch.set_grad_enabled(True)
    mesh = tp.make_tp_mesh(*shape)
    out = {route: _tp_route(img, variables, x, y, lr, mesh, route)
           for route in ("kernel", "plain")}
    out.update(coords=(mesh.rank, mesh.model.rank, dist.get_rank()),
               conv=_split_conv(mesh.model, conv_case),
               column=_column(mesh.model, column_case))
    return out


def _tp_route(img, variables, x, y, lr, mesh, route):
    """On one route: the TP eval forward of `variables` on x, one TP step
    on (x, y), the state after it and the step's gradients gathered whole
    (flax trees), the loss, the layout's roles, and whether the state's
    shards gather back to what was sharded."""
    model = tp_model(img, variables, feature_size=8, project_size=4)
    if route == "plain":
        use_plain_route(model)
    params = params_for(loss="DiceCELoss")
    opt = make_optimizer(params, model)
    layout = tp.shard_state_tp(model, mesh, opt)
    model.eval()
    with torch.no_grad(), tp.model_parallel(model):
        fwd = model(torch.from_numpy(x)).numpy()
    step = tp.make_tp_train_step(model, make_combined_loss(params), opt, mesh)
    loss = step(tp.shard_batch_tp(mesh, torch.from_numpy(x)),
                tp.shard_batch_tp(mesh, torch.from_numpy(y)), lr)
    tp.gather_tp_state(model, opt)
    grads = export_flax_grads(model)
    # the shards, moments included, gather back to what was sharded
    whole = [t.clone() for p in model.parameters()
             for t in [p.data] + list(opt.state[p].values())]
    tp.shard_state_tp(model, mesh, opt)
    tp.gather_tp_state(model, opt)
    again = [t for p in model.parameters()
             for t in [p.data] + list(opt.state[p].values())]
    return {"roundtrip": all(torch.equal(a, b) for a, b in zip(whole, again)),
            "roles": sorted(layout.roles.values()),
            "forward": fwd, "loss": float(loss), "grads": grads,
            "variables": export_flax_variables(model)}


def zoo_tp_model(spec, variables, route):
    """A port model of the TP zoo tests: `spec` (module, class, kwargs)
    built with `variables`, every dropout off (C2: the JAX side runs
    without), on `route` ("kernel" or "plain")."""
    import importlib

    from fcd_tpu_torch.ops.attention import ChannelDropout3d

    module, cls, kwargs = spec
    model = getattr(importlib.import_module(module), cls)(**kwargs)
    load_flax_variables(model, variables)
    for m in model.modules():
        if isinstance(m, ChannelDropout3d):
            m.rate = 0.0
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    if route == "plain":
        use_plain_route(model)
    return model


def _zoo_tp_route(case, mesh, route, lr):
    """One model on one route: the TP eval forward, one TP step (DiceCE,
    AdamW; a VAE model's normal draw the case's `noise`) and its
    gradients gathered whole (a flax tree), the same step's gradients on
    one device, the layout's roles and how many leaves it shards."""
    vae = case["noise"] is not None
    params = params_for(loss="DiceCELoss")
    x, y = (torch.from_numpy(a) for a in (case["x"], case["y"]))

    def fresh():
        model = zoo_tp_model(case["spec"], case["variables"], route)
        if vae:
            noise = torch.from_numpy(case["noise"])
            model.dropout_rng.normal = lambda shape, device: noise.to(device)
        return model

    model = fresh()
    make_train_step(model, make_combined_loss(params),
                    make_optimizer(params, model),
                    model_returns_vaeloss=vae)(x, y, lr)
    single = export_flax_grads(model)
    model = fresh()
    opt = make_optimizer(params, model)
    layout = tp.shard_state_tp(model, mesh, opt)
    model.eval()
    with torch.no_grad(), tp.model_parallel(model):
        fwd = model(x)
    fwd = (fwd[0] if vae else fwd).numpy()
    step = tp.make_tp_train_step(model, make_combined_loss(params), opt,
                                 mesh, model_returns_vaeloss=vae)
    loss = step(tp.shard_batch_tp(mesh, x), tp.shard_batch_tp(mesh, y), lr)
    tp.gather_tp_state(model, opt)
    return {"roles": sorted(set(layout.roles.values())),
            "sharded": len(layout.roles), "forward": fwd,
            "loss": float(loss), "grads": export_flax_grads(model),
            "single_grads": single}


def zoo_tp_checks(cases, shape, lr):
    """Run on n_data x n_model ranks: `_zoo_tp_route` for each case
    {name: {"spec", "variables", "x", "y", "noise", "routes"}} on each of
    its routes, one after the other in this rank. Returns {(name, route):
    result}."""
    torch.set_grad_enabled(True)
    mesh = tp.make_tp_mesh(*shape)
    return {(name, route): _zoo_tp_route(case, mesh, route, lr)
            for name, case in cases.items() for route in case["routes"]}
