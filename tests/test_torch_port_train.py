"""The port's training slice (fp32, CPU, plain versions of the kernels)
against the JAX package on the CPU, from the same numpy weights and
inputs.

* DiceLoss / DiceCELoss: value and gradient against make_combined_loss
  (rel 1e-5).
* epoch_lr over epochs 0-300 (exact) and 3 AdamW steps against
  optax.inject_hyperparams(optax.adamw) (rel 1e-6).
* Train BatchNorm (the affine from conv sums): output and running
  statistics against the JAX BatchNorm with mutable=["batch_stats"]
  (rel 1e-5).
* UnetResBlock (instance / batch norm, 1 and 2 parts), UnetrUpBlock (the
  upsample's backward) and TransformerBlock gradients against jax.grad
  (rel-L2 1e-4 per leaf); ChannelDropout3d's masks.
* The slice: one MS_DSA_NET train step at (32, 64, 64), fs8, one layer per
  level, against fcd_tpu's make_train_step: the loss (rel 1e-5), every
  parameter's gradient (rel-L2 1e-2 per leaf; 5e-4 for the head and the
  last decoder), the running statistics after the step (rel-L2 1e-4) and
  the parameters after AdamW (to 1e-3 of lr where the gradient is above
  1e-2 of its leaf's largest and above 1e-6). Dropout is off on
  both sides: dropout_rate 0, and the conv branch's ChannelDropout3d made
  the identity (monkeypatch on the JAX side, rate 0 on the port's). The
  grad tolerance is set by the level-6 grid, 1x2x2: its instance norms
  see 4 voxels with var / mean^2 down to 1e-3, where the port's variance
  from the conv sums (E[x^2] - mean^2, as the TPU path computes it) and
  flax's two-pass variance differ by ~1e-3 relative; swapping flax's
  formula for the port's moves JAX's own gradients by up to 2e-2
  (ROADMAP C4). Measured: 3.8e-3 worst leaf, 9.8e-6 at the head.
* ModelTrainer(device="cpu").train_step lowers the loss on a fixed batch.

Both sides compute in fp32; what differs is summation order and the
variance formulas (two-pass in flax's instance norm, E[x^2] - mean^2 from
the conv sums in the port), hence the tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.ms_dsa_net import MS_DSA_NET as FlaxMSDSANet
from fcd_tpu.ops.attention import TransformerBlock as FlaxTransformerBlock
from fcd_tpu.ops.blocks import UnetResBlock as FlaxUnetResBlock
from fcd_tpu.ops.blocks import UnetrUpBlock as FlaxUnetrUpBlock
from fcd_tpu.ops.layers import BatchNorm as FlaxBatchNorm
from fcd_tpu.train.schedule import epoch_lr as jax_epoch_lr
from fcd_tpu.train.state import (
    create_train_state,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET
from fcd_tpu_torch.ops.attention import ChannelDropout3d, TransformerBlock
from fcd_tpu_torch.ops.blocks import UnetResBlock, UnetrUpBlock
from fcd_tpu_torch.ops.layers import BatchNorm, DropoutRng
from fcd_tpu_torch.train.schedule import epoch_lr
from fcd_tpu_torch.train.state import make_optimizer, make_train_step, set_lr
from fcd_tpu_torch.train.trainer import ModelTrainer
from tests.test_torch_parity import randomize_batch_stats, randomize_params


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported (and
    the workers import every module); these tests need it on."""
    with torch.enable_grad():
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_variables(init_fn, rng):
    shapes = jax.eval_shape(init_fn)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return _numpy_tree(randomize_batch_stats(randomize_params(v, rng), rng))


def _init_variables(fm, img, rng):
    """The model's flax initialisation (well conditioned: the gradients of
    randomize_params' weights move by ~1e-2 under 1e-7 input noise), with
    gamma and the pos-embed drawn so that the attention contributes, and
    random running statistics."""
    v = fm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)}, jnp.zeros((1,) + img + (2,)))

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "gamma" in key or "pos_embed" in key:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, leaf.dtype)
        return leaf

    v = {"params": jax.tree_util.tree_map_with_path(draw, v["params"]),
         "batch_stats": v["batch_stats"]}
    return _numpy_tree(randomize_batch_stats(v, rng))


def _compare_trees(got, want, tol, what):
    """Every leaf of `want` has a leaf in `got` within rel-L2 `tol`."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert flat_w, what
    worst = []
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        worst.append((_rel_l2(node, leaf), jax.tree_util.keystr(path)))
    bad = [w for w in worst if w[0] > tol]
    assert not bad, f"{what}: {sorted(bad)[-5:]}"


def _identity_channel_dropout(monkeypatch):
    monkeypatch.setattr(
        jattention, "ChannelDropout3d",
        lambda rate: (lambda x, train=False, s2d_channels=None: x))


# -- losses, schedule, optimizer ------------------------------------------------

@pytest.mark.parametrize("loss", ["DiceLoss", "DiceCELoss"])
def test_losses_match_jax(loss):
    rng = np.random.RandomState(0)
    pred = rng.normal(size=(2, 6, 8, 10, 2)).astype(np.float32)
    label = (rng.rand(2, 6, 8, 10, 1) > 0.8).astype(np.float32)
    params = get_default_params()
    params["loss"] = loss
    jp = jax_default_params()
    jp["loss"] = loss
    jfn = jax_combined_loss(jp)
    val, grad = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(label)))(
        jnp.asarray(pred))
    pt = torch.tensor(pred, requires_grad=True)
    got = make_combined_loss(params)(pt, torch.tensor(label))
    got.backward()
    assert abs(float(got.detach()) - float(val)) <= 1e-5 * abs(float(val))
    assert _rel(pt.grad.numpy(), grad) < 1e-5


def test_epoch_lr_matches_jax():
    params = get_default_params()
    jp = jax_default_params()
    for epoch in range(301):
        assert epoch_lr(params, epoch) == jax_epoch_lr(jp, epoch)


def test_adamw_matches_optax():
    """Three steps, each with its own gradient and learning rate."""
    rng = np.random.RandomState(1)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i
              for k, s in shapes.items()} for i in range(3)]
    lrs = [1e-3, 5e-4, 2e-3]
    cfg = get_default_params()

    tx = optax.inject_hyperparams(optax.adamw)(
        learning_rate=cfg["lr"], weight_decay=cfg["weight_decay"])
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jparams)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()})
    opt = make_optimizer(cfg, module)
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, prm in module.items():
            prm.grad = torch.tensor(g[k])
        set_lr(opt, lr)
        opt.step()
        for k in shapes:
            assert _rel(module[k].detach().numpy(), jparams[k]) < 1e-6


def test_gradient_accumulation_is_refused():
    cfg = get_default_params()
    cfg["gradient_accumulation_steps"] = 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(cfg, torch.nn.Linear(2, 2))


# -- layers and blocks ------------------------------------------------------------

def test_train_batch_norm_matches_flax():
    """The train-mode affine the fused blocks take from per-(b, c) conv
    sums, and the running statistics it updates."""
    rng = np.random.RandomState(2)
    x = (rng.normal(size=(2, 4, 6, 5, 8)) * 2 + 1).astype(np.float32)
    fm = FlaxBatchNorm(use_running_average=False)
    v = _random_variables(lambda: fm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    want, mut = fm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(8).train()
    for name in ("scale", "bias"):
        getattr(bn, name).data = torch.tensor(v["params"][name])
    for name in ("mean", "var"):
        getattr(bn, name).data = torch.tensor(v["batch_stats"][name])
    xt = torch.tensor(x)
    w, sh = bn.affine_from_sums(xt.sum(dim=(1, 2, 3)),
                                xt.square().sum(dim=(1, 2, 3)), 4 * 6 * 5)
    got = xt * w[:, None, None, None] + sh[:, None, None, None]
    assert _rel(got.detach().numpy(), want) < 1e-5
    for name in ("mean", "var"):
        assert _rel(getattr(bn, name).numpy(),
                    mut["batch_stats"][name]) < 1e-5


def _block_loss_jax(module, variables, x, cot):
    def f(params, xx):
        out, mut = module.apply({"params": params,
                                 "batch_stats": variables.get("batch_stats",
                                                              {})},
                                xx, train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["batch_stats"])
        return jnp.sum(out * cot), mut

    (val, mut), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    return float(val), grads, mut.get("batch_stats", {})


@pytest.mark.parametrize("norm,cin,cout,nparts", [
    ("instance", 12, 20, 1), ("instance", 16, 8, 2), ("batch", 16, 16, 1),
    ("batch", 12, 16, 2)])
def test_unet_res_block_grads_match_jax(norm, cin, cout, nparts):
    rng = np.random.RandomState(3)
    x = rng.normal(size=(2, 6, 8, 6, cin)).astype(np.float32)
    cot = rng.normal(size=(2, 6, 8, 6, cout)).astype(np.float32)
    fm = FlaxUnetResBlock(out_channels=cout, kernel_size=3, stride=1,
                          norm_name=norm)
    v = _random_variables(lambda: fm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    val, (gp, gx), new_bs = _block_loss_jax(fm, v, x, cot)

    tm = UnetResBlock(cin, cout, norm).train()
    weights.load_resblock(tm, v["params"], v.get("batch_stats"))
    xt = torch.tensor(x, requires_grad=True)
    parts = [xt] if nparts == 1 else list(torch.split(xt, [cin // 2, cin - cin // 2],
                                                       dim=-1))
    out = tm(parts)
    loss = (out * torch.tensor(cot)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - val) <= 1e-4 * abs(val)
    assert _rel_l2(xt.grad.numpy(), gx) < 1e-4
    _compare_trees(weights.export_block_grads(tm), _numpy_tree(gp), 1e-4,
                   "grads")
    if norm == "batch":
        _compare_trees(weights.export_block_variables(tm),
                       {"batch_stats": _numpy_tree(new_bs)}, 1e-5,
                       "running stats")


def test_unetr_up_block_grads_match_jax():
    """Transposed conv (B4 forward, the two-matmul backward) + the
    two-part res block, against the dense JAX decoder block."""
    rng = np.random.RandomState(7)
    x = rng.normal(size=(2, 4, 4, 4, 16)).astype(np.float32)
    skip = rng.normal(size=(2, 8, 8, 8, 8)).astype(np.float32)
    cot = rng.normal(size=(2, 8, 8, 8, 8)).astype(np.float32)
    fm = FlaxUnetrUpBlock(out_channels=8, kernel_size=3,
                          upsample_kernel_size=2, norm_name="instance",
                          res_block=True, use_bias=False)
    v = _random_variables(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip)), rng)

    def f(params, xx, ss):
        return jnp.sum(fm.apply({"params": params}, xx, ss, train=True) * cot)

    val, (gp, gx, gs) = jax.value_and_grad(f, argnums=(0, 1, 2))(
        v["params"], jnp.asarray(x), jnp.asarray(skip))
    tm = UnetrUpBlock(16, 8).train()
    weights.load_up_block(tm, v["params"])
    xt = torch.tensor(x, requires_grad=True)
    st = torch.tensor(skip, requires_grad=True)
    loss = (tm(xt, st) * torch.tensor(cot)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(val)) <= 1e-4 * abs(float(val))
    assert _rel_l2(xt.grad.numpy(), gx) < 1e-4
    assert _rel_l2(st.grad.numpy(), gs) < 1e-4
    assert _rel_l2(tm.transp.grad.numpy(),
                   gp["ConvTranspose3d_0"]["kernel"]) < 1e-4
    _compare_trees(weights.export_block_grads(tm.block),
                   _numpy_tree(gp["UnetResBlock_0"]), 1e-4, "grads")


def test_channel_dropout_drops_whole_channels():
    gen = torch.Generator().manual_seed(0)
    drop = ChannelDropout3d(0.1, DropoutRng(gen)).train()
    x = torch.ones(64, 2, 2, 2, 32)
    y = drop(x)
    per_channel = y.reshape(64, 8, 32)
    # each (sample, channel) is all zeros or all 1 / 0.9
    assert bool((per_channel.amin(1) == per_channel.amax(1)).all())
    kept = per_channel[:, 0] > 0
    assert torch.allclose(per_channel[:, 0][kept], torch.tensor(1 / 0.9))
    assert abs(float(kept.float().mean()) - 0.9) < 0.02
    assert drop.eval()(x) is x


def test_transformer_block_grads_match_jax(monkeypatch):
    _identity_channel_dropout(monkeypatch)
    s, c, p, h = 4, 32, 16, 4
    n = s ** 3
    rng = np.random.RandomState(4)
    x = rng.normal(size=(2, s, s, s, c)).astype(np.float32)
    cot = rng.normal(size=(2, s, s, s, c)).astype(np.float32)
    fm = FlaxTransformerBlock(input_size=n, hidden_size=c, proj_size=p,
                              num_heads=h, sa_type="parallel", pos_embed=True,
                              dropout_rate=0.0)
    v = _random_variables(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x)), rng)
    val, (gp, gx), new_bs = _block_loss_jax(fm, v, x, cot)

    tm = TransformerBlock(n, c, p, h).train()
    tm.dropout.rate = 0.0
    weights.load_transformer_block(tm, v["params"], v["batch_stats"])
    xt = torch.tensor(x, requires_grad=True)
    loss = (tm(xt) * torch.tensor(cot)).sum()
    loss.backward()
    assert abs(float(loss.detach()) - val) <= 1e-4 * abs(val)
    assert _rel_l2(xt.grad.numpy(), gx) < 1e-4
    _compare_trees(weights.export_block_grads(tm), _numpy_tree(gp), 1e-4,
                   "grads")
    _compare_trees(weights.export_block_variables(tm),
                   {"batch_stats": _numpy_tree(new_bs)}, 1e-5,
                   "running stats")


# -- the slice --------------------------------------------------------------------

IMG = (32, 64, 64)  # test_torch_port_model.py: level 6 is 1x2x2


def test_ms_dsa_net_train_step_matches_jax(monkeypatch):
    _identity_channel_dropout(monkeypatch)
    rng = np.random.RandomState(5)
    jp = jax_default_params()
    jp.update(loss="DiceCELoss", chans_out=2)
    lr = 1e-4
    fm = FlaxMSDSANet(out_channels=2, img_size=IMG, feature_size=8,
                      project_size=16, num_layers=1, dropout_rate=0.0)
    v = _init_variables(fm, IMG, rng)
    x = rng.normal(size=(2,) + IMG + (2,)).astype(np.float32)
    y = (rng.rand(2, *IMG, 1) > 0.9).astype(np.float32)

    jloss = jax_combined_loss(jp)
    tx = jax_make_optimizer(jp)
    state = create_train_state(fm, v, jp)
    jstep = jax_make_train_step(fm, jloss, tx, donate=False, wrap_jit=False)

    @jax.jit
    def run(state, xx, yy):
        def loss_of(params):
            out, _ = fm.apply({"params": params,
                               "batch_stats": state.batch_stats}, xx,
                              train=True,
                              rngs={"dropout": jax.random.PRNGKey(2)},
                              mutable=["batch_stats"])
            return jloss(out, yy)

        grads = jax.grad(loss_of)(state.params)
        new_state, loss = jstep(state, xx, yy, lr, jax.random.PRNGKey(2))
        return grads, new_state, loss

    jgrads, jstate, jl = run(state, jnp.asarray(x), jnp.asarray(y))

    params = get_default_params()
    params.update(loss="DiceCELoss", chans_out=2)
    tm = MS_DSA_NET(2, IMG, in_channels=2, feature_size=8, project_size=16,
                    num_layers=1, dropout_rate=0.0)
    for stack in tm.transformers:
        for blk in stack:
            blk.dropout.rate = 0.0
    weights.load_flax_variables(tm, v)
    opt = make_optimizer(params, tm)
    step = make_train_step(tm, make_combined_loss(params), opt)
    loss = step(torch.tensor(x), torch.tensor(y), lr)

    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    got = weights.export_flax_grads(tm)
    jg = _numpy_tree(jgrads)
    _compare_trees(got, jg, 1e-2, "grads")
    _compare_trees({k: got[k] for k in ("Conv3d_4", "UnetrUpBlock_4")},
                   {k: jg[k] for k in ("Conv3d_4", "UnetrUpBlock_4")}, 5e-4,
                   "head and last decoder grads")
    new_vars = weights.export_flax_variables(tm)
    _compare_trees(new_vars["batch_stats"], _numpy_tree(jstate.batch_stats),
                   1e-4, "running stats")
    # AdamW's first step moves each parameter by lr * g / (|g| + 1e-8):
    # compare the elements whose gradient is above 1e-2 of its leaf's
    # largest and above 1e-6 (there eps / |g| <= 1e-2, so the update holds
    # to 1e-3 of lr; a gradient that is numerically 0 has either sign in
    # either package)
    new_p = new_vars["params"]
    want_p = _numpy_tree(jstate.params)
    n_strict = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        mine, g, p0 = new_p, jg, v["params"]
        for k in path:
            mine, g, p0 = mine[k.key], g[k.key], p0[k.key]
        strict = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        err = np.abs(np.asarray(mine, np.float64) - leaf)
        assert (err[strict] <= 1e-3 * lr + 1e-6 * np.abs(p0[strict])).all(), \
            jax.tree_util.keystr(path)
        assert (err <= 2.0 * lr + 1e-6 * np.abs(p0)).all()
        n_strict += int(strict.sum())
    assert n_strict > 0.3 * sum(l.size for l in jax.tree_util.tree_leaves(jg))


def test_model_trainer_train_step_lowers_the_loss():
    params = get_default_params()
    params.update(patch_size=32, feature_size=4, project_size=8,
                  loss="DiceCELoss")
    tr = ModelTrainer(params, device="cpu")
    rng = np.random.RandomState(6)
    x = rng.normal(size=(2, 32, 32, 32, 2)).astype(np.float32)
    y = (rng.rand(2, 32, 32, 32, 1) > 0.9).astype(np.float32)
    losses = [tr.train_step(x, y, 1e-3) for _ in range(4)]
    assert all(isinstance(l, torch.Tensor) and l.dim() == 0 for l in losses)
    vals = [float(l) for l in losses]
    assert all(np.isfinite(vals)) and vals[-1] < vals[0]
    # inference after training switches the model back to eval
    out = tr.inference(rng.normal(size=(36, 36, 36, 2)).astype(np.float32))
    assert not tr.model.training and out.shape == (36, 36, 36, 2)
