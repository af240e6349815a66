"""The port's tensor parallelism (`fcd_tpu_torch/parallel/tp.py`) on gloo
ranks against the JAX package on the CPU.

(a) The sharding rule: the port's spec of every parameter leaf of
MS_DSA_NET, taken from `weights.py`'s flax paths, equals
`fcd_tpu.parallel.tp.tp_spec_for`'s on the JAX variables, at fs8 over a
model axis of 4 and fs16 over 2; both have row- and column-parallel
leaves.
(b) One TP step on 8 ranks as a 2 x 4 ("data", "model") mesh, at the JAX
TP test's config (tests/test_parallel.py:131-147: MS_DSA_NET, fs8,
project 4, f32, DiceCE, a batch of 2, lr 1e-3) against the JAX package's
single-device `make_train_step`, the function that test holds GSPMD to.
Three changes, each forced: the patch is (32, 64, 64), not 16^3 (the
port pools every level, which needs even grids; at 16^3 the JAX model's
level 6 has no voxel), one transformer layer a level (as the slice test,
`test_torch_port_train.py`, to keep the JAX compile short), and dropout
off on both sides (no JAX stream can be matched, ROADMAP C2). The loss
within rel 1e-4. Every gathered gradient leaf (against `jax.grad` of the
same loss) within 2x, in rel-L2, the JAX gradient's own largest distance
under three inputs times (1 + 1e-6 N(0, 1)), plus 1e-4 (f32 sums over
2^18 voxels): the model is chaotic at this size, and the nudges move the
JAX gradients by 1e-6 (the head) to 4.4e-2 a leaf. Measured: the TP step
reads at most 0.98 of that control but on the head (7.1e-6, under the
floor); a gradient scaled by k reads |k - 1|, so a replicated gradient
summed over the model axis of 4 reads 3. Every gathered parameter leaf within rtol 2e-4 / atol
1e-6 on each element whose gradient's sign is determined: AdamW's first
step moves an element by lr * g / (|g| + 1e-8), so an element whose
gradient is at the rounding noise moves by +-lr either way, and one
whose |g| is near eps moves by lr * eps / |g| times g's relative error.
The elements held are those with |g| above 1e-2 of the leaf's largest
(the slice test's rule: the sign is determined) and above 1e-5 (eps / |g|
<= 1e-3, so a relative error of g moves the update by at most lr * 1e-3
= 1e-6); there the port's TP gradients and JAX's differ by C4's variance
formulas and summation order only. Every element within 2 lr. Measured: the noise
is the model's own, since 1e-6 of input noise moves the port's
single-device gradients of the level-6 transformer's gamma by 43% and its
batch norms' by 3e-3. The running statistics after the step within
rel-L2 1e-4.
(c) The TP eval forward against `model.apply` (rel 1e-4, as
test_torch_port_model.py holds the single-device forward), bit-equal on
every rank, with B5's `qkvv` gathered.
(d) B1 split around the all-reduce (the partial plain version on each
rank's channel slice, the f32 all-reduce, the finishing pass) against
`conv3x3_plain(want_stats=True)` through `conv3x3_op` on the whole
tensors, on the model axis of 4: y within rel 1e-5, its sums within rel
1e-5, and the gradients of x, w and the prologue's affine (slices) within
rel 1e-4 (f32, only the order of the sums differs).
(e) The mesh: rank r sits at (r // 4, r % 4); every rank's state after
the step is rank 0's; the state's shards, moments included, gather back
to what was sharded.
(f) `parallel.mesh.column_parallel` at bf16, the column-parallel op the
card's f16 route runs (an f32 x takes `copy_to_model`): the output, x's
gradient summed in f32 and rounded once, and w's gradient, against the
one-device op.

(b), (c) and the state of (e) are held on both routes, one case each:
the kernel route (the kernels' plain versions here) and the plain route
(`use_plain_route`: library convs, the row-parallel conv's partial in f32
and rounded once after the all-reduce, `ops/blocks.py::
conv3x3_row_plain`), the route the card takes at f32 and f16 and the JAX
package's own at `use_amp=False`, the JAX TP test's setting.

The 8 ranks are spawned once for the module
(`torch_port_mesh_ranks.tp_checks`), in a thread beside the JAX side's
compiles.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fcd_tpu.ops.attention as jattention
from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.ms_dsa_net import MS_DSA_NET as FlaxMSDSANet
from fcd_tpu.parallel.tp import _path_names, tp_spec_for as jax_spec_for
from fcd_tpu.train.state import (
    create_train_state,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET
from fcd_tpu_torch.parallel.mesh import launch
from fcd_tpu_torch.parallel.tp import tp_spec_for, tp_tree_shardings
from fcd_tpu_torch.weights import export_flax_variables
from tests.test_torch_parity import randomize_batch_stats

import torch
import torch_port_mesh_ranks as ranks

import torch_port_workers

torch_port_workers.share_cores()

IMG = (32, 64, 64)
LR = 1e-3
SHAPE = (2, 4)
NUDGE = 1e-6
N_NUDGES = 3
GRAD_MARGIN = 2.0
GRAD_FLOOR = 1e-4


def _variables(rng):
    """The port's initialisation of the TP model as a flax tree, with gamma
    and the pos-embed drawn so that the attention contributes and random
    running statistics (as test_torch_port_train.py's `_init_variables`)."""
    model = MS_DSA_NET(2, IMG, in_channels=2, feature_size=8, project_size=4,
                       num_layers=1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    v = export_flax_variables(model)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if "gamma" in key or "pos_embed" in key:
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        return leaf

    v["params"] = jax.tree_util.tree_map_with_path(draw, v["params"])
    return jax.tree_util.tree_map(np.asarray, randomize_batch_stats(v, rng))


def _conv_case(rng):
    """B1's row-parallel case at enc1's conv2 width over 4 ranks: x, w,
    the prologue's scale and shift, and cotangents of y and its sums."""
    b, g, c = 2, (6, 8, 10), 16
    f = np.float32
    return (rng.normal(size=(b, *g, c)).astype(f),
            (rng.normal(size=(3, 3, 3, c, c)) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, size=(b, c)).astype(f),
            rng.normal(size=(b, c)).astype(f) * 0.1,
            rng.normal(size=(b, *g, c)).astype(f),
            rng.normal(size=(b, c)).astype(f) * 0.1,
            rng.normal(size=(b, c)).astype(f) * 1e-2)


@pytest.fixture(scope="module")
def results():
    rng = np.random.RandomState(7)
    v = _variables(rng)
    x = rng.rand(2, *IMG, 2).astype(np.float32)
    y = (rng.rand(2, *IMG, 1) > 0.7).astype(np.float32)
    conv_case = _conv_case(rng)
    column_case = (rng.normal(size=(2, 5, 6, 7, 24)).astype(np.float32),
                   (rng.normal(size=(24, 16)) * 0.2).astype(np.float32),
                   rng.normal(size=(2, 5, 6, 7, 16)).astype(np.float32))
    port = {}

    def run_port():
        try:
            port["out"] = launch(ranks.tp_checks, SHAPE[0] * SHAPE[1], IMG,
                                 v, x, y, LR, conv_case, SHAPE, column_case,
                                 device_type="cpu", threads=1)
        except BaseException as e:        # re-raised in the test's thread
            port["error"] = e

    worker = threading.Thread(target=run_port)
    worker.start()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jattention, "ChannelDropout3d",
                       lambda rate: (lambda t, train=False,
                                     s2d_channels=None: t))
            jp = jax_default_params()
            jp.update(loss="DiceCELoss", chans_out=2, use_amp=False)
            fm = FlaxMSDSANet(out_channels=2, img_size=IMG, feature_size=8,
                              project_size=4, num_layers=1, dropout_rate=0.0)
            jloss = jax_combined_loss(jp)
            state = create_train_state(fm, v, jp)
            jstep = jax_make_train_step(fm, jloss, jax_make_optimizer(jp),
                                        donate=False, wrap_jit=False)
            xx, yy = jnp.asarray(x), jnp.asarray(y)

            @jax.jit
            def grad_at(params, xx):
                def loss_of(params):
                    out, _ = fm.apply(
                        {"params": params, "batch_stats": state.batch_stats},
                        xx, train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)},
                        mutable=["batch_stats"])
                    return jloss(out, yy)

                return jax.grad(loss_of)(params)

            @jax.jit
            def run(state):
                new_state, loss = jstep(state, xx, yy, LR,
                                        jax.random.PRNGKey(0))
                return new_state, loss, fm.apply(v, xx, train=False)

            grads = grad_at(state.params, xx)
            nudge = np.random.RandomState(8)
            nudged = [grad_at(state.params, jnp.asarray(x * (
                1 + NUDGE * nudge.normal(size=x.shape)).astype(np.float32)))
                for _ in range(N_NUDGES)]
            new_state, loss, fwd = run(state)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        jax_out = {"grads": np_tree(grads), "nudged": [np_tree(n) for n in nudged],
                   "params": np_tree(new_state.params),
                   "batch_stats": np_tree(new_state.batch_stats),
                   "loss": float(loss), "forward": np.asarray(fwd)}
    finally:
        worker.join()
    if "error" in port:
        raise port["error"]
    return {"jax": jax_out, "port": port["out"], "variables": v}


@pytest.mark.parametrize("fs,n_model", [(8, 4), (16, 2)])
def test_specs_match_jax(fs, n_model):
    fm = FlaxMSDSANet(out_channels=2, img_size=(32, 32, 32), feature_size=fs,
                      project_size=64, num_layers=3, dropout_rate=0.0)
    shapes = jax.eval_shape(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 32, 2))))["params"]
    want = {_path_names(p): tuple(jax_spec_for(_path_names(p), leaf.shape,
                                               n_model))
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = MS_DSA_NET(2, (32, 32, 32), in_channels=2, feature_size=fs,
                       project_size=64, num_layers=3)
    got = tp_tree_shardings(model, n_model)
    assert got == want
    specs = set(got.values())
    assert (None, None, None, None, "model") in specs     # column-parallel
    assert (None, None, None, "model", None) in specs     # row-parallel
    assert ("model", None) in specs                       # qkvv
    assert () in specs                                    # replicated


def test_spec_falls_back_to_replicated():
    """The JAX rule's divisibility fallback: a column that does not divide
    (the head's 2 classes), a row under 2 * n_model, 1-D leaves."""
    conv2 = ("UnetrBasicBlock_0", "UnetResBlock_0", "Conv3d_1", "kernel")
    for path, shape, n in [(("Conv3d_4", "kernel"), (1, 1, 1, 16, 2), 2),
                           (("Conv3d_4", "kernel"), (1, 1, 1, 16, 2), 4),
                           (conv2, (3, 3, 3, 4, 4), 4),
                           (conv2, (3, 3, 3, 6, 6), 4),
                           (("GroupNorm_0", "GroupNorm_0", "scale"), (32,), 2)]:
        assert tp_spec_for(path, shape, n) == \
            tuple(jax_spec_for(path, shape, n)) == ()


ROUTES = ["kernel", "plain"]


@pytest.mark.parametrize("route", ROUTES)
def test_mesh_coordinates(results, route):
    """Rank r at (r // n_model, r % n_model), as np.reshape lays out the
    JAX mesh; each rank holds row- and column-parallel shards."""
    for r, out in enumerate(results["port"]):
        assert out["coords"] == (r // SHAPE[1], r % SHAPE[1], r)
        assert {"col", "row"} <= set(out[route]["roles"])


@pytest.mark.parametrize("route", ROUTES)
def test_tp_loss_matches_jax(results, route):
    assert results["port"][0][route]["loss"] == pytest.approx(
        results["jax"]["loss"], rel=1e-4)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree, np.float64)


@pytest.mark.parametrize("route", ROUTES)
def test_tp_grads_match_jax(results, route):
    """(b): every gathered gradient leaf within GRAD_MARGIN times the JAX
    gradient's own largest distance under N_NUDGES inputs times
    (1 + NUDGE * N(0, 1)), plus GRAD_FLOOR, in rel-L2 (a gradient scaled
    by k reads |k - 1|)."""
    jx = results["jax"]
    got = results["port"][0][route]["grads"]
    leaves = jax.tree_util.tree_flatten_with_path(jx["grads"])[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, want in leaves:
        norm = np.linalg.norm(want)
        rel = np.linalg.norm(_leaf(got, path) - want) / norm
        ref = max(np.linalg.norm(_leaf(n, path) - want) / norm
                  for n in jx["nudged"])
        assert rel <= GRAD_MARGIN * ref + GRAD_FLOOR, (
            jax.tree_util.keystr(path), rel, ref)


@pytest.mark.parametrize("route", ROUTES)
def test_tp_params_match_jax(results, route):
    """(b): every leaf, at rtol 2e-4 / atol 1e-6 where the gradient's sign
    is determined, within 2 lr everywhere."""
    jx = results["jax"]
    got = results["port"][0][route]["variables"]["params"]
    n_strict = n_all = 0
    for path, want in jax.tree_util.tree_flatten_with_path(jx["params"])[0]:
        mine, g = _leaf(got, path), _leaf(jx["grads"], path)
        err = np.abs(mine - want)
        strict = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-5)
        bad = strict & (err > 1e-6 + 2e-4 * np.abs(want))
        name = jax.tree_util.keystr(path)
        assert not bad.any(), (name, err[bad].max(), np.abs(g[bad]).min(),
                               np.abs(g).max(), int(bad.sum()))
        assert (err <= 2 * LR + 1e-6 + 2e-4 * np.abs(want)).all(), name
        n_strict += int(strict.sum())
        n_all += want.size
    assert n_strict > 0.3 * n_all


@pytest.mark.parametrize("route", ROUTES)
def test_tp_running_stats_match_jax(results, route):
    got = results["port"][0][route]["variables"]["batch_stats"]
    want = results["jax"]["batch_stats"]
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert leaves
    for path, w in leaves:
        node = got
        for k in path:
            node = node[k.key]
        assert np.linalg.norm(node - w) <= 1e-4 * np.linalg.norm(w), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("route", ROUTES)
def test_tp_forward_matches_jax(results, route):
    want = results["jax"]["forward"]
    outs = [out[route] for out in results["port"]]
    got = outs[0]["forward"]
    assert got.shape == want.shape == (2,) + IMG + (2,)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    for out in outs[1:]:
        np.testing.assert_array_equal(out["forward"], got)


@pytest.mark.parametrize("route", ROUTES)
def test_every_rank_holds_the_same_state(results, route):
    """The state after the step, the batch norms' running statistics
    included, the same bits on every rank."""
    outs = [out[route] for out in results["port"]]
    assert all(out["roundtrip"] for out in outs)
    ref = jax.tree_util.tree_leaves(outs[0]["variables"])
    for out in outs[1:]:
        assert out["loss"] == outs[0]["loss"]
        for a, b in zip(jax.tree_util.tree_leaves(out["variables"]), ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("what", ["y", "ysum", "ysq", "dx", "dw", "dscale",
                                  "dshift"])
def test_split_conv_matches_whole(results, what):
    """(d), on every rank of the first model axis."""
    i = ["y", "ysum", "ysq", "dx", "dw", "dscale", "dshift"].index(what)
    tol = 1e-5 if i < 3 else 1e-4
    for out in results["port"][:SHAPE[1]]:
        got, want = out["conv"]["split"][i], out["conv"]["whole"][i]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


def test_column_parallel_rounds_once(results):
    """(f) A bf16 column-parallel matmul on the model axis of 4: the
    gathered output and the weight gradient's shard are the one-device
    matmul's within a bf16 ulp, and x's gradient is the ranks' f32
    partials summed and rounded once: the f32 sum rounded to bf16 within
    an ulp (each rank's partial rounded first would be off by more where
    the partials cancel)."""
    ulp = 2.0 ** -7
    for out in results["port"][:SHAPE[1]]:
        y, y1, dx, dx1, dw, dw1 = out["column"]
        for got, want in ((y, y1), (dx, dx1), (dw, dw1)):
            assert got.shape == want.shape
            assert (np.abs(got - want) <= ulp * np.abs(want) + 1e-30).all()


def test_tp_refuses_what_it_cannot_split(monkeypatch):
    """A sharded leaf whose module declares no split of it (`tp_splits`),
    or not in the rule's role, raises before anything is sliced, naming
    the module and the flax path, on either route, instead of running a
    wrong function; a 1-D mesh raises; a model on the plain route runs
    under `model_parallel`."""
    from fcd_tpu_torch.models.segresnet import SegResNet
    from fcd_tpu_torch.models.unetr import UNETR
    from fcd_tpu_torch.ops.blocks import UnetResBlock
    from fcd_tpu_torch.ops.layers import Conv3d, Dense, use_plain_route
    from fcd_tpu_torch.parallel.mesh import Mesh
    from fcd_tpu_torch.parallel.tp import model_parallel, shard_state_tp

    cpu = torch.device("cpu")
    model_axis = Mesh(0, 2, cpu, "gloo", axes=("model",))
    mesh = Mesh(0, 1, cpu, "gloo", axes=("data", "model"), model=model_axis)
    unetr = UNETR(img_size=(32, 32, 32), feature_size=4, hidden_size=48,
                  mlp_dim=48, num_heads=4)
    before = [p.shape for p in unetr.parameters()]
    for cls, splits, other, match in (
            (Conv3d, {}, SegResNet(init_filters=4),
             r"Conv3d 'conv_init'.*convInit/kernel"),
            (Conv3d, {}, use_plain_route(SegResNet(init_filters=4)),
             r"convInit/kernel"),
            (Dense, {"kernel": ("row",)}, unetr,
             r"Dense 'blocks.0.attn.qkv' does not split 'kernel' "
             r"col-parallel.*_ViTBlock_0/_SelfAttention_0/Dense_0/Dense_0/"
             r"kernel"),
            (UnetResBlock, {"conv1": ("row",), "conv2": ("row",)},
             MS_DSA_NET(2, (32, 32, 32), in_channels=2, feature_size=4,
                        project_size=16, num_layers=1),
             r"UnetrBasicBlock 'encoders.0' does not split 'conv1' "
             r"col-parallel.*UnetrBasicBlock_0/UnetResBlock_0/"
             r"Conv3d_0/kernel")):
        with monkeypatch.context() as mp:
            mp.setattr(cls, "tp_splits", splits)
            with pytest.raises(NotImplementedError, match=match):
                shard_state_tp(other, mesh)
        assert getattr(other, "tp_layout", None) is None
    # nothing was sliced
    assert before == [p.shape for p in unetr.parameters()]
    model = MS_DSA_NET(2, (32, 32, 32), in_channels=2, feature_size=4,
                       project_size=16, num_layers=1)
    with pytest.raises(ValueError, match="model"):
        shard_state_tp(model, Mesh(0, 1, cpu, "gloo"))
    with pytest.raises(RuntimeError, match="sharded"):
        with model_parallel(model):
            pass
    model.tp_layout = layout = object()
    use_plain_route(model)
    with model_parallel(model):
        assert all(m.tp is layout for m in model.modules())
    assert all(getattr(m, "tp", None) is None for m in model.modules())
