"""UNETR at bf16 in both packages: the port's narrowed UNETR at bf16 (B1,
K1, B2, K2 and B4's plain versions, the attention in bf16 with the JAX
rounding points) against the JAX package's UNETR at dtype bfloat16 (its
Pallas kernels in interpret mode), the same weights and 64^3 input, one
DiceCE step each, dropout off.

bf16 results of the two packages are not close to each other value by
value: their products round in other orders, and on one ViT block the two
differ in about 40% of the outputs. So each is measured against the JAX
package's f32 step, and the port's bf16 distance is held to
BF16_MARGIN times the JAX package's own bf16 distance: the logits (max abs
over the largest logit), the loss, and each top-level module's gradient
(rel-L2). Measured on the CPU: logits 1.30e-2 against 1.05e-2, loss 2.22e-4
against 2.92e-4, modules 0.62-1.16x. The JAX head's bias gradient is a bf16
sum (rel-L2 0.62 from f32), the port's an f32 one (1.8e-3).

The f32 route's forward and the f32 step are held value by value in
test_torch_port_zoo_a7.py and test_torch_port_zoo_a7_train.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.config import get_default_params as jax_default_params
from fcd_tpu.losses.combined import make_combined_loss as jax_combined_loss
from fcd_tpu.models.unetr import UNETR as FlaxUNETR
from fcd_tpu_torch import weights
from fcd_tpu_torch.config import get_default_params
from fcd_tpu_torch.losses.combined import make_combined_loss
from fcd_tpu_torch.models.unetr import UNETR
from fcd_tpu_torch.train.state import make_optimizer, make_train_step
from tests.test_torch_port_zoo_a7 import (
    PATCH,
    UNETR_KW,
    _model_variables,
    _numpy_tree,
    _rel,
    _rel_l2,
)

import torch_port_workers

torch_port_workers.share_cores()

BF16_MARGIN = 1.5
_RUNS = {}


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Other test modules turn autograd off when they are imported."""
    with torch.enable_grad():
        yield


def _runs():
    """{("jax" | "port", "f32" | "bf16"): (logits, loss, grads by top-level
    module)}, once a module."""
    if _RUNS:
        return _RUNS
    rng = np.random.RandomState(61)
    v = _model_variables(FlaxUNETR(img_size=(PATCH,) * 3, dropout_rate=0.0,
                                   **UNETR_KW), rng)
    x = rng.normal(size=(1,) + (PATCH,) * 3 + (2,)).astype(np.float32)
    y = (rng.rand(1, PATCH, PATCH, PATCH, 1) > 0.9).astype(np.float32)
    jp = jax_default_params()
    jp.update(loss="DiceCELoss", chans_out=2)
    jloss = jax_combined_loss(jp)
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        fm = FlaxUNETR(img_size=(PATCH,) * 3, dropout_rate=0.0, dtype=dtype,
                       **UNETR_KW)

        def loss_of(params, xx, fm=fm):
            out = fm.apply({"params": params}, xx, train=True)
            return jloss(out, jnp.asarray(y)), out

        (loss, out), grads = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(v["params"], jnp.asarray(x))
        _RUNS["jax", name] = (np.asarray(out, np.float32), float(loss),
                              _modules(_numpy_tree(grads)))
    tm = UNETR(img_size=(PATCH,) * 3, dropout_rate=0.0, **UNETR_KW)
    weights.load_flax_variables(tm, v)
    tm.compute_dtype = torch.bfloat16
    params = get_default_params()
    params.update(loss="DiceCELoss", chans_out=2)
    step = make_train_step(tm, make_combined_loss(params),
                           make_optimizer(params, tm))
    tm.train()
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).float().numpy()
    loss = float(step(torch.from_numpy(x), torch.from_numpy(y), 1e-4))
    _RUNS["port", "bf16"] = (out, loss,
                             _modules(weights.export_flax_grads(tm)))
    return _RUNS


def _modules(tree):
    """{top-level module: its gradient's leaves, flattened, f64}."""
    return {k: np.concatenate([np.ravel(np.asarray(a, np.float64))
                               for a in jax.tree_util.tree_leaves(sub)])
            for k, sub in tree.items()}


def test_unetr_bf16_forward_as_close_as_jax():
    runs = _runs()
    want = runs["jax", "f32"][0]
    ref = _rel(runs["jax", "bf16"][0], want)
    got = _rel(runs["port", "bf16"][0], want)
    assert 0 < got <= BF16_MARGIN * ref, (got, ref)


def test_unetr_bf16_step_as_close_as_jax():
    runs = _runs()
    _, loss, grads = runs["jax", "f32"]
    _, ref_loss, ref_grads = runs["jax", "bf16"]
    _, got_loss, got_grads = runs["port", "bf16"]
    ref = abs(ref_loss - loss) / abs(loss)
    got = abs(got_loss - loss) / abs(loss)
    assert got <= BF16_MARGIN * ref, (got, ref)
    assert set(got_grads) == set(grads)
    bad = {k: (_rel_l2(got_grads[k], grads[k]),
               _rel_l2(ref_grads[k], grads[k])) for k in grads}
    bad = {k: d for k, d in bad.items() if not d[0] <= BF16_MARGIN * d[1]}
    assert not bad, bad
