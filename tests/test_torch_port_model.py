"""The port's blocks, TransformerBlock and full MS_DSA_NET (fp32, CPU)
against the JAX package's CPU forward with the same weights.

Weights are the flax modules' variables with randomised values
(tests/test_torch_parity.py's helpers), loaded into the port through
`fcd_tpu_torch.weights`; inputs come from np.random.RandomState. Both
sides run fp32 on the CPU, so they agree to rel < 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fcd_tpu.models.ms_dsa_net import MS_DSA_NET as FlaxMSDSANet
from fcd_tpu.ops.attention import TransformerBlock as FlaxTransformerBlock
from fcd_tpu.ops.blocks import UnetResBlock as FlaxUnetResBlock
from fcd_tpu.ops.blocks import UnetrUpBlock as FlaxUnetrUpBlock
from fcd_tpu_torch import weights
from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET
from fcd_tpu_torch.ops.attention import TransformerBlock
from fcd_tpu_torch.ops.blocks import UnetResBlock, UnetrUpBlock
from tests.test_torch_parity import randomize_batch_stats, randomize_params

torch.set_grad_enabled(False)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _random_variables(init_fn, rng):
    """Variables of the flax module's shapes (eval_shape: no init compute)
    filled with well-scaled random values and running statistics."""
    shapes = jax.eval_shape(init_fn)
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return randomize_batch_stats(randomize_params(v, rng), rng)


@pytest.mark.parametrize("norm,cin,cout", [
    ("instance", 16, 16), ("instance", 12, 20), ("batch", 16, 16),
    ("batch", 16, 24)])
def test_unet_res_block_matches_jax(norm, cin, cout):
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 8, 10, 6, cin)).astype(np.float32)
    fm = FlaxUnetResBlock(out_channels=cout, kernel_size=3, stride=1,
                          norm_name=norm)
    v = _random_variables(lambda: fm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x), train=False))
    tm = UnetResBlock(cin, cout, norm).eval()
    vn = _numpy_tree(v)
    weights.load_resblock(tm, vn["params"], vn.get("batch_stats"))
    got = tm([torch.from_numpy(x)]).numpy()
    assert _rel(got, want) < 1e-4


def test_unetr_up_block_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(1, 4, 4, 4, 16)).astype(np.float32)
    skip = rng.normal(size=(1, 8, 8, 8, 8)).astype(np.float32)
    fm = FlaxUnetrUpBlock(out_channels=8, kernel_size=3,
                          upsample_kernel_size=2, norm_name="instance",
                          res_block=True, use_bias=False)
    v = _random_variables(lambda: fm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip)), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x), jnp.asarray(skip),
                               train=False))
    tm = UnetrUpBlock(16, 8).eval()
    weights.load_up_block(tm, _numpy_tree(v)["params"])
    got = tm(torch.from_numpy(x), torch.from_numpy(skip)).numpy()
    assert _rel(got, want) < 1e-4


def test_transformer_block_matches_jax():
    """LN + pos-embed + gamma residual + DSA + the batch-norm conv residual
    branch, eval."""
    s, c, p, h = 4, 32, 16, 4
    n = s ** 3
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, s, s, s, c)).astype(np.float32)
    fm = FlaxTransformerBlock(input_size=n, hidden_size=c, proj_size=p,
                              num_heads=h, sa_type="parallel", pos_embed=True)
    v = _random_variables(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x)), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x), train=False))
    tm = TransformerBlock(n, c, p, h).eval()
    vn = _numpy_tree(v)
    weights.load_transformer_block(tm, vn["params"], vn["batch_stats"])
    got = tm(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-4


# tests/test_full_model_parity.py uses (32, 32, 64), whose level-6 grid is
# 1x1x2: a 2-voxel instance norm amplifies the two frameworks' f32 conv
# rounding past 1e-4 (that file notes it too). (32, 64, 64) keeps fs 8 and
# gives level 6 a 1x2x2 grid.
IMG = (32, 64, 64)


def test_ms_dsa_net_forward_matches_jax():
    """The complete 6-level MS_DSA_NET (one transformer layer per level),
    weights loaded through load_flax_variables."""
    rng = np.random.RandomState(0)
    fm = FlaxMSDSANet(out_channels=2, img_size=IMG, feature_size=8,
                      project_size=16, num_layers=1)
    x = rng.normal(size=(1,) + IMG + (2,)).astype(np.float32)
    v = _random_variables(lambda: fm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1,) + IMG + (2,))), rng)
    want = np.asarray(fm.apply(v, jnp.asarray(x), train=False))
    tm = MS_DSA_NET(2, IMG, in_channels=2, feature_size=8, project_size=16,
                    num_layers=1).eval()
    weights.load_flax_variables(tm, _numpy_tree(v))
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1,) + IMG + (2,)
    assert _rel(got, want) < 1e-4
