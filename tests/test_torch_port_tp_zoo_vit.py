"""Tensor parallelism for UNETR (at hidden 48, 4 heads, MLP 64, feature
size 4) and SwinUNETR (at feature size 12) on gloo ranks against the JAX
package on the CPU, both routes: the checks (a)-(c) of
`test_torch_port_tp_zoo.py` (its `run_cases`) on a (1, 2) mesh. Their
Dense layers (the ViT's and the Swin blocks' qkv, projection and MLP,
PatchMerging's reduction), patch embeds and transposed convs split as the
general layers do; their res and up blocks as MS_DSA_NET's.
"""

import pytest

from fcd_tpu.models.swin_unetr import SwinUNETR as FlaxSwinUNETR
from fcd_tpu.models.unetr import UNETR as FlaxUNETR
from tests.test_torch_port_tp_zoo import (
    FS,
    IMG,
    ROUTES,
    SHAPE,
    forward_check,
    grads_check,
    loss_check,
    run_cases,
    spec_check,
)

import torch_port_workers

torch_port_workers.share_cores()

UNETR_KW = dict(feature_size=FS, hidden_size=48, mlp_dim=64, num_heads=4)
CASES = {
    "UNETR": (
        lambda: FlaxUNETR(img_size=IMG, dropout_rate=0.0, **UNETR_KW),
        ("fcd_tpu_torch.models.unetr", "UNETR",
         dict(img_size=IMG, dropout_rate=0.0, **UNETR_KW)),
        ROUTES, False),
    "SwinUNETR": (
        lambda: FlaxSwinUNETR(feature_size=12),
        ("fcd_tpu_torch.models.swin_unetr", "SwinUNETR",
         dict(feature_size=12)),
        ROUTES, False),
}
CASE_ROUTES = [(name, route) for name, case in CASES.items()
               for route in case[2]]


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES, SHAPE, 51)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_zoo_specs_match_jax(name, n_model):
    spec_check(CASES[name][0], CASES[name][1], n_model)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_tp_zoo_forward_matches_jax(results, name, route):
    forward_check(results, name, route)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_tp_zoo_loss_matches_jax(results, name, route):
    loss_check(results, name, route)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_tp_zoo_grads_match_jax(results, name, route):
    grads_check(results, name, route)
