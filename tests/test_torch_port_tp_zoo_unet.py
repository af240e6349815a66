"""Tensor parallelism for UNet (channels 4-128) and VNet on gloo ranks
against the JAX package on the CPU: the checks (a)-(c) of
`test_torch_port_tp_zoo.py` (its `run_cases`) on a (1, 2) mesh, on one
route (no kernel is on their path at the defaults, so both routes are the
same code), and UNet under FCD_FAST_CONV=1 (its 3x3 stride-1 convs through
B1 on the kernel route: a unit's first conv column-parallel, its second
row-parallel as B1's partial instance and the finishing pass; the JAX
package takes its fast conv at bf16 only, so at f32 it runs the same
function as without).
"""

import pytest

from fcd_tpu.models.unet import UNet as FlaxUNet
from fcd_tpu.models.vnet import VNet as FlaxVNet
from tests.test_torch_port_tp_zoo import (
    SHAPE,
    forward_check,
    grads_check,
    loss_check,
    run_cases,
    spec_check,
)

import torch_port_workers

torch_port_workers.share_cores()

UNET_CHANNELS = (4, 8, 16, 32, 64, 128)
CASES = {
    "UNet": (lambda: FlaxUNet(channels=UNET_CHANNELS, dropout=0.0),
             ("fcd_tpu_torch.models.unet", "UNet",
              dict(channels=UNET_CHANNELS, dropout=0.0)),
             ("kernel",), False),
    "UNet fast": (lambda: FlaxUNet(channels=UNET_CHANNELS, dropout=0.0),
                  ("fcd_tpu_torch.models.unet", "UNet",
                   dict(channels=UNET_CHANNELS, dropout=0.0, fast=True)),
                  ("kernel",), False),
    "VNet": (lambda: FlaxVNet(dropout_prob=0.0),
             ("fcd_tpu_torch.models.vnet", "VNet", dict(dropout_prob=0.0)),
             ("kernel",), False),
}
CASE_ROUTES = [(name, route) for name, case in CASES.items()
               for route in case[2]]


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES, SHAPE, 71)


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
