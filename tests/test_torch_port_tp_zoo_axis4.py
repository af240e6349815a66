"""Tensor parallelism on a model axis of 4: SegResNet_DSA at feature size
4 (widths 4-32) on a (1, 4) mesh of gloo ranks against the JAX package on
the CPU, both routes, the checks (b) and (c) of `test_torch_port_tp_zoo.py`
(its `run_cases`). At this width the JAX rule's fallback splits the model:
the level-0 convs (4 channels, under twice the model axis) stay
replicated and run whole on every rank, while the deeper levels, the
transformers' conv blocks, `conv8` and `qkvv` are sharded 4 ways.
"""

import pytest

from fcd_tpu_torch.parallel.tp import tp_tree_shardings
from tests.test_torch_port_tp_zoo import (
    forward_check,
    grads_check,
    loss_check,
    run_cases,
)
from tests.test_torch_port_tp_zoo_segres import CASES as SEGRES_CASES
from tests.test_torch_port_tp_zoo_segres import segres_kwargs

import torch_port_workers

torch_port_workers.share_cores()

SHAPE = (1, 4)
CASES = {"SegResNet_DSA": SEGRES_CASES["SegResNet_DSA"]}
CASE_ROUTES = [(name, route) for name, case in CASES.items()
               for route in case[2]]


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES, SHAPE, 81)


def test_axis4_takes_the_fallback():
    """Leaves split over 2 ranks and replicated over 4 (a column under
    2 x 4, a row under 2 x 4), beside leaves split over 4."""
    from fcd_tpu_torch.models.segresnet_dsa import SegResNet_DSA

    model = SegResNet_DSA(**segres_kwargs(True, False))
    two, four = (tp_tree_shardings(model, n) for n in (2, 4))
    fallback = [p for p in two if two[p] and not four[p]]
    assert ("convInit", "kernel") in fallback
    assert ("down_blocks_0_0", "Conv3d_1", "kernel") in fallback
    assert sum(1 for s in four.values() if s) >= 20


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_axis4_forward_matches_jax(results, name, route):
    forward_check(results, name, route)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_axis4_loss_matches_jax(results, name, route):
    loss_check(results, name, route)


@pytest.mark.parametrize("name,route", CASE_ROUTES)
def test_axis4_grads_match_jax(results, name, route):
    grads_check(results, name, route)
