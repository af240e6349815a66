"""Tensor parallelism for the SegResNet family on gloo ranks against the
JAX package on the CPU: the checks (a)-(c) of `test_torch_port_tp_zoo.py`
(its `run_cases`) on a (1, 2) mesh, for SegResNet, SegResNetVAE,
SegResNet_DSA and SegResNetVAE_DSA at feature size 4, projection 16, on
both routes (their res blocks run B1 on the kernel route), and SegResNet
with `deconv` upsampling (`UpSample`'s transposed conv: B4 on the kernel
route, column-parallel).

A VAE model's normal draw is fed in on both sides: JAX's
`jax.random.normal` returns the test's (1, 256) array, and the port's
`dropout_rng.normal` the same array (`torch_port_mesh_ranks.
_zoo_tp_route`); its loss is DiceCE plus 0.2 times the VAE loss, as the
train step adds it.
"""

import pytest

from fcd_tpu.models.segresnet import SegResNet as FlaxSegResNet
from fcd_tpu.models.segresnet import SegResNetVAE as FlaxSegResNetVAE
from fcd_tpu.models.segresnet_dsa import SegResNet_DSA as FlaxSegResNetDSA
from fcd_tpu.models.segresnet_dsa import (
    SegResNetVAE_DSA as FlaxSegResNetVAEDSA,
)
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


def segres_kwargs(dsa: bool, vae: bool):
    """The factory's SegResNet configuration at feature size 4, dropout
    off (the port's keyword arguments; the JAX model's add `norm` and
    `dsa_pos_embed`)."""
    kw = dict(out_channels=2, in_channels=2, init_filters=FS,
              dropout_prob=None, upsample_mode="pixelshuffle",
              blocks_down=(1, 2, 2, 4), blocks_up=(1, 1, 1))
    if dsa:
        kw.update(dsa_img_size=IMG, dsa_project_size=16, dsa_num_heads=4,
                  dsa_dropout_rate=0.0, dsa_sa_type="parallel",
                  dsa_num_layers=1, dsa_start_level=2)
    if vae:
        kw.update(input_image_size=IMG, vae_default_std=0.3, vae_nz=256)
    return kw


def _segres(flax_cls, module, fn, dsa, vae, **extra):
    kw = dict(segres_kwargs(dsa, vae), **extra)
    return (lambda: flax_cls(norm="instance", dsa_pos_embed=True, **kw),
            (f"fcd_tpu_torch.models.{module}", fn, kw), ROUTES, vae)


CASES = {
    "SegResNet": _segres(FlaxSegResNet, "segresnet", "SegResNet", False,
                         False),
    "SegResNet deconv": _segres(FlaxSegResNet, "segresnet", "SegResNet",
                                False, False, upsample_mode="deconv"),
    "SegResNetVAE": _segres(FlaxSegResNetVAE, "segresnet", "SegResNetVAE",
                            False, True),
    "SegResNet_DSA": _segres(FlaxSegResNetDSA, "segresnet_dsa",
                             "SegResNet_DSA", True, False),
    "SegResNetVAE_DSA": _segres(FlaxSegResNetVAEDSA, "segresnet_dsa",
                                "SegResNetVAE_DSA", True, True),
}

CASE_ROUTES = [(name, route) for name, case in CASES.items()
               for route in case[2]]


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES, SHAPE, 61)


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
