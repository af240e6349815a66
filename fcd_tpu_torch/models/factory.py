"""Model factory: params['model_type'] -> constructed model.

Counterpart of `fcd_tpu/models/factory.py::get_model` for all twelve of
its model types, with exactly the JAX factory's settings (:33-249):
MS_DSA_NET and MS_DSA_NET_PS (res blocks, instance norm, leaky-ReLU 0.01,
no conv bias, pos-embed, 3 transformer layers per level, attention
dropout 0.1; PS with pixelshuffle decoders), BaseUNet (depth 6), the
SegResNet family (SegResNet, SegResNetVAE, SegResNet_DSA, SegResNetVAE_DSA:
ReLU, instance norm, dropout 0.1, `segresnet_upsample_mode`, blocks (1, 2,
2, 4) / (1, 1, 1) or, with `segresnet_deeper`, (1, 2, 2, 4, 4) / (2, 2, 2,
2); VAE nz 256, std 0.3; DSA levels from len(blocks_down) - 2 with the
configured projection, 4 heads, 3 layers, dropout 0.1), UNETR++ (:180-197),
UNet (channels 16-512, strides 2, two res units, instance norm, PReLU,
dropout 0.1: :199-211), VNet (PReLU 0.2, dropout 0.5: :214-222), UNETR
(hidden 768, MLP 1024, 12 heads, the configured feature size, res blocks,
dropout 0.1: :225-239) and SwinUNETR (feature size 24: :242-249). The JAX
package's performance gates (`params['perf_flags']`, exported `FCD_*`
variables) are resolved now and frozen into the model
(`fcd_tpu_torch/flags.py`), and so is the route the compute type takes: a
model built to compute in f32 or f16 on the card takes the JAX package's
plain route for that type (`ops/layers.py::takes_plain_route`, ROADMAP
C18, C20), one built for bf16 (or for the CPU, `compute_dtype` None) the
kernel route.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from fcd_tpu_torch import flags
from fcd_tpu_torch.models.ms_dsa_net import (
    MS_DSA_NET,
    MS_DSA_NET_PS,
    BaseUNet,
    _triple,
)
from fcd_tpu_torch.models.segresnet import SegResNet, SegResNetVAE
from fcd_tpu_torch.models.segresnet_dsa import (
    SegResNet_DSA,
    SegResNetVAE_DSA,
)
from fcd_tpu_torch.models.swin_unetr import SwinUNETR
from fcd_tpu_torch.models.unet import UNet
from fcd_tpu_torch.models.unetr import UNETR
from fcd_tpu_torch.models.unetr_pp import UNETR_PP
from fcd_tpu_torch.models.vnet import VNet
from fcd_tpu_torch.ops.layers import takes_plain_route, use_plain_route

_VAE_MODELS = {"segresnetvae", "segresnetvae_dsa"}


def _fast(params) -> bool:
    """FCD_FAST_CONV: the zoo's plain 3x3 stride-1 convs through B1."""
    return flags.on("FCD_FAST_CONV", flags.resolve(params.get("perf_flags")))


def _build_ms_dsa_net(params: Dict[str, Any]) -> MS_DSA_NET:
    gates = flags.resolve(params.get("perf_flags"))
    return MS_DSA_NET(
        out_channels=params["chans_out"],
        img_size=_triple(params["patch_size"]),
        in_channels=params["chans_in"],
        feature_size=params["feature_size"],
        project_size=params["project_size"],
        sa_type=params["sa_type"],
        dropout_rate=0.1,
        **flags.model_gates(gates),
    )


def _build_ms_dsa_net_ps(params: Dict[str, Any]) -> MS_DSA_NET_PS:
    return MS_DSA_NET_PS(
        out_channels=params["chans_out"],
        img_size=_triple(params["patch_size"]),
        in_channels=params["chans_in"],
        feature_size=params["feature_size"],
        project_size=params["project_size"],
        sa_type=params["sa_type"],
        dropout_rate=0.1,
        upsample_mode="pixelshuffle",
        fast=_fast(params),
    )


def _build_baseunet(params: Dict[str, Any]) -> BaseUNet:
    return BaseUNet(out_channels=params["chans_out"],
                    in_channels=params["chans_in"],
                    feature_size=params["feature_size"], depth=6)


def _build_unetrpp(params: Dict[str, Any]) -> UNETR_PP:
    fs = params["feature_size"]
    return UNETR_PP(
        out_channels=params["chans_out"],
        in_channels=params["chans_in"],
        feature_size=fs,
        num_heads=4,
        depths=(3, 3, 3, 3),
        dims=(fs * 2, fs * 4, fs * 8, fs * 16),  # (32, 64, 128, 256) at fs 16
        patch_size=_triple(params["patch_size"]),
        norm_name="instance",
        do_ds=False,
        dropout_rate=0.1,
    )


def _build_unet(params: Dict[str, Any]) -> UNet:
    return UNet(in_channels=params["chans_in"],
                out_channels=params["chans_out"],
                channels=(16, 32, 64, 128, 256, 512), dropout=0.1,
                fast=_fast(params))


def _build_vnet(params: Dict[str, Any]) -> VNet:
    return VNet(in_channels=params["chans_in"],
                out_channels=params["chans_out"], dropout_prob=0.5)


def _build_unetr(params: Dict[str, Any]) -> UNETR:
    return UNETR(in_channels=params["chans_in"],
                 out_channels=params["chans_out"],
                 img_size=_triple(params["patch_size"]),
                 feature_size=params["feature_size"], hidden_size=768,
                 mlp_dim=1024, num_heads=12, dropout_rate=0.1)


def _build_swinunetr(params: Dict[str, Any]) -> SwinUNETR:
    return SwinUNETR(in_channels=params["chans_in"],
                     out_channels=params["chans_out"], feature_size=24)


def _segresnet_kwargs(params: Dict[str, Any], dsa: bool, vae: bool):
    deeper = params.get("segresnet_deeper", False)
    blocks_down = (1, 2, 2, 4, 4) if deeper else (1, 2, 2, 4)
    blocks_up = (2, 2, 2, 2) if deeper else (1, 1, 1)
    kw = dict(out_channels=params["chans_out"],
              in_channels=params["chans_in"],
              init_filters=params["feature_size"], dropout_prob=0.1,
              act=("relu", {}),
              upsample_mode=params["segresnet_upsample_mode"],
              blocks_down=blocks_down, blocks_up=blocks_up,
              fast=_fast(params))
    if vae:
        kw.update(input_image_size=_triple(params["patch_size"]),
                  vae_default_std=0.3, vae_nz=256)
    if dsa:
        kw.update(dsa_img_size=_triple(params["patch_size"]),
                  dsa_project_size=params["project_size"], dsa_num_heads=4,
                  dsa_dropout_rate=0.1, dsa_sa_type=params["sa_type"],
                  dsa_num_layers=3, dsa_start_level=len(blocks_down) - 2)
    return kw


_BUILDERS = {
    "ms_dsa_net": _build_ms_dsa_net,
    "ms_dsa_net_ps": _build_ms_dsa_net_ps,
    "baseunet": _build_baseunet,
    "unetrpp": _build_unetrpp,
    "segresnet": lambda p: SegResNet(**_segresnet_kwargs(p, False, False)),
    "segresnetvae": lambda p: SegResNetVAE(**_segresnet_kwargs(p, False,
                                                               True)),
    "segresnet_dsa": lambda p: SegResNet_DSA(**_segresnet_kwargs(p, True,
                                                                 False)),
    "segresnetvae_dsa": lambda p: SegResNetVAE_DSA(
        **_segresnet_kwargs(p, True, True)),
    "unet": _build_unet,
    "vnet": _build_vnet,
    "unetr": _build_unetr,
    "swinunetr": _build_swinunetr,
}


def get_model(params: Dict[str, Any], return_model: bool = True,
              compute_dtype: Optional[torch.dtype] = None):
    """Build the configured model; sets params['model_returns_vaeloss'] as
    the JAX factory does. Returns (model, params), with model None when
    return_model is False (the JAX factory's signature, :270).
    `compute_dtype` other than bf16 builds the plain route into the model (the
    trainer passes the card's compute type; None keeps the kernel route,
    whose kernels' plain versions run on the CPU)."""
    model_type = params["model_type"].lower()
    params["model_returns_vaeloss"] = model_type in _VAE_MODELS
    if model_type not in _BUILDERS:
        raise ValueError(f"Unknown model_type: {params['model_type']}")
    if not return_model:
        return None, params
    model = _BUILDERS[model_type](params)
    if compute_dtype is not None and takes_plain_route(compute_dtype):
        use_plain_route(model)
    return model, params
