"""Model factory: params['model_type'] -> constructed model.

Counterpart of `fcd_tpu/models/factory.py::get_model` for the model the
port has, MS_DSA_NET with the JAX factory's settings (res blocks,
instance norm, leaky-ReLU 0.01, no conv bias, pos-embed, 3 transformer
layers per level, attention dropout 0.1). The rest of the zoo is queued in
ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Dict

from fcd_tpu_torch.models.ms_dsa_net import MS_DSA_NET, _triple

_ZOO = {"ms_dsa_net_ps", "baseunet", "segresnet", "segresnetvae",
        "segresnet_dsa", "segresnetvae_dsa", "unetrpp", "unet", "vnet",
        "unetr", "swinunetr"}


def _build_ms_dsa_net(params: Dict[str, Any]) -> MS_DSA_NET:
    return MS_DSA_NET(
        out_channels=params["chans_out"],
        img_size=_triple(params["patch_size"]),
        in_channels=params["chans_in"],
        feature_size=params["feature_size"],
        project_size=params["project_size"],
        sa_type=params["sa_type"],
        dropout_rate=0.1,
    )


def get_model(params: Dict[str, Any], return_model: bool = True):
    """Build the configured model; sets params['model_returns_vaeloss'] as
    the JAX factory does. Returns (model, params), with model None when
    return_model is False (the JAX factory's signature, :270)."""
    model_type = params["model_type"].lower()
    params["model_returns_vaeloss"] = model_type in ("segresnetvae",
                                                     "segresnetvae_dsa")
    if model_type in _ZOO:
        raise NotImplementedError(
            f"model_type {params['model_type']!r} is not ported yet: the "
            "port has MS_DSA_NET; the model zoo is queued in ROADMAP.md")
    if model_type != "ms_dsa_net":
        raise ValueError(f"Unknown model_type: {params['model_type']}")
    return (_build_ms_dsa_net(params) if return_model else None), params
