"""The training loss selected by params: the main loss plus the weighted
regularisers.

Counterpart of `fcd_tpu/losses/combined.py::get_main_loss` (:26) and
`make_combined_loss` (:135), dense layout: DiceLoss, DiceCELoss,
DiceFocalLoss, GeneralizedDiceLoss and GeneralizedDiceFocalLoss
(`params['loss']`; any other name gives no main term, as in the JAX
package), plus the total-variation (`tv_loss_weight`, `tv_loss_norm`,
`tvloss_exclude_borders`), boundary (`boundaryloss_weight`) and cortical
(`caloss_weight`, with a thickness map) terms. The JAX package's s2d loss
variant is a TPU layout and has no counterpart here.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional

import torch

from fcd_tpu_torch.losses.dice import (
    cross_entropy_loss,
    dice_loss,
    focal_loss,
    generalized_dice_loss,
)
from fcd_tpu_torch.losses.extras import (
    boundary_loss,
    cortical_boundary_loss,
    total_variation_loss,
)

LossFn = Callable[..., torch.Tensor]


def get_main_loss(params: Dict[str, Any]) -> Optional[LossFn]:
    """The main loss params['loss'] names (None for another name), as a
    function of (pred, target, sample_mask=None)."""
    loss_type = params.get("loss", "DiceLoss")
    onehot = params["chans_out"] > 1
    dice = partial(
        dice_loss, include_background=False, smooth_nr=1e-5, smooth_dr=1e-5,
        to_onehot_y=onehot, sigmoid=params["sigmoid"],
        softmax=params["softmax"], batch=True,
        squared_pred=params["square_pred"], jaccard=params["jaccard"])
    gdice = partial(
        generalized_dice_loss, include_background=True, to_onehot_y=onehot,
        sigmoid=params["sigmoid"], softmax=params["softmax"],
        w_type=params["gdice_wtype"], batch=True)

    def focal(include_background):
        return partial(focal_loss, gamma=params["gamma_focal"],
                       include_background=include_background,
                       to_onehot_y=onehot, use_softmax=params["softmax"])

    def mix(a, la, b, lb):
        def loss(pred, target, sample_mask=None):
            return (la * a(pred, target, sample_mask=sample_mask)
                    + lb * b(pred, target, sample_mask=sample_mask))
        return loss

    if loss_type == "DiceLoss":
        return dice
    if loss_type == "DiceCELoss":
        weight = torch.tensor([params["ce_background_weight"],
                               params["ce_fcd_weight"]], dtype=torch.float32)
        return mix(dice, params["lambda_dice"],
                   partial(cross_entropy_loss, weight=weight),
                   params["lambda_ce"])
    if loss_type == "DiceFocalLoss":
        return mix(dice, params["lambda_dice"], focal(False),
                   params["lambda_focal"])
    if loss_type == "GeneralizedDiceLoss":
        return gdice
    if loss_type == "GeneralizedDiceFocalLoss":
        return mix(gdice, params["lambda_dice"], focal(True),
                   params["lambda_focal"])
    return None


def make_combined_loss(params: Dict[str, Any]) -> LossFn:
    """loss_fn(pred (B, D, H, W, C) logits, target (B, D, H, W, 1),
    thickness_map=None, sample_mask=None) -> scalar f32 tensor. The
    cortical term needs a thickness map and is left out without one, as in
    the JAX package; sample_mask (B,) 0/1 leaves padded samples out of
    every term."""
    main = get_main_loss(params)
    tv_w = params.get("tv_loss_weight", 0.0)
    b_w = params.get("boundaryloss_weight", 0.0)
    ca_w = params.get("caloss_weight", 0.0)
    tv_norm = 2 if params.get("tv_loss_norm", "l1") == "l2" else 1
    tv_excl = params.get("tvloss_exclude_borders", False)
    sigmoid, softmax = params["sigmoid"], params["softmax"]

    def loss_fn(pred, target, thickness_map=None, sample_mask=None):
        total = 0.0
        if main is not None:
            total = total + main(pred, target, sample_mask=sample_mask)
        if tv_w > 0:
            total = total + tv_w * total_variation_loss(
                pred, target, norm=tv_norm, sigmoid=sigmoid, softmax=softmax,
                exclude_borders=tv_excl, sample_mask=sample_mask)
        if b_w > 0:
            total = total + b_w * boundary_loss(pred, target,
                                                sample_mask=sample_mask)
        if ca_w > 0 and thickness_map is not None:
            total = total + ca_w * cortical_boundary_loss(
                pred, thickness_map, sample_mask=sample_mask)
        return total

    return loss_fn
