"""The training loss selected by params['loss'].

Counterpart of `fcd_tpu/losses/combined.py::get_main_loss` (:26) and
`make_combined_loss` (:135) for DiceLoss (the config default) and
DiceCELoss (the train benchmark's), dense layout only: the JAX package's
s2d loss is a TPU layout and has no counterpart here.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict

import torch

from fcd_tpu_torch.losses.dice import cross_entropy_loss, dice_loss

LossFn = Callable[..., torch.Tensor]

_EXTRAS = ("tv_loss_weight", "boundaryloss_weight", "caloss_weight")


def get_main_loss(params: Dict[str, Any]) -> LossFn:
    loss_type = params.get("loss", "DiceLoss")
    dice = partial(
        dice_loss, include_background=False, smooth_nr=1e-5, smooth_dr=1e-5,
        to_onehot_y=params["chans_out"] > 1, sigmoid=params["sigmoid"],
        softmax=params["softmax"], batch=True,
        squared_pred=params["square_pred"], jaccard=params["jaccard"])
    if loss_type == "DiceLoss":
        return dice
    if loss_type == "DiceCELoss":
        weight = torch.tensor([params["ce_background_weight"],
                               params["ce_fcd_weight"]], dtype=torch.float32)
        l_dice, l_ce = params["lambda_dice"], params["lambda_ce"]

        def dice_ce(pred, target):
            return l_dice * dice(pred, target) + l_ce * cross_entropy_loss(
                pred, target, weight=weight)

        return dice_ce
    raise NotImplementedError(
        f"loss {loss_type!r}: the port has DiceLoss and DiceCELoss; the other "
        "losses are queued in ROADMAP.md")


def make_combined_loss(params: Dict[str, Any]) -> LossFn:
    """loss_fn(pred_logits (B, D, H, W, C), target (B, D, H, W, 1)) ->
    scalar f32 tensor."""
    for key in _EXTRAS:
        if params.get(key, 0.0):
            raise NotImplementedError(
                f"{key} > 0: the TV / boundary / cortical loss terms are "
                "queued in ROADMAP.md")
    return get_main_loss(params)
