"""SegResNet_DSA / SegResNetVAE_DSA: the residual encoder with dual
self-attention transformer levels (`fcd_tpu/models/segresnet_dsa.py`;
the survey's "combined architecture"). Both are `SegResNetCore` with a
`dsa_start_level`: the factory starts the levels at len(blocks_down) - 2,
three TransformerBlocks on each level's own width."""

from __future__ import annotations

from fcd_tpu_torch.models.segresnet import SegResNetCore


def SegResNet_DSA(**kw) -> SegResNetCore:
    kw.setdefault("vae", False)
    if kw.get("dsa_start_level") is None:
        raise ValueError("SegResNet_DSA needs a dsa_start_level")
    return SegResNetCore(**kw)


def SegResNetVAE_DSA(**kw) -> SegResNetCore:
    kw["vae"] = True
    if kw.get("dsa_start_level") is None:
        raise ValueError("SegResNetVAE_DSA needs a dsa_start_level")
    return SegResNetCore(**kw)
