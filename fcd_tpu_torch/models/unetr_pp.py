"""UNETR++: the efficient-paired-attention encoder and decoder.

Counterpart of `fcd_tpu/models/unetr_pp.py::UNETR_PP` (:45-123) on dense
channels-last tensors:

- encoder: a k4 s4 conv stem (no bias) and GroupNorm of min(in_channels,
  dims[0]) groups, then three k2 s2 downsampling convs, each with a
  GroupNorm of dims[i - 1] groups; after each, `depths[i]` EPA blocks
  (`ops/attention.py::EPABlock`) on the stage's grid (patch / 4, / 8,
  / 16, / 32) with the projection `proj_sizes[i]`;
- a full-resolution `UnetResBlock` (in_channels -> feature_size) on the
  input;
- three decoders (`up_epa`): a k2 s2 transposed conv (no bias), the skip
  added, three EPA blocks at projection 64;
- a k4 s4 transposed conv to feature_size, the full-resolution branch
  added, a second `UnetResBlock` and the 1x1 head with bias; `do_ds`
  returns [logits, ds2, ds3], the deep-supervision heads on the first and
  second decoder's outputs (1x1 convs with bias).

The JAX package leaves the strided convs and the transposed convs to XLA
(they are not its s2d blocks): here `F.conv3d` and `F.conv_transpose3d`
(`ops/layers.py`). The EPA blocks run B5 at eval and K3/K4 in training;
their batch-norm conv blocks and the two full-resolution blocks run B1 and
B2 (K1 and K2 backward) on the kernel route and the plain branch on the
plain route (`ops/layers.py::use_plain_route`). GroupNorm computes in f32;
its output is cast to the model's compute type, as MS_DSA_NET's patch
embed casts its own, so the EPA stacks run in that type.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from fcd_tpu_torch.ops.attention import EPABlock
from fcd_tpu_torch.ops.blocks import UnetResBlock
from fcd_tpu_torch.ops.layers import (
    Conv3d,
    ConvTranspose3d,
    DropoutRng,
    GroupNorm,
)


class UNETR_PP(nn.Module):
    """UNETR++ (the module docstring). forward: (B, D, H, W, in_channels)
    patches of `patch_size` -> (B, D, H, W, out_channels) logits in
    compute_dtype (with do_ds, the list of three heads)."""

    def __init__(self, out_channels: int = 2, in_channels: int = 2,
                 feature_size: int = 16, num_heads: int = 4,
                 depths: Sequence[int] = (3, 3, 3, 3),
                 dims: Sequence[int] = (32, 64, 128, 256),
                 proj_sizes: Sequence[int] = (64, 64, 64, 32),
                 patch_size: Sequence[int] = (128, 128, 128),
                 norm_name: str = "instance", do_ds: bool = False,
                 dropout_rate: float = 0.1):
        super().__init__()
        fs = feature_size
        self.patch_size = tuple(int(s) for s in patch_size)
        self.in_channels = in_channels
        self.do_ds = do_ds
        self.compute_dtype = torch.float32
        self.dropout_rng = DropoutRng()
        grids = [tuple(s // (4 * 2 ** i) for s in self.patch_size)
                 for i in range(4)]
        self.downs = nn.ModuleList()
        self.down_norms = nn.ModuleList()
        self.stages = nn.ModuleList()
        salt = 0
        for i in range(4):
            if i == 0:
                self.downs.append(Conv3d(in_channels, dims[0], 4, 4, False))
                self.down_norms.append(GroupNorm(dims[0],
                                                 min(in_channels, dims[0])))
            else:
                self.downs.append(Conv3d(dims[i - 1], dims[i], 2, 2, False))
                self.down_norms.append(GroupNorm(dims[i], dims[i - 1]))
            stage = nn.ModuleList()
            for _ in range(depths[i]):
                stage.append(EPABlock(math.prod(grids[i]), dims[i],
                                      proj_sizes[i], num_heads, dropout_rate,
                                      self.dropout_rng, salt))
                salt += 1
            self.stages.append(stage)
        self.conv_block = UnetResBlock(in_channels, fs, norm_name)
        # up_epa decoders: (in, out, grid) for dec3, dec2, dec1
        self.up_convs = nn.ModuleList()
        self.up_stages = nn.ModuleList()
        for cin, cout, grid in ((fs * 16, fs * 8, grids[2]),
                                (fs * 8, fs * 4, grids[1]),
                                (fs * 4, fs * 2, grids[0])):
            self.up_convs.append(ConvTranspose3d(cin, cout, 2, False))
            stage = nn.ModuleList()
            for _ in range(3):
                stage.append(EPABlock(math.prod(grid), cout, 64, num_heads,
                                      0.1, self.dropout_rng, salt))
                salt += 1
            self.up_stages.append(stage)
        self.out_up = ConvTranspose3d(fs * 2, fs, 4, False)
        self.out_block = UnetResBlock(fs, fs, norm_name)
        self.head = Conv3d(fs, out_channels, 1, 1, True)
        self.ds_heads = (nn.ModuleList([Conv3d(fs * 2, out_channels, 1, 1,
                                               True),
                                        Conv3d(fs * 4, out_channels, 1, 1,
                                               True)])
                         if do_ds else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers, drawn from `generator`."""
        layers = [*self.downs, *self.down_norms, self.conv_block,
                  *self.up_convs, self.out_up, self.out_block, self.head]
        layers += [blk for stage in (*self.stages, *self.up_stages)
                   for blk in stage]
        if self.ds_heads is not None:
            layers += list(self.ds_heads)
        for m in layers:
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        if tuple(x.shape[1:4]) != self.patch_size:
            raise ValueError(f"patch grid {tuple(x.shape[1:4])} != "
                             f"patch_size {self.patch_size}")
        x = x.to(self.compute_dtype).contiguous()
        dtype = x.dtype
        hidden: Tuple[torch.Tensor, ...] = ()
        h = x
        for down, norm, stage in zip(self.downs, self.down_norms,
                                     self.stages):
            h = norm(down(h)).to(dtype).contiguous()
            for blk in stage:
                h = blk(h)
            hidden += (h,)
        enc1, enc2, enc3, enc4 = hidden
        conv_block = self.conv_block([x])
        decs = []
        out = enc4
        for up, stage, skip in zip(self.up_convs, self.up_stages,
                                   (enc3, enc2, enc1)):
            out = (up(out) + skip).contiguous()
            for blk in stage:
                out = blk(out)
            decs.append(out)
        dec3, dec2, dec1 = decs
        out = (self.out_up(dec1) + conv_block).contiguous()
        logits = self.head(self.out_block([out]))
        if self.do_ds:
            return [logits, self.ds_heads[0](dec1), self.ds_heads[1](dec2)]
        return logits
