"""SwinUNETR: a 3D shifted-window transformer encoder and UNETR's decoder
(MONAI SwinUNETR equivalent).

Counterpart of `fcd_tpu/models/swin_unetr.py` on dense channels-last
tensors: a k2 s2 conv patch embed (no bias), four stages of `SwinBlock`s
(depths 2/2/2/2, heads 3/6/12/24, 7^3 windows; every second block shifts
the windows by 3 where the padded grid exceeds one window, with the
-1e9 mask across the rolled regions; a relative position bias), each
followed by `PatchMerging` (2x2x2 neighbours concatenated in JAX's order,
LayerNorm, a Dense to twice the width without bias); then res
`UnetrBasicBlock`s on the image, on stages 1-3 and on the last merge, and
five `UnetrUpBlock`s and a 1x1 head with bias.

The window helpers (`window_partition`, `window_reverse`, `rel_pos_index`,
`shift_attn_mask`) are copies of the JAX module's. The rounding points are
its own: `LayerNorm` returns f32 and each Dense takes its input cast to
the compute type; q is scaled by head_width^-0.5 rounded to q's dtype; the
bias table and the mask are cast to the scores' dtype before they are
added; the softmax and both products are plain PyTorch, as the JAX package
computes them outside Pallas. In training each block runs under
`torch.utils.checkpoint` (the JAX model's `nn.remat`, MONAI's
use_checkpoint=True); its flax name is `CheckpointSwinBlock_k`. The res
blocks run B1 and B2 and the up blocks B4 (K1 and K2 backward) on the
kernel route, the blocks' plain branch on the plain route.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fcd_tpu_torch.ops.blocks import MLPBlock, UnetrBasicBlock, UnetrUpBlock
from fcd_tpu_torch.ops.layers import (
    Conv3d,
    Dense,
    DropoutRng,
    LayerNorm,
    trunc_normal_,
)


WINDOW = 7                  # window edge; the shift is WINDOW // 2
DEPTH = 2                   # Swin blocks a stage
NUM_HEADS = (3, 6, 12, 24)  # heads of the four stages


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nw, ws^3, C), windows in (d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws, ws, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws ** 3, c)


def window_reverse(windows: torch.Tensor, ws: int, dims) -> torch.Tensor:
    """The inverse of `window_partition` onto a (B, D, H, W, C) grid."""
    b, d, h, w = dims
    x = windows.reshape(b, d // ws, h // ws, w // ws, ws, ws, ws, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def rel_pos_index(ws: int) -> np.ndarray:
    """(ws^3, ws^3) indices into the (2 ws - 1)^3 relative-position bias
    table (`fcd_tpu/models/swin_unetr.py::_rel_pos_index`)."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), np.arange(ws),
                    indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    return (rel[0] * (2 * ws - 1) ** 2 + rel[1] * (2 * ws - 1)
            + rel[2]).astype(np.int32)


def shift_attn_mask(dims, ws: int, shift: int) -> np.ndarray:
    """(nw, ws^3, ws^3) f32 mask of the shifted windows: -1e9 between
    tokens of different rolled regions, 0 within one
    (`fcd_tpu/models/swin_unetr.py::_shift_attn_mask`)."""
    d, h, w = dims
    img = np.zeros((d, h, w), np.float32)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for cnt, (sd, sh, sw) in enumerate(itertools.product(slices, slices,
                                                         slices)):
        img[sd, sh, sw] = cnt
    win = img.reshape(d // ws, ws, h // ws, ws, w // ws, ws)
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws ** 3)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """`fcd_tpu/models/swin_unetr.py::WindowAttention`: qkv Dense (C, 3C)
    with bias, q * hd^-0.5, q k^T plus the relative position bias
    (`rel_pos_bias` ((2 ws - 1)^3, heads), truncated normal 0.02), plus the
    mask of each window when given, softmax, times v, the output Dense
    (the JAX model's dropouts are at the factory's rate 0). x (B * nw,
    ws^3, C) in the compute type."""

    def __init__(self, dim: int, num_heads: int, window_size: int = WINDOW):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads))
        self.register_buffer("index", torch.from_numpy(
            rel_pos_index(window_size).reshape(-1).astype(np.int64)),
            persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.qkv.reset_parameters(generator)
        self.proj.reset_parameters(generator)
        trunc_normal_(self.rel_pos_bias, 0.02, generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(bw, n, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q = q * torch.tensor(hd ** -0.5, dtype=q.dtype)
        attn = torch.matmul(q, k.transpose(-1, -2))
        bias = self.rel_pos_bias[self.index].reshape(n, n, h)
        attn = attn + bias.permute(2, 0, 1).to(attn.dtype)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, h, n, n)
                    + mask[None, :, None].to(attn.dtype)).reshape(bw, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """`fcd_tpu/models/swin_unetr.py::SwinBlock`: LayerNorm, zero padding to
    a multiple of the window, the cyclic shift (where the padded grid
    exceeds one window) with its mask, window attention, the windows put
    back, the shift undone, the crop; the residual; then x + MLP(LayerNorm(
    x)) at 4x width."""

    def __init__(self, dim: int, num_heads: int, shift: int = 0):
        super().__init__()
        self.shift = shift
        self.ln1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads)
        self.ln2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, 4 * dim)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.reset_parameters(generator)

    def mask(self, dims, shift: int, device) -> torch.Tensor:
        """`shift_attn_mask` of the padded grid, kept per grid and device."""
        key = (tuple(dims), shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(
                dims, WINDOW, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws = WINDOW
        pads = [(-s) % ws for s in (d, h, w)]
        y = self.ln1(x).to(x.dtype)
        if any(pads):
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dp, hp, wp = y.shape[1:4]
        shift = self.shift if min(dp, hp, wp) > ws else 0
        mask = None
        if shift:
            y = torch.roll(y, (-shift,) * 3, dims=(1, 2, 3))
            mask = self.mask((dp, hp, wp), shift, y.device)
        y = self.attn(window_partition(y, ws), mask)
        y = window_reverse(y, ws, (b, dp, hp, wp))
        if shift:
            y = torch.roll(y, (shift,) * 3, dims=(1, 2, 3))
        x = x + y[:, :d, :h, :w]
        return x + self.mlp(self.ln2(x).to(x.dtype))


class PatchMerging(nn.Module):
    """`fcd_tpu/models/swin_unetr.py::PatchMerging`: odd axes padded by one,
    each 2x2x2 neighbourhood's channels concatenated in the order of the
    transpose (0, 1, 3, 5, 2, 4, 6, 7) (z, y, x parity, x fastest; not
    MONAI's x0..x7), LayerNorm over 8C, Dense to 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Dense(8 * dim, 2 * dim, use_bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.norm.reset_parameters(generator)
        self.reduction.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
            b, d, h, w, c = x.shape
        x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d // 2, h // 2,
                                                      w // 2, 8 * c)
        return self.reduction(self.norm(x).to(x.dtype))


class SwinUNETR(nn.Module):
    """`fcd_tpu/models/swin_unetr.py::SwinUNETR` as the JAX factory builds it
    (depths 2/2/2/2, heads 3/6/12/24, 7^3 windows, instance norm, dropout
    0, checkpointed blocks; the module docstring). forward: (B, D, H, W,
    in_channels) -> logits (B, D, H, W, out_channels) in compute_dtype; the
    grid must divide by 32."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2,
                 feature_size: int = 24):
        super().__init__()
        fs = feature_size
        self.compute_dtype = torch.float32
        self.dropout_rng = DropoutRng()   # the trainer's handle; rate 0 here
        self.patch_embed = Conv3d(in_channels, fs, 2, 2, False)
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleList()
        dim = fs
        for heads in NUM_HEADS:
            self.stages.append(nn.ModuleList(
                SwinBlock(dim, heads, 0 if j % 2 == 0 else WINDOW // 2)
                for j in range(DEPTH)))
            self.merges.append(PatchMerging(dim))
            dim *= 2
        # enc0 (the image), enc1-enc3 (stages 1-3), dec4 (the last merge)
        self.encoders = nn.ModuleList(
            UnetrBasicBlock(cin, cout) for cin, cout in (
                (in_channels, fs), (fs, fs), (2 * fs, 2 * fs),
                (4 * fs, 4 * fs), (16 * fs, 16 * fs)))
        self.decoders = nn.ModuleList(            # d3, d2, d1, d0, out
            UnetrUpBlock(cin, cout) for cin, cout in (
                (16 * fs, 8 * fs), (8 * fs, 4 * fs), (4 * fs, 2 * fs),
                (2 * fs, fs), (fs, fs)))
        self.head = Conv3d(fs, out_channels, 1, 1, True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers, drawn from `generator`."""
        layers = [self.patch_embed]
        for stage, merge in zip(self.stages, self.merges):
            layers += [*stage, merge]
        layers += [*self.encoders, *self.decoders, self.head]
        for m in layers:
            m.reset_parameters(generator)

    def _block(self, blk: SwinBlock, h: torch.Tensor) -> torch.Tensor:
        if self.training and torch.is_grad_enabled():
            return checkpoint(blk, h, use_reentrant=False)
        return blk(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).contiguous()
        h = self.patch_embed(x)
        hidden = []
        for stage, merge in zip(self.stages, self.merges):
            for blk in stage:
                h = self._block(blk, h)
            hidden.append(h.contiguous())
            h = merge(h)
        hidden.append(h.contiguous())
        enc0, enc1, enc2, enc3, dec4 = (
            enc([t]) for enc, t in zip(self.encoders, (
                x, hidden[0], hidden[1], hidden[2], hidden[4])))
        out = dec4
        for dec, skip in zip(self.decoders,
                             (hidden[3], enc3, enc2, enc1, enc0)):
            out = dec(out, skip)
        return self.head(out)
