"""Random augmentation of a train batch on the card, in PyTorch.

Counterpart of `fcd_tpu/data/augment.py` (`augment_batch` :136, here
`draw_augment` then `apply_augment`; `scheduled_probs` :149). The chain
and its order are the JAX package's (`_augment_one` :78-133): flips over
the three spatial axes (p = .5 each) -> rotation about the y axis, angle
U(-pi/2, pi/2), linear image / nearest label, edge padding (p = .5) ->
intensity shift U(-.1, .1) (p = .5) -> additive Gaussian noise, std U(0,
.1) (p = .5) -> coarse dropout (5 holes of 16^3, scheduled probability)
-> GridMask (period U{16..31}, ratio .5, scheduled probability).

The JAX package draws every choice from one key inside its jitted
program, and jax.random's streams cannot be reproduced in PyTorch (ROADMAP
C2). So the port splits the chain in two:

* `draw_augment` draws each sample's choices on the host from an explicit
  `torch.Generator`, in `_augment_one`'s order: the three flips, the
  rotation flag and angle, the shift flag and value, the noise flag and
  std, the dropout flag and its 5 x 3 hole starts, the GridMask flag,
  period and three offsets.
* `apply_augment` applies them to the tensors on their device. The
  Gaussian noise comes from a generator of that device unless a tensor of
  standard normal values is passed in.

A test feeds `apply_augment` the draws and the noise that JAX's own key
splits give and holds each transform to `fcd_tpu.data.augment`.

The rotation repeats `jax.scipy.ndimage.map_coordinates` (order 1 for the
image, 0 for the label, mode "nearest"): the sample points, the floor or
the round-half-away-from-zero, the clamp to the edge, the weights and the
order of the sum, then a gather. It does not go through `F.grid_sample`,
whose normalised coordinates move the points by an ulp: at order 0 that
flips labels wherever a point lies near .5. The rotation's cosine and sine
are taken in float64 on the host and rounded to float32, so the card and
the CPU rotate alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

HOLES = 5          # coarse dropout holes (fcd_tpu/data/augment.py:110)
HOLE = 16          # their edge
GRID_PERIOD = (16, 32)   # GridMask's period d in [16, 32)


class Draws(NamedTuple):
    """One batch's random choices, host tensors with the batch first."""
    flip: torch.Tensor            # (B, 3) bool, per spatial axis
    rotate: torch.Tensor          # (B,) bool
    angle: torch.Tensor           # (B,) f32 in (-pi/2, pi/2)
    shift_on: torch.Tensor        # (B,) bool
    shift: torch.Tensor           # (B,) f32 in (-.1, .1)
    noise_on: torch.Tensor        # (B,) bool
    noise_std: torch.Tensor       # (B,) f32 in (0, .1)
    dropout_on: torch.Tensor      # (B,) bool
    dropout_starts: torch.Tensor  # (B, 5, 3) int64 hole starts
    gridmask_on: torch.Tensor     # (B,) bool
    gridmask_period: torch.Tensor  # (B,) int64 in [16, 32)
    gridmask_offsets: torch.Tensor  # (B, 3) int64 in [0, period)


def _holes(shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The dropout hole's edge per axis and the exclusive bound of its
    starts (fcd_tpu/data/augment.py:110-115)."""
    hole = tuple(min(HOLE, int(s)) for s in shape)
    return hole, tuple(max(int(s) - k, 1) for s, k in zip(shape, hole))


def draw_augment(batch: int, shape: Sequence[int],
                 generator: torch.Generator, coarse_prob: float,
                 gridmask_prob: float) -> Draws:
    """Every random choice of the chain for `batch` samples of spatial
    shape (D, H, W), drawn from `generator` (a CPU generator) sample by
    sample in the chain's order. A flag is a uniform draw below its
    probability, as jax.random.bernoulli is."""
    _, bound = _holes(shape)

    def u() -> float:
        return float(torch.rand((), generator=generator))

    def randint(lo: int, hi: int) -> int:
        return int(torch.randint(lo, hi, (), generator=generator))

    rows = []
    for _ in range(batch):
        flip = [u() < 0.5 for _ in range(3)]
        rotate, angle = u() < 0.5, (u() - 0.5) * math.pi
        shift_on, shift = u() < 0.5, (u() - 0.5) * 0.2
        noise_on, std = u() < 0.5, u() * 0.1
        dropout_on = u() < coarse_prob
        starts = [[randint(0, b) for b in bound] for _ in range(HOLES)]
        grid_on = u() < gridmask_prob
        period = randint(*GRID_PERIOD)
        offsets = [randint(0, period) for _ in range(3)]
        rows.append((flip, rotate, angle, shift_on, shift, noise_on, std,
                     dropout_on, starts, grid_on, period, offsets))
    cols = list(zip(*rows))
    f32 = torch.float32
    return Draws(
        flip=torch.tensor(cols[0], dtype=torch.bool),
        rotate=torch.tensor(cols[1], dtype=torch.bool),
        angle=torch.tensor(cols[2], dtype=f32),
        shift_on=torch.tensor(cols[3], dtype=torch.bool),
        shift=torch.tensor(cols[4], dtype=f32),
        noise_on=torch.tensor(cols[5], dtype=torch.bool),
        noise_std=torch.tensor(cols[6], dtype=f32),
        dropout_on=torch.tensor(cols[7], dtype=torch.bool),
        dropout_starts=torch.tensor(cols[8], dtype=torch.int64),
        gridmask_on=torch.tensor(cols[9], dtype=torch.bool),
        gridmask_period=torch.tensor(cols[10], dtype=torch.int64),
        gridmask_offsets=torch.tensor(cols[11], dtype=torch.int64))


def _cos_sin(angle: torch.Tensor) -> Tuple[float, float]:
    """cos and sin of an f32 angle, in float64, each then rounded to f32."""
    a = float(angle)
    return (float(torch.tensor(math.cos(a), dtype=torch.float32)),
            float(torch.tensor(math.sin(a), dtype=torch.float32)))


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """lax.round: to the nearest integer, halves away from zero (exact:
    the fraction x - trunc(x) is exact in floating point)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x),
                           torch.zeros_like(x))


def rotate_y(vol: torch.Tensor, angle: torch.Tensor,
             order: int) -> torch.Tensor:
    """A (D, H, W, C) f32 volume rotated about the y (2nd spatial) axis
    around its centre, edges repeated (fcd_tpu/data/augment.py:28-48): the
    points, indices, weights and sums of jax.scipy.ndimage.map_coordinates
    (order 1 or 0, mode "nearest"). y passes through: its weights are 1
    and 0, and the zero terms add nothing to the sum."""
    d, h, w, c = vol.shape
    dev = vol.device
    cos, sin = _cos_sin(angle)
    c0, c2 = (d - 1) / 2.0, (w - 1) / 2.0
    gx = torch.arange(d, dtype=torch.float32, device=dev)[:, None]
    gz = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    # each product and sum rounded as its own f32 op, in the JAX order
    sx = (cos * (gx - c0) + sin * (gz - c2)) + c0
    sz = (-sin * (gx - c0) + cos * (gz - c2)) + c2
    plane = vol.permute(0, 2, 1, 3).reshape(d * w, h * c)

    def take(ix, iz):
        return plane[(ix * w + iz).reshape(-1)].reshape(d, w, h, c)

    if order == 0:
        ix = _round_half_away(sx).long().clamp(0, d - 1)
        iz = _round_half_away(sz).long().clamp(0, w - 1)
        out = take(ix, iz)
    elif order == 1:
        lx, lz = torch.floor(sx), torch.floor(sz)
        ux, uz = sx - lx, sz - lz            # upper weights
        wx, wz = 1 - ux, 1 - uz              # lower weights
        ix, iz = lx.long(), lz.long()
        ix0, ix1 = ix.clamp(0, d - 1), (ix + 1).clamp(0, d - 1)
        iz0, iz1 = iz.clamp(0, w - 1), (iz + 1).clamp(0, w - 1)

        def wt(a, b):
            return (a * b)[..., None, None]

        # map_coordinates' terms in itertools.product order (x, then z;
        # the y-upper terms are zero), added left to right
        out = wt(wx, wz) * take(ix0, iz0)
        out = out + wt(wx, uz) * take(ix0, iz1)
        out = out + wt(ux, wz) * take(ix1, iz0)
        out = out + wt(ux, uz) * take(ix1, iz1)
    else:
        raise ValueError(f"order {order}: map_coordinates takes 0 or 1")
    return out.permute(0, 2, 1, 3)


def gridmask_mask(shape: Sequence[int], period: int,
                  offsets: Sequence[int], device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """GridMask's (D, H, W) keep mask (fcd_tpu/data/augment.py:51-75): a
    voxel of axis position y in the oversized cube (edge hh, the volume
    centred in it) is zeroed on that axis iff (y - offset) mod d < ceil(d /
    2); the mask keeps what no axis zeroes."""
    dd, hh_, ww = (int(s) for s in shape)
    hh = int(math.ceil(math.sqrt(dd * dd + hh_ * hh_ + ww * ww)))
    band = (period + 1) // 2

    def axis(n, st):
        y = torch.arange(n, device=device) + (hh - n) // 2
        return torch.remainder(y - int(st), period) >= band

    m0, m1, m2 = (axis(n, st) for n, st in zip((dd, hh_, ww), offsets))
    return (m0[:, None, None] & m1[None, :, None]
            & m2[None, None, :]).to(dtype)


def dropout_keep(shape: Sequence[int], starts: torch.Tensor, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """Coarse dropout's (D, H, W) keep mask: zero in the HOLES holes."""
    hole, _ = _holes(shape)
    keep = torch.ones(tuple(int(s) for s in shape), dtype=dtype,
                      device=device)
    for s in starts.tolist():
        keep[s[0]:s[0] + hole[0], s[1]:s[1] + hole[1],
             s[2]:s[2] + hole[2]] = 0
    return keep


def apply_augment(images: torch.Tensor, labels: torch.Tensor, draws: Draws,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain on (B, D, H, W, C) images and (B, D, H, W, 1) labels, on
    their device, with `draws` (draw_augment's). `noise`: (B, D, H, W, C)
    standard normal values; without it they are drawn where a sample's
    noise is on, on the images' device from `generator` (that device's
    default generator if None). Returns new f32 tensors."""
    b = images.shape[0]
    if labels.shape[0] != b or draws.flip.shape[0] != b:
        raise ValueError(f"{b} images, {labels.shape[0]} labels and "
                         f"{draws.flip.shape[0]} draws")
    dev, shape = images.device, tuple(images.shape[1:4])
    out_i, out_l = [], []
    for i in range(b):
        img, lbl = images[i].float(), labels[i].float()
        dims = [ax for ax in range(3) if bool(draws.flip[i, ax])]
        if dims:
            img, lbl = torch.flip(img, dims), torch.flip(lbl, dims)
        if bool(draws.rotate[i]):
            img = rotate_y(img, draws.angle[i], order=1)
            lbl = rotate_y(lbl, draws.angle[i], order=0)
        if bool(draws.shift_on[i]):
            img = img + draws.shift[i].to(dev)
        if bool(draws.noise_on[i]):
            z = (noise[i].to(dev, torch.float32) if noise is not None else
                 torch.randn(img.shape, generator=generator, device=dev))
            img = img + z * draws.noise_std[i].to(dev)
        if bool(draws.dropout_on[i]):
            img = img * dropout_keep(shape, draws.dropout_starts[i],
                                     dev)[..., None]
        if bool(draws.gridmask_on[i]):
            img = img * gridmask_mask(shape, int(draws.gridmask_period[i]),
                                      draws.gridmask_offsets[i].tolist(),
                                      dev)[..., None]
        out_i.append(img)
        out_l.append(lbl)
    return torch.stack(out_i), torch.stack(out_l)


def scheduled_probs(params, epoch: int) -> Tuple[float, float]:
    """Epoch-ramped coarse-dropout / GridMask probabilities
    (fcd_tpu/data/augment.py:149-168)."""
    max_epochs = params["max_epochs"]

    def ramp(max_prob, start):
        if max_prob == 0 or epoch < start:
            return 0.0
        return max_prob * min(1.0, (epoch - start)
                              / max(max_epochs - start, 1e-9))

    return (ramp(params.get("coarse_dropout_max_prob", 0.0),
                 params.get("coarse_dropout_start_epoch", 0.0)),
            ramp(params.get("gridmask_max_prob", 0.0),
                 params.get("gridmask_start_epoch", 0.0)))
