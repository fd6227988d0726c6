"""Mesh-polygon ROI: channel means over a per-frame convex polygon.

Port of ``vhr_tpu/ops/polyroi.py``.  The measured region is a convex ring
of face-mesh vertices (:data:`CHEEK_POLY_IDX`, the cheek band's hull), so
the means follow the skin under pose instead of a rectangle that takes in
background and hair at the face's sides.

The estimate is the JAX package's: the polygon's bounding box is sampled on
a ``grid x grid`` lattice of cell centres, each sample bilinear from the
frame (taps clamped into the frame), the samples inside the polygon (a
half-plane test against each edge, normalized by the signed area so either
winding works) and inside the image are averaged.  The JAX package resamples
with two dense interpolation-matrix products over the whole frame, after a
float32 copy of the clip; here each sample gathers its four taps straight
from the u8 frames, the x-pass then the y-pass in the same order, over
slices of ``_SLICE`` frames, and no float32 copy of the clip is made.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["CHEEK_POLY_IDX", "polygon_channel_means", "polygon_bbox"]

# Convex hull of the 478-point face-mesh vertices inside the reference's
# cheek band (ROIConfig ratios 0.15/0.40/0.65 of the rolled landmark box),
# derived on the bundled real portrait with the production MediaPipe
# weights, in ring order.  The mesh topology is shared by every face, so
# these indices land on the cheeks and nose of any subject.
CHEEK_POLY_IDX = (207, 50, 118, 119, 277, 330, 427, 436, 165)

# Frames per slice of the gather.
_SLICE = 64


def polygon_bbox(verts: torch.Tensor, W: int, H: int) -> torch.Tensor:
    """``(T, E, 2)`` float vertices -> ``(T, 4)`` int32 ``[x1, y1, x2,
    y2]``: floor of the minimum and ceil of the maximum, clipped to the
    frame (exclusive ends)."""
    x1 = torch.floor(verts[..., 0].amin(-1)).clamp(0, W - 1)
    y1 = torch.floor(verts[..., 1].amin(-1)).clamp(0, H - 1)
    x2 = torch.ceil(verts[..., 0].amax(-1)).clamp(0, W)
    y2 = torch.ceil(verts[..., 1].amax(-1)).clamp(0, H)
    return torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32)


def _convex_mask(verts: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
                 ) -> torch.Tensor:
    """Half-plane rasterization: verts ``(T, E, 2)``, sample coordinates
    ``xs (T, G)``, ``ys (T, G)`` -> mask ``(T, G_y, G_x)`` float32.

    inside(p) = all_e cross(v[e+1] - v[e], p - v[e]) * sign(area) >= 0;
    repeated vertices give zero cross products and drop out.
    """
    v1 = torch.roll(verts, -1, dims=1)
    e = (v1 - verts)[:, :, None, None]                    # (T, E, 1, 1, 2)
    v = verts[:, :, None, None]
    X = xs[:, None, None, :]                              # (T, 1, 1, Gx)
    Y = ys[:, None, :, None]                              # (T, 1, Gy, 1)
    cross = e[..., 0] * (Y - v[..., 1]) - e[..., 1] * (X - v[..., 0])
    area2 = (verts[..., 0] * v1[..., 1] - v1[..., 0] * verts[..., 1]).sum(1)
    sgn = torch.where(area2 >= 0.0, 1.0, -1.0)
    inside = (cross * sgn[:, None, None, None] >= 0.0).all(1)
    return inside.to(torch.float32)


def _taps(coords: torch.Tensor, n_src: int):
    """Bilinear taps of ``(T, G)`` sample coordinates along an axis of
    ``n_src``: ``(i0, i1, f)``, the floor tap clipped into range, the second
    ``clip(i0 + 1)``, the fraction ``coords - floor(coords)``."""
    x0 = torch.floor(coords)
    i0 = x0.to(torch.int64).clamp(0, n_src - 1)
    return i0, (i0 + 1).clamp(0, n_src - 1), coords - x0


def _samples(frames: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
             ) -> torch.Tensor:
    """``(T, Gy, Gx, C)`` float32 bilinear samples of u8 ``frames (T, H, W,
    C)`` at the lattice ``ys x xs``: the x-pass ``(1 - f) p0 + f p1`` on the
    two rows, then the same along y."""
    T, H, W, C = frames.shape
    x0, x1, fx = _taps(xs, W)
    y0, y1, fy = _taps(ys, H)
    t = torch.arange(T, device=frames.device)[:, None, None]

    def row(yi):
        p0 = frames[t, yi[:, :, None], x0[:, None, :]].to(torch.float32)
        p1 = frames[t, yi[:, :, None], x1[:, None, :]].to(torch.float32)
        f = fx[:, None, :, None]
        return (1.0 - f) * p0 + f * p1                    # (T, Gy, Gx, C)

    g = fy[:, :, None, None]
    return (1.0 - g) * row(y0) + g * row(y1)


def polygon_channel_means(frames: torch.Tensor, verts: torch.Tensor,
                          grid: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of each colour channel over a per-frame convex polygon.

    Args:
      frames: ``(T, H, W, C)`` uint8.
      verts: ``(T, E, 2)`` float32 vertices in image pixels, ring order
        (either winding).  All-zero vertices (an invalid frame's
        convention) give zero means and zero count.
      grid: samples per axis over the polygon's bounding box.

    Returns:
      ``(means, count)``: ``(T, C)`` float32 channel means (0 where the mask
      is empty) and ``(T,)`` float32 mask areas in pixels (mask fraction x
      bounding-box area).
    """
    T, H, W, C = frames.shape
    verts = verts.to(device=frames.device, dtype=torch.float32)
    x1, x2 = verts[..., 0].amin(-1), verts[..., 0].amax(-1)
    y1, y2 = verts[..., 1].amin(-1), verts[..., 1].amax(-1)
    u = (torch.arange(grid, dtype=torch.float32, device=frames.device)
         + 0.5) / grid
    xs = x1[:, None] + u[None, :] * (x2 - x1)[:, None]    # (T, G)
    ys = y1[:, None] + u[None, :] * (y2 - y1)[:, None]
    mask = torch.empty((T, grid, grid), dtype=torch.float32,
                       device=frames.device)
    sums = torch.empty((T, C), dtype=torch.float32, device=frames.device)
    for s in range(0, T, _SLICE):
        sl = slice(s, min(T, s + _SLICE))
        m = _convex_mask(verts[sl], xs[sl], ys[sl])
        # Samples off the image count neither in the sums nor in the area
        # (the reference clips its ROI to the frame).
        in_x = ((xs[sl] >= 0.0) & (xs[sl] < float(W))).to(torch.float32)
        in_y = ((ys[sl] >= 0.0) & (ys[sl] < float(H))).to(torch.float32)
        m = m * in_y[:, :, None] * in_x[:, None, :]
        mask[sl] = m
        patch = _samples(frames[sl], xs[sl], ys[sl])
        sums[sl] = (patch * m[..., None]).sum((1, 2))
    frac = mask.sum((1, 2))                               # grid cells
    means = sums / frac.clamp(min=1.0)[:, None]
    count = (frac / float(grid * grid) * (x2 - x1).clamp(min=0.0)
             * (y2 - y1).clamp(min=0.0))
    means = torch.where(count[:, None] > 0.0, means, 0.0)
    return means, count
