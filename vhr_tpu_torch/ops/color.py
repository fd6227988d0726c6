"""Batched colorspace conversions (plain PyTorch).

Port of ``vhr_tpu/ops/color.py``: colorsys's NTSC YIQ coefficients, applied
to float32 tensors (Python scalars times a float32 tensor round in float32,
as JAX's weakly typed constants do), and the planar YUV 4:2:0 (I420) side
of ingest: :func:`i420_to_bgr_flat` rebuilds BGR frames bit for bit as
``cv2.COLOR_YUV2BGR_I420`` does, and :func:`i420_roi_means` takes BGR
channel means over per-frame ROIs straight from the planes.  Both work in
slices of frames, so their intermediates stay bounded whatever the chunk's
length (eager PyTorch does not fuse the expressions as XLA does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rgb_to_yiq", "yiq_to_rgb", "bgr_u8_to_yiq", "yiq_to_bgr_u8",
           "i420_to_bgr_flat", "i420_roi_means"]

# OpenCV's ITU-R BT.601 studio-swing fixed-point constants (20-bit descale:
# CY=1.164, CUB=2.018, CUG=-0.391, CVG=-0.813, CVR=1.596), kept as the exact
# integers so the reconstruction equals cv2.COLOR_YUV2BGR_I420 bit for bit.
_CY, _CUB, _CUG, _CVG, _CVR = 1220542, 2116026, -409993, -852492, 1673527
# Frames converted per step: 8 frames of 1080p hold ~0.5 GB of int32
# intermediates.
_FRAME_CHUNK = 8


def _planes(chunk: torch.Tensor, h: int, w: int):
    """``(Y (n, h, w), U (n, h/2, w/2), V)`` views of ``(n, ...)`` planar
    I420 frames whose first ``h*w*3//2`` bytes hold Y, then U, then V."""
    n = chunk.shape[0]
    flat = chunk.reshape(n, -1)
    ysz, csz = h * w, (h // 2) * (w // 2)
    if flat.shape[1] < ysz + 2 * csz:
        raise ValueError(f"an I420 frame of {w}x{h} needs {ysz + 2 * csz} "
                         f"bytes, got {flat.shape[1]}")
    return (flat[:, :ysz].reshape(n, h, w),
            flat[:, ysz:ysz + csz].reshape(n, h // 2, w // 2),
            flat[:, ysz + csz:ysz + 2 * csz].reshape(n, h // 2, w // 2))


def i420_to_bgr_flat(chunk: torch.Tensor, h: int, w: int,
                     w_out: Optional[int] = None) -> torch.Tensor:
    """Planar YUV 4:2:0 bytes -> flat interleaved BGR.

    ``chunk`` is ``(n, H*3//2, W)`` or ``(n, stride)`` uint8 whose first
    ``h*w*3//2`` bytes a frame hold Y ``(h, w)``, then U and V ``(h/2,
    w/2)`` each (``io.video.ChunkReader(fmt="i420")``'s layout).  Chroma is
    replicated over each 2x2 block and the studio-swing BT.601 matrix
    applied in int32 fixed point: equal bit for bit to
    ``cv2.COLOR_YUV2BGR_I420``.

    Returns ``(n, h, w_out*3)`` uint8 (``w_out`` defaults to ``w``; columns
    past ``w`` are zero, the padded width the fused kernels take).
    """
    w_out = w if w_out is None else w_out
    if w_out < w:
        raise ValueError(f"w_out={w_out} is narrower than the frame ({w})")
    y, u, v = _planes(chunk, h, w)
    n = y.shape[0]
    out = torch.zeros((n, h, w_out, 3), dtype=torch.uint8,
                      device=chunk.device)
    half = 1 << 19
    for s in range(0, n, _FRAME_CHUNK):
        e = min(s + _FRAME_CHUNK, n)

        def up(c):
            c = c[s:e].to(torch.int32) - 128
            return c.repeat_interleave(2, 1).repeat_interleave(2, 2)

        up_, vp = up(u), up(v)
        yv = (y[s:e].to(torch.int32) - 16).clamp_(min=0) * _CY
        b = (yv + _CUB * up_ + half) >> 20
        g = (yv + _CUG * up_ + _CVG * vp + half) >> 20
        r = (yv + _CVR * vp + half) >> 20
        out[s:e, :, :w] = torch.stack([b, g, r], -1).clamp_(0, 255).to(
            torch.uint8)
    return out.reshape(n, h, w_out * 3)


def _masked_plane_sums(plane: torch.Tensor, x1, y1, x2, y2, offset: float,
                       relu: bool) -> torch.Tensor:
    """Exact float64 sums of ``pre(plane)`` over each frame's box, with
    ``pre(p) = p - offset`` (clamped at 0 when ``relu``), in slices of
    frames."""
    T, hh, ww = plane.shape
    dev = plane.device
    rows = torch.arange(hh, device=dev)[None, :]
    cols = torch.arange(ww, device=dev)[None, :]
    row_m = ((rows >= y1[:, None]) & (rows < y2[:, None])).to(torch.float64)
    col_m = ((cols >= x1[:, None]) & (cols < x2[:, None])).to(torch.float64)
    sums = torch.empty((T,), dtype=torch.float64, device=dev)
    for s in range(0, T, _FRAME_CHUNK):
        e = min(s + _FRAME_CHUNK, T)
        fr = plane[s:e].to(torch.float64) - offset
        if relu:
            fr = fr.clamp_(min=0.0)
        part = torch.einsum("thw,tw->th", fr, col_m[s:e])
        sums[s:e] = torch.einsum("th,th->t", part, row_m[s:e])
    return sums


def i420_roi_means(chunk: torch.Tensor, rois: torch.Tensor, h: int, w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BGR channel means over per-frame ROIs, straight from planar I420.

    The reconstruction is affine per pixel, so a region's channel means are
    the same affine map of its plane means: BGR never materializes.  Y
    enters as ``relu(y - 16)`` per pixel (exact), U and V as ``c - 128``
    over the chroma box, which rounds outward (``x1 // 2`` to
    ``ceil(x2 / 2)``): exact for even-aligned boxes, a half-pixel border
    otherwise.  Dropping the per-pixel descale and clip moves a mean by
    under 0.5 u8 unless the ROI holds out-of-gamut pixels.

    The plane sums are exact (float64), then JAX's float32 map in its
    order: each plane mean, then ``(CY*ym + CUB*um) * 2**-20`` and so on,
    clipped to [0, 255], 0 where the count is 0.

    Args:
      chunk: ``(T, H*3//2, W)`` or ``(T, stride)`` uint8 planar frames.
      rois: ``(T, 4)`` int ``[x1, y1, x2, y2]`` (exclusive ends) in
        full-resolution coordinates.
    Returns:
      ``(means (T, 3) float32 BGR, count (T,) float32)``, the contract of
      :func:`vhr_tpu_torch.ops.reduce.roi_channel_means` (``count`` is the
      unclipped area).
    """
    y, u, v = _planes(chunk, h, w)
    rois = rois.to(device=chunk.device, dtype=torch.int64)
    x1, y1, x2, y2 = rois.unbind(-1)
    cx1, cy1 = torch.div(x1, 2, rounding_mode="floor"), \
        torch.div(y1, 2, rounding_mode="floor")
    cx2, cy2 = -torch.div(-x2, 2, rounding_mode="floor"), \
        -torch.div(-y2, 2, rounding_mode="floor")
    f32 = torch.float32
    ysum = _masked_plane_sums(y, x1, y1, x2, y2, 16.0, True).to(f32)
    usum = _masked_plane_sums(u, cx1, cy1, cx2, cy2, 128.0, False).to(f32)
    vsum = _masked_plane_sums(v, cx1, cy1, cx2, cy2, 128.0, False).to(f32)
    yn = ((y2 - y1).clamp(min=0) * (x2 - x1).clamp(min=0)).to(f32)
    un = ((cy2 - cy1).clamp(min=0) * (cx2 - cx1).clamp(min=0)).to(f32)
    ym = torch.div(ysum, yn.clamp(min=1.0))
    um = torch.div(usum, un.clamp(min=1.0))
    vm = torch.div(vsum, un.clamp(min=1.0))
    scale = 1.0 / float(1 << 20)
    b = (_CY * ym + _CUB * um) * scale
    g = (_CY * ym + _CUG * um + _CVG * vm) * scale
    r = (_CY * ym + _CVR * vm) * scale
    means = torch.stack([b, g, r], -1).clamp(0.0, 255.0)
    means = torch.where(yn[:, None] > 0, means, torch.zeros_like(means))
    return means, yn


def rgb_to_yiq(rgb: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` RGB in [0,1] -> YIQ (colorsys.rgb_to_yiq coefficients)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.30 * r + 0.59 * g + 0.11 * b
    i = 0.74 * (r - y) - 0.27 * (b - y)
    q = 0.48 * (r - y) + 0.41 * (b - y)
    return torch.stack([y, i, q], dim=-1)


def yiq_to_rgb(yiq: torch.Tensor) -> torch.Tensor:
    """YIQ -> RGB in [0,1] (colorsys.yiq_to_rgb coefficients + clamp)."""
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    r = y + 0.9468822170900693 * i + 0.6235565819861433 * q
    g = y - 0.27478764629897834 * i - 0.6356910791873801 * q
    b = y - 1.1085450346420322 * i + 1.7090069284064666 * q
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def bgr_u8_to_yiq(frames: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` uint8 BGR -> float32 YIQ in [0,1] luminance scale."""
    rgb = frames.flip(-1).to(torch.float32) / 255.0
    return rgb_to_yiq(rgb)


def yiq_to_bgr_u8(yiq: torch.Tensor) -> torch.Tensor:
    """YIQ -> uint8 BGR, rounding half to even (as ``jnp.round``)."""
    bgr = yiq_to_rgb(yiq).flip(-1)
    return torch.clamp(torch.round(bgr * 255.0), 0, 255).to(torch.uint8)
