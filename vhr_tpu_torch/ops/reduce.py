"""Per-frame ROI channel means (plain PyTorch).

Port of ``vhr_tpu/ops/reduce.py::roi_channel_means``, and the plain version
of the K2 and K3 kernels (``ops/roi_means_cuda.py``).  The masked sums are
taken in float64, where sums of u8 pixels are exact integers, so the result
is independent of summation order and equals the kernels' integer sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["roi_channel_means", "frame_layout"]

# Frames reduced per step: bounds the float64 copy (16 frames of 1080p BGR
# are 0.8 GB) independently of the clip length.
_FRAME_CHUNK = 16


def frame_layout(frames: torch.Tensor, channels: int = 3,
                 width: Optional[int] = None) -> Tuple[int, int, int, int]:
    """``(T, H, W, C)`` of ``(T, H, W, C)`` frames, or of flat ``(T, H,
    row_bytes)`` frames whose rows hold ``W * channels`` interleaved pixel
    bytes and then padding (``width`` gives ``W``; it defaults to
    ``row_bytes // channels``, which must then divide evenly)."""
    if frames.dim() == 4:
        return tuple(frames.shape)
    if frames.dim() != 3:
        raise ValueError(f"frames must be (T,H,W,C) or (T,H,row_bytes), got "
                         f"{tuple(frames.shape)}")
    T, H, row_bytes = frames.shape
    if width is None:
        if row_bytes % channels:
            raise ValueError(f"flat row width {row_bytes} is not a multiple "
                             f"of channels={channels}; pass width")
        width = row_bytes // channels
    if width < 0 or width * channels > row_bytes:
        raise ValueError(f"width {width} x {channels} channels does not fit "
                         f"a row of {row_bytes} bytes")
    return T, H, width, channels


def roi_channel_means(frames: torch.Tensor, rois: torch.Tensor,
                      channels: int = 3, width: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of each color channel over a per-frame ROI rectangle.

    Args:
      frames: ``(T, H, W, C)`` uint8 (or float), or flat ``(T, H,
        row_bytes)`` with padded rows (:func:`frame_layout`).
      rois: ``(T, 4)`` int ``[x1, y1, x2, y2]`` (x2/y2 exclusive).  Pixels
        outside the frame contribute nothing; ``count`` is the unclipped
        area.

    Returns:
      ``(means, count)`` — ``(T, C)`` float32 channel means (0 where the ROI
      is empty) and ``(T,)`` float32 pixel counts.
    """
    T, H, W, C = frame_layout(frames, channels, width)
    if frames.dim() == 3:
        frames = frames[..., :W * C].reshape(T, H, W, C)
    dev = frames.device
    rois = rois.to(device=dev, dtype=torch.int64)
    x1, y1, x2, y2 = rois.unbind(-1)
    rows = torch.arange(H, device=dev)[None, :]
    cols = torch.arange(W, device=dev)[None, :]
    row_m = ((rows >= y1[:, None]) & (rows < y2[:, None])).to(torch.float64)
    col_m = ((cols >= x1[:, None]) & (cols < x2[:, None])).to(torch.float64)
    sums = torch.empty((T, C), dtype=torch.float64, device=dev)
    for s in range(0, T, _FRAME_CHUNK):
        e = min(s + _FRAME_CHUNK, T)
        fr = frames[s:e].to(torch.float64)
        partial = torch.einsum("thwc,tw->thc", fr, col_m[s:e])
        sums[s:e] = torch.einsum("thc,th->tc", partial, row_m[s:e])
    count = ((y2 - y1).clamp(min=0) * (x2 - x1).clamp(min=0)).to(torch.float32)
    means = sums.to(torch.float32) / count.clamp(min=1.0)[:, None]
    return means, count
