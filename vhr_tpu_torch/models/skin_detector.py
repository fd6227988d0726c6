"""Weight-free face localization by skin-chroma segmentation.

Port of ``vhr_tpu/models/skin_detector.py``:

  u8 BGR -> YCbCr chroma box test -> box-filter smoothing -> threshold ->
  bbox from row/column occupancy -> validity from skin-pixel count.

The chroma expressions round as the jitted JAX detector's do on the CPU
(:func:`ycbcr_from_bgr`), and the box filter sums 0/1 values (small
integers, exact in float32) before one division by the border-normalised
window size, so the boxes equal the JAX detector's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["SkinDetectorConfig", "skin_mask", "pooled_skin_mask",
           "detect_faces"]

# Frames per detection step: bounds the float intermediates (about 64 MB per
# 1080p frame) independently of the clip length.
_FRAME_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class SkinDetectorConfig:
    # YCbCr chroma bounds for skin (classic Chai & Ngan style box).
    cb_min: float = 77.0
    cb_max: float = 127.0
    cr_min: float = 133.0
    cr_max: float = 173.0
    y_min: float = 40.0
    smooth: int = 5            # box-filter half-width (pixels)
    threshold: float = 0.5
    min_area_fraction: float = 0.005  # of the frame, else invalid
    # Detect on a k-x reduced frame: "sample" strides the pixel grid,
    # "mean" average-pools k x k cells.
    downsample: int = 1
    pool_mode: str = "sample"


def _fma32(a: float, x: torch.Tensor, c) -> torch.Tensor:
    """float32 ``fma(a, x, c)``: one rounding of the exact ``a*x + c``.

    Computed in float64, where it is exact for the chroma operands (u8
    values or their 1/2^k-pooled means times 24-bit constants, added to
    values below 2^9), and rounded once to float32.
    """
    return (float(np.float32(a)) * x + c).to(torch.float32).to(torch.float64)


def ycbcr_from_bgr(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 Y, Cb, Cr of float32 B, G, R planes.

    Rounds as XLA:CPU evaluates the JAX expressions
    ``y = 0.299 r + 0.587 g + 0.114 b``,
    ``cb = 128 - 0.168736 r - 0.331264 g + 0.5 b`` and
    ``cr = 128 + 0.5 r - 0.418688 g - 0.081312 b`` under ``jit``: LLVM
    contracts them into the fused multiply-adds below.  A different
    rounding moves skin-test decisions at the threshold, and with them box
    edges.  The CUDA kernel K1 uses the same ``fmaf`` chain.
    """
    b, g, r = b.to(torch.float64), g.to(torch.float64), r.to(torch.float64)
    g_term = (float(np.float32(0.587)) * g).to(torch.float32).to(torch.float64)
    y = _fma32(0.114, b, _fma32(0.299, r, g_term))
    cb = _fma32(0.5, b, _fma32(-0.331264, g, _fma32(-0.168736, r, 128.0)))
    cr = _fma32(-0.081312, b, _fma32(-0.418688, g, _fma32(0.5, r, 128.0)))
    return y.to(torch.float32), cb.to(torch.float32), cr.to(torch.float32)


def _bgr_to_ycbcr(frames: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return ycbcr_from_bgr(frames[..., 0].to(torch.float32),
                          frames[..., 1].to(torch.float32),
                          frames[..., 2].to(torch.float32))


def skin_mask(frames: torch.Tensor,
              cfg: SkinDetectorConfig = SkinDetectorConfig()) -> torch.Tensor:
    """Smoothed skin probability in [0, 1], shape ``(T, H, W)``."""
    y, cb, cr = _bgr_to_ycbcr(frames)
    raw = ((cb >= cfg.cb_min) & (cb <= cfg.cb_max) &
           (cr >= cfg.cr_min) & (cr <= cfg.cr_max) &
           (y >= cfg.y_min)).to(torch.float32)
    if cfg.smooth > 0:
        s = cfg.smooth
        # Zero-padded window sums, then the in-frame window size.
        win = F.avg_pool2d(raw[:, None], 2 * s + 1, stride=1, padding=s,
                           count_include_pad=True, divisor_override=1)[:, 0]
        H, W = frames.shape[1], frames.shape[2]
        def in_frame(n):   # window positions inside [0, n) per position
            i = torch.arange(n, device=frames.device)
            return (i + s + 1).clamp(max=n) - (i - s).clamp(min=0)

        norm = (in_frame(H)[:, None] * in_frame(W)[None, :]).to(torch.float32)
        # XLA folds the division by this constant into a multiplication by
        # its float32 reciprocal; the same rounding keeps threshold
        # decisions equal.
        raw = win * (torch.ones_like(norm) / norm)
    return raw


def pooled_skin_mask(frames: torch.Tensor, cfg: SkinDetectorConfig
                     ) -> torch.Tensor:
    """Thresholded skin mask on the (optionally ``downsample``-reduced)
    pixel grid, shape ``(T, H//k, W//k)`` bool."""
    T, H0, W0, _ = frames.shape
    k = cfg.downsample
    if k > 1:
        Hc, Wc = (H0 // k) * k, (W0 // k) * k
        if cfg.pool_mode == "sample":
            frames = frames[:, k // 2:Hc:k, k // 2:Wc:k]
        else:
            # A tensor divisor: CUDA divides by a Python scalar as a
            # multiplication by its reciprocal.  Filled on the device: a
            # copy from the host would wait for the card's queue.
            div = torch.full((), float(k * k), device=frames.device)
            frames = (frames[:, :Hc, :Wc].reshape(T, Hc // k, k, Wc // k, k, 3)
                      .to(torch.float32).sum((2, 4)) / div)
    return skin_mask(frames, cfg) >= cfg.threshold


def _detect_chunk(frames: torch.Tensor, cfg: SkinDetectorConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    T, H0, W0, _ = frames.shape
    k = cfg.downsample
    mask = pooled_skin_mask(frames, cfg)                   # (T, H, W)
    _, H, W = mask.shape
    dev = frames.device
    col_any = mask.any(dim=1)                              # (T, W)
    row_any = mask.any(dim=2)                              # (T, H)
    col_idx = torch.arange(W, device=dev).expand(T, W)
    row_idx = torch.arange(H, device=dev).expand(T, H)
    x1 = torch.where(col_any, col_idx, W).amin(dim=1)
    x2 = torch.where(col_any, col_idx, -1).amax(dim=1)
    y1 = torch.where(row_any, row_idx, H).amin(dim=1)
    y2 = torch.where(row_any, row_idx, -1).amax(dim=1)
    area = mask.reshape(T, -1).sum(dim=1).to(torch.float32)
    thresh = torch.full((), cfg.min_area_fraction * (H * W),
                        dtype=torch.float32, device=dev)
    valid = area >= thresh
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32)
    if k > 1:
        # Scale pooled-grid coords back to pixels (outer pixel of each cell).
        boxes = torch.stack([boxes[..., 0] * k, boxes[..., 1] * k,
                             boxes[..., 2] * k + (k - 1),
                             boxes[..., 3] * k + (k - 1)], dim=-1)
        boxes = torch.stack([boxes[..., 0].clamp(max=W0 - 1),
                             boxes[..., 1].clamp(max=H0 - 1),
                             boxes[..., 2].clamp(max=W0 - 1),
                             boxes[..., 3].clamp(max=H0 - 1)], dim=-1)
    boxes = torch.where(valid[:, None], boxes, 0).to(torch.int32)
    return boxes, valid


def detect_faces(frames: torch.Tensor,
                 cfg: SkinDetectorConfig = SkinDetectorConfig()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame face boxes from skin occupancy.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
    Returns:
      ``(boxes, valid)`` — ``(T, 4)`` int32 ``[x1, y1, x2, y2]`` (inclusive
      ends) and ``(T,)`` bool.  Frames are processed ``_FRAME_CHUNK`` at a
      time.
    """
    parts = [_detect_chunk(frames[s:s + _FRAME_CHUNK], cfg)
             for s in range(0, frames.shape[0], _FRAME_CHUNK)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
