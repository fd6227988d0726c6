"""Per-frame ROI channel means and frame statistics (plain PyTorch).

Port of ``vhr_tpu/ops/reduce.py``: ``roi_channel_means`` (the plain
version of the K2 and K3 kernels, ``ops/roi_means_cuda.py``),
``roi_channel_means_multi`` (K ROIs a frame, which the JAX package also
computes in XLA, outside any Pallas kernel), and ``bpp.py``'s per-frame
statistics (``grayscale_u8``, ``frame_entropy``, ``frame_noise_variance``,
``frame_nsr``, ``video_stats``).  The masked sums are taken in float64,
where sums of u8 pixels are exact integers, so the result is independent of
summation order and equals the kernels' integer sums; the statistics take
their pixel sums in int64, exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["roi_channel_means", "roi_channel_means_multi", "frame_layout",
           "grayscale_u8", "frame_entropy", "frame_noise_variance",
           "frame_nsr", "FrameStats", "video_stats"]

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


def roi_channel_means_multi(frames: torch.Tensor, rois: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K ROIs a frame: ``frames (T, H, W, C)``, ``rois (T, K, 4)`` ``[x1,
    y1, x2, y2]`` (exclusive ends) -> ``(means (T, K, C) float32, count (T,
    K) float32)``, equal to K calls of :func:`roi_channel_means`.  The K
    column masks join one product over each chunk of frames, so the frames
    are read once whatever K is."""
    T, H, W, C = frames.shape
    dev = frames.device
    rois = rois.to(device=dev, dtype=torch.int64)
    x1, y1, x2, y2 = rois.unbind(-1)                           # (T, K)
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    row_m = ((rows >= y1[..., None]) & (rows < y2[..., None])
             ).to(torch.float64)                               # (T, K, H)
    col_m = ((cols >= x1[..., None]) & (cols < x2[..., None])
             ).to(torch.float64)                               # (T, K, W)
    sums = torch.empty((T, rois.shape[1], C), dtype=torch.float64,
                       device=dev)
    for s in range(0, T, _FRAME_CHUNK):
        e = min(s + _FRAME_CHUNK, T)
        fr = frames[s:e].to(torch.float64)
        partial = torch.einsum("thwc,tkw->tkhc", fr, col_m[s:e])
        sums[s:e] = torch.einsum("tkhc,tkh->tkc", partial, row_m[s:e])
    count = ((y2 - y1).clamp(min=0) * (x2 - x1).clamp(min=0)).to(torch.float32)
    means = sums.to(torch.float32) / count.clamp(min=1.0)[..., None]
    return means, count


# --- bpp.py's per-frame statistics ----------------------------------------

def grayscale_u8(frames: torch.Tensor) -> torch.Tensor:
    """BGR uint8 ``(..., 3)`` -> gray uint8 with OpenCV's fixed-point
    weights: ``cv2.cvtColor(f, COLOR_BGR2GRAY)`` is ``(R*9798 + G*19235 +
    B*3735 + 16384) >> 15``, bit for bit."""
    b = frames[..., 0].to(torch.int32)
    g = frames[..., 1].to(torch.int32)
    r = frames[..., 2].to(torch.int32)
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).to(torch.uint8)


def _histogram256(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame 256-bin histogram of ``(T, H, W)`` uint8 -> ``(T, 256)``
    int64 counts: one ``bincount`` over ``frame * 256 + gray`` (a one-hot
    of a 1080p frame would take 2 GB)."""
    T = gray.shape[0]
    frame = torch.arange(T, device=gray.device)[:, None] * 256
    key = (gray.reshape(T, -1).to(torch.int64) + frame).reshape(-1)
    return torch.bincount(key, minlength=T * 256).reshape(T, 256)


def frame_entropy(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame grayscale entropy (``bpp.py:34-46``): the normalized
    256-bin histogram ``p``, ``-sum(p * log2(p + 1e-6))``, in float64 from
    the exact counts, as float32."""
    hist = _histogram256(gray).to(torch.float64)
    p = hist / hist.sum(-1, keepdim=True)
    return (-(p * torch.log2(p + 1e-6)).sum(-1)).to(torch.float32)


def _moments(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame ``(mean, variance)`` of ``(T, H, W)`` uint8 as float64,
    from exact int64 sums of the pixels and of their squares."""
    g = gray.reshape(gray.shape[0], -1).to(torch.int64)
    n = g.shape[1]
    s1 = g.sum(-1)
    s2 = (g * g).sum(-1)
    # n * sum(x^2) - sum(x)^2 = n^2 var, exact in int64 below 2^63 (a
    # 1080p frame's is at most about 2.7e17).
    var = (n * s2 - s1 * s1).to(torch.float64) / float(n * n)
    return s1.to(torch.float64) / n, var


def frame_noise_variance(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame pixel variance (``bpp.py:83-91``), float32."""
    return _moments(gray)[1].to(torch.float32)


def _nsr(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    return torch.where(mean == 0, torch.zeros_like(mean),
                       var.sqrt() / mean.clamp(min=1e-30)).to(torch.float32)


def frame_nsr(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame noise-to-signal ratio std/mean (``bpp.py:128-140``), 0
    where the mean is 0; float32."""
    return _nsr(*_moments(gray))


class FrameStats(NamedTuple):
    entropy: torch.Tensor
    noise_variance: torch.Tensor
    nsr: torch.Tensor


def video_stats(frames: torch.Tensor) -> FrameStats:
    """Every per-frame statistic of ``(T, H, W, 3)`` BGR uint8 frames,
    ``_FRAME_CHUNK`` frames at a time: ``FrameStats`` of ``(T,)`` float32
    tensors on the frames' device."""
    parts = []
    for s in range(0, frames.shape[0], _FRAME_CHUNK):
        gray = grayscale_u8(frames[s:s + _FRAME_CHUNK])
        mean, var = _moments(gray)
        parts.append((frame_entropy(gray), var.to(torch.float32),
                      _nsr(mean, var)))
    if not parts:
        empty = torch.zeros((0,), dtype=torch.float32, device=frames.device)
        return FrameStats(empty, empty, empty)
    return FrameStats(*(torch.cat(p) for p in zip(*parts)))
