"""K2 and K3: per-frame ROI channel means on hand-written CUDA kernels.

K2 (:func:`roi_channel_means_cuda`, ``csrc/roi_means.cu``) is the port of
``vhr_tpu/ops/pallas_roi.py::roi_channel_means_pallas``, one block per
frame; K3 (:func:`roi_channel_means_batched_cuda`,
``csrc/roi_means_batched.cu``) of ``roi_channel_means_pallas_batched``, 8
frames per block, reading rows through a pitch.  Both compute
:func:`vhr_tpu_torch.ops.reduce.roi_channel_means`, their plain version.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .reduce import frame_layout, roi_channel_means

__all__ = ["roi_channel_means_cuda", "roi_channel_means_batched_cuda",
           "LAUNCHES", "BATCHED_LAUNCHES"]

# Kernel launches made by roi_channel_means_cuda (K2) and
# roi_channel_means_batched_cuda (K3), CUDA tensors only.
LAUNCHES = 0
BATCHED_LAUNCHES = 0


def roi_channel_means_cuda(frames: torch.Tensor, rois: torch.Tensor,
                           channels: int = 3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROI channel means via the K2 kernel.

    Args:
      frames: ``(T, H, W, C)`` uint8, or flat ``(T, H, W*C)`` with
        ``channels`` giving the interleave.
      rois: ``(T, 4)`` int ``[x1, y1, x2, y2]`` (exclusive ends); reads are
        clamped to the frame, ``count`` is the unclipped area.

    Returns:
      ``(means (T, C) float32, count (T,) float32)``, equal to
      :func:`vhr_tpu_torch.ops.reduce.roi_channel_means`.
    """
    T, H, W, C = frame_layout(frames, channels)
    if tuple(rois.shape) != (T, 4):
        raise ValueError(f"rois must be ({T}, 4), got {tuple(rois.shape)}")
    if frames.device.type == "cpu":
        return roi_channel_means(frames.reshape(T, H, W, C), rois.cpu())
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"K2 takes uint8 frames, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("K2 needs contiguous frames")
    rois = rois.to(device=frames.device, dtype=torch.int32).contiguous()
    means = torch.empty((T, C), dtype=torch.float32, device=frames.device)
    count = torch.empty((T,), dtype=torch.float32, device=frames.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    global LAUNCHES
    LAUNCHES += 1
    _build.check(lib.vhr_roi_means_u8(frames.data_ptr(), rois.data_ptr(),
                                      None, 0, means.data_ptr(),
                                      count.data_ptr(), T, H, W, C, stream),
                 "roi_channel_means_cuda")
    return means, count


def roi_channel_means_batched_cuda(frames: torch.Tensor, rois: torch.Tensor,
                                   channels: int = 3,
                                   width: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROI channel means via the K3 kernel, one launch for any ``T``.

    Args:
      frames: ``(T, H, W, C)`` uint8, or flat ``(T, H, row_bytes)`` uint8
        whose rows hold ``W * channels`` pixel bytes and then padding
        (``width`` gives ``W``, see
        :func:`vhr_tpu_torch.ops.reduce.frame_layout`).  Frames and rows may
        be strided (a padded reader buffer needs no copy); each row's bytes
        must be contiguous.
      rois: ``(T, 4)`` int ``[x1, y1, x2, y2]`` (exclusive ends); reads are
        clamped to the frame, ``count`` is the unclipped area.

    Returns:
      ``(means (T, C) float32, count (T,) float32)``, equal to
      :func:`vhr_tpu_torch.ops.reduce.roi_channel_means`.
    """
    T, H, W, C = frame_layout(frames, channels, width)
    if tuple(rois.shape) != (T, 4):
        raise ValueError(f"rois must be ({T}, 4), got {tuple(rois.shape)}")
    if frames.device.type == "cpu":
        return roi_channel_means(frames, rois.cpu(), channels, width)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"K3 takes uint8 frames, got {frames.dtype}")
    if not 1 <= C <= 4:
        raise ValueError(f"K3 takes 1 to 4 channels, got {C}")
    inner = (1,) if frames.dim() == 3 else (C, 1)
    if tuple(frames.stride()[2:]) != inner and H * W > 0:
        raise ValueError("K3 needs each row's bytes contiguous")
    # The kernel indexes (row, 16-byte vector) pairs of a ROI in int32.
    if H * ((W * C + 15) // 16 + 1) >= 2 ** 31:
        raise ValueError(f"frame {H}x{W}x{C} too large for K3")
    rois = rois.to(device=frames.device, dtype=torch.int32).contiguous()
    means = torch.empty((T, C), dtype=torch.float32, device=frames.device)
    count = torch.empty((T,), dtype=torch.float32, device=frames.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    _build.check(lib.vhr_roi_means_batched_u8(
        frames.data_ptr(), frames.stride(0), frames.stride(1),
        rois.data_ptr(), means.data_ptr(), count.data_ptr(), T, H, W, C,
        stream), "roi_channel_means_batched_cuda")
    return means, count
