"""K2: per-frame ROI channel means on a hand-written CUDA kernel.

Port of ``vhr_tpu/ops/pallas_roi.py::roi_channel_means_pallas``; the kernel
is ``csrc/roi_means.cu``.  A CPU tensor takes the plain version
(:func:`vhr_tpu_torch.ops.reduce.roi_channel_means`); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .reduce import roi_channel_means

__all__ = ["roi_channel_means_cuda", "LAUNCHES"]

# Kernel launches made by roi_channel_means_cuda (CUDA tensors only).
LAUNCHES = 0


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
    if frames.dim() == 3:
        T, H, WC = frames.shape
        C = channels
        if WC % C:
            raise ValueError(f"flat row width {WC} is not a multiple of "
                             f"channels={C}")
        W = WC // C
    elif frames.dim() == 4:
        T, H, W, C = frames.shape
    else:
        raise ValueError(f"frames must be (T,H,W,C) or (T,H,W*C), got "
                         f"{tuple(frames.shape)}")
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
