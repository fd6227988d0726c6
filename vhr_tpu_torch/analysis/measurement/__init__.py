"""Measurement plugins: video path in, (N, 2) [t_sec, bpm] out.

Each plugin decodes the video on the host (``io.video.read_video``) and
runs its measure on the sweep's device (``analysis.context``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import context
from ...io import video as vio


def read_frames(video_path: str) -> Tuple[torch.Tensor, float]:
    """``(frames (T, H, W, 3) u8 on the sweep's device, fps)`` of a video.

    The device is resolved before the decode, so a sweep meant for the
    card fails at once without one.
    """
    device = context.current_device()
    frames, fps = vio.read_video(video_path)
    return torch.as_tensor(frames, device=device), fps
