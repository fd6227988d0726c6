"""Shared machinery for degradation plugins.

The port's copy of ``vhr_tpu/analysis/degradation/common.py``, line for
line below this docstring.  Pixel-domain corruptions (noise, quantisation,
resizing) run as batched ops on the sweep's device, one chunk of frames at
a time (``per_frame_device_op``); encode-domain corruptions use host codecs
(ffmpeg if present, OpenCV writers otherwise).  Every level is cached on
disk keyed by video + label and skipped when present, matching the
reference's idempotency contract (e.g. ``colour_noise.py:47-48``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

from ...io import video as vio

__all__ = ["output_root", "cached_level", "per_frame_device_op",
           "have_ffmpeg", "run_ffmpeg"]

def output_root(input_path: str, kind: str) -> Path:
    results_dir = os.environ.get("VHR_RESULTS_DIR", "results")
    base = Path(input_path).stem
    root = Path(results_dir) / base / "degraded" / kind
    root.mkdir(parents=True, exist_ok=True)
    return root


def cached_level(out_path: Path, label: str,
                 generate: Callable[[], None]) -> Tuple[str, str]:
    """Generate ``out_path`` unless it already exists; yield contract tuple."""
    if not out_path.exists():
        generate()
    return str(out_path), label


def per_frame_device_op(input_path: str, out_path: Path,
                        op: Callable[[np.ndarray], np.ndarray],
                        fps_override: Optional[float] = None,
                        chunk_frames: int = 256) -> None:
    """Stream a video through a batched on-device op and re-encode.

    ``op`` maps a ``(T, H, W, 3)`` uint8 chunk to a uint8 chunk (typically a
    jitted JAX function); chunking bounds device memory for long videos.
    """
    import cv2
    writer = None
    try:
        for chunk, fps, _ in vio.iter_video_chunks(input_path, chunk_frames):
            out = np.asarray(op(chunk))
            if writer is None:
                h, w = out.shape[1:3]
                writer = cv2.VideoWriter(
                    str(out_path), cv2.VideoWriter_fourcc(*"mp4v"),
                    fps_override or fps, (w, h))
            for f in out:
                writer.write(np.ascontiguousarray(f))
    finally:
        if writer is not None:
            writer.release()


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def run_ffmpeg(args: list) -> None:
    subprocess.run(["ffmpeg", "-y", "-loglevel", "error"] + args, check=True)
