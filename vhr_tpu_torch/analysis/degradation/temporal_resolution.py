"""Temporal downsampling to target frame rates {60, 30, 25, 15, 10, 5}.

The port's copy of ``vhr_tpu/analysis/degradation/temporal_resolution.py``,
line for line below this docstring: below-original targets only, original
first; without ffmpeg, a constant frame-rate resample (nearest source frame
per output tick) on the host.
"""

from __future__ import annotations

from typing import Generator, Tuple

import numpy as np

from . import common
from ...io import video as vio

TARGET_FPS = [60, 30, 25, 15, 10, 5]


def _resample(input_path: str, out_path, target_fps: float) -> None:
    import cv2
    writer = None
    next_tick = 0.0
    out_idx = 0
    for chunk, fps, start in vio.iter_video_chunks(input_path, 256):
        if writer is None:
            h, w = chunk.shape[1:3]
            writer = cv2.VideoWriter(str(out_path),
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     target_fps, (w, h))
        for i in range(chunk.shape[0]):
            t = (start + i) / fps
            while t >= next_tick - 1e-9:
                writer.write(np.ascontiguousarray(chunk[i]))
                out_idx += 1
                next_tick = out_idx / target_fps
    if writer is not None:
        writer.release()


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    root = common.output_root(input_path, "temporal_resolution")
    _, _, fps, _, _ = vio.video_metadata(input_path)

    yield str(input_path), f"{fps:g}fps"

    for tf in [t for t in TARGET_FPS if t < fps]:
        label = f"{tf}fps"
        out = root / f"{label}.mp4"

        def gen(o=out, t=tf):
            if common.have_ffmpeg():   # reference temporal_resolution.py:36-47
                common.run_ffmpeg(["-i", str(input_path), "-c:v", "libx264",
                                   "-r", str(t), "-pix_fmt", "yuv420p",
                                   str(o)])
            else:
                _resample(input_path, o, float(t))

        yield common.cached_level(out, label, gen)
