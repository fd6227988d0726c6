"""Codec-matrix re-encoding: MJPEG / H.264-class / lossless.

The port's copy of ``vhr_tpu/analysis/degradation/encoding.py``, line for
line below this docstring.  With an ffmpeg binary, levels use the
reference's codec commands (mjpeg q31 yuvj444p / libx264 crf28 yuv420p /
ffv1 rgb24); without one, codecs resolve against what the host OpenCV build
provides, and unavailable entries are skipped with a notice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Generator, Tuple

import numpy as np

from . import common
from ...io import video as vio

# (label, cv2 fourcc + ext fallback, ffmpeg args + ext) — the ffmpeg halves
# mirror the reference codec matrix (encoding.py:7-20).
CODECS = [
    ("mjpeg", "MJPG", ".avi",
     ["-c:v", "mjpeg", "-q:v", "31", "-pix_fmt", "yuvj444p"], ".avi"),
    ("h264", "avc1", ".mp4",
     ["-c:v", "libx264", "-crf", "28", "-pix_fmt", "yuv420p"], ".mp4"),
    ("lossless", "FFV1", ".avi",
     ["-c:v", "ffv1", "-pix_fmt", "rgb24"], ".mkv"),
]


def _reencode(input_path: str, out_path: Path, fourcc: str) -> bool:
    import cv2
    writer = None
    ok = True
    for chunk, fps, _ in vio.iter_video_chunks(input_path, 128):
        if writer is None:
            h, w = chunk.shape[1:3]
            writer = cv2.VideoWriter(str(out_path),
                                     cv2.VideoWriter_fourcc(*fourcc),
                                     fps, (w, h))
            if not writer.isOpened():
                ok = False
                break
        for f in chunk:
            writer.write(np.ascontiguousarray(f))
    if writer is not None:
        writer.release()
    if not ok and out_path.exists():
        out_path.unlink()
    return ok


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    root = common.output_root(input_path, "encoding")

    yield str(input_path), "original"

    use_ff = common.have_ffmpeg()
    for label, fourcc, ext, ff_args, ff_ext in CODECS:
        out = root / f"{label}{ff_ext if use_ff else ext}"
        if out.exists():
            yield str(out), label
            continue
        if use_ff:
            common.run_ffmpeg(["-i", str(input_path)] + ff_args + [str(out)])
            yield str(out), label
        elif _reencode(input_path, out, fourcc):
            yield str(out), label
        else:
            print(f"[encoding] codec {label} ({fourcc}) unavailable; skipped")
