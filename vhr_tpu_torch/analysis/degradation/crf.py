"""Lossy-compression sweep at CRF in {25, 30, 35, 40, 45, 51}.

The port's copy of ``vhr_tpu/analysis/degradation/crf.py``, line for line
below this docstring.  With ffmpeg available, levels are true libx264 CRF
encodes; without it, each level falls back to a per-frame JPEG re-encode
whose quality is mapped from the CRF value, a monotone compression-artifact
ladder.
"""

from __future__ import annotations

from typing import Generator, Tuple


from . import common
from ...io import video as vio

CRF_LEVELS = [25, 30, 35, 40, 45, 51]


def _crf_to_jpeg_quality(crf: int) -> int:
    # CRF 0 (lossless) -> ~95, CRF 51 (worst) -> 2; linear in between.
    return max(2, int(round(95 - crf * 1.8)))


def _jpeg_recompress(input_path: str, out_path, crf: int) -> None:
    import cv2
    q = _crf_to_jpeg_quality(crf)
    writer = None
    for chunk, fps, _ in vio.iter_video_chunks(input_path, 128):
        if writer is None:
            h, w = chunk.shape[1:3]
            writer = cv2.VideoWriter(str(out_path),
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
        for f in chunk:
            ok, buf = cv2.imencode(".jpg", f,
                                   [cv2.IMWRITE_JPEG_QUALITY, q])
            writer.write(cv2.imdecode(buf, cv2.IMREAD_COLOR))
    if writer is not None:
        writer.release()


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    root = common.output_root(input_path, "crf")

    yield str(input_path), "original"

    for crf in CRF_LEVELS:
        label = f"crf{crf}"
        out = root / f"{label}.mp4"

        def gen(o=out, c=crf):
            if common.have_ffmpeg():
                common.run_ffmpeg(["-i", input_path, "-c:v", "libx264",
                                   "-crf", str(c), str(o)])
            else:
                _jpeg_recompress(input_path, o, c)

        yield common.cached_level(out, label, gen)
