"""App-style measurement: 10 s window, zero-phase bandpass, Welch PSD peak.

Port of ``vhr_tpu/analysis/measurement/app_welch.py``: the interactive
app's analysis loop (``rppg_VIDEO.py:392-415``) as a measurement plugin.
"""

from __future__ import annotations

import numpy as np

from . import read_frames
from .. import context
from ...config import BAND_VIDEO, FilterConfig, PipelineConfig
from ...pipeline import offline


def measure(video_path: str) -> np.ndarray:
    frames, fps = read_frames(video_path)
    if frames.shape[0] == 0:
        return np.empty((0, 2))
    cfg = PipelineConfig(window_seconds=10.0, band=BAND_VIDEO,
                         filter=FilterConfig(kind="cheby2", order=4))
    ts, bpm, valid = offline.measure_app_welch(
        frames, fps, cfg,
        detector=context.current_detector(),
        detect_every=context.current_detect_every())
    return offline.to_measurement_array(ts, bpm, valid)
