"""Canonical measurement: cheek-ROI green mean -> rolling FFT BPM.

Port of ``vhr_tpu/analysis/measurement/green_avg.py``: the reference's
contract (30 s rolling window, 10 s acquisition, per-frame timestamps,
(N, 2) result) as ``pipeline.offline.measure_green_avg`` in its plain form
(the JAX plugin's XLA form).
"""

from __future__ import annotations

import numpy as np

from . import read_frames
from .. import context
from ...config import PipelineConfig
from ...pipeline import offline

WINDOW_SIZE = 30.0
ACQUISITION_TIME = 10.0


def measure(video_path: str) -> np.ndarray:
    frames, fps = read_frames(video_path)
    if frames.shape[0] == 0:
        return np.empty((0, 2))
    cfg = PipelineConfig(window_seconds=WINDOW_SIZE,
                         acquisition_seconds=ACQUISITION_TIME)
    ts, bpm, valid = offline.measure_green_avg(
        frames, fps, cfg,
        detector=context.current_detector(),
        detect_every=context.current_detect_every())
    return offline.to_measurement_array(ts, bpm, valid)
