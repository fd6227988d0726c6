"""ICA measurement: blind source separation over BGR ROI means.

Port of ``vhr_tpu/analysis/measurement/ica.py``: the reference's contract
(10 s window / 5 s acquisition, FastICA with convergence-skip,
best-component FFT peak) as ``pipeline.offline.measure_ica``.
"""

from __future__ import annotations

import numpy as np

from . import read_frames
from .. import context
from ...config import ICAConfig, PipelineConfig
from ...pipeline import offline


def measure(video_path: str) -> np.ndarray:
    frames, fps = read_frames(video_path)
    if frames.shape[0] == 0:
        return np.empty((0, 2))
    ts, bpm, valid = offline.measure_ica(
        frames, fps, PipelineConfig(), ICAConfig(),
        detector=context.current_detector(),
        detect_every=context.current_detect_every())
    return offline.to_measurement_array(ts, bpm, valid)
