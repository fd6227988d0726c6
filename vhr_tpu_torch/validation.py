"""The frame-at-a-time CPU reference of the green-channel measure.

The port's own copy of ``vhr_tpu/validation.py::cpu_reference_green_avg``:
a faithful per-frame numpy port of the reference's deque loop
(``analysis/measurement/green_avg.py``) and FFT peak
(``analysis/utils/estimate_bpm.py``).  ``chip_smoke.py`` holds the port's
BPM against it on the port's own green trace.
"""

from __future__ import annotations

from collections import deque
from typing import Dict

import numpy as np

from .config import BAND_ANALYSIS, HRBand

__all__ = ["cpu_reference_green_avg"]


def cpu_reference_green_avg(green: np.ndarray, fps: float,
                            window_s: float = 30.0, acq_s: float = 10.0,
                            band: HRBand = BAND_ANALYSIS) -> Dict[int, float]:
    """Frame-at-a-time CPU pipeline on a green trace (the reference's deque
    loop + FFT peak), returning {frame: bpm}."""
    window_len = int(window_s * fps)
    acq_len = int(acq_s * fps)
    dq = deque(maxlen=window_len)
    out: Dict[int, float] = {}
    for i, v in enumerate(green):
        dq.append(float(v))
        if len(dq) < acq_len:
            continue
        sig = np.asarray(dq, dtype=np.float32)
        sig = (sig - np.mean(sig)).astype(np.float64)
        N = len(sig)
        if N < 8:
            continue
        freqs = np.fft.fftfreq(N, d=1.0 / fps)
        mags = np.abs(np.fft.fft(sig))
        pos = freqs > 0
        fp, mp = freqs[pos], mags[pos]
        mask = (fp >= band.low_hz) & (fp <= band.high_hz)
        if not mask.any():
            continue
        out[i] = float(fp[mask][np.argmax(mp[mask])] * 60.0)
    return out
