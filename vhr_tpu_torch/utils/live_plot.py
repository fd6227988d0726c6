"""Live signal plot: raw cheek green, its filtered counterpart and the BPM.

The port's own copy of ``vhr_tpu/utils/live_plot.py``, line for line below
this docstring (``tests/test_torch_imports.py`` pins it equal).  Two
modes: interactive (``show=True``, a pyplot window redrawn every
``redraw_every`` frames) and headless (``show=False`` with ``out_path``:
one summary panel written on ``close()``).  Samples are plain floats
pushed from the host loop; nothing here touches the device.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

__all__ = ["LivePlotter"]


class LivePlotter:
    def __init__(self, maxlen: int = 500, show: bool = False,
                 out_path: Optional[str] = None, redraw_every: int = 5):
        self.raw = deque(maxlen=maxlen)
        self.filt = deque(maxlen=maxlen)
        self.bpm_t: list = []          # (frame_idx, bpm) — full history
        self.show = show
        self.out_path = out_path
        self.redraw_every = max(1, redraw_every)
        self._n = 0
        self._fig = None
        if show:
            import matplotlib.pyplot as plt
            plt.ion()
            self._fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 5))
            (self._line_raw,) = ax1.plot([], [], lw=0.8, label="cheek green")
            (self._line_filt,) = ax1.plot([], [], lw=0.8, label="filtered")
            ax1.legend(loc="upper right")
            (self._line_bpm,) = ax2.plot([], [], lw=1.2)
            ax2.set_ylabel("BPM (Welch)")
            ax2.set_xlabel("frame")
            self._axes = (ax1, ax2)
            self._fig.tight_layout()

    def push(self, raw: float, filt: float, bpm: float,
             bpm_valid: bool) -> None:
        self._n += 1
        self.raw.append(float(raw))
        self.filt.append(float(filt))
        if bpm_valid:
            self.bpm_t.append((self._n, float(bpm)))
        if self.show and self._n % self.redraw_every == 0:
            self._redraw()

    def _redraw(self) -> None:
        import matplotlib.pyplot as plt
        x = np.arange(len(self.raw))
        self._line_raw.set_data(x, np.asarray(self.raw))
        self._line_filt.set_data(x, np.asarray(self.filt))
        if self.bpm_t:
            bt = np.asarray(self.bpm_t)
            self._line_bpm.set_data(bt[:, 0], bt[:, 1])
        for ax in self._axes:              # relim like the reference's
            ax.relim()                     # update_plot (:87-90)
            ax.autoscale_view()
        self._fig.canvas.draw_idle()
        plt.pause(0.001)

    def close(self) -> Optional[str]:
        """Finalize: save the headless summary panel (returns its path) or
        close the interactive window."""
        if self.show and self._fig is not None:
            import matplotlib.pyplot as plt
            plt.ioff()
            plt.close(self._fig)
            return None
        if self.out_path is None:
            return None
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 6))
        x = np.arange(len(self.raw))
        ax1.plot(x, np.asarray(self.raw), lw=0.8, label="cheek green")
        ax1.plot(x, np.asarray(self.filt), lw=0.8, label="filtered")
        ax1.set_ylabel("signal")
        ax1.legend()
        if self.bpm_t:
            bt = np.asarray(self.bpm_t)
            ax2.plot(bt[:, 0], bt[:, 1], lw=1.2)
        ax2.set_ylabel("BPM (Welch)")
        ax2.set_xlabel("frame")
        ax2.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(self.out_path, dpi=150)
        plt.close(fig)
        return self.out_path
