"""PSD debugging plots of the stage PSDs that
``analysis/measurement/green_avg_psd.py`` saves.

The port's copy of ``vhr_tpu/utils/psd_plot.py``, line for line below this
docstring: one window's four stage PSDs and the BPM series to a PNG
headless, or stepped interactively (arrow keys step windows, 'a' jumps past
the acquisition, 'x'/Esc closes) where a display is available.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["plot_stage_psds", "plot_interactive"]

STAGES = ["raw", "zscore", "bandpass", "zscore_bandpass"]


def load_stages(npz_path: str) -> Dict[str, np.ndarray]:
    z = np.load(npz_path)
    return {k: z[k] for k in list(z.keys())}


def plot_stage_psds(npz_path: str, measurement: np.ndarray,
                    acquisition_s: float, out_path: str,
                    window_index: int = -1) -> None:
    """Render one window's stage PSDs + the BPM series to a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = load_stages(npz_path)
    freqs = data["freqs"]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8))

    for name in STAGES:
        if name not in data:
            continue
        psd = data[name]
        w = psd.shape[0] + window_index if window_index < 0 else window_index
        p = psd[w]
        ax1.semilogy(freqs, np.maximum(p, 1e-20), lw=1.2, label=name)
    ax1.set_xlabel("Frequency (Hz)")
    ax1.set_ylabel("PSD")
    ax1.set_title(f"Stage PSDs (window {window_index})")
    ax1.set_xlim(0, 4)
    ax1.legend()
    ax1.grid(alpha=0.3)

    if measurement.shape[0]:
        ax2.plot(measurement[:, 0], measurement[:, 1], lw=1.2)
        ax2.axvspan(0, acquisition_s, alpha=0.15, color="gray",
                    label="acquisition")
        ax2.legend()
    ax2.set_xlabel("Time (s)")
    ax2.set_ylabel("BPM")
    ax2.grid(alpha=0.3)

    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def plot_interactive(npz_path: str, measurement: np.ndarray,
                     acquisition_s: float) -> None:  # pragma: no cover - UI
    """Keyboard-driven window stepping (needs a display)."""
    import matplotlib.pyplot as plt

    data = load_stages(npz_path)
    freqs = data["freqs"]
    n_windows = data[STAGES[0]].shape[0]
    state = {"w": 0, "stop": False}

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8))

    def draw():
        ax1.cla()
        for name in STAGES:
            if name in data:
                ax1.semilogy(freqs, np.maximum(data[name][state["w"]], 1e-20),
                             lw=1.2, label=name)
        ax1.set_xlim(0, 4)
        ax1.set_title(f"window {state['w']} / {n_windows - 1} "
                      "(arrows step, 'a' skip acquisition, 'x' quit)")
        ax1.legend()
        ax2.cla()
        if measurement.shape[0]:
            ax2.plot(measurement[:, 0], measurement[:, 1], lw=1.2)
            ax2.axvspan(0, acquisition_s, alpha=0.15, color="gray")
        fig.canvas.draw_idle()

    def on_key(event):
        if event.key in ("x", "escape"):
            state["stop"] = True
            plt.close(fig)
        elif event.key == "a":
            state["w"] = min(n_windows - 1, state["w"] + int(acquisition_s))
        elif event.key == "right":
            state["w"] = min(n_windows - 1, state["w"] + 1)
        elif event.key == "left":
            state["w"] = max(0, state["w"] - 1)
        draw()

    fig.canvas.mpl_connect("key_press_event", on_key)
    draw()
    plt.show()
