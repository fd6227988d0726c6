"""Fidelity validation: the port's green-channel measure against the
frame-at-a-time CPU reference and the synthetic clips' truth.

The port's own copy of ``vhr_tpu/validation.py::cpu_reference_green_avg``
(a faithful per-frame numpy port of the reference's deque loop,
``analysis/measurement/green_avg.py``, and FFT peak,
``analysis/utils/estimate_bpm.py``), and the port of
``validate_green_avg``: both pipelines consume the same per-frame ROI
greens, so their difference is the DSP's, and the same estimator fed by the
ground-truth face boxes' ROI isolates the detector's error.
``chip_smoke.py`` holds the port's BPM against the reference on the port's
own green trace.

:func:`main` (``python -m vhr_tpu_torch.validation [--device cpu]``)
writes the port's table to ``VALIDATION_TORCH.md`` in the working
directory, never the JAX package's ``VALIDATION.md``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List

import numpy as np

from .config import BAND_ANALYSIS, HRBand, PipelineConfig
from .utils.synth import SynthSpec, synthesize

__all__ = ["cpu_reference_green_avg", "validate_green_avg",
           "DEFAULT_SPECS", "main"]

# The port's table; the JAX package's is VALIDATION.md.
OUTPUT = "VALIDATION_TORCH.md"


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


def validate_green_avg(specs: List[SynthSpec],
                       cfg: PipelineConfig = PipelineConfig(),
                       device=None) -> List[dict]:
    """Per-clip fidelity record: the port-vs-CPU-reference MAE and the
    MAEs against the truth, keyed as the JAX package's rows
    (``mae_tpu_vs_cpu_reference`` is the port's BPM against the CPU
    reference).  The port runs on ``device``: the CUDA card unless
    ``device="cpu"``."""
    import torch

    from .device import resolve_device
    from .ops import reduce as vreduce
    from .ops import roi as vroi
    from .ops import windows as vwin
    from .pipeline import offline

    dev = resolve_device(device)
    rows = []
    for spec in specs:
        clip = synthesize(spec)
        frames = torch.as_tensor(clip.frames, device=dev)
        trace = offline.extract_signals(frames, cfg)
        green_t = trace.bgr[:, cfg.channel]
        green = green_t.cpu().numpy()
        rolling = vwin.rolling_bpm_fft(
            green_t, clip.fps, cfg.band, cfg.window_len(clip.fps),
            cfg.acquisition_len(clip.fps))
        port_bpm = rolling.bpm.cpu().numpy()
        port_valid = rolling.valid.cpu().numpy()

        # The same estimator fed by the ground-truth face boxes' cheek ROI:
        # the difference is the detector's (ROI placement), not the DSP's.
        H, W = clip.frames.shape[1:3]
        rois_t = vroi.cheek_roi(torch.as_tensor(clip.face_boxes, device=dev),
                                cfg.roi, W, H)
        means_t, _ = vreduce.roi_channel_means(frames, rois_t)
        rolling_t = vwin.rolling_bpm_fft(
            means_t[:, cfg.channel], clip.fps, cfg.band,
            cfg.window_len(clip.fps), cfg.acquisition_len(clip.fps))
        truthroi_bpm = rolling_t.bpm.cpu().numpy()

        ref = cpu_reference_green_avg(green, clip.fps, cfg.window_seconds,
                                      cfg.acquisition_seconds, cfg.band)
        idx = sorted(set(ref) & set(np.nonzero(port_valid)[0].tolist()))
        rows.append({
            "spec": dataclasses.asdict(spec),
            "frames_compared": len(idx),
            "mae_tpu_vs_cpu_reference": float(np.mean(
                [abs(port_bpm[i] - ref[i]) for i in idx])),
            "mae_tpu_vs_truth": float(np.mean(
                [abs(port_bpm[i] - clip.bpm_truth[i]) for i in idx])),
            "mae_cpu_reference_vs_truth": float(np.mean(
                [abs(ref[i] - clip.bpm_truth[i]) for i in idx])),
            "mae_detector_vs_truth_roi": float(np.mean(
                [abs(port_bpm[i] - truthroi_bpm[i]) for i in idx])),
        })
    return rows


DEFAULT_SPECS = [
    SynthSpec(duration_s=45.0, bpm=60.0, noise_std=1.0),
    SynthSpec(duration_s=45.0, bpm=72.0, noise_std=2.0,
              motion_amplitude=3.0),
    SynthSpec(duration_s=45.0, bpm=95.0, noise_std=1.0,
              drift_amplitude=4.0),
    SynthSpec(duration_s=45.0, bpm=130.0, noise_std=0.5),
    SynthSpec(duration_s=45.0, bpm=72.0, noise_std=1.0,
              hr_drift_bpm=10.0),
]


def main(argv=None) -> int:
    """Validate the port on :data:`DEFAULT_SPECS` (the JAX package's five
    clips) and write the table to ``VALIDATION_TORCH.md`` in the working
    directory.  Exit code 0 when the worst MAE against the CPU reference is
    at most 0.5 BPM, as the JAX package's ``main``."""
    import argparse

    import torch

    from .device import resolve_device

    p = argparse.ArgumentParser(
        description="The port's green-channel measure against the "
                    "frame-at-a-time CPU reference")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the CPU")
    rows = validate_green_avg(DEFAULT_SPECS, device=dev)
    lines = [
        "# VALIDATION_TORCH: the PyTorch port against the CPU reference",
        "",
        f"Written by `python -m vhr_tpu_torch.validation`; the port ran on "
        f"{name} (`{dev}`).",
        "",
        "Green-channel (green_avg) pipeline on synthetic clips with known",
        "BPM, the JAX package's `validation.main` table for the port:",
        "",
        "- **MAE vs CPU ref**: both pipelines consume the same per-frame ROI",
        "  greens, so this is the DSP's difference (windowing, FFT, band",
        "  mask, peak pick), not the detector's.",
        "- **det-vs-truth-ROI**: the same estimator fed by the detector's",
        "  ROI against the ground-truth face box's ROI: the error the",
        "  detector brings into the loop.",
        "- **vs truth**: absolute accuracy, estimator limits included.",
        "",
        "(Target: MAE <= 0.5 BPM against the CPU reference.)",
        "",
        "| clip | frames | MAE vs CPU ref | det-vs-truth-ROI "
        "| port vs truth | CPU ref vs truth |",
        "|---|---|---|---|---|---|",
    ]
    worst = 0.0
    for r in rows:
        s = r["spec"]
        label = (f"{s['bpm']:g}bpm n{s['noise_std']:g} "
                 f"m{s['motion_amplitude']:g} d{s['hr_drift_bpm']:g}")
        lines.append(
            f"| {label} | {r['frames_compared']} | "
            f"{r['mae_tpu_vs_cpu_reference']:.4f} | "
            f"{r['mae_detector_vs_truth_roi']:.4f} | "
            f"{r['mae_tpu_vs_truth']:.2f} | "
            f"{r['mae_cpu_reference_vs_truth']:.2f} |")
        worst = max(worst, r["mae_tpu_vs_cpu_reference"])
    lines += ["", f"Worst-case MAE vs CPU reference: **{worst:.4f} BPM** "
              f"(target <= 0.5)."]
    with open(OUTPUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0 if worst <= 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
