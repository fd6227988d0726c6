"""Synthetic rPPG video generation (host-side numpy).

The port's own copy of ``vhr_tpu/utils/synth.py``, line for line below
this docstring (``tests/test_torch_imports.py`` pins it equal): an
elliptical skin-tone "face" whose green channel pulses at a prescribed BPM
(plus optional motion, drift and sensor noise), with the ground-truth face
box and pulse waveform returned alongside the pixels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["SynthSpec", "SynthVideo", "synthesize",
           "FaceSpec", "MultiSynthVideo", "synthesize_multi"]


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    height: int = 144
    width: int = 176
    fps: float = 30.0
    duration_s: float = 40.0
    bpm: float = 72.0
    pulse_amplitude: float = 2.0        # green-channel peak amplitude (u8 units)
    skin_bgr: Tuple[float, float, float] = (105.0, 135.0, 180.0)
    background_bgr: Tuple[float, float, float] = (60.0, 60.0, 60.0)
    face_center: Tuple[float, float] = (0.5, 0.45)   # (x, y) fractions
    face_radii: Tuple[float, float] = (0.18, 0.28)   # (rx, ry) fractions
    motion_amplitude: float = 0.0       # horizontal sway in pixels
    motion_hz: float = 0.1
    drift_amplitude: float = 0.0        # slow global brightness drift
    drift_hz: float = 0.05
    noise_std: float = 0.0
    hr_drift_bpm: float = 0.0           # linear BPM ramp over the clip
    seed: int = 0
    dropout_frames: Tuple[int, ...] = ()  # frames where the face disappears
    # Multiplicative common-mode illumination flicker (whole image), an
    # in-band confound for the raw green mean: brightness scales by
    # 1 + amp*sin(2*pi*(flicker_bpm/60)*t).  The chrominance projections
    # (dsp.projections) reject it by construction.
    flicker_bpm: Optional[float] = None
    flicker_amp: float = 0.0


@dataclasses.dataclass(frozen=True)
class SynthVideo:
    frames: np.ndarray        # (T, H, W, 3) uint8 BGR
    fps: float
    bpm_truth: np.ndarray     # (T,) instantaneous BPM
    face_boxes: np.ndarray    # (T, 4) int32 [x1, y1, x2, y2] ground truth
    pulse: np.ndarray         # (T,) the injected pulse waveform


def synthesize(spec: SynthSpec) -> SynthVideo:
    rng = np.random.default_rng(spec.seed)
    T = int(round(spec.duration_s * spec.fps))
    H, W = spec.height, spec.width
    t = np.arange(T) / spec.fps

    bpm_t = spec.bpm + spec.hr_drift_bpm * (t / max(t[-1], 1e-9))
    phase = 2.0 * np.pi * np.cumsum(bpm_t / 60.0) / spec.fps
    pulse = np.sin(phase)

    cx = spec.face_center[0] * W + spec.motion_amplitude * np.sin(
        2.0 * np.pi * spec.motion_hz * t)
    cy = np.full(T, spec.face_center[1] * H)
    rx, ry = spec.face_radii[0] * W, spec.face_radii[1] * H

    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.empty((T, H, W, 3), dtype=np.uint8)
    boxes = np.zeros((T, 4), dtype=np.int32)
    drift = spec.drift_amplitude * np.sin(2.0 * np.pi * spec.drift_hz * t)

    bg = np.array(spec.background_bgr, dtype=np.float32)
    skin = np.array(spec.skin_bgr, dtype=np.float32)
    dropout = set(spec.dropout_frames)
    flick = np.ones(T)
    if spec.flicker_bpm is not None:
        flick += spec.flicker_amp * np.sin(
            2.0 * np.pi * (spec.flicker_bpm / 60.0) * t)

    for i in range(T):
        img = np.broadcast_to(bg, (H, W, 3)).astype(np.float32).copy()
        if i not in dropout:
            mask = (((xx - cx[i]) / rx) ** 2 + ((yy - cy[i]) / ry) ** 2) <= 1.0
            color = skin.copy()
            color[1] += spec.pulse_amplitude * pulse[i]   # green pulsates
            img[mask] = color
            ys, xs = np.nonzero(mask)
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
        img *= flick[i]
        img += drift[i]
        if spec.noise_std > 0:
            img += rng.normal(0.0, spec.noise_std, size=img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)

    return SynthVideo(frames=frames, fps=spec.fps, bpm_truth=bpm_t,
                      face_boxes=boxes, pulse=pulse)


@dataclasses.dataclass(frozen=True)
class FaceSpec:
    """One subject in a multi-face clip."""

    center: Tuple[float, float]                       # (x, y) fractions
    bpm: float = 72.0
    radii: Tuple[float, float] = (0.12, 0.18)
    skin_bgr: Tuple[float, float, float] = (105.0, 135.0, 180.0)
    pulse_amplitude: float = 2.0
    dropout_frames: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class MultiSynthVideo:
    frames: np.ndarray        # (T, H, W, 3) uint8 BGR
    fps: float
    bpm_truth: np.ndarray     # (K,) per-face BPM
    face_boxes: np.ndarray    # (T, K, 4) int32 ground truth (x-sorted)


def synthesize_multi(faces: Tuple[FaceSpec, ...],
                     height: int = 144, width: int = 256,
                     fps: float = 30.0, duration_s: float = 40.0,
                     background_bgr: Tuple[float, float, float] = (60.0,) * 3,
                     noise_std: float = 0.0, seed: int = 0
                     ) -> MultiSynthVideo:
    """Several pulsing faces in one clip (multi-subject monitoring fixture;
    the reference configures ``num_faces=2`` at ``rppg_LIVESTREAM.py:308``
    but only ever processes ``face_landmarks[0]``)."""
    rng = np.random.default_rng(seed)
    T = int(round(duration_s * fps))
    H, W = height, width
    t = np.arange(T) / fps
    yy, xx = np.mgrid[0:H, 0:W]
    order = np.argsort([f.center[0] for f in faces])
    faces = tuple(faces[i] for i in order)
    K = len(faces)

    frames = np.empty((T, H, W, 3), dtype=np.uint8)
    boxes = np.zeros((T, K, 4), dtype=np.int32)
    bg = np.array(background_bgr, dtype=np.float32)
    pulses = [np.sin(2.0 * np.pi * (f.bpm / 60.0) * t) for f in faces]

    for i in range(T):
        img = np.broadcast_to(bg, (H, W, 3)).astype(np.float32).copy()
        for k, f in enumerate(faces):
            if i in f.dropout_frames:
                continue
            cx, cy = f.center[0] * W, f.center[1] * H
            rx, ry = f.radii[0] * W, f.radii[1] * H
            mask = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1.0
            color = np.array(f.skin_bgr, np.float32).copy()
            color[1] += f.pulse_amplitude * pulses[k][i]
            img[mask] = color
            ys, xs = np.nonzero(mask)
            boxes[i, k] = [xs.min(), ys.min(), xs.max(), ys.max()]
        if noise_std > 0:
            img += rng.normal(0.0, noise_std, size=img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)

    return MultiSynthVideo(frames=frames, fps=fps,
                           bpm_truth=np.array([f.bpm for f in faces]),
                           face_boxes=boxes)
