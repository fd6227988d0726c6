"""The served pool's reference: what one fused live step computes for a
slot, tick by tick, over the frames the slot received since it was
attached.

Written from the semantics the port documents at commit 4101bf2:

- **Detection and tracking.**  Kernel K4 advances each slot by one frame
  from the slot's own carry (``vhr_tpu_torch/ops/fused_cuda.py::
  fused_detect_roi_slots_plain``, line 370: per slot, K1's step at
  ``t_len=1``; ``csrc/fused_slots.cu``, lines 336-364, the tracker's
  finish).  At this configuration's settings (every frame detected,
  ungated) a slot's session is one stream of ``skin_fused.py``'s chroma
  test and holdover (``frame_stats``, ``track``) with the cheek ROI's
  means of ``track.py`` (``roi_means``): the frame's ROI is the cheek
  rectangle of the box tracked on the frames before it, its box is this
  frame's detection or the one held.  ``tests/test_torch_pool_reference.py``
  holds the port's pool to this on the CPU.
- **Streaming filter.**  The band-pass Butterworth of ``scipy.signal.
  butter`` (order 4, the band in Hz, second-order sections), pushed one
  sample a tick in direct form II transposed from a zero state, in
  float64.  A tick whose face is not valid gives the filter's output for
  its sample and keeps the state (``pipeline/live.py::_finish_batched``).
- **Rings.**  The raw and filtered samples of the valid ticks; the last
  ``ring_len`` of them are held.
- **Welch.**  Each tick, over the filtered samples held, oldest first:
  segments of ``nperseg = min(ring_len, fps * welch_segment_seconds)``
  samples from the oldest held sample, half overlapping, as many as fit
  (scipy's ``welch`` over the held samples); the mean of the held samples
  removed, then each segment's mean (``detrend="constant"``); a periodic
  Hann window (scipy's default); the mean over segments of the in-band
  bins' power, the band's ends included; the first bin of the largest
  power, times 60.  The BPM is valid once ``nperseg`` samples are held.

Departures:

- the PSD's constant scale (density, one-sided doubling) is left out: it
  multiplies every in-band bin alike and does not move the peak;
- ``precision="bfloat16"`` is the control: the chroma planes and the means
  in bfloat16 (``skin_fused.py``), and every value of the filter and of
  the Welch (its samples, their products and sums) rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from . import dsp, skin_fused
from .executor import no_tf32
from .track import roi_means


def sos(cfg: dict) -> np.ndarray:
    """The live filter's sections: Butterworth band-pass of ``filter_order``
    over ``band_hz`` at ``fps``."""
    lv = cfg["live"]
    return scipy.signal.butter(int(lv["filter_order"]), lv["band_hz"],
                               btype="bandpass", fs=float(cfg["fps"]),
                               output="sos")


def track_slots(recordings: torch.Tensor, cfg: dict,
                chroma: str = "float32", means: str = "float32") -> dict:
    """``(S, T, H, W, 3)`` u8 sessions, each from a fresh slot -> per tick
    ``(S, T, ...)``: ``box`` (this frame's detection, or the box held),
    ``face_valid`` (the track the ROI was taken from), ``means``
    (float64)."""
    S, T, H, W, _ = recordings.shape
    lv = cfg["live"]
    pool = int(lv["detect_row_pool"])
    flat = recordings.reshape(S * T, H, W, 3)
    stats = skin_fused.frame_stats(flat, pool, cfg["skin"], chroma)
    # Slot by slot: an attached slot starts from an all-zero carry, its
    # box too (a flat batch of streams would carry the box over).
    parts = [skin_fused.track(stats[s * T:(s + 1) * T], H, W, T, pool,
                              cfg["skin"], lv["roi"]) for s in range(S)]
    rois, boxes, _, roi_ok = (np.concatenate(a) for a in zip(*parts))
    return {"box": boxes.reshape(S, T, 4),
            "face_valid": roi_ok.reshape(S, T),
            "means": roi_means(flat, rois, means).reshape(S, T, 3)}


def live_tail(green: np.ndarray, face_valid: np.ndarray, cfg: dict,
              precision: str = "float64") -> dict:
    """``(S, T)`` green samples and face validity of sessions from a fresh
    slot -> per tick ``(S, T)``: ``filt`` (the filter's output), ``bpm``,
    ``bpm_valid`` and ``tie`` (the second largest in-band power over the
    largest, 0 where the BPM is not valid)."""
    lv = cfg["live"]
    fps = float(cfg["fps"])
    N = int(lv["ring_len"])
    nperseg = int(min(N, fps * float(lv["welch_segment_seconds"])))
    step = nperseg - nperseg // 2
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / fps)
    lo, hi = lv["band_hz"]
    band = np.nonzero((freqs >= lo) & (freqs <= hi))[0]
    r = (lambda x: x) if precision == "float64" else \
        (lambda x: dsp.round_to(np.asarray(x, np.float64), precision))

    S, T = green.shape
    coef = sos(cfg)
    z = np.zeros((S, coef.shape[0], 2))
    filt = np.zeros((S, T))
    bpm = np.zeros((S, T))
    ok = np.zeros((S, T), bool)
    tie = np.zeros((S, T))
    held = [[] for _ in range(S)]
    for t in range(T):
        x = r(green[:, t].astype(np.float64))
        zn = z.copy()
        for k, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            y = r(r(b0 * x) + z[:, k, 0])
            zn[:, k, 0] = r(r(r(b1 * x) - r(a1 * y)) + z[:, k, 1])
            zn[:, k, 1] = r(r(b2 * x) - r(a2 * y))
            x = y
        filt[:, t] = x
        v = face_valid[:, t]
        z[v] = zn[v]
        for s in np.nonzero(v)[0]:
            held[s] = (held[s] + [x[s]])[-N:]
        for s in range(S):
            if len(held[s]) < nperseg:
                continue
            ring = np.asarray(held[s])
            ring = r(ring - r(ring.mean()))
            n_seg = (len(ring) - nperseg) // step + 1
            power = np.zeros(band.size)
            for i in range(n_seg):
                seg = ring[i * step:i * step + nperseg]
                seg = r(seg - r(seg.mean()))
                spec = np.fft.rfft(r(seg * win))[band]
                power = power + r(spec.real ** 2 + spec.imag ** 2)
            power = r(power / n_seg)
            top = np.argsort(-power, kind="stable")
            bpm[s, t] = freqs[band[top[0]]] * 60.0
            ok[s, t] = True
            tie[s, t] = power[top[1]] / power[top[0]] \
                if band.size > 1 and power[top[0]] > 0 else 0.0
    return {"filt": filt, "bpm": bpm, "bpm_valid": ok, "tie": tie}


def reference(recordings: torch.Tensor, cfg: dict, prec: dict) -> list:
    """``(S, T, H, W, 3)`` u8 sessions -> one dict a session, numpy, per
    tick: ``box``, ``face_valid``, ``means``, ``green_raw``,
    ``green_filtered``, ``bpm``, ``bpm_valid``, ``tie``.  ``prec`` gives
    the ``chroma``, ``means`` and ``estimate`` precisions (the
    configuration's ``precision``, or its ``control``)."""
    with no_tf32():
        det = track_slots(recordings, cfg, prec["chroma"], prec["means"])
    green = det["means"][..., 1]
    est = "float64" if prec["estimate"] == "float32" else prec["estimate"]
    tail = live_tail(green, det["face_valid"], cfg, est)
    return [{"box": det["box"][s], "face_valid": det["face_valid"][s],
             "means": det["means"][s], "green_raw": green[s],
             "green_filtered": tail["filt"][s], "bpm": tail["bpm"][s],
             "bpm_valid": tail["bpm_valid"][s], "tie": tail["tie"][s]}
            for s in range(green.shape[0])]
