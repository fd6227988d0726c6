"""The offline measures: whole-clip and streaming.

Port of ``vhr_tpu/pipeline/offline.py``.  The main path is the
green-channel measure:

  uint8 frames (T, H, W, 3) -> skin-chroma face box -> <=15-frame holdover
  -> cheek ROI -> per-frame BGR means -> forward-fill -> rolling FFT BPM
  -> (ts, bpm, valid)

and the other measures share its front end and change the pulse or the
estimator: the chrominance projections (:func:`measure_projection`), the
per-window best of them (:func:`measure_adaptive`), FastICA
(:func:`measure_ica`) and the interactive app's filtered Welch loop
(:func:`measure_app_welch`).  The front end runs

in two forms: the detect-then-reduce form (:func:`extract_signals`,
with the K2 ROI kernel under ``use_pallas="roi"``) and the fused form
(:func:`extract_signals_fused`, kernel K1).  ``use_pallas`` keeps the JAX
package's name and values so callers of both packages read alike.

:func:`extract_signals_streaming` and :func:`measure_green_avg_file` run
the same two forms over a video file in chunks (bounded memory for long
recordings), with the tracking state carried across chunk boundaries so
the results equal a whole-clip pass; the detect-then-reduce chunks take
their ROI means on kernel K3, or from the I420 planes.  The stream decodes
on one cv2 thread or several (``n_decoders``) and stages BGR or planar I420
(``transfer``).

:func:`extract_signals_multi` and :func:`measure_green_avg_multi` monitor K
subjects of one clip: the top-K skin regions a frame
(``models.multiface``), the identity-matched K-track holdover, the K ROIs'
means in one read of each frame, and the K rolling estimates as one batch.

:func:`extract_signals_landmark_roi` and :func:`extract_signals_polygon`
measure where a landmark detector says: a cheek ROI carved in the face's
rolled frame, or a convex ring of mesh vertices (``ops.polyroi``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ICAConfig, PipelineConfig
from ..device import resolve_device
from ..dsp import design, filters, ica as ica_mod, spectral
from ..dsp.filters import forward_fill
from ..dsp.projections import PULSES
from ..io.video import ChunkReader
from ..models import multiface, skin_detector
from ..ops import color, polyroi
from ..ops import reduce as vreduce
from ..ops import roi as vroi
from ..ops import windows as vwin
from ..ops.fused_cuda import (fused_detect_roi_carry, fused_detect_roi_cuda,
                              init_carry)
from ..ops.roi_means_cuda import (roi_channel_means_batched_cuda,
                                  roi_channel_means_cuda)

__all__ = ["SignalTrace", "extract_signals", "extract_signals_fused",
           "extract_signals_streaming", "measure_green_avg",
           "measure_green_avg_file", "measure_projection", "AdaptiveResult",
           "adaptive_pulse_select", "measure_adaptive", "measure_ica",
           "measure_app_welch", "to_measurement_array",
           "extract_signals_multi", "measure_green_avg_multi",
           "extract_signals_landmark_roi", "extract_signals_polygon"]

# A detector maps (T, H, W, 3) u8 -> ((T, 4) int32 boxes, (T,) bool valid).
DetectorFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class SignalTrace(NamedTuple):
    """Per-frame ROI channel means with tracking metadata."""

    bgr: torch.Tensor       # (T, 3) float32 ROI channel means (BGR)
    valid: torch.Tensor     # (T,) bool — detector+holdover validity
    rois: torch.Tensor      # (T, 4) int32 measurement ROI boxes
    boxes: torch.Tensor     # (T, 4) int32 face boxes after holdover


def extract_signals(frames: torch.Tensor,
                    cfg: PipelineConfig = PipelineConfig(),
                    detector: Optional[DetectorFn] = None,
                    use_pallas=False,
                    detect_every: int = 1) -> SignalTrace:
    """Frames -> per-frame ROI channel means.

    ``use_pallas`` selects the compute path:

    * ``False`` — detector, holdover and the plain masked ROI reduction;
    * ``"roi"`` — the same, with the ROI reduction on kernel K2;
    * ``True`` / ``"fused"`` — kernel K1 (:func:`extract_signals_fused`),
      which needs the default skin detector and the cheek ROI.

    ``detect_every=N`` runs the detector on every N-th frame only; the
    frames in between reuse the tracked box without draining the holdover
    budget.
    """
    if use_pallas in (True, "fused"):
        if detector is not None:
            raise ValueError("the fused kernel is the skin detector; pass "
                             "detector=None (or use_pallas='roi')")
        if cfg.roi_site != "cheek":
            raise ValueError("the fused kernel bakes cheek ROI geometry; "
                             "roi_site='forehead' takes the other paths")
        return extract_signals_fused(frames, cfg, detect_every=detect_every)
    if use_pallas not in (False, "roi"):
        raise ValueError(f"unknown use_pallas {use_pallas!r} "
                         "(False | 'roi' | 'fused')")
    track, rois, _ = _track(frames, cfg, detector or
                            skin_detector.detect_faces, detect_every)
    if use_pallas == "roi":
        means, _ = roi_channel_means_cuda(frames, rois)
    else:
        means, _ = vreduce.roi_channel_means(frames, rois)
    return SignalTrace(bgr=means, valid=track.valid, rois=rois,
                       boxes=track.box)


def _track(frames: torch.Tensor, cfg: PipelineConfig, det_fn: DetectorFn,
           detect_every: int,
           carry: Optional[vroi.HoldoverCarry] = None
           ) -> Tuple[vroi.BoxTrack, torch.Tensor, vroi.HoldoverCarry]:
    """Detector (on every ``detect_every``-th frame, from the first),
    holdover from ``carry`` and the measurement ROI (zeroed where the track
    is invalid): ``(track, rois, carry_out)``."""
    T, H, W, _ = frames.shape
    b_sub, v_sub = det_fn(frames[::detect_every] if detect_every > 1
                          else frames)
    return _cadence_track(b_sub, v_sub, T, cfg, detect_every, W, H, carry)


def _spread_cadence(b_sub: torch.Tensor, v_sub: torch.Tensor, T: int,
                    detect_every: int):
    """Detections of the cadence frames ``[::detect_every]`` spread over
    ``T`` frames: ``(boxes, valid, attempted (T,) or None)``, zero and
    not attempted off the cadence."""
    if detect_every == 1:
        return b_sub, v_sub, None
    dev = b_sub.device
    raw_boxes = torch.zeros((T,) + tuple(b_sub.shape[1:]), dtype=b_sub.dtype,
                            device=dev)
    raw_valid = torch.zeros((T,) + tuple(v_sub.shape[1:]), dtype=torch.bool,
                            device=dev)
    attempted = torch.zeros((T,), dtype=torch.bool, device=dev)
    raw_boxes[::detect_every] = b_sub
    raw_valid[::detect_every] = v_sub
    attempted[::detect_every] = True
    return raw_boxes, raw_valid, attempted


def _cadence_track(b_sub: torch.Tensor, v_sub: torch.Tensor, T: int,
                   cfg: PipelineConfig, detect_every: int, W: int, H: int,
                   carry: Optional[vroi.HoldoverCarry] = None
                   ) -> Tuple[vroi.BoxTrack, torch.Tensor, vroi.HoldoverCarry]:
    """:func:`_track` from the detections of the cadence frames ``[::
    detect_every]`` of ``T`` frames of a ``W x H`` frame."""
    raw_boxes, raw_valid, attempted = _spread_cadence(b_sub, v_sub, T,
                                                      detect_every)
    track, carry = vroi.holdover_with_carry(
        raw_boxes, raw_valid, cfg.roi.landmark_hold_frames, carry,
        attempted=attempted)
    rois = vroi.measurement_roi(track.box, cfg.roi, W, H, cfg.roi_site)
    rois = torch.where(track.valid[:, None], rois, 0)
    return track, rois, carry


def extract_signals_fused(frames: torch.Tensor,
                          cfg: PipelineConfig = PipelineConfig(),
                          det: Optional[skin_detector.SkinDetectorConfig] = None,
                          detect_every: int = 1,
                          gate_margin: Optional[float] = None,
                          rescan_every: int = 30,
                          detect_row_pool: int = 1) -> SignalTrace:
    """:func:`extract_signals` on the fused detect+reduce kernel K1.

    One read of each frame; each frame's ROI uses the box tracked from
    *previous* frames, a one-frame lag inside the reference's own holdover
    tolerance.  ``gate_margin``, ``rescan_every`` and ``detect_row_pool``
    are K1's knobs (:func:`vhr_tpu_torch.ops.fused_cuda.fused_detect_roi_carry`).
    """
    T, H, W, _ = frames.shape
    res = fused_detect_roi_cuda(frames, det=det or
                                skin_detector.SkinDetectorConfig(),
                                roi=cfg.roi, detect_every=detect_every,
                                gate_margin=gate_margin,
                                rescan_every=rescan_every,
                                detect_row_pool=detect_row_pool)
    # The ROI that produced means[t] is the cheek rect of the box tracked
    # before frame t's update: boxes[t-1] (zeros at t=0).
    prev = torch.cat([torch.zeros_like(res.boxes[:1]), res.boxes[:-1]])
    rois = vroi.cheek_roi(prev, cfg.roi, W, H)
    rois = torch.where(res.roi_valid[:, None], rois, 0)
    return SignalTrace(bgr=res.means, valid=res.roi_valid, rois=rois,
                       boxes=res.boxes)


def _cadence_detect(frames: torch.Tensor, detector, detect_every: int):
    """A detector of the ``frames -> (boxes, payload, valid)`` contract on
    the cadence frames, spread over the clip: ``(boxes, payload, valid,
    attempted)`` (:func:`_spread_cadence`)."""
    T = frames.shape[0]
    b_sub, p_sub, v_sub = detector(frames[::detect_every]
                                   if detect_every > 1 else frames)
    boxes, valid, attempted = _spread_cadence(b_sub, v_sub, T, detect_every)
    payload, _, _ = _spread_cadence(p_sub, v_sub, T, detect_every)
    return boxes, payload, valid, attempted


def extract_signals_landmark_roi(frames: torch.Tensor, detector,
                                 cfg: PipelineConfig = PipelineConfig(),
                                 detect_every: int = 1) -> SignalTrace:
    """Pose-robust :func:`extract_signals`: the cheek ROI comes from the
    detector, carved from the landmark cloud in the face's rolled frame,
    instead of the box's interior ratios.

    ``detector`` maps ``frames -> (boxes (T, 4), rois (T, 4), valid (T,))``
    (``models.mediapipe_face.make_mediapipe_roi_detector``).  The box and
    the ROI ride separate holdovers of ``cfg.roi.landmark_hold_frames``
    (a stale cloud's ROI is reused as its box is); ``detect_every=N``
    detects on every N-th frame and holds both in between without draining
    the budget.  The means are the plain masked ROI reduction.
    """
    boxes, rois_raw, valid, attempted = _cadence_detect(frames, detector,
                                                        detect_every)
    hold = cfg.roi.landmark_hold_frames
    track_box = vroi.holdover(boxes, valid, hold, attempted=attempted)
    track_roi = vroi.holdover(rois_raw, valid, hold, attempted=attempted)
    rois = torch.where(track_roi.valid[:, None], track_roi.box, 0)
    means, _ = vreduce.roi_channel_means(frames, rois)
    return SignalTrace(bgr=means, valid=track_roi.valid, rois=rois,
                       boxes=track_box.box)


def extract_signals_polygon(frames: torch.Tensor, detector,
                            cfg: PipelineConfig = PipelineConfig(),
                            detect_every: int = 1,
                            grid: int = 32) -> SignalTrace:
    """Mesh-polygon :func:`extract_signals`: the means over a convex ring
    of face-mesh vertices (``ops.polyroi.polygon_channel_means``), so
    background and hair at the face's sides never enter them.

    ``detector`` maps ``frames -> (boxes (T, 4), verts (T, E, 2), valid
    (T,))`` (``models.mediapipe_face.make_mediapipe_poly_detector``).  The
    box and the ring (its ``2E`` floats as the held state) ride separate
    holdovers, as in :func:`extract_signals_landmark_roi`; ``rois`` are the
    held ring's bounding boxes; ``grid`` is the samples per axis.
    """
    T, H, W, _ = frames.shape
    boxes, verts_raw, valid, attempted = _cadence_detect(frames, detector,
                                                         detect_every)
    E = verts_raw.shape[1]
    hold = cfg.roi.landmark_hold_frames
    track_box = vroi.holdover(boxes, valid, hold, attempted=attempted)
    track_v = vroi.holdover(verts_raw.reshape(T, 2 * E), valid, hold,
                            attempted=attempted)
    verts = torch.where(track_v.valid[:, None, None],
                        track_v.box.reshape(T, E, 2), 0.0)
    means, _ = polyroi.polygon_channel_means(frames, verts, grid=grid)
    rois = torch.where(track_v.valid[:, None],
                       polyroi.polygon_bbox(verts, W, H), 0)
    return SignalTrace(bgr=means, valid=track_v.valid, rois=rois,
                       boxes=track_box.box)


def extract_signals_multi(frames: torch.Tensor, k_faces: int = 2,
                          cfg: PipelineConfig = PipelineConfig(),
                          det: Optional[skin_detector.SkinDetectorConfig]
                          = None,
                          detector=None,
                          detect_every: int = 1) -> SignalTrace:
    """Multi-subject :func:`extract_signals`: per-face ROI means.

    The top-``k_faces`` skin regions a frame
    (``models.multiface.detect_faces_multi``, tuned by ``det``), the
    identity-matched K-track holdover (``ops.roi.holdover_multi``), and the
    K ROIs' means in one read of each frame
    (``ops.reduce.roi_channel_means_multi``).  ``detector`` replaces the
    skin detector with any ``frames -> (boxes (T, K, 4), valid (T, K))``
    callable.  ``detect_every=N`` detects on every N-th frame; the K-track
    holdover holds identity through the rest without draining budgets.

    Returns a :class:`SignalTrace` with a face axis on every field: ``bgr
    (T, K, 3)``, ``valid (T, K)``, ``rois/boxes (T, K, 4)``.
    """
    T, H, W, _ = frames.shape
    det = det or skin_detector.SkinDetectorConfig()
    if detector is None:
        detector = lambda fr: multiface.detect_faces_multi(fr, k_faces, det)
    b_sub, v_sub = detector(frames[::detect_every] if detect_every > 1
                            else frames)
    raw_boxes, raw_valid, attempted = _spread_cadence(
        b_sub.to(torch.int32), v_sub, T, detect_every)
    track = vroi.holdover_multi(raw_boxes, raw_valid,
                                cfg.roi.landmark_hold_frames,
                                attempted=attempted)
    rois = vroi.measurement_roi(track.box, cfg.roi, W, H, cfg.roi_site)
    rois = torch.where(track.valid[..., None], rois, 0)
    means, _ = vreduce.roi_channel_means_multi(frames, rois)
    return SignalTrace(bgr=means, valid=track.valid, rois=rois,
                       boxes=track.box)


def measure_green_avg_multi(frames: torch.Tensor, fps: float,
                            k_faces: int = 2,
                            cfg: PipelineConfig = PipelineConfig(),
                            det: Optional[skin_detector.SkinDetectorConfig]
                            = None,
                            detector=None,
                            trace: Optional[SignalTrace] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-face green-channel BPM: ``(ts (T,), bpm (T, K), valid (T, K))``
    numpy arrays, K subjects monitored from one clip.  Pass ``trace`` (from
    :func:`extract_signals_multi`) to reuse an extraction.  Each face's
    trace is forward-filled over its own dropouts, and the K rolling
    estimates run as one batch over the face axis."""
    if trace is None:
        trace = extract_signals_multi(frames, k_faces, cfg, det, detector)
    elif trace.bgr.shape[1] != k_faces:
        raise ValueError(f"trace has {trace.bgr.shape[1]} face slots, "
                         f"k_faces={k_faces}")
    green = _fill_invalid(trace.bgr[..., cfg.channel], trace.valid)  # (T, K)
    rolling = _rolling(green, fps, cfg)
    return _host(fps, rolling.bpm, rolling.valid & trace.valid)


def _fill_invalid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Carry the last valid sample forward over dropouts; leading-invalid
    frames stay 0 (they are masked out downstream).  ``x`` and ``valid``
    of one shape ``(T, K)`` fill each column over its own dropouts."""
    if valid.dim() > 1:
        idx = torch.arange(x.shape[0], device=x.device).reshape(
            (-1,) + (1,) * (x.dim() - 1))
        last = torch.cummax(torch.where(valid, idx, -1), dim=0).values
        filled = torch.gather(x, 0, last.clamp(min=0))
        return torch.where(last < 0, torch.zeros_like(x), filled)
    return forward_fill(x, valid, init="zeros")


def measure_green_avg(frames: torch.Tensor, fps: float,
                      cfg: PipelineConfig = PipelineConfig(),
                      detector: Optional[DetectorFn] = None,
                      use_pallas=False,
                      detect_every: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The canonical green-channel measure.

    Returns per-frame ``(timestamps, bpm, valid)`` numpy arrays; see
    :func:`to_measurement_array` for the reference's (N, 2) contract.
    """
    trace = extract_signals(frames, cfg, detector, use_pallas,
                            detect_every=detect_every)
    return _host(fps, *_green_bpm(trace.bgr, trace.valid, fps, cfg))


# --- the DSP after the trace ----------------------------------------------
# Each function maps a (T, 3) BGR trace and its (T,) validity to per-frame
# (bpm, valid) tensors on the trace's device; the measures are the front end
# (extract_signals) followed by one of them.

def _host(fps: float, bpm: torch.Tensor, valid: torch.Tensor
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(timestamps, bpm, valid)`` numpy arrays of a measure."""
    return (np.arange(bpm.shape[0]) / fps, bpm.cpu().numpy(),
            valid.cpu().numpy())


def _rolling(pulse: torch.Tensor, fps: float, cfg: PipelineConfig
             ) -> vwin.RollingBPM:
    """The configured rolling estimator over a ``(T,)`` pulse."""
    return vwin.rolling_bpm(pulse, fps, cfg.band,
                            window_len=cfg.window_len(fps),
                            acquisition_len=cfg.acquisition_len(fps),
                            estimator=cfg.estimator,
                            segment_seconds=cfg.welch.segment_seconds)


def _green_bpm(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
               cfg: PipelineConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The green measure's DSP: forward-fill, the rolling estimate."""
    rolling = _rolling(_fill_invalid(bgr[:, cfg.channel], valid), fps, cfg)
    return rolling.bpm, rolling.valid & valid


def _projection_bpm(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
                    cfg: PipelineConfig, method: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A projection measure's DSP: the pulse, the rolling estimate."""
    rolling = _rolling(PULSES[method](bgr, valid, fps), fps, cfg)
    return rolling.bpm, rolling.valid & valid


def measure_projection(frames: torch.Tensor, fps: float,
                       method: str = "pos",
                       cfg: PipelineConfig = PipelineConfig(),
                       detector: Optional[DetectorFn] = None,
                       use_pallas=False,
                       detect_every: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chrominance-projection measures, ``method`` in {"chrom", "pos",
    "omit"}: :func:`measure_green_avg`'s contract, with the pulse from a
    motion-robust projection of the BGR means (``dsp.projections``)
    instead of the raw green mean."""
    trace = extract_signals(frames, cfg, detector, use_pallas,
                            detect_every=detect_every)
    return _host(fps, *_projection_bpm(trace.bgr, trace.valid, fps, cfg,
                                       method))


class AdaptiveResult(NamedTuple):
    ts: np.ndarray        # (T,) seconds
    bpm: np.ndarray       # (T,) selected-method estimate
    valid: np.ndarray     # (T,) bool
    choice: np.ndarray    # (T,) int index into `methods` (0 during ramp)
    snr: np.ndarray       # (M, T) per-method in-band SNR (-inf during ramp)


def adaptive_pulse_select(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
                          cfg: PipelineConfig = PipelineConfig(),
                          methods: Tuple[str, ...] = ("green", "chrom",
                                                      "pos", "omit")):
    """Per-window best-of-breed pulse selection from ``(T, 3)`` BGR means.

    Builds every candidate pulse (the raw green mean and the CHROM, POS and
    OMIT projections) and takes each frame's BPM from the method whose
    window scores the best in-band SNR around the cross-method consensus:
    the median BPM of the valid methods (an even count averages its two
    middle values, as ``jnp.nanmedian``).  Frames before a full window
    take ``methods[0]``.  Returns ``(bpm (T,), valid (T,), choice (T,),
    snr (M, T))`` tensors.
    """
    W = cfg.window_len(fps)
    pulses, bpms, oks = [], [], []
    for m in methods:
        if m == "green":
            pulse = _fill_invalid(bgr[:, cfg.channel], valid)
        else:
            pulse = PULSES[m](bgr, valid, fps)
        rolling = _rolling(pulse, fps, cfg)
        pulses.append(pulse)
        bpms.append(rolling.bpm)
        oks.append(rolling.valid)
    bpm_m, ok_m = torch.stack(bpms), torch.stack(oks)        # (M, T)
    consensus = torch.nan_to_num(spectral.nanmedian(
        torch.where(ok_m, bpm_m, torch.full_like(bpm_m, float("nan"))), 0))
    snr_m = torch.stack([
        vwin.rolling_band_snr(p, fps, cfg.band, W, target_bpm=consensus)
        for p in pulses])                                    # (M, T)
    # Invalid methods never win; all -inf (ramp) -> argmax picks index 0.
    ranked = torch.where(ok_m, snr_m, torch.full_like(snr_m, -math.inf))
    choice = torch.argmax(ranked, dim=0)
    take = lambda a: torch.gather(a, 0, choice[None])[0]
    return take(bpm_m), take(ok_m), choice, snr_m


def measure_adaptive(frames: torch.Tensor, fps: float,
                     cfg: PipelineConfig = PipelineConfig(),
                     detector: Optional[DetectorFn] = None,
                     use_pallas=False,
                     methods: Tuple[str, ...] = ("green", "chrom",
                                                 "pos", "omit"),
                     detect_every: int = 1) -> AdaptiveResult:
    """Adaptive measurement: :func:`measure_green_avg`'s front end, each
    frame's estimate from the method :func:`adaptive_pulse_select` picks
    for its window; ``choice`` and ``snr`` expose the selection."""
    trace = extract_signals(frames, cfg, detector, use_pallas,
                            detect_every=detect_every)
    bpm, ok, choice, snr = adaptive_pulse_select(trace.bgr, trace.valid, fps,
                                                 cfg, methods)
    ts, bpm, valid = _host(fps, bpm, ok & trace.valid)
    return AdaptiveResult(ts=ts, bpm=bpm, valid=valid,
                          choice=choice.cpu().numpy(), snr=snr.cpu().numpy())


def _masked_norm(wins: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Per-window std-normalise ``(N, L, C)`` windows over their first
    ``n_valid`` rows (ddof=1); other rows become 0."""
    keep = (torch.arange(wins.shape[1], device=wins.device)
            < n_valid[:, None])[..., None]
    n = n_valid.to(wins.dtype)[:, None, None]
    zero = torch.zeros((), dtype=wins.dtype, device=wins.device)
    mean = torch.where(keep, wins, zero).sum(1, keepdim=True) / n
    var = torch.where(keep, (wins - mean) ** 2, zero).sum(
        1, keepdim=True) / (n - 1.0)
    std = torch.sqrt(var)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return torch.where(keep, wins / std, zero)


def _ica_bpm(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
             cfg: PipelineConfig, icacfg: ICAConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ICA measure's DSP: the growing windows of the acquisition ramp
    (padded to one length, with their true lengths) and the full sliding
    windows, each solved as one FastICA batch."""
    bgr_f = _fill_invalid(bgr, valid)                        # (T, 3)
    T, dev = bgr.shape[0], bgr.device
    window_len = int(icacfg.window_seconds * fps)
    acq_len = int(icacfg.acquisition_seconds * fps)
    bpm = torch.zeros(T, dtype=torch.float32, device=dev)
    ok = torch.zeros(T, dtype=torch.bool, device=dev)
    first = acq_len - 1
    if first >= T:
        return bpm, ok
    w_init = ica_mod.default_w_init(icacfg.n_components, icacfg.seed)
    # Ramp: frame i sees bgr[:i+1] (the deque still filling).
    ramp_end = min(window_len - 1, T - 1)
    if ramp_end >= first:
        lengths = torch.arange(first + 1, ramp_end + 2, device=dev)
        prefix = bgr_f[:ramp_end + 1]
        wins = prefix[None].expand((lengths.shape[0],) + prefix.shape)
        res = ica_mod.ica_sources(_masked_norm(wins, lengths), w_init,
                                  icacfg.max_iter, icacfg.tol,
                                  n_valid=lengths)
        est = spectral.estimate_bpm_multichannel_exact(res.sources, lengths,
                                                       fps, cfg.band)
        bpm[first:ramp_end + 1] = est.bpm
        ok[first:ramp_end + 1] = est.valid & res.converged
    # Steady: full-length sliding windows as one batch.
    if T >= window_len:
        wins = vwin.sliding_windows(bgr_f, window_len)       # (N, W, 3)
        n = wins.shape[1]
        c = wins - wins.mean(1, keepdim=True)
        std = (c * c).mean(1, keepdim=True).sqrt() * math.sqrt(n / (n - 1.0))
        std = torch.where(std == 0, torch.ones_like(std), std)
        res = ica_mod.ica_sources(wins / std, w_init, icacfg.max_iter,
                                  icacfg.tol)
        est = spectral.estimate_bpm_multichannel(res.sources, fps, cfg.band)
        bpm[window_len - 1:] = est.bpm
        ok[window_len - 1:] = est.valid & res.converged
    return bpm, ok & valid


def measure_ica(frames: torch.Tensor, fps: float,
                cfg: PipelineConfig = PipelineConfig(),
                icacfg: ICAConfig = ICAConfig(),
                detector: Optional[DetectorFn] = None,
                use_pallas=False,
                detect_every: int = 1
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ICA measure (the reference's ``analysis/measurement/ica.py``).

    Per frame after acquisition: std-normalise the window's BGR means
    (ddof=1), FastICA, skip windows that did not converge, take the best
    component's in-band FFT peak (:func:`_ica_bpm`).
    """
    trace = extract_signals(frames, cfg, detector, use_pallas,
                            detect_every=detect_every)
    return _host(fps, *_ica_bpm(trace.bgr, trace.valid, fps, cfg, icacfg))


def _app_filter(wins: torch.Tensor, fps: float,
               cfg: PipelineConfig) -> torch.Tensor:
    """The app's zero-phase band-pass of ``cfg.filter`` over the last axis
    of ``(N, L)`` windows: Butterworth or Chebyshev II sections through
    ``sosfiltfilt``, or a FIR through ``filtfilt_fir``."""
    fc = cfg.filter
    if fc.kind == "fir":
        b = design.firwin_bandpass(fc.fir_numtaps,
                                   cfg.band.low_hz / (0.5 * fps),
                                   cfg.band.high_hz / (0.5 * fps))
        return filters.filtfilt_fir(b, wins.T).T
    sos = design.sos_design(fc.kind, fps, cfg.band.low_hz, cfg.band.high_hz,
                            fc.order, fc.cheby2_stop_atten_db)
    return filters.sosfiltfilt(sos, wins.T).T


def _app_welch_bpm(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
                   cfg: PipelineConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The app loop's DSP: per frame after the first window, the last
    ``window_len`` green samples demeaned, band-passed
    (:func:`_app_filter`) and the Welch PSD peak, every window in one
    batch."""
    green = _fill_invalid(bgr[:, cfg.channel], valid)
    T, dev = bgr.shape[0], bgr.device
    window_len = cfg.window_len(fps)
    bpm = torch.zeros(T, dtype=torch.float32, device=dev)
    ok = torch.zeros(T, dtype=torch.bool, device=dev)
    if T > window_len:
        wins = vwin.sliding_windows(green, window_len)[1:]   # frames W..T-1
        wins = wins - wins.mean(-1, keepdim=True)
        est = spectral.estimate_bpm_welch(_app_filter(wins, fps, cfg), fps,
                                          cfg.band,
                                          cfg.welch.segment_seconds)
        bpm[window_len:] = est.bpm
        ok[window_len:] = est.valid
    return bpm, ok & valid


def measure_app_welch(frames: torch.Tensor, fps: float,
                      cfg: PipelineConfig = PipelineConfig(),
                      detector: Optional[DetectorFn] = None,
                      use_pallas=False,
                      detect_every: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The interactive app's analysis loop (:func:`_app_welch_bpm`):
    frames up to ``window_len`` are invalid (the app needs more samples
    than the window)."""
    trace = extract_signals(frames, cfg, detector, use_pallas,
                            detect_every=detect_every)
    return _host(fps, *_app_welch_bpm(trace.bgr, trace.valid, fps, cfg))

def _open_reader(video_path: str, chunk_frames: int, device: torch.device,
                 n_decoders: int, transfer: str) -> ChunkReader:
    """The chunk reader for ``transfer``: planar I420 where the frame's
    sides are even, else BGR, as the JAX package stages BGR when its native
    reader refuses I420."""
    if transfer not in ("bgr", "i420"):
        raise ValueError(f"transfer must be 'bgr' or 'i420', got {transfer!r}")
    if transfer == "i420":
        try:
            return ChunkReader(video_path, chunk_frames, device, n_decoders,
                               fmt="i420")
        except IOError:
            pass                  # odd sides: stage BGR instead
    return ChunkReader(video_path, chunk_frames, device, n_decoders)


def _stream(video_path: str, cfg: PipelineConfig,
            detector: Optional[DetectorFn], chunk_frames: int,
            use_fused: bool, detect_row_pool: int,
            gate_margin: Optional[float], detect_every: int,
            device: torch.device, n_decoders: int = 1,
            transfer: str = "bgr"
            ) -> Tuple[torch.Tensor, torch.Tensor, float, float, float]:
    """The chunked pass of :func:`extract_signals_streaming`, its outputs
    left on ``device``: ``(bgr (T, 3), valid (T,), fps, seconds waiting on
    the reader, seconds in the chunk steps)``."""
    if use_fused and detector is not None:
        raise ValueError("use_fused streams through the skin-detector "
                         "kernel; pass detector=None")
    if detect_every > 1 and chunk_frames % detect_every != 0:
        # Every chunk starts on a detection frame, so the per-chunk stride
        # [0::N] stays on the global cadence.
        raise ValueError("detect_every must divide chunk_frames")
    reader = _open_reader(video_path, chunk_frames, device, n_decoders,
                          transfer)
    H, W = reader.height, reader.width
    # Planar chunks become BGR at the 128-column padded width, whose rows
    # the fused kernel takes (W*3 % 128 == 0); the padding is zero.
    wpad = -(-W // 128) * 128
    i420 = reader.fmt == "i420"
    if use_fused:
        carry = init_carry(device)

        def step(frames, start, carry):
            if i420:
                frames = color.i420_to_bgr_flat(frames, H, W, wpad)
            res, carry = fused_detect_roi_carry(
                frames, carry, roi=cfg.roi, detect_every=detect_every,
                detect_row_pool=detect_row_pool, gate_margin=gate_margin,
                phase=start)
            return res.means, res.roi_valid, carry
    elif i420:
        det_fn = detector or skin_detector.detect_faces
        carry = vroi.init_holdover_carry(device)

        def step(raw, start, carry):
            # The plane path: only the cadence frames become BGR (at the
            # padded width, as the JAX stream's detector sees them); the
            # means come from the planes (ops.color.i420_roi_means).
            sub = color.i420_to_bgr_flat(raw[::detect_every], H, W, wpad)
            b_sub, v_sub = det_fn(sub.reshape(sub.shape[0], H, wpad, 3))
            track, rois, carry = _cadence_track(
                b_sub, v_sub, raw.shape[0], cfg, detect_every, wpad, H,
                carry)
            # Out of the zero padding: the planes are the true width.
            rois = torch.stack([rois[:, 0], rois[:, 1],
                                rois[:, 2].clamp(max=W),
                                rois[:, 3].clamp(max=H)], 1)
            means, _ = color.i420_roi_means(raw, rois, H, W)
            return means, track.valid, carry
    else:
        det_fn = detector or skin_detector.detect_faces
        carry = vroi.init_holdover_carry(device)

        def step(frames, start, carry):
            track, rois, carry = _track(frames, cfg, det_fn, detect_every,
                                        carry)
            means, _ = roi_channel_means_batched_cuda(frames, rois)
            return means, track.valid, carry

    bgr_parts, valid_parts = [], []
    t_wait = t_step = 0.0
    with reader:
        fps = reader.fps
        chunks = iter(reader)
        while True:
            t0 = time.perf_counter()
            item = next(chunks, None)        # blocks on the decode threads
            t_wait += time.perf_counter() - t0
            if item is None:
                break
            t0 = time.perf_counter()
            frames, start = item
            means, valid, carry = step(frames, start, carry)
            bgr_parts.append(means)
            valid_parts.append(valid)
            t_step += time.perf_counter() - t0
    if not bgr_parts:
        return (torch.zeros((0, 3), device=device),
                torch.zeros((0,), dtype=torch.bool, device=device), 0.0,
                t_wait, t_step)
    return (torch.cat(bgr_parts), torch.cat(valid_parts), float(fps), t_wait,
            t_step)


def extract_signals_streaming(video_path: str,
                              cfg: PipelineConfig = PipelineConfig(),
                              detector: Optional[DetectorFn] = None,
                              chunk_frames: int = 256,
                              prefer_native: bool = True,
                              use_fused: bool = False,
                              detect_row_pool: int = 1,
                              gate_margin: Optional[float] = None,
                              ring_stats: Optional[dict] = None,
                              n_decoders: int = 1,
                              detect_every: int = 1,
                              transfer: str = "bgr",
                              device=None
                              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Chunked-decode signal extraction for long recordings.

    Frames stream from the file in chunks of ``chunk_frames``
    (:class:`vhr_tpu_torch.io.video.ChunkReader`: cv2 decode ahead on
    threads, pinned buffers, copies to the card on a side stream); the
    detector and ROI reduction run per chunk with the holdover state carried
    across chunk boundaries, so the results equal a whole-clip pass.  The
    chunk steps' outputs stay on ``device`` and come back to the host once,
    at the end.

    * Detect-then-reduce (default): the detector (every ``detect_every``-th
      frame), ``roi.holdover_with_carry``, the measurement ROI, then the ROI
      means on kernel K3 (its plain version on the CPU).
    * ``use_fused=True``: one K1 launch per chunk
      (:func:`vhr_tpu_torch.ops.fused_cuda.fused_detect_roi_carry` with the
      chunk's first global frame index as ``phase``), its ``(6,)`` carry
      kept on the card between chunks; ``detect_row_pool`` and
      ``gate_margin`` are its knobs.  Needs ``H % 8 == 0``, ``W*3 % 128 ==
      0`` (with ``transfer="i420"``, ``H % 8 == 0``) and ``detector=None``.

    ``n_decoders > 1`` decodes disjoint segments of the file on that many
    cv2 threads (at most 8); the chunks, and so the results, are unchanged.
    ``transfer="i420"`` stages planar YUV 4:2:0 (1.5 bytes a pixel, the
    conversion on the decode threads) and rebuilds BGR on ``device`` bit
    for bit as cv2 does (``ops.color.i420_to_bgr_flat``), at the width
    padded to 128 columns: the fused form runs K1 on the rebuilt chunk; the
    detect form rebuilds only the cadence frames for the detector and takes
    the ROI means from the planes (``ops.color.i420_roi_means``, no K3),
    within 1.5 u8 of the BGR means.  Odd frame sides stage BGR instead.
    ``prefer_native`` is accepted for the JAX signature: the port's reader
    is the cv2 one (the native framestore needs OpenCV's C++ headers).
    ``detect_every`` must divide ``chunk_frames``.

    Returns ``(bgr (T, 3) float32, valid (T,) bool, fps)`` as host numpy.
    If ``ring_stats`` is a dict it receives ``host_wait_on_decode_s`` (time
    blocked on the reader), ``device_dispatch_fetch_s`` (the chunk steps
    and the final fetch), their ``verdict`` (``"decode-bound"`` or
    ``"device-bound"``) and ``decode_wait_fraction``.  ``device`` defaults
    to the CUDA card (raises without one); pass ``device="cpu"`` for the
    CPU.
    """
    del prefer_native
    if transfer not in ("bgr", "i420"):
        raise ValueError(f"transfer must be 'bgr' or 'i420', got {transfer!r}")
    bgr, valid, fps, t_wait, t_dev = _stream(
        video_path, cfg, detector, chunk_frames, use_fused, detect_row_pool,
        gate_margin, detect_every, resolve_device(device), n_decoders,
        transfer)
    t0 = time.perf_counter()
    bgr, valid = bgr.cpu().numpy(), valid.cpu().numpy()
    t_dev += time.perf_counter() - t0
    if ring_stats is not None:
        ring_stats["host_wait_on_decode_s"] = round(t_wait, 3)
        ring_stats["device_dispatch_fetch_s"] = round(t_dev, 3)
        total = t_wait + t_dev
        ring_stats["verdict"] = ("decode-bound" if t_wait > t_dev
                                 else "device-bound")
        ring_stats["decode_wait_fraction"] = (round(t_wait / total, 3)
                                              if total > 0 else 0.0)
    return bgr, valid, fps


def measure_green_avg_file(video_path: str,
                           cfg: PipelineConfig = PipelineConfig(),
                           detector: Optional[DetectorFn] = None,
                           chunk_frames: int = 256,
                           use_fused: bool = False,
                           detect_row_pool: int = 1,
                           gate_margin: Optional[float] = None,
                           detect_every: int = 1,
                           device=None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Streaming-decode variant of :func:`measure_green_avg` (bounded
    memory): the chunked pass of :func:`extract_signals_streaming`, then
    forward-fill and the rolling BPM on ``device`` (the CUDA card by
    default).  Returns ``(timestamps, bpm, valid)`` numpy arrays."""
    bgr, valid, fps, _, _ = _stream(
        video_path, cfg, detector, chunk_frames, use_fused, detect_row_pool,
        gate_margin, detect_every, resolve_device(device))
    T = bgr.shape[0]
    if T == 0:
        return np.zeros(0), np.zeros(0, np.float32), np.zeros(0, bool)
    return _host(fps, *_green_bpm(bgr, valid, fps, cfg))


def to_measurement_array(ts: np.ndarray, bpm: np.ndarray,
                         valid: np.ndarray) -> np.ndarray:
    """Collapse per-frame results to the reference's ``(N, 2)`` contract
    (rows only where an estimate exists)."""
    keep = np.asarray(valid, bool)
    return np.column_stack([np.asarray(ts)[keep],
                            np.asarray(bpm, np.float64)[keep]])
