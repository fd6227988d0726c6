"""The offline green-channel measure: whole-clip tensor programs.

Port of the main path of ``vhr_tpu/pipeline/offline.py``:

  uint8 frames (T, H, W, 3) -> skin-chroma face box -> <=15-frame holdover
  -> cheek ROI -> per-frame BGR means -> forward-fill -> rolling FFT BPM
  -> (ts, bpm, valid)

in its two forms: the detect-then-reduce form (:func:`extract_signals`,
with the K2 ROI kernel under ``use_pallas="roi"``) and the fused form
(:func:`extract_signals_fused`, kernel K1).  ``use_pallas`` keeps the JAX
package's name and values so callers of both packages read alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vhr_tpu.config import PipelineConfig

from ..dsp.filters import forward_fill
from ..models import skin_detector
from ..ops import reduce as vreduce
from ..ops import roi as vroi
from ..ops import windows as vwin
from ..ops.fused_cuda import fused_detect_roi_cuda
from ..ops.roi_means_cuda import roi_channel_means_cuda

__all__ = ["SignalTrace", "extract_signals", "extract_signals_fused",
           "measure_green_avg", "to_measurement_array"]

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
    det_fn = detector or skin_detector.detect_faces
    T, H, W, _ = frames.shape
    dev = frames.device
    if detect_every > 1:
        b_sub, v_sub = det_fn(frames[::detect_every])
        raw_boxes = torch.zeros((T, 4), dtype=b_sub.dtype, device=dev)
        raw_valid = torch.zeros((T,), dtype=torch.bool, device=dev)
        attempted = torch.zeros((T,), dtype=torch.bool, device=dev)
        raw_boxes[::detect_every] = b_sub
        raw_valid[::detect_every] = v_sub
        attempted[::detect_every] = True
    else:
        raw_boxes, raw_valid = det_fn(frames)
        attempted = None
    track = vroi.holdover(raw_boxes, raw_valid, cfg.roi.landmark_hold_frames,
                          attempted=attempted)
    rois = vroi.measurement_roi(track.box, cfg.roi, W, H, cfg.roi_site)
    rois = torch.where(track.valid[:, None], rois, 0)
    if use_pallas == "roi":
        means, _ = roi_channel_means_cuda(frames, rois)
    else:
        means, _ = vreduce.roi_channel_means(frames, rois)
    return SignalTrace(bgr=means, valid=track.valid, rois=rois,
                       boxes=track.box)


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


def _fill_invalid(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Carry the last valid sample forward over dropouts; leading-invalid
    frames stay 0 (they are masked out downstream)."""
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
    green = _fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
    rolling = vwin.rolling_bpm(
        green, fps, cfg.band,
        window_len=cfg.window_len(fps),
        acquisition_len=cfg.acquisition_len(fps),
        estimator=cfg.estimator,
        segment_seconds=cfg.welch.segment_seconds)
    ts = np.arange(frames.shape[0]) / fps
    valid = rolling.valid & trace.valid
    return ts, rolling.bpm.cpu().numpy(), valid.cpu().numpy()


def to_measurement_array(ts: np.ndarray, bpm: np.ndarray,
                         valid: np.ndarray) -> np.ndarray:
    """Collapse per-frame results to the reference's ``(N, 2)`` contract
    (rows only where an estimate exists)."""
    keep = np.asarray(valid, bool)
    return np.column_stack([np.asarray(ts)[keep],
                            np.asarray(bpm, np.float64)[keep]])
