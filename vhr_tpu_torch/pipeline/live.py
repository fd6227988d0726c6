"""Live streaming rPPG: one carried-state step per frame.

Port of ``vhr_tpu/pipeline/live.py`` (``pack_output``, ``unpack_output``,
``LiveConfig``, ``LiveState``, ``LiveOutput``, ``init_state``,
``_masked_welch_psd``, ``_masked_welch_bpm``, ``_ring_pulse``,
``_welch_snr``, ``_method_bpm``, ``step``, ``make_step``,
``_i420_frame_to_bgr``, ``bgr_to_i420_host``, ``LivePipeline``, and the
multi-face ``MultiLiveState``, ``init_state_multi``, ``step_multi`` and
``make_step_multi``).  The
per-frame update is the reference's live loop as tensor code: detection
(or the fused kernel), landmark holdover, ROI mean, one causal SOS step, a
masked ring write and a masked Welch BPM over the ring.  The method
decides what the Welch runs over: the filtered green ring (``"green"``), a
chrominance projection recomputed from the BGR ring each tick
(``"chrom"``, ``"pos"``, ``"omit"``), or all of ``adaptive_methods``, the
tick's BPM from the one with the best consensus-anchored SNR
(``"adaptive"``).

The update is written once, over a leading slot axis, and shared with the
serving pool (``vhr_tpu_torch.serving``), which advances all its slots in one
call; :func:`step` is that update with one slot.  The fused path runs kernel
K4 (``ops.fused_cuda.fused_detect_roi_slots``) with the slot's frame counter
read on the card, so a step on CUDA tensors never waits for the device; its
constant tables (the Welch basis, the projections' window plans) are cached
on the device, since a copy from pageable host memory waits for the card's
queue.
The skin-detector path runs the detector on every frame and masks its
result off the ``detect_every`` cadence for the same reason; the pool, which
keeps its cadence on the host, skips the detector on off-cadence ticks.
:class:`LivePipeline` rests on that: it enqueues frame N's step, then reads
frame N-1's output, whose copy to pinned host memory was enqueued before
step N, so its only wait for the card is that fetch.  With
``transfer="i420"`` a step takes a planar YUV 4:2:0 frame and rebuilds BGR
on the card (``ops.color.i420_to_bgr_flat``).

The multi-face step (:func:`step_multi`) monitors K subjects of one frame:
the top-K skin regions (``models.multiface``), the K-track holdover
(``ops.roi.holdover_multi_step``, the offline scan's step), the K ROIs'
means in one read of the frame, and then each (slot, face) pair is one
stream of the same update, flattened into the slot axis.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import BAND_LIVE, HRBand, ROIConfig
from ..device import resolve_device
from ..dsp import design, filters, projections, spectral
from ..models import multiface, skin_detector
from ..ops import color
from ..ops import reduce as vreduce
from ..ops import roi as vroi
from ..ops.fused_cuda import fused_detect_roi_slots
from ..ops.roi_means_cuda import roi_channel_means_cuda
from .offline import DetectorFn

__all__ = ["LiveConfig", "LiveState", "LiveOutput", "init_state", "step",
           "make_step", "pack_output", "unpack_output", "bgr_to_i420_host",
           "LivePipeline", "MultiLiveState", "init_state_multi", "step_multi",
           "make_step_multi"]


def pack_output(o: "LiveOutput") -> torch.Tensor:
    """LiveOutput -> one ``(..., 10)`` float32 tensor ``[bpm, bpm_valid,
    green_raw, green_filtered, face_valid, box x1, y1, x2, y2, choice]``,
    so a step's result crosses to the host as one copy.  The layout is the
    JAX package's.  Inverse: :func:`unpack_output`."""
    f32 = lambda x: x.to(torch.float32)
    return torch.cat([
        torch.stack([f32(o.bpm), f32(o.bpm_valid), f32(o.green_raw),
                     f32(o.green_filtered), f32(o.face_valid)], dim=-1),
        f32(o.box), f32(o.choice)[..., None]], dim=-1)


def unpack_output(a: np.ndarray) -> "LiveOutput":
    """Inverse of :func:`pack_output` (host side, numpy fields)."""
    return LiveOutput(bpm=a[..., 0], bpm_valid=a[..., 1] > 0.5,
                      green_raw=a[..., 2], green_filtered=a[..., 3],
                      box=a[..., 5:9].astype(np.int32),
                      face_valid=a[..., 4] > 0.5,
                      choice=a[..., 9].astype(np.int32))


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """The JAX package's ``LiveConfig``, field for field."""

    band: HRBand = BAND_LIVE
    filter_order: int = 4
    ring_len: int = 500
    welch_segment_seconds: float = 9.0
    roi: ROIConfig = ROIConfig()
    fps: float = 30.0
    # Fused detection (kernel K4): one read per frame, the ROI from the box
    # tracked on previous frames; needs H % 8 == 0 and W*3 % 128 == 0.
    use_fused: bool = False
    detect_row_pool: int = 1
    gate_margin: Optional[float] = None
    # Run detection on every N-th frame only; the box is tracked between
    # without draining the holdover budget.
    detect_every: int = 1
    roi_site: str = "cheek"
    method: str = "green"
    proj_window_seconds: float = 1.6
    adaptive_methods: Tuple[str, ...] = ("green", "chrom", "pos", "omit")
    snr_guard_bins: int = 1


class LiveState(NamedTuple):
    """Per-stream state; the serving pool adds a leading ``(S,)`` axis."""

    ring_raw: torch.Tensor     # (N,) float32 raw green samples (circular)
    ring_filt: torch.Tensor    # (N,) float32 causally filtered samples
    count: torch.Tensor        # () int32 samples written
    zi: torch.Tensor           # (n_sections, 2) float32 streaming SOS state
    last_box: torch.Tensor     # (4,) int32 last face box
    hold_budget: torch.Tensor  # () int32 remaining reuse frames
    has_last: torch.Tensor     # () bool
    frame_idx: torch.Tensor    # () int32 wall-frame counter (cadence phase)
    ring_bgr: torch.Tensor     # (N, 3) float32 raw BGR ROI means


class LiveOutput(NamedTuple):
    bpm: torch.Tensor
    bpm_valid: torch.Tensor
    green_raw: torch.Tensor
    green_filtered: torch.Tensor
    box: torch.Tensor
    face_valid: torch.Tensor
    choice: torch.Tensor       # index into cfg.adaptive_methods behind
                               # this tick's BPM (0 unless "adaptive")


def _sos(cfg: LiveConfig) -> np.ndarray:
    return design.sos_design("butterworth", cfg.fps, cfg.band.low_hz,
                             cfg.band.high_hz, cfg.filter_order)


def _check_method(cfg: LiveConfig) -> None:
    if cfg.method not in ("green", "adaptive") + tuple(projections.PULSES):
        raise ValueError(f"unknown live method {cfg.method!r}")


def _check_fused(cfg: LiveConfig, detector) -> None:
    if cfg.use_fused and detector is not None:
        raise ValueError("use_fused runs the in-kernel skin detector; "
                         "pass detector=None")
    if cfg.use_fused and cfg.roi_site != "cheek":
        raise ValueError("the fused kernel bakes cheek ROI geometry; "
                         "roi_site='forehead' needs use_fused=False")


def _zero_state(cfg: LiveConfig, lead: Tuple[int, ...], device=None
                ) -> LiveState:
    def z(shape, dtype):
        return torch.zeros(tuple(lead) + shape, dtype=dtype, device=device)

    N = cfg.ring_len
    return LiveState(ring_raw=z((N,), torch.float32),
                     ring_filt=z((N,), torch.float32),
                     count=z((), torch.int32),
                     zi=filters.sos_stream_init(_sos(cfg), lead, device),
                     last_box=z((4,), torch.int32),
                     hold_budget=z((), torch.int32),
                     has_last=z((), torch.bool),
                     frame_idx=z((), torch.int32),
                     ring_bgr=z((N, 3), torch.float32))


def init_state(cfg: LiveConfig = LiveConfig(), device=None) -> LiveState:
    """Zeroed state (a zeroed state is a fresh stream)."""
    return _zero_state(cfg, (), device)


class MultiLiveState(NamedTuple):
    """K subjects' live state: :class:`LiveState`'s fields with a face axis
    ``(K,)`` after any slot axis, except ``frame_idx``, the frame's."""

    ring_raw: torch.Tensor     # (K, N)
    ring_filt: torch.Tensor    # (K, N)
    count: torch.Tensor        # (K,)
    zi: torch.Tensor           # (K, n_sections, 2)
    last_box: torch.Tensor     # (K, 4)
    hold_budget: torch.Tensor  # (K,)
    has_last: torch.Tensor     # (K,)
    frame_idx: torch.Tensor    # () wall-frame counter (cadence phase)
    ring_bgr: torch.Tensor     # (K, N, 3)


def _zero_multi_state(cfg: LiveConfig, lead: Tuple[int, ...], k_faces: int,
                      device=None) -> MultiLiveState:
    z = _zero_state(cfg, tuple(lead) + (k_faces,), device)
    return MultiLiveState(**dict(
        z._asdict(), frame_idx=torch.zeros(tuple(lead), dtype=torch.int32,
                                           device=device)))


def init_state_multi(cfg: LiveConfig = LiveConfig(), k_faces: int = 2,
                     device=None) -> MultiLiveState:
    """Zeroed K-subject state."""
    return _zero_multi_state(cfg, (), k_faces, device)


@functools.lru_cache(maxsize=16)
def _welch_basis(N: int, fps: float, band: HRBand, segment_seconds: float,
                 device: torch.device):
    """The banded DFT of the masked Welch: ``(nperseg, n_segments, cos (L,
    B), sin (L, B), psd scale (B,), band freqs (B,) float32 on the device,
    bin spacing df)``, or ``None`` when no bin falls in the band.
    Window, scaling and bin grid are scipy's ``welch`` (periodic Hann,
    density, one-sided).  Cached per device, so a step copies nothing from
    the host (such a copy would wait for the card's queue)."""
    nperseg = int(min(N, fps * segment_seconds))
    step_len = nperseg - nperseg // 2
    n_segments = (N - nperseg // 2) // step_len
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / fps)
    band_idx = np.where((freqs >= band.low_hz) & (freqs <= band.high_hz))[0]
    if band_idx.size == 0:
        return None
    ang = (2.0 * np.pi / nperseg) * np.outer(np.arange(nperseg), band_idx)
    doubling = np.full(freqs.shape, 2.0)
    doubling[0] = 1.0
    if nperseg % 2 == 0:
        doubling[-1] = 1.0
    scale = doubling[band_idx] / (fps * float(np.sum(win * win)))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    band_freqs = freqs[band_idx]
    df = float(band_freqs[1] - band_freqs[0]) if band_idx.size > 1 else 1.0
    return (nperseg, n_segments, t(np.cos(ang) * win[:, None]),
            t(np.sin(ang) * win[:, None]), t(scale), t(band_freqs), df)


def _masked_welch_psd(ordered: torch.Tensor, n_valid: torch.Tensor,
                      fps: float, band: HRBand, segment_seconds: float):
    """Masked Welch over chronologically ordered rings ``(..., N)`` whose
    last ``n_valid (...)`` samples are real: -> ``(mean_psd (..., B),
    band_freqs (B,) on the device, their spacing df, valid (...))``, or
    ``None`` for a degenerate
    band/fps.  Segments anchor at the start of the valid suffix, and only
    segments inside it count.  The in-band bins come from two float32
    matmuls (the banded DFT), not a full FFT."""
    N = ordered.shape[-1]
    basis = _welch_basis(N, float(fps), band, float(segment_seconds),
                         ordered.device)
    if basis is None:
        return None
    nperseg, n_seg, cos_m, sin_m, scale, band_freqs, df = basis
    dev = ordered.device
    n_valid = n_valid.to(torch.int64)
    starts = torch.arange(n_seg, device=dev) * (nperseg - nperseg // 2)
    idx = ((N - n_valid)[..., None, None] + starts[:, None]
           + torch.arange(nperseg, device=dev)).clamp(max=N - 1)
    segs = torch.gather(
        ordered[..., None, :].expand(ordered.shape[:-1] + (n_seg, N)),
        -1, idx)                                           # (..., n_seg, L)
    seg_ok = starts + nperseg <= n_valid[..., None]        # (..., n_seg)
    # Demean over the valid data, then each segment (detrend="constant").
    total = ordered.sum(-1) / n_valid.to(torch.float32).clamp(min=1.0)
    segs = segs - total[..., None, None]
    segs = segs - segs.mean(-1, keepdim=True)
    re, im = segs @ cos_m, segs @ sin_m
    psd = (re * re + im * im) * scale
    w = seg_ok.to(torch.float32)[..., None]
    mean_psd = (psd * w).sum(-2) / w.sum(-2).clamp(min=1.0)
    valid = seg_ok.any(-1) & (n_valid >= nperseg)
    return mean_psd, band_freqs, df, valid


def _masked_welch_bpm(ordered: torch.Tensor, n_valid: torch.Tensor,
                      fps: float, band: HRBand, segment_seconds: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Welch PSD peak over ordered rings: ``(bpm (...), valid (...))``.
    With a full ring this is scipy's ``welch`` peak over the ring."""
    res = _masked_welch_psd(ordered, n_valid, fps, band, segment_seconds)
    if res is None:
        shape = ordered.shape[:-1]
        return (torch.zeros(shape, dtype=torch.float32, device=ordered.device),
                torch.zeros(shape, dtype=torch.bool, device=ordered.device))
    mean_psd, freqs, _, valid = res
    return freqs[torch.argmax(mean_psd, dim=-1)] * 60.0, valid


def _ring_pulse(method: str, ordered_bgr: torch.Tensor,
                ordered_green: torch.Tensor, n_valid: torch.Tensor,
                fps: float, window_seconds: float) -> torch.Tensor:
    """Pulse of ``method`` over ordered rings -> ``(..., N)``.

    The last ``n_valid`` samples are data; the projections forward-fill the
    zero prefix from the first valid sample, so once a ring is full this is
    ``dsp.projections.<method>_pulse`` over its trailing ``N`` frames.
    """
    if method == "green":
        return ordered_green
    N = ordered_bgr.shape[-2]
    suffix = (torch.arange(N, device=n_valid.device)
              >= (N - n_valid)[..., None])
    if method not in projections.PULSES:
        raise ValueError(f"unknown live method {method!r}")
    return projections.PULSES[method](ordered_bgr, suffix, fps,
                                      window_seconds)


def _welch_snr(mean_psd: torch.Tensor, freqs: torch.Tensor, df: float,
               target_bpm: torch.Tensor, guard_bins: int) -> torch.Tensor:
    """In-band SNR of Welch PSDs ``(..., B)`` around ``target_bpm (...)``:
    the power within ``guard_bins`` bins of the target over the rest of the
    band (``dsp.spectral.band_snr``'s targeted form on the live Welch's
    banded grid, bins ``freqs (B,)`` spaced ``df``)."""
    near = (freqs - (target_bpm / 60.0)[..., None]).abs() \
        <= (guard_bins + 0.5) * df
    peak = torch.where(near, mean_psd, torch.zeros_like(mean_psd)).sum(-1)
    rest = mean_psd.sum(-1) - peak
    return peak / torch.clamp(rest, min=1e-12)


def _method_bpm(cfg: LiveConfig, ring_raw: torch.Tensor,
                ring_bgr: torch.Tensor, ring_filt: torch.Tensor,
                count: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tick BPM of each ring under ``cfg.method`` -> ``(bpm, valid,
    choice)``.  ``"green"``: Welch over the causally filtered ring, in time
    order.  A projection: Welch over the pulse recomputed from the BGR ring.
    ``"adaptive"``: every method of ``cfg.adaptive_methods`` scored by its
    Welch SNR around the median BPM of the valid methods (an even count
    averages its two middle values, as ``jnp.nanmedian``), the best one's
    BPM and its index as ``choice``."""
    _check_method(cfg)
    N = cfg.ring_len
    n_valid = count.clamp(max=N)
    zeros = torch.zeros_like(count)
    # Rotate each ring so its oldest sample comes first (jnp.roll(-r)).
    idx = (torch.arange(N, device=count.device)
           + (count % N).to(torch.int64)[..., None]) % N
    band = (cfg.fps, cfg.band, cfg.welch_segment_seconds)
    if cfg.method == "green":
        bpm, valid = _masked_welch_bpm(torch.gather(ring_filt, -1, idx),
                                       n_valid, *band)
        return bpm, valid, zeros
    ordered_bgr = torch.gather(ring_bgr, -2, idx[..., None].expand(
        ring_bgr.shape))
    ordered_green = torch.gather(ring_raw, -1, idx)
    if cfg.method != "adaptive":
        pulse = _ring_pulse(cfg.method, ordered_bgr, ordered_green, n_valid,
                            cfg.fps, cfg.proj_window_seconds)
        bpm, valid = _masked_welch_bpm(pulse, n_valid, *band)
        return bpm, valid, zeros

    bpms, oks, psds = [], [], []
    for m in cfg.adaptive_methods:
        pulse = _ring_pulse(m, ordered_bgr, ordered_green, n_valid, cfg.fps,
                            cfg.proj_window_seconds)
        res = _masked_welch_psd(pulse, n_valid, *band)
        if res is None:                  # degenerate band/fps config
            return (torch.zeros(count.shape, dtype=torch.float32,
                                device=count.device),
                    torch.zeros(count.shape, dtype=torch.bool,
                                device=count.device), zeros)
        mean_psd, freqs, df, ok = res
        bpms.append(freqs[torch.argmax(mean_psd, dim=-1)] * 60.0)
        oks.append(ok)
        psds.append(mean_psd)
    bpm_m, ok_m = torch.stack(bpms), torch.stack(oks)        # (M, ...)
    consensus = torch.nan_to_num(spectral.nanmedian(
        torch.where(ok_m, bpm_m, torch.full_like(bpm_m, float("nan"))), 0))
    snr_m = torch.stack([_welch_snr(p, freqs, df, consensus,
                                    cfg.snr_guard_bins) for p in psds])
    ranked = torch.where(ok_m, snr_m, torch.full_like(snr_m, -math.inf))
    choice = torch.argmax(ranked, dim=0)
    bpm = torch.gather(bpm_m, 0, choice[None])[0]
    valid = torch.gather(ok_m, 0, choice[None])[0]
    return bpm, valid, choice.to(torch.int32)


# --- the update, over a leading slot axis ---------------------------------
# Each helper returns (means (S, 3), face_valid, new_last, new_budget,
# new_has); face_valid is already masked by `active` (a slot that got no
# frame advances nothing).

def _fused_track(state: LiveState, frames: torch.Tensor,
                 active: torch.Tensor, cfg: LiveConfig):
    """Kernel K4: detection and cheek-ROI means in one read of each slot's
    frame; the tracking carry is the state's holdover fields and the
    cadence phase each slot's own frame counter."""
    carry = torch.cat([state.last_box.to(torch.int32),
                       state.hold_budget.to(torch.int32)[:, None],
                       state.has_last.to(torch.int32)[:, None]], dim=1)
    res, carry_out = fused_detect_roi_slots(
        frames, carry, state.frame_idx, roi=cfg.roi,
        detect_every=cfg.detect_every, detect_row_pool=cfg.detect_row_pool,
        gate_margin=cfg.gate_margin)
    # An inactive slot's (stale) frame was scanned too: keep its carry.
    carry_out = torch.where(active[:, None], carry_out, carry)
    return (res.means, res.roi_valid & active, carry_out[:, 0:4],
            carry_out[:, 4], carry_out[:, 5] > 0)


def _skin_track(state: LiveState, frames: torch.Tensor,
                attempt: torch.Tensor, active: torch.Tensor,
                cfg: LiveConfig, detector: Optional[DetectorFn],
                run_detector: bool):
    """Detector, holdover with the cadence's 'attempted' semantics (a frame
    off the cadence tracks without draining the budget), then the ROI means
    (kernel K2 on the card).  ``run_detector=False`` stands for a detector
    that found nothing, for ticks where no slot attempts."""
    S, H, W, _ = frames.shape
    if run_detector:
        boxes, v_det = (detector or skin_detector.detect_faces)(frames)
        boxes = boxes.to(torch.int32)
    else:
        boxes = torch.zeros((S, 4), dtype=torch.int32, device=frames.device)
        v_det = torch.zeros((S,), dtype=torch.bool, device=frames.device)
    v = v_det & attempt
    new_last = torch.where(v[:, None], boxes, state.last_box)
    new_has = v | state.has_last
    reuse_ok = ~v & attempt & state.has_last & (state.hold_budget > 0)
    tracked = ~attempt & state.has_last
    new_budget = torch.where(
        v, torch.full_like(state.hold_budget, cfg.roi.landmark_hold_frames),
        torch.where(reuse_ok, state.hold_budget - 1, state.hold_budget))
    face_valid = (v | reuse_ok | tracked) & active
    rois = vroi.measurement_roi(new_last, cfg.roi, W, H, cfg.roi_site)
    rois = torch.where(face_valid[:, None], rois, 0)
    means, _ = roi_channel_means_cuda(frames, rois)
    return means, face_valid, new_last, new_budget, new_has


def _finish_batched(state: LiveState, cfg: LiveConfig, sos: np.ndarray,
                    active: torch.Tensor, means: torch.Tensor,
                    face_valid: torch.Tensor, new_last: torch.Tensor,
                    new_budget: torch.Tensor, new_has: torch.Tensor
                    ) -> Tuple[LiveState, LiveOutput]:
    """Common tail of every update: streaming SOS push, ring writes masked
    by ``face_valid`` (an invalid frame appends nothing, as the reference's
    deques), the method's BPM, and the new state."""
    green = means[:, 1]
    filt, zi = filters.sos_stream_push(sos, state.zi, green)
    slots = torch.arange(green.shape[0], device=green.device)
    ptr = (state.count % cfg.ring_len).to(torch.int64)

    def write(ring, value):
        old = ring[slots, ptr]
        keep = face_valid.reshape(face_valid.shape + (1,) * (old.dim() - 1))
        return ring.index_put((slots, ptr), torch.where(keep, value, old))

    ring_raw = write(state.ring_raw, green)
    ring_filt = write(state.ring_filt, filt)
    ring_bgr = write(state.ring_bgr, means)
    count = state.count + face_valid.to(torch.int32)
    zi = torch.where(face_valid[:, None, None], zi, state.zi)
    bpm, bpm_valid, choice = _method_bpm(cfg, ring_raw, ring_bgr, ring_filt,
                                         count)
    new_state = LiveState(ring_raw=ring_raw, ring_filt=ring_filt,
                          count=count, zi=zi, last_box=new_last,
                          hold_budget=new_budget, has_last=new_has,
                          frame_idx=state.frame_idx + active.to(torch.int32),
                          ring_bgr=ring_bgr)
    out = LiveOutput(bpm=bpm, bpm_valid=bpm_valid, green_raw=green,
                     green_filtered=filt, box=new_last,
                     face_valid=face_valid, choice=choice)
    return new_state, out


def _multi_update(state: MultiLiveState, frames: torch.Tensor,
                  attempt: torch.Tensor, active: torch.Tensor,
                  cfg: LiveConfig, k_faces: int, detector,
                  run_detector: bool
                  ) -> Tuple[MultiLiveState, LiveOutput]:
    """The K-subject update over a leading slot axis: the top-K detector
    (``run_detector=False`` stands for one that found nothing), the K-track
    holdover with the cadence's 'attempted' semantics, the K ROIs' means in
    one read of each frame, then :func:`_finish_batched` with each (slot,
    face) pair as a stream of its own.  Output fields are ``(S, K, ...)``."""
    S, H, W, _ = frames.shape
    K = k_faces
    dev = frames.device
    if run_detector:
        cand, cval = (detector(frames) if detector is not None
                      else multiface.detect_faces_multi(frames, K))
        cand = cand.to(torch.int32)
    else:
        cand = torch.zeros((S, K, 4), dtype=torch.int32, device=dev)
        cval = torch.zeros((S, K), dtype=torch.bool, device=dev)
    (new_last, new_budget, new_has), (boxes, face_valid) = \
        vroi.holdover_multi_step(
            (state.last_box, state.hold_budget, state.has_last), cand, cval,
            cfg.roi.landmark_hold_frames, attempted=attempt)
    face_valid = face_valid & active[:, None]
    rois = vroi.measurement_roi(boxes, cfg.roi, W, H, cfg.roi_site)
    rois = torch.where(face_valid[..., None], rois, 0)
    means, _ = vreduce.roi_channel_means_multi(frames, rois)   # (S, K, 3)

    def flat(x):
        return x.reshape((S * K,) + x.shape[2:])

    streams = LiveState(
        ring_raw=flat(state.ring_raw), ring_filt=flat(state.ring_filt),
        count=flat(state.count), zi=flat(state.zi),
        last_box=flat(state.last_box), hold_budget=flat(state.hold_budget),
        has_last=flat(state.has_last),
        frame_idx=state.frame_idx.repeat_interleave(K),
        ring_bgr=flat(state.ring_bgr))
    new, out = _finish_batched(streams, cfg, _sos(cfg),
                               active.repeat_interleave(K), flat(means),
                               flat(face_valid), flat(new_last),
                               flat(new_budget), flat(new_has))
    unflat = lambda x: x.reshape((S, K) + x.shape[1:])
    new = MultiLiveState(**dict(
        {k: unflat(v) for k, v in new._asdict().items()},
        frame_idx=state.frame_idx + active.to(torch.int32)))
    return new, LiveOutput(*(unflat(x) for x in out))


def step_multi(state: MultiLiveState, frame: torch.Tensor, cfg: LiveConfig,
               k_faces: int = 2, detector=None
               ) -> Tuple[MultiLiveState, LiveOutput]:
    """One frame of K-subject live monitoring: ``(state, (H, W, 3) u8
    frame) -> (state, out)``, every output field with a leading ``(K,)``
    face axis.  ``detector`` replaces the top-K skin detector with any
    ``frames (1, H, W, 3) -> (boxes (1, K, 4), valid (1, K))`` callable.
    ``cfg.use_fused`` is single-face and raises here."""
    if cfg.use_fused:
        raise ValueError("use_fused is single-face (pipeline.live.step); "
                         "step_multi runs the multi-face detector path")
    _check_method(cfg)
    frames = torch.as_tensor(frame)[None]
    one = torch.ones((1,), dtype=torch.bool, device=frames.device)
    st = MultiLiveState(*(x[None] for x in state))
    attempt = (st.frame_idx % cfg.detect_every == 0
               if cfg.detect_every > 1 else one)
    new, out = _multi_update(st, frames, attempt, one, cfg, k_faces,
                             detector, True)
    return (MultiLiveState(*(x[0] for x in new)),
            LiveOutput(*(x[0] for x in out)))


def step(state: LiveState, frame: torch.Tensor, cfg: LiveConfig,
         detector: Optional[DetectorFn] = None
         ) -> Tuple[LiveState, LiveOutput]:
    """One frame update: ``(state, (H, W, 3) u8 frame) -> (state, out)``.

    ``detector`` replaces the skin detector with any single-face
    ``frames (1, H, W, 3) -> (boxes (1, 4), valid (1,))`` callable;
    incompatible with ``use_fused``.  The frame and the state must be on one
    device.
    """
    _check_method(cfg)
    _check_fused(cfg, detector)
    frames = torch.as_tensor(frame)[None]
    one = torch.ones((1,), dtype=torch.bool, device=frames.device)
    st = LiveState(*(x[None] for x in state))
    if cfg.use_fused:
        parts = _fused_track(st, frames, one, cfg)
    else:
        attempt = (st.frame_idx % cfg.detect_every == 0
                   if cfg.detect_every > 1 else one)
        parts = _skin_track(st, frames, attempt, one, cfg, detector, True)
    new, out = _finish_batched(st, cfg, _sos(cfg), one, *parts)
    return (LiveState(*(x[0] for x in new)),
            LiveOutput(*(x[0] for x in out)))


def _i420_frame_to_bgr(planar: torch.Tensor) -> torch.Tensor:
    """``(H*3//2, W)`` planar YUV 4:2:0 -> ``(H, W, 3)`` uint8 BGR on the
    frame's device, equal bit for bit to cv2's."""
    h, w = planar.shape[0] * 2 // 3, planar.shape[1]
    return color.i420_to_bgr_flat(planar[None], h, w).reshape(h, w, 3)


def bgr_to_i420_host(frame_bgr) -> np.ndarray:
    """Host-side BGR -> planar I420 (cv2), for ``transfer="i420"`` steps and
    pools: 1.5 bytes a pixel on the wire instead of 3."""
    import cv2
    return cv2.cvtColor(np.ascontiguousarray(frame_bgr),
                        cv2.COLOR_BGR2YUV_I420)


def make_step(cfg: LiveConfig = LiveConfig(),
              detector: Optional[DetectorFn] = None, transfer: str = "bgr"):
    """The per-frame step as a ``(state, frame) -> (state, out)`` callable,
    with its configuration checked once.  ``transfer="i420"``: the step
    takes a ``(H*3//2, W)`` uint8 planar YUV 4:2:0 frame
    (:func:`bgr_to_i420_host`) and rebuilds BGR on the frame's device."""
    if transfer not in ("bgr", "i420"):
        raise ValueError(f"transfer must be 'bgr' or 'i420', got {transfer!r}")
    _check_method(cfg)
    _check_fused(cfg, detector)
    if transfer == "i420":
        return lambda state, frame: step(
            state, _i420_frame_to_bgr(torch.as_tensor(frame)), cfg, detector)
    return lambda state, frame: step(state, frame, cfg, detector)


def make_step_multi(cfg: LiveConfig = LiveConfig(), k_faces: int = 2,
                    detector=None, transfer: str = "bgr"):
    """:func:`step_multi` as a ``(state, frame) -> (state, out)`` callable,
    with its configuration checked once (``transfer`` as in
    :func:`make_step`)."""
    if transfer not in ("bgr", "i420"):
        raise ValueError(f"transfer must be 'bgr' or 'i420', got {transfer!r}")
    if cfg.use_fused:
        raise ValueError("use_fused is single-face (pipeline.live.step); "
                         "make_step_multi runs the multi-face detector path")
    _check_method(cfg)
    if transfer == "i420":
        return lambda state, frame: step_multi(
            state, _i420_frame_to_bgr(torch.as_tensor(frame)), cfg, k_faces,
            detector)
    return lambda state, frame: step_multi(state, frame, cfg, k_faces,
                                           detector)


class LivePipeline:
    """One-frame-deep pipelined live loop: enqueue frame N, then read N-1.

    >>> pipe = LivePipeline(cfg)            # on the CUDA card
    >>> for frame in frames:
    ...     out = pipe.submit(frame)   # LiveOutput for the PREVIOUS frame
    ...     if out is not None: draw(out)
    >>> last = pipe.flush()

    :meth:`submit` stages the frame (a pinned host buffer, one
    ``non_blocking`` copy), enqueues its step, starts the copy of the
    step's packed ``(10,)`` output into pinned host memory, and then waits
    for the *previous* frame's copy: the card runs frame N while the host
    turns frame N-1 into a :class:`LiveOutput`.  The answer lags one frame,
    as the reference's async detector callback does.

    * ``transfer="i420"``: frames are ``(H*3//2, W)`` planar YUV 4:2:0
      (:func:`bgr_to_i420_host`), rebuilt to BGR on the card: half the
      host-to-card bytes.
    * ``fetch_every=N``: N outputs come back in one stacked copy;
      :meth:`submit` returns a list of N outputs every N-th call (None
      otherwise), at most N+1 frames late.
    * ``frames_per_call=M``: M frames are uploaded in one stacked pinned
      copy, run as M carried steps, and their outputs fetched in one copy;
      :meth:`submit` returns a list of M outputs every M-th call, at most
      2M frames late; :meth:`flush` runs the partial tail one frame at a
      time.  Every frame still gets its own estimate.

    The two batching levers exclude each other.  ``device`` is the CUDA
    card by default (raises without one); pass ``device="cpu"`` for the
    CPU, where every step runs to its end before :meth:`submit` returns.
    ``k_faces > 1`` runs :func:`step_multi` (``detector`` then follows the
    multi-face contract); every output field gains a ``(K,)`` face axis.
    """

    def __init__(self, cfg: LiveConfig = LiveConfig(),
                 detector: Optional[DetectorFn] = None, k_faces: int = 1,
                 transfer: str = "bgr", fetch_every: int = 1,
                 frames_per_call: int = 1, device=None):
        if transfer not in ("bgr", "i420"):
            raise ValueError(f"transfer must be 'bgr' or 'i420', "
                             f"got {transfer!r}")
        _check_fused(cfg, detector)
        _check_method(cfg)
        if fetch_every < 1:
            raise ValueError("fetch_every must be >= 1")
        if frames_per_call < 1:
            raise ValueError("frames_per_call must be >= 1")
        if fetch_every > 1 and frames_per_call > 1:
            raise ValueError("fetch_every and frames_per_call are "
                             "alternative batching levers; use one")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.transfer = transfer
        self._fetch_every = fetch_every
        self._frames_per_call = frames_per_call
        if k_faces > 1:
            self._step = make_step_multi(cfg, k_faces, detector, transfer)
            self._state = init_state_multi(cfg, k_faces, self.device)
        else:
            self._step = make_step(cfg, detector, transfer)
            self._state = init_state(cfg, self.device)
        self._cuda = self.device.type == "cuda"
        self._buf: list = []        # host frames of a partial call
        self._batch: list = []      # packed outputs awaiting their fetch
        self._inflight: list = []   # fetches started: (host tensor, event)
        # Two pinned upload buffers per frame shape, used in turn; the
        # event recorded after a buffer's copy guards its next write.
        self._pinned: dict = {}
        self.h2d_bytes = 0          # host-to-card frame bytes so far

    def _upload(self, frames) -> torch.Tensor:
        """Host frames (numpy) or tensors -> a tensor on the device."""
        if isinstance(frames, torch.Tensor):
            if frames.device != self.device:
                self.h2d_bytes += frames.numel() * frames.element_size()
            return frames.to(self.device, non_blocking=True)
        a = np.ascontiguousarray(frames, dtype=np.uint8)
        if not self._cuda:
            return torch.from_numpy(a.copy())
        self.h2d_bytes += a.nbytes
        bufs = self._pinned.get(a.shape)
        if bufs is None:
            bufs = self._pinned[a.shape] = [
                [torch.empty(a.shape, dtype=torch.uint8, pin_memory=True),
                 torch.cuda.Event()] for _ in range(2)]
            bufs.append(0)
        turn = bufs[2]
        buf, done = bufs[turn]
        if not done.query():
            done.synchronize()      # the copy that last read this buffer
        buf.numpy()[...] = a
        out = buf.to(self.device, non_blocking=True)
        done.record()
        bufs[2] = turn ^ 1
        return out

    def _run(self, frame: torch.Tensor) -> torch.Tensor:
        self._state, out = self._step(self._state, frame)
        return pack_output(out)

    def _start_fetch(self, vecs: list):
        """Start the copy of packed outputs to the host: one copy."""
        v = torch.stack(vecs)
        if not self._cuda:
            return v, None
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _finish(fetch) -> list:
        """Wait for a fetch (the only wait for the card) and unpack it."""
        host, ev = fetch
        if ev is not None:
            ev.synchronize()
        a = host.numpy()
        return [unpack_output(a[i]) for i in range(a.shape[0])]

    def submit(self, frame):
        """Enqueue ``frame``.  With ``fetch_every=1`` (default): returns the
        previous frame's LiveOutput (host arrays), or None on the very first
        call.  With ``fetch_every=N`` or ``frames_per_call=M``: returns a
        list of the N (M) oldest pending LiveOutputs every Nth (Mth) call,
        None otherwise."""
        ready, self._inflight = self._inflight, []
        if self._frames_per_call > 1:
            self._buf.append(frame)
            if len(self._buf) < self._frames_per_call:
                self._inflight = ready
                return None
            if all(isinstance(f, np.ndarray) for f in self._buf):
                frames = self._upload(np.stack(self._buf))  # one upload
            else:
                frames = torch.stack([self._upload(torch.as_tensor(f))
                                      for f in self._buf])
            self._buf = []
            self._inflight.append(self._start_fetch(
                [self._run(f) for f in frames]))
        else:
            self._batch.append(self._run(self._upload(frame)))
            if len(self._batch) == self._fetch_every:
                self._inflight.append(self._start_fetch(self._batch))
                self._batch = []
        if not ready:
            return None
        outs = self._finish(ready[0])
        if self._fetch_every == 1 and self._frames_per_call == 1:
            return outs[0]
        return outs

    def flush(self):
        """Drain the frames in flight (call once after the last submit).
        Returns a LiveOutput (``fetch_every=1``), a list, or None."""
        for f in self._buf:                  # partial tail, one at a time
            self._batch.append(self._run(self._upload(f)))
        self._buf = []
        if self._batch:
            self._inflight.append(self._start_fetch(self._batch))
            self._batch = []
        outs: list = []
        for fetch in self._inflight:
            outs.extend(self._finish(fetch))
        self._inflight = []
        if not outs:
            return None
        if (self._fetch_every == 1 and self._frames_per_call == 1
                and len(outs) == 1):
            return outs[0]
        return outs
