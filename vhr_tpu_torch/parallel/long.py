"""Long-recording BPM over a time-sharded recording (sequence parallelism).

Port of ``vhr_tpu/parallel/long.py``.  An hour-scale recording is split
over the ``time`` axis of a mesh; each place computes its frames, and
every cross-shard dependency is one collective:

- the rolling windows take a ``window_len - 1`` halo from the left
  neighbour (one :func:`~vhr_tpu_torch.parallel.mesh.ppermute`);
- the detection holdover and the forward-fill carry a state across shard
  boundaries, but any valid frame resets it, so each shard's effect is a
  small summary: one :func:`~vhr_tpu_torch.parallel.mesh.all_gather` of the
  summaries and a prefix fold over them give every shard its input carry,
  and a local pass finishes exactly as the sequential one.

Each public function takes a tensor (split over ``axis_name``) or this
process's shards, and returns the shards' results concatenated.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..config import HRBand, PipelineConfig
from ..dsp import design, spectral
from ..models import skin_detector
from ..ops import roi as vroi
from ..ops import windows as vwin
from ..ops.roi_means_cuda import roi_channel_means_cuda
from .mesh import Mesh, all_gather, gather, local_shards, ppermute
from .time_shard import _filter_shards

__all__ = ["sharded_steady_bpm", "sharded_holdover", "sharded_forward_fill",
           "sharded_rolling_bpm_fft", "measure_green_avg_sharded"]

Signal = Union[torch.Tensor, Sequence[torch.Tensor]]


def _left_halo(xs: list, mesh: Mesh, axis: str, halo: int) -> list:
    """Each shard's left neighbour's last ``halo`` samples (cyclic)."""
    n = mesh.shape[axis]
    return ppermute([xl[-halo:] for xl in xs], mesh,
                    [(i, (i + 1) % n) for i in range(n)], axis)


def _steady(xl: torch.Tensor, left: torch.Tensor, fps: float, band: HRBand,
            window_len: int):
    """The FFT-peak estimate of every length-``window_len`` window that
    ends on one of ``xl``'s frames (``left`` precedes ``xl``), demeaned as
    :func:`~vhr_tpu_torch.ops.windows.rolling_bpm_fft` demeans them."""
    wins = vwin.sliding_windows(torch.cat([left, xl]), window_len)
    wins = wins - wins.mean(-1, keepdim=True)
    return spectral.estimate_bpm(wins, fps, band)


def sharded_steady_bpm(signal: Signal, fps: float, band: HRBand,
                       window_len: int, mesh: Mesh, axis_name: str = "time"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame steady-state BPM of a time-sharded ``(T,)`` signal.

    Frame ``i`` (global) sees ``signal[i - window_len + 1 : i + 1]``;
    frames before ``window_len - 1`` are invalid (their ``bpm`` is not
    zeroed: shard 0 estimates them over a zero halo).  Returns ``(bpm,
    valid)``.
    """
    xs = local_shards(signal, mesh, axis_name)
    lefts = _left_halo(xs, mesh, axis_name, window_len - 1)
    bpms, valids = [], []
    for idx, xl, left in zip(mesh.local_positions(axis_name), xs, lefts):
        if idx == 0:                # no real left context
            left = torch.zeros_like(left)
        est = _steady(xl, left, fps, band, window_len)
        t_local = xl.shape[0]
        global_i = idx * t_local + torch.arange(t_local, device=xl.device)
        bpms.append(est.bpm)
        valids.append(est.valid & (global_i >= window_len - 1))
    return gather(bpms), gather(valids)


def _holdover(bls: list, vls: list, als: list, mesh: Mesh, hold: int,
              axis: str) -> Tuple[list, list]:
    """Shards of the sequential holdover's ``(box, valid)``.

    A shard's summary is ``(any_valid, last_valid_box, attempted failures
    after it, attempted failures in all)``.  A shard with a detection maps
    any input carry to ``(last_box, max(hold - f_after, 0), True)``; one
    without passes the carry through with its budget drained by
    ``f_total`` (held at 0).  Folding the summaries before a shard gives
    its input carry, and :func:`~vhr_tpu_torch.ops.roi.holdover_with_carry`
    from it is exactly the sequential scan."""
    summaries = []
    for bl, vl, al in zip(bls, vls, als):
        t_local = vl.shape[0]
        idx = torch.arange(t_local, device=vl.device)
        last_idx = torch.where(vl, idx, -1).amax().clamp(min=0)
        fails = al & ~vl
        v_after = vl.to(torch.int64).flip(0).cumsum(0).flip(0) \
            - vl.to(torch.int64)
        f_after = (fails & (v_after == 0)).sum()
        summaries.append(torch.cat([
            torch.stack([vl.any().to(torch.int64), f_after,
                         fails.sum()]), bl[last_idx].to(torch.int64)]))
    gathered = all_gather(summaries, mesh, axis)       # (n, 7) a shard
    boxes, valids = [], []
    for pos, bl, vl, al, g in zip(mesh.local_positions(axis), bls, vls, als,
                                  gathered):
        last = torch.zeros(4, dtype=torch.int64, device=g.device)
        budget = torch.zeros((), dtype=torch.int64, device=g.device)
        has = torch.zeros((), dtype=torch.bool, device=g.device)
        for k in range(pos):                    # the shards before this one
            a = g[k, 0] > 0
            reset = (hold - g[k, 1]).clamp(min=0)
            through = torch.where(has, (budget - g[k, 2]).clamp(min=0),
                                  budget)
            last = torch.where(a, g[k, 3:], last)
            budget = torch.where(a, reset, through)
            has = a | has
        carry = (last.to(torch.int32), budget.to(torch.int32), has)
        track, _ = vroi.holdover_with_carry(bl, vl, hold, carry=carry,
                                            attempted=al)
        boxes.append(track.box)
        valids.append(track.valid)
    return boxes, valids


def sharded_holdover(box: Signal, valid: Signal, mesh: Mesh,
                     hold_frames: int = 15, axis_name: str = "time",
                     attempted: Signal = None) -> vroi.BoxTrack:
    """Detection holdover over a time-sharded recording, exactly equal to
    the sequential :func:`~vhr_tpu_torch.ops.roi.holdover` (the cadence
    ``attempted`` rule included): two local passes and one all-gather of
    7 integers a shard.  ``box (T, 4)``, ``valid (T,)`` and ``attempted
    (T,)`` (every frame by default) are split over ``axis_name``."""
    bls = [b.to(torch.int32) for b in local_shards(box, mesh, axis_name)]
    vls = [v.to(torch.bool) for v in local_shards(valid, mesh, axis_name)]
    als = ([torch.ones_like(v) for v in vls] if attempted is None else
           [a.to(torch.bool) for a in local_shards(attempted, mesh,
                                                   axis_name)])
    boxes, valids = _holdover(bls, vls, als, mesh, hold_frames, axis_name)
    return vroi.BoxTrack(box=gather(boxes), valid=gather(valids))


def _forward_fill(xs: list, vls: list, mesh: Mesh, axis: str) -> list:
    """Shards of ``forward_fill(x, valid, init="zeros")``: a shard's
    summary is ``(any_valid, last_valid_value)``."""
    summaries = []
    for xl, vl in zip(xs, vls):
        idx = torch.arange(vl.shape[0], device=vl.device)
        last_idx = torch.where(vl, idx, -1).amax().clamp(min=0)
        summaries.append((vl.any(), xl[last_idx]))
    g_any = all_gather([s[0] for s in summaries], mesh, axis)
    g_last = all_gather([s[1] for s in summaries], mesh, axis)
    out = []
    for pos, xl, vl, ga, gl in zip(mesh.local_positions(axis), xs, vls,
                                   g_any, g_last):
        val = torch.zeros_like(xl[0])
        for k in range(pos):
            val = torch.where(ga[k], gl[k], val)
        T = vl.shape[0]
        idx = torch.arange(T, device=vl.device)
        last = torch.cummax(torch.where(vl, idx, -1), dim=0).values
        lead = (last < 0).reshape((T,) + (1,) * (xl.dim() - 1))
        out.append(torch.where(lead, val, xl[last.clamp(min=0)]))
    return out


def sharded_forward_fill(x: Signal, valid: Signal, mesh: Mesh,
                         axis_name: str = "time") -> torch.Tensor:
    """Forward-fill over a time-sharded trace, exactly equal to the
    sequential :func:`~vhr_tpu_torch.dsp.filters.forward_fill`
    (``init="zeros"``).  ``x`` is ``(T,)`` or ``(T, C)``."""
    xs = local_shards(x, mesh, axis_name)
    vls = [v.to(torch.bool) for v in local_shards(valid, mesh, axis_name)]
    return gather(_forward_fill(xs, vls, mesh, axis_name))


def _rolling(xs: list, fps: float, band: HRBand, window_len: int,
             acquisition_len: int, mesh: Mesh, axis: str
             ) -> Tuple[list, list]:
    """Shards of :func:`~vhr_tpu_torch.ops.windows.rolling_bpm_fft`."""
    if mesh.shape[axis] == 1:
        r = vwin.rolling_bpm_fft(xs[0], fps, band, window_len,
                                 acquisition_len)
        return [r.bpm], [r.valid]
    t_local = xs[0].shape[0]
    if t_local < window_len:
        raise ValueError(
            f"time-sharded rolling BPM needs T_local >= window_len "
            f"({t_local} < {window_len}); use fewer shards or a shorter "
            f"window")
    xs = [vwin._as_float(xl) for xl in xs]
    lefts = _left_halo(xs, mesh, axis, window_len - 1)
    first = acquisition_len - 1
    bpms, valids = [], []
    for idx, xl, left in zip(mesh.local_positions(axis), xs, lefts):
        est = _steady(xl, left, fps, band, window_len)
        global_i = idx * t_local + torch.arange(t_local, device=xl.device)
        steady = global_i >= window_len - 1
        bpm = torch.where(steady, est.bpm, torch.zeros_like(est.bpm))
        valid = steady & est.valid & (window_len >= 8)
        # The acquisition ramp (global frames first .. window_len - 2)
        # lies on shard 0, whose frames are the recording's first: its
        # growing windows are rolling_bpm_fft's, lengths and all.
        if idx == 0 and first <= window_len - 2:
            r_bpm, r_valid = vwin.ramp_bpm(xl, fps, band, first + 1,
                                           window_len)
            bpm[first:window_len - 1] = r_bpm[:-1]
            valid[first:window_len - 1] = r_valid[:-1]
        bpms.append(bpm)
        valids.append(valid)
    return bpms, valids


def sharded_rolling_bpm_fft(signal: Signal, fps: float, band: HRBand,
                            window_len: int, acquisition_len: int,
                            mesh: Mesh, axis_name: str = "time"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-sharded :func:`~vhr_tpu_torch.ops.windows.rolling_bpm_fft`:
    the deque-semantics FFT BPM, growing-window ramp and steady windows.

    ``bpm`` is 0 outside the steady frames and the ramp.  The steady
    windows take a ``window_len - 1`` left halo; the ramp runs on shard 0
    alone, so ``T_local >= window_len`` is required (``ValueError``
    otherwise).  One shard delegates to the unsharded function.  Returns
    ``(bpm, valid)``.
    """
    bpms, valids = _rolling(local_shards(signal, mesh, axis_name), fps,
                            band, window_len, acquisition_len, mesh,
                            axis_name)
    return gather(bpms), gather(valids)


def measure_green_avg_sharded(frames: Signal, fps: float, mesh: Mesh,
                              cfg: PipelineConfig = None, detector=None,
                              bandpass: bool = False,
                              axis_name: str = "time"):
    """The green-channel measure over a time-sharded long recording.

    ``frames`` is ``(T, H, W, 3)`` uint8 (split over ``axis_name``) or this
    process's shards of it.  A shard detects its own frames (``detector``,
    or the skin detector), the holdover crosses shard boundaries
    (:func:`sharded_holdover`), a shard takes the ``cfg.roi_site`` ROI's
    means of its frames (kernel K2 on a CUDA place, one launch a shard),
    dropouts are forward-filled (:func:`sharded_forward_fill`),
    ``bandpass=True`` zero-phase filters the filled trace (order-2
    Butterworth over ``cfg.band``, :func:`~vhr_tpu_torch.parallel.
    time_shard.halo_sosfiltfilt`'s halo), and the windows give the BPM
    (:func:`sharded_rolling_bpm_fft`).

    ``bandpass=False`` equals :func:`vhr_tpu_torch.pipeline.offline.
    measure_green_avg`'s per-frame ``(bpm, valid)``.  Returns ``(bpm,
    valid, green)``, each ``(T,)`` (this process's frames).
    """
    cfg = cfg or PipelineConfig()
    det_fn = detector or skin_detector.detect_faces
    fs = local_shards(frames, mesh, axis_name)
    _, H, W, _ = fs[0].shape
    dets = [det_fn(f) for f in fs]
    boxes, tvalid = _holdover([b.to(torch.int32) for b, _ in dets],
                              [v.to(torch.bool) for _, v in dets],
                              [torch.ones_like(v, dtype=torch.bool)
                               for _, v in dets],
                              mesh, cfg.roi.landmark_hold_frames, axis_name)
    greens = []
    for f, bx, vl in zip(fs, boxes, tvalid):
        rois = vroi.measurement_roi(bx, cfg.roi, W, H, cfg.roi_site)
        rois = torch.where(vl[:, None], rois, 0)
        means, _ = roi_channel_means_cuda(f, rois)
        greens.append(means[:, cfg.channel])
    greens = _forward_fill(greens, tvalid, mesh, axis_name)
    sig = greens
    if bandpass:
        sos = design.sos_design("butterworth", fps, cfg.band.low_hz,
                                cfg.band.high_hz, order=2)
        sig = _filter_shards(sos, sig, mesh, axis_name)
    bpms, rvalid = _rolling(sig, fps, cfg.band, cfg.window_len(fps),
                            cfg.acquisition_len(fps), mesh, axis_name)
    ok = [rv & tv for rv, tv in zip(rvalid, tvalid)]
    return gather(bpms), gather(ok), gather(greens)
