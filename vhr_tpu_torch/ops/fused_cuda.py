"""K1 and K4: skin detection + holdover tracking + cheek-ROI means.

Port of ``vhr_tpu/ops/pallas_fused.py`` (``FusedResult``, ``init_carry``,
``fused_detect_roi_carry``, ``fused_detect_roi_slots``, and
``fused_detect_roi_pallas`` as :func:`fused_detect_roi_cuda`).  K1
(``csrc/fused_detect.cu``) tracks one stream through a clip; K4
(``csrc/fused_slots.cu``) advances S independent serving slots by one frame
each.  Each frame's ROI is the cheek rectangle of the box tracked from
*previous* frames, so frame 0 of a fresh clip has ``roi_valid=False``.

A CPU tensor takes the plain version (:func:`fused_detect_roi_plain`: the
per-chunk skin test vectorised, the tracking in a Python loop over frames;
:func:`fused_detect_roi_slots_plain` runs it per slot); a CUDA tensor
launches the kernel or raises.  The Pallas wrapper's ``t_block`` (a Mosaic
SMEM limit) has no counterpart: one launch covers the whole clip.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..config import ROIConfig
from ..models.skin_detector import SkinDetectorConfig, ycbcr_from_bgr
from .reduce import roi_channel_means
from .roi_means_cuda import INSTANCES, alignment, roi_plan, sm_count

__all__ = ["FusedResult", "init_carry", "fused_detect_roi_carry",
           "fused_detect_roi_cuda", "fused_detect_roi_plain",
           "fused_detect_roi_slots", "fused_detect_roi_slots_plain",
           "LAUNCHES", "SLOT_LAUNCHES"]

# Kernel launches made by fused_detect_roi_carry (K1) and
# fused_detect_roi_slots (K4), CUDA tensors only.
LAUNCHES = 0
SLOT_LAUNCHES = 0

# Frames per step of the plain version's vectorised skin test.
_FRAME_CHUNK = 32


class FusedResult(NamedTuple):
    means: torch.Tensor      # (T, 3) float32 cheek-ROI channel means
    count: torch.Tensor      # (T,) float32 ROI pixel count (0 if not roi_valid)
    boxes: torch.Tensor      # (T, 4) int32 detected face boxes (this frame)
    det_valid: torch.Tensor  # (T,) bool skin-area validity (this frame)
    roi_valid: torch.Tensor  # (T,) bool tracked-box validity used for the ROI


def init_carry(device=None) -> torch.Tensor:
    """Fresh ``(6,)`` int32 tracking state ``[x1, y1, x2, y2, budget,
    has_last]``."""
    return torch.zeros((6,), dtype=torch.int32, device=device)


class _Geometry(NamedTuple):
    T: int
    H: int
    W: int
    rb: int          # rows per chunk
    n_chunks: int
    min_area: np.float32
    t_start: int     # the launch covers frames [t_start, t_start + t_len)
    t_len: int
    phase0: int      # cadence index of frame t_start


def _geometry(frames: torch.Tensor, row_block: int, detect_row_pool: int,
              det: SkinDetectorConfig, detect_every: int, rescan_every: int,
              seq_len: Optional[int], t_start: int, t_len: Optional[int],
              phase: Optional[int]) -> _Geometry:
    """Validate a launch's arguments and derive its chunk geometry."""
    if frames.dim() == 3:
        T, H, WC = frames.shape
        if WC % 3:
            raise ValueError(f"flat row width {WC} is not a multiple of 3")
        W = WC // 3
    elif frames.dim() == 4 and frames.shape[-1] == 3:
        T, H, W, _ = frames.shape
    else:
        raise ValueError(f"frames must be (T,H,W,3) or (T,H,W*3), got "
                         f"{tuple(frames.shape)}")
    # The JAX kernel's contract (kept so both packages accept the same
    # clips).
    if H % 8 != 0 or (W * 3) % 128 != 0:
        raise ValueError("fused kernel needs H % 8 == 0 and W*3 % 128 == 0")
    if detect_row_pool not in (1, 2, 4, 8):
        raise ValueError("detect_row_pool must be 1, 2, 4 or 8 (must divide "
                         "the 8-row chunk alignment)")
    if detect_every < 1 or rescan_every < 1 or (seq_len is not None
                                                and seq_len < 1):
        raise ValueError("detect_every, rescan_every and seq_len must be "
                         ">= 1")
    if t_len is None:
        t_len = T - t_start
    if not (0 <= t_start and t_start + t_len <= T):
        raise ValueError(f"frames [{t_start}, {t_start + t_len}) outside "
                         f"a clip of {T}")
    rb = max(8, min(row_block, H) // 8 * 8)
    return _Geometry(T, H, W, rb, -(-H // rb),
                     np.float32(det.min_area_fraction * H * W), t_start,
                     t_len, t_start if phase is None else int(phase))


def _skin_cells(frames: torch.Tensor, pool: int, det: SkinDetectorConfig
                ) -> torch.Tensor:
    """``(T, H, W, 3)`` u8 -> ``(T, H//pool, W)`` bool skin test on
    ``pool``-row mean-pooled cells (``pool`` is a power of two, so the
    mean is exact)."""
    T, H, W, _ = frames.shape
    x = (frames.reshape(T, H // pool, pool, W, 3).to(torch.int32).sum(2)
         .to(torch.float32) * (1.0 / pool))
    y, cb, cr = ycbcr_from_bgr(x[..., 0], x[..., 1], x[..., 2])
    return ((cb >= det.cb_min) & (cb <= det.cb_max) & (cr >= det.cr_min)
            & (cr <= det.cr_max) & (y >= det.y_min))


def _chunk_stats(frames: torch.Tensor, g: _Geometry, pool: int,
                 det: SkinDetectorConfig):
    """Per (frame, chunk): skin cells per column ``(T, n, W)``, and cell
    count, first and last row of a pooled row with >= 2 skin cells
    ``(T, n, 3)`` (``H`` / ``-1`` when there is none)."""
    cols, stats = [], []
    bounds = [(i * g.rb // pool, min((i + 1) * g.rb, g.H) // pool)
              for i in range(g.n_chunks)]
    for s in range(0, frames.shape[0], _FRAME_CHUNK):
        skin = _skin_cells(frames[s:s + _FRAME_CHUNK], pool, det)
        n = skin.shape[0]
        q = torch.arange(skin.shape[1], device=skin.device)
        has_row = skin.sum(-1) >= 2                           # (n, H/p)
        rmin = torch.where(has_row, q * pool, g.H)
        rmax = torch.where(has_row, q * pool + pool - 1, -1)
        c_cols, c_stats = [], []
        for lo, hi in bounds:
            cc = skin[:, lo:hi].sum(1)                        # (n, W)
            c_cols.append(cc)
            c_stats.append(torch.stack([cc.sum(-1), rmin[:, lo:hi].amin(-1),
                                        rmax[:, lo:hi].amax(-1)], -1))
        cols.append(torch.stack(c_cols, 1).reshape(n, g.n_chunks, g.W))
        stats.append(torch.stack(c_stats, 1))
    return torch.cat(cols), torch.cat(stats)


def fused_detect_roi_plain(frames: torch.Tensor, carry: torch.Tensor,
                           det: SkinDetectorConfig = SkinDetectorConfig(),
                           roi: ROIConfig = ROIConfig(),
                           row_block: int = 128,
                           detect_every: int = 1,
                           gate_margin: Optional[float] = None,
                           rescan_every: int = 30,
                           detect_row_pool: int = 1,
                           seq_len: Optional[int] = None,
                           t_start: int = 0,
                           t_len: Optional[int] = None,
                           phase: Optional[int] = None
                           ) -> Tuple[FusedResult, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_detect_roi_carry` (any device).

    The chunked skin test runs vectorised over all frames; the tracking
    state machine runs in a Python loop over frames on the host.
    """
    g = _geometry(frames, row_block, detect_row_pool, det, detect_every,
                  rescan_every, seq_len, t_start, t_len, phase)
    t_len = g.t_len
    dev = frames.device
    fr = frames.reshape(g.T, g.H, g.W, 3)[t_start:t_start + t_len]
    pool = detect_row_pool
    colcnt, stats = _chunk_stats(fr, g, pool, det)
    colcnt, stats = colcnt.cpu(), stats.cpu().tolist()
    starts = [min(i * g.rb, g.H - g.rb) for i in range(g.n_chunks)]
    f32 = np.float32

    st = [int(v) for v in carry.cpu().tolist()]
    rois = np.zeros((t_len, 4), np.int32)
    boxes = np.zeros((t_len, 4), np.int32)
    flags = np.zeros((t_len, 2), bool)
    for t in range(t_len):
        ph = g.phase0 + t
        bx1, by1, bx2, by2 = st[:4]
        has_prev = st[5] > 0
        do_detect = ph % detect_every == 0
        if seq_len is not None:
            fresh = ph % seq_len == 0
            has_prev = has_prev and not fresh
            do_detect = do_detect or fresh
        bw, bh = f32(bx2 - bx1), f32(by2 - by1)
        rx1 = bx1 + int(np.floor(f32(roi.cheek_horizontal) * bw))
        rx2 = bx2 - int(np.ceil(f32(roi.cheek_horizontal) * bw))
        ry1 = by1 + int(np.floor(f32(roi.cheek_top) * bh))
        ry2 = by1 + int(np.floor(f32(roi.cheek_bottom) * bh))
        gy1, gy2 = 0, g.H
        if gate_margin is not None:
            periodic = ph % (detect_every * rescan_every) == 0
            if not (periodic or not has_prev or st[4] <= 0):
                marg = int(np.ceil(f32(gate_margin) * bh))
                gy1, gy2 = max(by1 - marg, 0), min(by2 + 1 + marg, g.H)
        xmin, xmax, cells, rmin, rmax = g.W, -1, 0, g.H, -1
        if do_detect:
            sel = [i for i, s in enumerate(starts)
                   if s < gy2 and s + g.rb > gy1]
            if sel:
                occ = torch.nonzero(colcnt[t, sel].sum(0) * pool >= 2)
                if occ.numel():
                    xmin, xmax = int(occ.min()), int(occ.max())
                cells = sum(stats[t][i][0] for i in sel)
                rmin = min(stats[t][i][1] for i in sel)
                rmax = max(stats[t][i][2] for i in sel)
        det_ok = do_detect and f32(cells * pool) >= g.min_area
        tracked = not do_detect and has_prev
        reuse_ok = do_detect and not det_ok and has_prev and st[4] > 0
        new_box = [xmin, rmin, xmax, rmax] if det_ok else [bx1, by1, bx2, by2]
        rois[t] = [rx1, ry1, rx2, ry2]
        boxes[t] = new_box
        area = max(ry2 - ry1, 0) * max(rx2 - rx1, 0)
        flags[t] = [det_ok or tracked, has_prev and area > 0]
        budget = (roi.landmark_hold_frames if det_ok
                  else st[4] - 1 if reuse_ok else st[4])
        st = new_box + [budget, int(det_ok or has_prev)]

    flags_t = torch.as_tensor(flags, device=dev)
    means, count = roi_channel_means(fr, torch.as_tensor(rois, device=dev))
    res = FusedResult(means=means,
                      count=torch.where(flags_t[:, 1], count, 0.0),
                      boxes=torch.as_tensor(boxes, device=dev),
                      det_valid=flags_t[:, 0], roi_valid=flags_t[:, 1])
    return res, torch.as_tensor(st, dtype=torch.int32, device=dev)


def fused_detect_roi_carry(frames: torch.Tensor, carry: torch.Tensor,
                           det: SkinDetectorConfig = SkinDetectorConfig(),
                           roi: ROIConfig = ROIConfig(),
                           row_block: int = 128,
                           detect_every: int = 1,
                           gate_margin: Optional[float] = None,
                           rescan_every: int = 30,
                           detect_row_pool: int = 1,
                           seq_len: Optional[int] = None,
                           t_start: int = 0,
                           t_len: Optional[int] = None,
                           phase: Optional[int] = None
                           ) -> Tuple[FusedResult, torch.Tensor]:
    """One launch over frames ``[t_start, t_start + t_len)`` with explicit
    tracking carry.

    Args:
      frames: ``(T, H, W, 3)`` or flat ``(T, H, W*3)`` uint8 BGR; needs
        ``H % 8 == 0`` and ``W*3 % 128 == 0``.
      carry: ``(6,)`` int32 ``[x1, y1, x2, y2, hold_budget, has_last]``
        (:func:`init_carry` for a fresh one).
      detect_every: run the skin test on frames whose phase is a multiple
        of it; the box is tracked in between.
      gate_margin: with a tracked box, test only row chunks inside a band
        of ``gate_margin * box height`` around it; full scans every
        ``rescan_every``-th detection, when nothing is tracked and when the
        holdover budget is spent.  ``None`` scans the full frame.
      detect_row_pool: mean-pool this many rows (1, 2, 4 or 8) before the
        chroma test.
      seq_len: the time axis is a concatenation of independent streams of
        this length; tracking resets at each stream start.
      phase: the first frame's global index for the cadences (defaults to
        ``t_start``).

    Returns:
      ``(FusedResult, carry_out)``.
    """
    if frames.device.type == "cpu":
        return fused_detect_roi_plain(
            frames, carry, det, roi, row_block, detect_every, gate_margin,
            rescan_every, detect_row_pool, seq_len, t_start, t_len, phase)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    g = _geometry(frames, row_block, detect_row_pool, det, detect_every,
                  rescan_every, seq_len, t_start, t_len, phase)
    if frames.dtype != torch.uint8:
        raise TypeError(f"K1 takes uint8 frames, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("K1 needs contiguous frames")
    t_len = g.t_len
    dev = frames.device
    carry = carry.to(device=dev, dtype=torch.int32).contiguous()
    if tuple(carry.shape) != (6,):
        raise ValueError(f"carry must be (6,), got {tuple(carry.shape)}")

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    colcnt, stats = i32(t_len, g.n_chunks, g.W), i32(t_len, g.n_chunks, 3)
    full = i32(t_len, 5)
    rois, boxes, flags, carry_out = i32(t_len, 4), i32(t_len, 4), \
        i32(t_len, 2), i32(6)
    means = torch.empty((t_len, 3), dtype=torch.float32, device=dev)
    count = torch.empty((t_len,), dtype=torch.float32, device=dev)
    # The ROI sums are K2's launch on the t_len frames from t_start.
    pitch = g.W * 3
    plan = roi_plan(t_len, g.H, g.W, 3, g.H * pitch, pitch,
                    alignment(frames.data_ptr() + t_start * g.H * pitch),
                    sm_count(dev.index or 0))
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    global LAUNCHES
    LAUNCHES += 1
    err = lib.vhr_fused_detect_roi(
        frames.data_ptr(), t_start, t_len, g.phase0, g.H, g.W, g.rb,
        g.n_chunks, detect_row_pool, detect_every, seq_len or 0,
        int(gate_margin is not None),
        0.0 if gate_margin is None else gate_margin, rescan_every,
        float(g.min_area), det.cb_min, det.cb_max, det.cr_min, det.cr_max,
        det.y_min, roi.cheek_horizontal, roi.cheek_top, roi.cheek_bottom,
        roi.landmark_hold_frames, INSTANCES.index(plan.instance),
        plan.bands, plan.threads, plan.grid, carry.data_ptr(),
        carry_out.data_ptr(),
        colcnt.data_ptr(), stats.data_ptr(), full.data_ptr(), rois.data_ptr(),
        boxes.data_ptr(), flags.data_ptr(), means.data_ptr(),
        count.data_ptr(), stream)
    _build.check(err, "fused_detect_roi_carry")
    res = FusedResult(means=means, count=count, boxes=boxes,
                      det_valid=flags[:, 0] > 0, roi_valid=flags[:, 1] > 0)
    return res, carry_out


def fused_detect_roi_cuda(frames: torch.Tensor,
                          det: SkinDetectorConfig = SkinDetectorConfig(),
                          roi: ROIConfig = ROIConfig(),
                          row_block: int = 128,
                          detect_every: int = 1,
                          gate_margin: Optional[float] = None,
                          rescan_every: int = 30,
                          detect_row_pool: int = 1,
                          seq_len: Optional[int] = None) -> FusedResult:
    """Skin box detection + cheek-ROI means over a whole clip from a fresh
    tracking state (the counterpart of ``fused_detect_roi_pallas``)."""
    res, _ = fused_detect_roi_carry(
        frames, init_carry(frames.device), det, roi, row_block, detect_every,
        gate_margin, rescan_every, detect_row_pool, seq_len)
    return res


def _slot_args(frames: torch.Tensor, carry: torch.Tensor, phase: torch.Tensor,
               row_block: int, detect_row_pool: int, det: SkinDetectorConfig,
               detect_every: int, rescan_every: int) -> _Geometry:
    g = _geometry(frames, row_block, detect_row_pool, det, detect_every,
                  rescan_every, None, 0, None, None)
    if g.T == 0:
        raise ValueError("fused_detect_roi_slots needs at least one slot")
    if tuple(carry.shape) != (g.T, 6) or tuple(phase.shape) != (g.T,):
        raise ValueError(f"{g.T} slots need carry ({g.T}, 6) and phase "
                         f"({g.T},), got {tuple(carry.shape)} and "
                         f"{tuple(phase.shape)}")
    return g


def fused_detect_roi_slots_plain(frames: torch.Tensor, carry: torch.Tensor,
                                 phase: torch.Tensor,
                                 det: SkinDetectorConfig = SkinDetectorConfig(),
                                 roi: ROIConfig = ROIConfig(),
                                 row_block: int = 128,
                                 detect_every: int = 1,
                                 gate_margin: Optional[float] = None,
                                 rescan_every: int = 30,
                                 detect_row_pool: int = 1
                                 ) -> Tuple[FusedResult, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_detect_roi_slots` (any
    device): :func:`fused_detect_roi_plain` on each slot's frame, from the
    slot's carry row at the slot's phase."""
    g = _slot_args(frames, carry, phase, row_block, detect_row_pool, det,
                   detect_every, rescan_every)
    fr = frames.reshape(g.T, g.H, g.W, 3)
    parts = [fused_detect_roi_plain(
        fr[s:s + 1], carry[s], det, roi, row_block, detect_every,
        gate_margin, rescan_every, detect_row_pool, phase=int(ph))
        for s, ph in enumerate(phase.tolist())]
    res = FusedResult(*(torch.cat([getattr(p[0], f) for p in parts])
                        for f in FusedResult._fields))
    return res, torch.stack([p[1] for p in parts])


# K4's accumulators, one zero-filled int32 tensor per (device, stream).  Every
# launch leaves them zero again, so any slot count and frame size can share
# a tensor that is long enough; two launches on different streams must not.
_SLOT_SCRATCH: dict = {}


def _slot_scratch(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           stream)
    buf = _SLOT_SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SLOT_SCRATCH[key] = torch.zeros(n, dtype=torch.int32,
                                               device=dev)
    return buf


def fused_detect_roi_slots(frames: torch.Tensor, carry: torch.Tensor,
                           phase: torch.Tensor,
                           det: SkinDetectorConfig = SkinDetectorConfig(),
                           roi: ROIConfig = ROIConfig(),
                           row_block: int = 128,
                           detect_every: int = 1,
                           gate_margin: Optional[float] = None,
                           rescan_every: int = 30,
                           detect_row_pool: int = 1
                           ) -> Tuple[FusedResult, torch.Tensor]:
    """S independent live streams, one frame each, in one launch (the
    serving-pool tick).

    Args:
      frames: ``(S, H, W, 3)`` or flat ``(S, H, W*3)`` uint8 BGR, slot s's
        current frame; ``H % 8 == 0`` and ``W*3 % 128 == 0``.
      carry: ``(S, 6)`` int32, each slot's ``[x1, y1, x2, y2, hold_budget,
        has_last]`` (a zeroed row is a fresh slot).
      phase: ``(S,)`` int32, each slot's own frame counter for the
        ``detect_every`` / ``rescan_every`` cadences.  The kernel reads it
        from device memory, so a caller keeping it on the card never waits.
      Other knobs as :func:`fused_detect_roi_carry`.

    Returns:
      ``(FusedResult with a leading (S,) axis, carry_out (S, 6))``; per
      slot, :func:`fused_detect_roi_carry` at ``t_len=1, phase=phase[s]``.
    """
    if frames.device.type == "cpu":
        return fused_detect_roi_slots_plain(
            frames, carry, phase, det, roi, row_block, detect_every,
            gate_margin, rescan_every, detect_row_pool)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    g = _slot_args(frames, carry, phase, row_block, detect_row_pool, det,
                   detect_every, rescan_every)
    if frames.dtype != torch.uint8:
        raise TypeError(f"K4 takes uint8 frames, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("K4 needs contiguous frames")
    if frames.data_ptr() % 16:
        raise ValueError("K4 needs 16-byte aligned frames")
    S, dev = g.T, frames.device
    carry = carry.to(device=dev, dtype=torch.int32).contiguous()
    phase = phase.to(device=dev, dtype=torch.int32).contiguous()

    # One allocation for the outputs (the pool keeps them across ticks, so
    # they are fresh each call): carry_out (S, 6) and boxes (S, 4) int32,
    # means (S, 3) and count (S,) float32, det_valid and roi_valid (S,) bool.
    out = torch.empty((S * 58,), dtype=torch.uint8, device=dev)
    carry_out = out[:S * 24].view(torch.int32).view(S, 6)
    boxes = out[S * 24:S * 40].view(torch.int32).view(S, 4)
    means = out[S * 40:S * 52].view(torch.float32).view(S, 3)
    count = out[S * 52:S * 56].view(torch.float32)
    valid = out[S * 56:].view(torch.bool).view(2, S)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _slot_scratch(dev, stream, S * (7 + g.W // 16 + g.H))
    global SLOT_LAUNCHES
    SLOT_LAUNCHES += 1
    err = lib.vhr_fused_detect_roi_slots(
        frames.data_ptr(), S, g.H, g.W, g.rb, detect_row_pool, detect_every,
        int(gate_margin is not None),
        0.0 if gate_margin is None else gate_margin, rescan_every,
        float(g.min_area), det.cb_min, det.cb_max, det.cr_min, det.cr_max,
        det.y_min, roi.cheek_horizontal, roi.cheek_top, roi.cheek_bottom,
        roi.landmark_hold_frames, carry.data_ptr(), phase.data_ptr(),
        carry_out.data_ptr(), scratch.data_ptr(), boxes.data_ptr(),
        valid.data_ptr(), means.data_ptr(), count.data_ptr(), stream)
    _build.check(err, "fused_detect_roi_slots")
    res = FusedResult(means=means, count=count, boxes=boxes,
                      det_valid=valid[0], roi_valid=valid[1])
    return res, carry_out
