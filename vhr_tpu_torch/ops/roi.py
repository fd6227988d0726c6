"""ROI geometry and detection-dropout holdover as batched index math.

Port of ``vhr_tpu/ops/roi.py`` (``BoxTrack``, ``bbox_from_landmarks``,
``roi_from_bbox``, ``cheek_roi``, ``forehead_roi``, ``measurement_roi``,
``roi_from_landmarks``, ``cheek_roi_from_landmarks``, ``holdover``,
``holdover_with_carry``, and the K-track ``holdover_multi``,
``init_multi_carry`` and ``holdover_multi_step``).  Boxes and ROIs are
``(..., 4)`` int32 tensors ``[x1, y1, x2, y2]``.

The JAX holdover is a ``lax.scan`` over frames.  Here it is closed-form:
with ``j(t)`` the last valid index up to ``t`` (a ``cummax``) and
``fails(t)`` the attempted-but-failed frames in ``(j(t), t]`` (a
``cumsum``), frame ``t`` is valid when
``v | has_last & (~attempted | fails <= budget)``, where ``budget`` is
``hold_frames`` after a detection and the carried budget before the first.
The held state is whatever a frame carries: a ``(T, 4)`` int32 box, or a
``(T, 2E)`` float32 vertex ring (the polygon measure).

The K-track holdover matches candidates to tracks, so it stays a step a
frame (:func:`holdover_multi_step`), shared by the offline scan, the live
multi-face step and the serving pool's tick.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ROIConfig

__all__ = ["BoxTrack", "bbox_from_landmarks", "roi_from_bbox", "cheek_roi",
           "forehead_roi", "measurement_roi", "roi_from_landmarks",
           "cheek_roi_from_landmarks", "holdover", "holdover_with_carry",
           "init_holdover_carry", "holdover_multi", "init_multi_carry",
           "holdover_multi_step"]

HoldoverCarry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class BoxTrack(NamedTuple):
    """Per-frame boxes with validity after dropout holdover."""

    box: torch.Tensor    # (T, 4) int32 [x1, y1, x2, y2], or the held state
    valid: torch.Tensor  # (T,) bool


def bbox_from_landmarks(landmarks: torch.Tensor, width: int, height: int
                        ) -> torch.Tensor:
    """Face box from normalized landmarks ``(..., L, 2)``: the min and max
    of the cloud scaled to pixels and truncated toward zero, ``x1``/``y1``
    clipped at 0 and ``x2``/``y2`` at ``width - 1``/``height - 1`` (the
    reference's ``_bbox_from_landmarks``).  Returns ``(..., 4)`` int32."""
    xs, ys = landmarks[..., 0], landmarks[..., 1]
    x1 = (xs.amin(-1) * width).to(torch.int32).clamp(min=0)
    y1 = (ys.amin(-1) * height).to(torch.int32).clamp(min=0)
    x2 = (xs.amax(-1) * width).to(torch.int32).clamp(max=width - 1)
    y2 = (ys.amax(-1) * height).to(torch.int32).clamp(max=height - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def roi_from_bbox(bbox: torch.Tensor, horizontal: float, top: float,
                  bottom: float, width: int, height: int) -> torch.Tensor:
    """Sub-rectangle of a bbox by ratios, clamped to the frame.

    The ROI spans ``[x1 + r*bw, x2 - r*bw]`` horizontally and
    ``[y1 + top*bh, y1 + bottom*bh]`` vertically; the upper-x edge rounds
    via the ceil of the margin.  Returns exclusive ends.
    """
    x1, y1, x2, y2 = bbox.unbind(-1)
    bw = (x2 - x1).to(torch.float32)
    bh = (y2 - y1).to(torch.float32)
    rx1 = x1 + torch.floor(horizontal * bw).to(torch.int32)
    rx2 = x2 - torch.ceil(horizontal * bw).to(torch.int32)
    ry1 = y1 + torch.floor(top * bh).to(torch.int32)
    ry2 = y1 + torch.floor(bottom * bh).to(torch.int32)
    return torch.stack([rx1.clamp(0, width - 1), ry1.clamp(0, height - 1),
                        rx2.clamp(0, width), ry2.clamp(0, height)],
                       dim=-1).to(torch.int32)


def cheek_roi(bbox: torch.Tensor, cfg: ROIConfig, width: int, height: int
              ) -> torch.Tensor:
    return roi_from_bbox(bbox, cfg.cheek_horizontal, cfg.cheek_top,
                         cfg.cheek_bottom, width, height)


def forehead_roi(bbox: torch.Tensor, cfg: ROIConfig, width: int, height: int
                 ) -> torch.Tensor:
    return roi_from_bbox(bbox, cfg.forehead_horizontal, cfg.forehead_top,
                         cfg.forehead_bottom, width, height)


def measurement_roi(bbox: torch.Tensor, cfg: ROIConfig, width: int,
                    height: int, site: str = "cheek") -> torch.Tensor:
    """The configured measurement site's ROI (``PipelineConfig.roi_site``)."""
    if site == "cheek":
        return cheek_roi(bbox, cfg, width, height)
    if site == "forehead":
        return forehead_roi(bbox, cfg, width, height)
    raise ValueError(f"unknown roi_site {site!r} (cheek|forehead)")


def roi_from_landmarks(landmarks: torch.Tensor, horizontal: float,
                       top: float, bottom: float, width: int, height: int
                       ) -> torch.Tensor:
    """Pose-robust ROI from the landmark cloud ``(..., L, 2)`` (normalized
    [x, y]): the box ratios applied in the face's own rotated frame.

    The cloud samples the face boundary at uniform angles, so its first
    circular harmonic gives the centre ``c = mean(pts)`` and the rotated
    semi-axes ``u = (2/L) sum pts_i cos(theta_i)``, ``v = (2/L) sum pts_i
    sin(theta_i)``.  The ratios map to local corners ``alpha = +-(1 - 2
    horizontal)``, ``beta in [2 top - 1, 2 bottom - 1]``; the result is the
    axis-aligned box of the four corners ``c + alpha u + beta v``, truncated
    and clipped as :func:`roi_from_bbox`'s.  Returns ``(..., 4)`` int32
    (exclusive ends).
    """
    L = landmarks.shape[-2]
    dev = landmarks.device
    # The harmonic's tables in float32, built in numpy as the JAX package
    # builds them.
    theta = 2.0 * np.pi * np.arange(L, dtype=np.float32) / L
    cosw = torch.as_tensor(np.cos(theta), device=dev)
    sinw = torch.as_tensor(np.sin(theta), device=dev)
    scale = torch.tensor([width, height], dtype=torch.float32, device=dev)
    pts = landmarks * scale                                   # pixels
    c = pts.mean(-2)
    u = 2.0 / L * (pts * cosw[:, None]).sum(-2)
    v = 2.0 / L * (pts * sinw[:, None]).sum(-2)
    alphas = np.array([-(1.0 - 2.0 * horizontal), 1.0 - 2.0 * horizontal],
                      np.float32)
    betas = np.array([2.0 * top - 1.0, 2.0 * bottom - 1.0], np.float32)
    corners = torch.stack([c + float(a) * u + float(b) * v
                           for a in alphas for b in betas], dim=-2)
    cx, cy = corners[..., 0], corners[..., 1]
    return torch.stack([cx.amin(-1).to(torch.int32).clamp(0, width - 1),
                        cy.amin(-1).to(torch.int32).clamp(0, height - 1),
                        cx.amax(-1).to(torch.int32).clamp(0, width),
                        cy.amax(-1).to(torch.int32).clamp(0, height)],
                       dim=-1)


def cheek_roi_from_landmarks(landmarks: torch.Tensor, cfg: ROIConfig,
                             width: int, height: int) -> torch.Tensor:
    return roi_from_landmarks(landmarks, cfg.cheek_horizontal, cfg.cheek_top,
                              cfg.cheek_bottom, width, height)


def init_holdover_carry(device=None, shape: Tuple[int, ...] = (4,),
                        dtype=torch.int32) -> HoldoverCarry:
    """Fresh ``(last (shape) dtype, budget () int32, has_last () bool)``:
    a ``(4,)`` int32 box by default, or any held state (a ``(2E,)`` float32
    vertex ring)."""
    return (torch.zeros(tuple(shape), dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def holdover(box: torch.Tensor, valid: torch.Tensor, hold_frames: int = 15,
             carry: Optional[HoldoverCarry] = None,
             attempted: Optional[torch.Tensor] = None) -> BoxTrack:
    """Detection-dropout tolerance over the time axis.

    A detected frame refreshes the box and resets the budget to
    ``hold_frames``; an attempted frame whose detection failed reuses the
    last box while the budget lasts and drains it by one; a frame that was
    not attempted (detection cadence) reuses the box without draining the
    budget.  Before the first detection (and with no carried box) frames
    are invalid.  ``attempted=None`` means every frame was attempted.
    """
    track, _ = holdover_with_carry(box, valid, hold_frames, carry, attempted)
    return track


def holdover_with_carry(box: torch.Tensor, valid: torch.Tensor,
                        hold_frames: int = 15,
                        carry: Optional[HoldoverCarry] = None,
                        attempted: Optional[torch.Tensor] = None
                        ) -> Tuple[BoxTrack, HoldoverCarry]:
    """:func:`holdover` that also returns the final carry, so a long
    recording can be processed in chunks with tracking state carried
    across chunk boundaries.  ``box`` is ``(T, ...)``: integer boxes are
    held as int32, a float state (a vertex ring) in its own dtype."""
    T = box.shape[0]
    dev = box.device
    if not box.is_floating_point():
        box = box.to(torch.int32)
    valid = valid.to(torch.bool)
    att = (torch.ones_like(valid) if attempted is None
           else attempted.to(torch.bool))
    if carry is None:
        carry = init_holdover_carry(dev, box.shape[1:], box.dtype)
    last0 = carry[0].to(device=dev, dtype=box.dtype)
    budget0 = carry[1].to(device=dev, dtype=torch.int64)
    has0 = carry[2].to(device=dev, dtype=torch.bool)

    idx = torch.arange(T, device=dev)
    j = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)),
                     dim=0).values
    seen = j >= 0
    failed_cum = torch.cumsum((att & ~valid).to(torch.int64), dim=0)
    fails = failed_cum - torch.where(
        seen, failed_cum[j.clamp(min=0)], torch.zeros_like(failed_cum))
    budget_ref = torch.where(seen, torch.full_like(fails, hold_frames),
                             budget0.expand(T))
    has = seen | has0
    out_valid = valid | (has & (~att | (fails <= budget_ref)))
    held = seen.reshape((T,) + (1,) * (box.dim() - 1))
    boxes = torch.where(held, box[j.clamp(min=0)], last0.expand(box.shape))

    if T == 0:
        return BoxTrack(box=boxes, valid=out_valid), carry
    # Each attempted failure drains one unit while the budget is positive.
    f, b = fails[-1], budget_ref[-1]
    drained = b - torch.minimum(f, b.clamp(min=0))
    budget_end = torch.where(has[-1], drained, b).to(torch.int32)
    final = (boxes[-1], budget_end, has[-1])
    return BoxTrack(box=boxes, valid=out_valid), final


MultiCarry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# The matching's "no pair" cost, as the JAX step's float32 1e9.
_INF = 1e9


def init_multi_carry(k_faces: int, lead: Tuple[int, ...] = (),
                     device=None) -> MultiCarry:
    """Zeroed K-track carry ``(last (..., K, 4) int32, budget (..., K)
    int32, has (..., K) bool)`` for :func:`holdover_multi_step`, with
    leading axes ``lead``."""
    lead = tuple(lead)
    return (torch.zeros(lead + (k_faces, 4), dtype=torch.int32,
                        device=device),
            torch.zeros(lead + (k_faces,), dtype=torch.int32, device=device),
            torch.zeros(lead + (k_faces,), dtype=torch.bool, device=device))


def holdover_multi_step(carry: MultiCarry, cand: torch.Tensor,
                        cval: torch.Tensor, hold_frames: int = 15,
                        attempted=True
                        ) -> Tuple[MultiCarry, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """One frame of the K-track identity-matched holdover, over any leading
    axes (the serving pool's slots).

    1. Greedy nearest-centre matching of valid candidates to live tracks:
       K rounds, each taking the first minimum of the flattened (track,
       candidate) cost, the float32 L1 distance of the box centres
       (``1e9`` where a track or a candidate is not available).
    2. Matched tracks take the candidate's box and a full budget;
       unmatched live tracks hold their box while the budget lasts.
    3. Unmatched candidates claim free slots (never used, or budget spent)
       left to right: the leftmost candidate the lowest free slot (a stable
       sort, so equal centres keep the candidates' order).

    ``attempted`` (a bool or a ``(...)`` tensor) False holds every track
    without matching, draining or claiming (the detection cadence).

    Args:
      carry: ``(last (..., K, 4), budget (..., K), has (..., K))``.
      cand/cval: this frame's ``(..., K, 4)`` candidates and ``(..., K)``
        validity.
    Returns:
      ``(new_carry, (boxes (..., K, 4), valid (..., K)))``.
    """
    last, budget, has = carry
    K = cand.shape[-2]
    dev = cand.device
    cval = cval.to(torch.bool)
    cand = cand.to(torch.int32)

    def centers(b):
        bf = b.to(torch.float32)
        return (bf[..., 0] + bf[..., 2]) * 0.5, (bf[..., 1] + bf[..., 3]) * 0.5

    tx, ty = centers(last)
    cx, cy = centers(cand)
    cost = ((tx[..., :, None] - cx[..., None, :]).abs()
            + (ty[..., :, None] - cy[..., None, :]).abs())     # (..., K, K)
    cost = torch.where(has[..., :, None] & cval[..., None, :], cost, _INF)

    ar = torch.arange(K, device=dev)
    assign = torch.full(cval.shape, -1, dtype=torch.int64, device=dev)
    avail_t, avail_c = has, cval
    for _ in range(K):
        masked = torch.where(avail_t[..., :, None] & avail_c[..., None, :],
                             cost, _INF).flatten(-2)           # (..., K*K)
        flat = torch.argmin(masked, dim=-1, keepdim=True)      # first min
        ok = torch.gather(masked, -1, flat) < _INF             # (..., 1)
        ti, ci = flat // K, flat % K
        assign = torch.where(ok & (ar == ti), ci, assign)
        avail_t = avail_t & ~(ok & (ar == ti))
        avail_c = avail_c & ~(ok & (ar == ci))
    got = assign >= 0

    # New subjects claim free slots, leftmost candidate -> lowest free slot.
    unmatched = cval & avail_c
    free = ~got & (~has | (budget <= 0))
    cand_order = torch.argsort(torch.where(unmatched, cx, _INF), dim=-1,
                               stable=True)
    free_rank = torch.cumsum(free.to(torch.int64), dim=-1) - 1
    n_new = unmatched.sum(-1, keepdim=True)
    seed = free & (free_rank < n_new)
    cidx = torch.gather(cand_order, -1, free_rank.clamp(0, K - 1))
    assign = torch.where(seed, cidx, assign)
    got = assign >= 0

    a = assign.clamp(0, K - 1)
    picked = torch.gather(cand, -2, a[..., None].expand(cand.shape))
    new_last = torch.where(got[..., None], picked, last)
    reuse = ~got & has & (budget > 0)
    new_budget = torch.where(got, torch.full_like(budget, hold_frames),
                             torch.where(reuse, budget - 1, budget))
    new_has = got | has
    out_valid = got | reuse

    if attempted is not True:
        # Not attempted (detection cadence): every live track holds its box
        # and budget; the matching above is discarded.  (A literal True
        # skips this: a scalar copied to the card would wait for its queue.)
        att = torch.as_tensor(attempted, dtype=torch.bool, device=dev)
        new_last = torch.where(att[..., None, None], new_last, last)
        new_budget = torch.where(att[..., None], new_budget, budget)
        new_has = torch.where(att[..., None], new_has, has)
        out_valid = torch.where(att[..., None], out_valid, has)
    return (new_last, new_budget, new_has), (new_last, out_valid)


def holdover_multi(box: torch.Tensor, valid: torch.Tensor,
                   hold_frames: int = 15,
                   attempted: Optional[torch.Tensor] = None) -> BoxTrack:
    """K-track holdover with identity assignment over a clip: per-frame
    candidates ``box (T, K, 4)``, ``valid (T, K)`` (``attempted (T,)``:
    frames where detection ran, ``None`` for all) -> :class:`BoxTrack` with
    ``box (T, K, 4)``, ``valid (T, K)``, slot k one subject for the whole
    clip.  :func:`holdover_multi_step` a frame, from a zeroed carry."""
    T, K = box.shape[0], box.shape[1]
    carry = init_multi_carry(K, device=box.device)
    boxes, valids = [], []
    for t in range(T):
        carry, (b, v) = holdover_multi_step(
            carry, box[t], valid[t], hold_frames,
            True if attempted is None else attempted[t])
        boxes.append(b)
        valids.append(v)
    if T == 0:
        return BoxTrack(box=box.to(torch.int32), valid=valid.to(torch.bool))
    return BoxTrack(box=torch.stack(boxes), valid=torch.stack(valids))
