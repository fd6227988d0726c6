"""ROI geometry and detection-dropout holdover as batched index math.

Port of ``vhr_tpu/ops/roi.py`` (``BoxTrack``, ``roi_from_bbox``,
``cheek_roi``, ``forehead_roi``, ``measurement_roi``, ``holdover``,
``holdover_with_carry``).  Boxes and ROIs are ``(..., 4)`` int32 tensors
``[x1, y1, x2, y2]``.

The JAX holdover is a ``lax.scan`` over frames.  Here it is closed-form:
with ``j(t)`` the last valid index up to ``t`` (a ``cummax``) and
``fails(t)`` the attempted-but-failed frames in ``(j(t), t]`` (a
``cumsum``), frame ``t`` is valid when
``v | has_last & (~attempted | fails <= budget)``, where ``budget`` is
``hold_frames`` after a detection and the carried budget before the first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import ROIConfig

__all__ = ["BoxTrack", "roi_from_bbox", "cheek_roi", "forehead_roi",
           "measurement_roi", "holdover", "holdover_with_carry",
           "init_holdover_carry"]

HoldoverCarry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class BoxTrack(NamedTuple):
    """Per-frame boxes with validity after dropout holdover."""

    box: torch.Tensor    # (T, 4) int32 [x1, y1, x2, y2]
    valid: torch.Tensor  # (T,) bool


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


def init_holdover_carry(device=None) -> HoldoverCarry:
    """Fresh ``(last_box (4,) int32, budget () int32, has_last () bool)``."""
    return (torch.zeros((4,), dtype=torch.int32, device=device),
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
    across chunk boundaries."""
    T = box.shape[0]
    dev = box.device
    valid = valid.to(torch.bool)
    att = (torch.ones_like(valid) if attempted is None
           else attempted.to(torch.bool))
    if carry is None:
        carry = init_holdover_carry(dev)
    last0 = carry[0].to(device=dev, dtype=torch.int32)
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
    boxes = torch.where(seen[:, None], box.to(torch.int32)[j.clamp(min=0)],
                        last0.expand(T, 4))

    if T == 0:
        return BoxTrack(box=boxes, valid=out_valid), carry
    # Each attempted failure drains one unit while the budget is positive.
    f, b = fails[-1], budget_ref[-1]
    drained = b - torch.minimum(f, b.clamp(min=0))
    budget_end = torch.where(has[-1], drained, b).to(torch.int32)
    final = (boxes[-1], budget_end, has[-1])
    return BoxTrack(box=boxes, valid=out_valid), final
