"""Multi-subject face localization: the top-K skin regions of each frame.

Port of ``vhr_tpu/models/multiface.py``.  Faces separate as runs of
occupied columns in the skin mask's x-projection (side-by-side subjects),
each run's box recovered by masked min/max reductions:

  skin mask -> column occupancy -> run ids (cumsum of run starts) ->
  per-candidate masked box + area -> top-K by area -> x-sorted identity.

Identity across frames is x-order; per-face dropout tolerance is the K-track
holdover (``ops.roi.holdover_multi_step``).  Vertically stacked faces do not
separate in the x-projection (the JAX package's documented limitation).

The two cuts are stable sorts: ``lax.top_k`` puts the lower index first
among equal areas, and ``jnp.argsort`` keeps the order of equal keys, so two
faces of equal area keep their identities as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .skin_detector import SkinDetectorConfig, pooled_skin_mask

__all__ = ["detect_faces_multi"]

# Frames per detection step: the per-candidate masks are (frames, H, W), so
# a chunk bounds them independently of the clip length.
_FRAME_CHUNK = 32


def _detect_chunk(frames: torch.Tensor, k_faces: int,
                  cfg: SkinDetectorConfig, n_cand: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    T, H0, W0, _ = frames.shape
    k = cfg.downsample
    mask = pooled_skin_mask(frames, cfg)                    # (T, H, W)
    _, H, W = mask.shape
    dev = frames.device

    col_occ = mask.sum(1) >= 2                              # noise floor
    prev = torch.cat([torch.zeros_like(col_occ[:, :1]), col_occ[:, :-1]], 1)
    starts = col_occ & ~prev
    run_id = torch.cumsum(starts.to(torch.int64), dim=1) - 1
    run_id = torch.where(col_occ, run_id, -1)               # (T, W)

    col_idx = torch.arange(W, device=dev).expand(T, W)
    row_idx = torch.arange(H, device=dev).expand(T, H)
    boxes_c, area_c = [], []
    for r in range(n_cand):
        sel = run_id == r                                   # (T, W)
        x1 = torch.where(sel, col_idx, W).amin(1)
        x2 = torch.where(sel, col_idx, -1).amax(1)
        rowsum = (mask & sel[:, None, :]).sum(2)            # (T, H)
        row_occ = rowsum >= 2
        y1 = torch.where(row_occ, row_idx, H).amin(1)
        y2 = torch.where(row_occ, row_idx, -1).amax(1)
        boxes_c.append(torch.stack([x1, y1, x2, y2], -1))
        area_c.append(rowsum.sum(1))
    boxes_c = torch.stack(boxes_c, 1)                       # (T, C, 4)
    area_c = torch.stack(area_c, 1)                         # (T, C)
    thresh = torch.full((), cfg.min_area_fraction * (H * W),
                        dtype=torch.float32, device=dev)
    ok = (boxes_c[..., 2] >= boxes_c[..., 0]) & (
        area_c.to(torch.float32) >= thresh)
    ranked = torch.where(ok, area_c, -1)

    top = torch.sort(ranked, dim=1, descending=True,
                     stable=True).indices[:, :k_faces]      # (T, K)
    boxes = torch.gather(boxes_c, 1, top[..., None].expand(T, k_faces, 4))
    valid = torch.gather(ok, 1, top)

    # Stable identity: the kept faces left to right, invalid last.
    order = torch.argsort(torch.where(valid, boxes[..., 0], W + 1), dim=1,
                          stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand(T, k_faces, 4))
    valid = torch.gather(valid, 1, order)

    if k > 1:
        boxes = torch.stack([(boxes[..., 0] * k).clamp(max=W0 - 1),
                             (boxes[..., 1] * k).clamp(max=H0 - 1),
                             (boxes[..., 2] * k + (k - 1)).clamp(max=W0 - 1),
                             (boxes[..., 3] * k + (k - 1)).clamp(max=H0 - 1)],
                            dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0).to(torch.int32)
    return boxes, valid


def detect_faces_multi(frames: torch.Tensor, k_faces: int = 2,
                       cfg: SkinDetectorConfig = SkinDetectorConfig(),
                       candidates: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame top-``k_faces`` face boxes from skin occupancy.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
      candidates: column runs considered before the top-K cut (default
        ``k_faces + 2``: spurious slivers lose the area ranking).
    Returns:
      ``(boxes, valid)``: ``(T, K, 4)`` int32 ``[x1, y1, x2, y2]``
      (inclusive ends), x-sorted (leftmost face first), and ``(T, K)``
      bool.  Frames are processed ``_FRAME_CHUNK`` at a time.
    """
    n_cand = candidates or (k_faces + 2)
    parts = [_detect_chunk(frames[s:s + _FRAME_CHUNK], k_faces, cfg, n_cand)
             for s in range(0, frames.shape[0], _FRAME_CHUNK)]
    if not parts:
        return (torch.zeros((0, k_faces, 4), dtype=torch.int32,
                            device=frames.device),
                torch.zeros((0, k_faces), dtype=torch.bool,
                            device=frames.device))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
