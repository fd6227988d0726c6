"""Detect-then-reduce reference: the holdover over detection dropouts and
the cheek ROI of a held box.

Written from the semantics the port documents at commit 523c5c8
(``vhr_tpu_torch/ops/roi.py::holdover``, ``roi_from_bbox``;
``parallel/streams.py::_shard``): a detected frame refreshes the box and
the budget; a failed frame keeps the last box while at most
``hold_frames`` failures have followed it; before the first detection a
frame is invalid.  The ROI spans ``[x1 + floor(h * bw), x2 - ceil(h *
bw)]`` by ``[y1 + floor(top * bh), y1 + floor(bottom * bh)]`` in float32,
clipped to the frame, zero where the track is invalid.
"""

from __future__ import annotations

import numpy as np
import torch

FRAME_CHUNK = 32


def holdover(boxes: np.ndarray, valid: np.ndarray, hold_frames: int):
    """``(T, 4)`` boxes, ``(T,)`` validity -> the held ``(boxes, valid)``."""
    T = boxes.shape[0]
    out = np.zeros((T, 4), np.int64)
    ok = np.zeros(T, bool)
    last, fails, seen = np.zeros(4, np.int64), 0, False
    for t in range(T):
        if valid[t]:
            last, fails, seen = boxes[t].astype(np.int64), 0, True
        elif seen:
            fails += 1
        out[t] = last
        ok[t] = bool(valid[t]) or (seen and fails <= hold_frames)
    return out, ok


def cheek_roi(boxes: np.ndarray, valid: np.ndarray, roi: dict, W: int,
              H: int) -> np.ndarray:
    """``(T, 4)`` held boxes -> ``(T, 4)`` cheek ROIs (exclusive ends)."""
    f32 = np.float32
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    bw = (x2 - x1).astype(f32)
    bh = (y2 - y1).astype(f32)
    h, top, bot = (f32(roi[k]) for k in ("cheek_horizontal", "cheek_top",
                                          "cheek_bottom"))
    rx1 = x1 + np.floor(h * bw).astype(np.int64)
    rx2 = x2 - np.ceil(h * bw).astype(np.int64)
    ry1 = y1 + np.floor(top * bh).astype(np.int64)
    ry2 = y1 + np.floor(bot * bh).astype(np.int64)
    out = np.stack([np.clip(rx1, 0, W - 1), np.clip(ry1, 0, H - 1),
                    np.clip(rx2, 0, W), np.clip(ry2, 0, H)], -1)
    return np.where(valid[:, None], out, 0)


def roi_sums(frames: torch.Tensor, rois: np.ndarray) -> torch.Tensor:
    """``(N, 3)`` float64 sums of each frame's ROI ``[x1, y1, x2, y2]``
    (exclusive ends; pixels outside the frame add nothing)."""
    N, H, W, _ = frames.shape
    dev = frames.device
    r = torch.as_tensor(rois, device=dev)
    rows = torch.arange(H, device=dev)[None, :]
    cols = torch.arange(W, device=dev)[None, :]
    row_m = ((rows >= r[:, 1:2]) & (rows < r[:, 3:4])).to(torch.float64)
    col_m = ((cols >= r[:, 0:1]) & (cols < r[:, 2:3])).to(torch.float64)
    sums = torch.empty((N, 3), dtype=torch.float64, device=dev)
    for s in range(0, N, FRAME_CHUNK):
        e = min(s + FRAME_CHUNK, N)
        part = torch.einsum("thwc,tw->thc", frames[s:e].to(torch.float64),
                            col_m[s:e])
        sums[s:e] = torch.einsum("thc,th->tc", part, row_m[s:e])
    return sums


def roi_means(frames: torch.Tensor, rois: np.ndarray,
              precision: str = "float32") -> np.ndarray:
    """``(N, 3)`` float64 channel means over each frame's ROI (0 where it
    is empty); in bfloat16 for the control."""
    sums = roi_sums(frames, rois).cpu().numpy()
    area = (np.clip(rois[:, 3] - rois[:, 1], 0, None)
            * np.clip(rois[:, 2] - rois[:, 0], 0, None)).astype(np.float64)
    means = sums / np.maximum(area, 1.0)[:, None]
    if precision == "bfloat16":
        means = torch.as_tensor(means).to(torch.bfloat16).double().numpy()
    return means
