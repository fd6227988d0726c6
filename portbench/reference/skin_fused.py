"""The fused skin form's reference: the skin-chroma test on pooled cells,
the holdover tracker and the cheek-ROI means, per frame of a flat batch
of streams.

Frozen from ``vhr_tpu_torch`` at commit 523c5c8:
``models/skin_detector.py`` (``_fma32``, ``ycbcr_from_bgr``, lines 56-77;
``SkinDetectorConfig``'s bounds) and ``ops/fused_cuda.py``
(``_skin_cells``, ``_chunk_stats``, ``fused_detect_roi_plain``, lines
131-276).  Departures:

- only the configuration's path is kept: every frame detected
  (``detect_every=1``), ungated (``gate_margin=None``), tracking reset at
  each stream's first frame (``seq_len``);
- without a gate every row chunk is tested, so the per-chunk sums are
  taken over the whole frame at once, on the device;
- the ROI sums are taken in float64 and divided in float64 (the port
  divides float32 sums);
- ``precision="bfloat16"`` is the control: the chroma planes and the
  means in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from .track import roi_means

FRAME_CHUNK = 32


def _fma32(a: float, x: torch.Tensor, c) -> torch.Tensor:
    """float32 ``fma(a, x, c)``: one rounding of the exact ``a*x + c``
    (exact in float64 for these operands), rounded once to float32."""
    return (float(np.float32(a)) * x + c).to(torch.float32).to(torch.float64)


def ycbcr(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
          precision: str = "float32"):
    """float32 Y, Cb, Cr of B, G, R planes, rounded as the port's chroma
    test rounds them (a chain of float32 fused multiply-adds); in
    bfloat16 arithmetic for the control."""
    if precision == "bfloat16":
        b, g, r = (v.to(torch.bfloat16) for v in (b, g, r))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
        return y.float(), cb.float(), cr.float()
    b, g, r = b.to(torch.float64), g.to(torch.float64), r.to(torch.float64)
    g_term = (float(np.float32(0.587)) * g).to(torch.float32).to(torch.float64)
    y = _fma32(0.114, b, _fma32(0.299, r, g_term))
    cb = _fma32(0.5, b, _fma32(-0.331264, g, _fma32(-0.168736, r, 128.0)))
    cr = _fma32(-0.081312, b, _fma32(-0.418688, g, _fma32(0.5, r, 128.0)))
    return y.to(torch.float32), cb.to(torch.float32), cr.to(torch.float32)


def skin_cells(frames: torch.Tensor, pool: int, skin: dict,
               precision: str = "float32") -> torch.Tensor:
    """``(n, H, W, 3)`` u8 -> ``(n, H // pool, W)`` bool: the chroma test
    on ``pool``-row means (a power of two, so the mean is exact)."""
    n, H, W, _ = frames.shape
    x = (frames.reshape(n, H // pool, pool, W, 3).to(torch.int32).sum(2)
         .to(torch.float32) * (1.0 / pool))
    y, cb, cr = ycbcr(x[..., 0], x[..., 1], x[..., 2], precision)
    return ((cb >= skin["cb_min"]) & (cb <= skin["cb_max"])
            & (cr >= skin["cr_min"]) & (cr <= skin["cr_max"])
            & (y >= skin["y_min"]))


def frame_stats(frames: torch.Tensor, pool: int, skin: dict,
                precision: str = "float32") -> np.ndarray:
    """``(N, H, W, 3)`` u8 -> ``(N, 5)`` int64 per frame: skin cells, the
    first and last row of a pooled row with >= 2 skin cells (``H`` / -1
    when none), the first and last column with >= 2 skin cells (``W`` /
    -1 when none)."""
    N, H, W, _ = frames.shape
    dev = frames.device
    out = []
    q = torch.arange(H // pool, device=dev)
    cols = torch.arange(W, device=dev)
    for s in range(0, N, FRAME_CHUNK):
        sk = skin_cells(frames[s:s + FRAME_CHUNK], pool, skin, precision)
        cells = sk.sum((1, 2))
        has_row = sk.sum(-1) >= 2
        rmin = torch.where(has_row, q * pool, H).amin(-1)
        rmax = torch.where(has_row, q * pool + pool - 1, -1).amax(-1)
        occ = sk.sum(1) * pool >= 2
        xmin = torch.where(occ, cols, W).amin(-1)
        xmax = torch.where(occ, cols, -1).amax(-1)
        out.append(torch.stack([cells, rmin, rmax, xmin, xmax], -1))
    return torch.cat(out).cpu().numpy().astype(np.int64)


def track(stats: np.ndarray, H: int, W: int, seq_len: int, pool: int,
          skin: dict, roi: dict):
    """The holdover tracker over a flat batch of streams of ``seq_len``
    frames: ``(rois (N, 4), boxes (N, 4), det_valid (N,), roi_valid (N,))``.
    Frame ``t``'s ROI is the cheek rectangle of the box tracked from the
    frames before it."""
    f32 = np.float32
    min_area = f32(skin["min_area_fraction"] * H * W)
    ch, ct, cb = f32(roi["cheek_horizontal"]), f32(roi["cheek_top"]), \
        f32(roi["cheek_bottom"])
    hold = int(roi["landmark_hold_frames"])
    N = stats.shape[0]
    rois = np.zeros((N, 4), np.int64)
    boxes = np.zeros((N, 4), np.int64)
    flags = np.zeros((N, 2), bool)
    st = [0, 0, 0, 0, 0, 0]
    for t in range(N):
        bx1, by1, bx2, by2 = st[:4]
        has_prev = st[5] > 0 and t % seq_len != 0
        bw, bh = f32(bx2 - bx1), f32(by2 - by1)
        rx1 = bx1 + int(np.floor(ch * bw))
        rx2 = bx2 - int(np.ceil(ch * bw))
        ry1 = by1 + int(np.floor(ct * bh))
        ry2 = by1 + int(np.floor(cb * bh))
        cells, rmin, rmax, xmin, xmax = (int(v) for v in stats[t])
        det_ok = f32(cells * pool) >= min_area
        reuse_ok = not det_ok and has_prev and st[4] > 0
        new_box = [xmin, rmin, xmax, rmax] if det_ok else [bx1, by1, bx2,
                                                           by2]
        rois[t] = [rx1, ry1, rx2, ry2]
        boxes[t] = new_box
        area = max(ry2 - ry1, 0) * max(rx2 - rx1, 0)
        flags[t] = [det_ok, has_prev and area > 0]
        budget = hold if det_ok else st[4] - 1 if reuse_ok else st[4]
        st = new_box + [budget, int(det_ok or has_prev)]
    return rois, boxes, flags[:, 0], flags[:, 1]


def reference(frames: torch.Tensor, cfg: dict,
              precision: str = "float32") -> dict:
    """``(S, T, H, W, 3)`` u8 recordings -> per frame ``(S, T, ...)``:
    ``boxes``, ``box_valid`` (this frame's detection), ``roi_valid`` (the
    track the ROI was taken from), ``means`` (float64)."""
    S, T, H, W, _ = frames.shape
    flat = frames.reshape(S * T, H, W, 3)
    pool = int(cfg["fused"]["detect_row_pool"])
    stats = frame_stats(flat, pool, cfg["skin"], precision)
    rois, boxes, det_ok, roi_ok = track(stats, H, W, T, pool, cfg["skin"],
                                        cfg["pipeline"]["roi"])
    means = roi_means(flat, rois, precision)
    return {"boxes": boxes.reshape(S, T, 4),
            "box_valid": det_ok.reshape(S, T),
            "roi_valid": roi_ok.reshape(S, T),
            "means": means.reshape(S, T, 3)}
