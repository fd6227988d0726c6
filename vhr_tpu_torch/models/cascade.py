"""Two-stage cascade detection: proposals, then landmarker crop refinement.

Port of ``vhr_tpu/models/cascade.py``.  Three compositions of the learned
landmarker (:mod:`vhr_tpu_torch.models.landmarker`):

* **self-refinement** (:func:`make_refined_detector`): the full-frame
  landmarker proposes a box and a second pass on a pad-0.3 crop around it
  sharpens it (held-out IoU 0.890 -> 0.924, the JAX package's measurement);
* **multi-face cascade** (:func:`make_cascade_detector_multi`): the top-K
  skin proposals of ``models.multiface``, each refined on its crop, the
  landmarker's presence a veto;
* **tiled multi-face** (:func:`make_tiled_detector_multi`): the landmarker
  swept over a static two-scale window grid, score-descending NMS with
  IoMin containment suppression, crop refinement with the presence veto and
  a cross-slot dedupe; no chroma stage, so skin-coloured backgrounds do
  not take the proposals down.

Every crop is a fixed-size separable bilinear resample, two dense
interpolation-matrix products in full float32, with this module's own edge
rule (coordinates clamped to ``[0, n-1]``, the floor tap clipped to
``n-2``).  The crops and the nets run over the frames in slices of
``landmarker._SLICE`` frames, the tiled proposals in groups of at most 512
crops.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..device import float32_exact, resolve_device
from .landmarker import (_SLICE, FaceLandmarker, LandmarkerConfig,
                         build_model, run_net)
from .skin_detector import SkinDetectorConfig

__all__ = ["crop_boxes_bilinear", "refine_boxes", "make_refined_detector",
           "load_default_refined_detector", "make_cascade_detector_multi",
           "tiled_landmark_proposals", "select_faces_nms",
           "make_tiled_detector_multi"]

# Crops a tiled-proposal group holds (512 crops of 96x96x3 float32 are
# about 54 MB).
_GROUP_CROPS = 512


def _interp_matrix(coords: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., S)`` sample coordinates -> ``(..., S, n)`` bilinear matrix:
    coordinates clamped to ``[0, n-1]`` and the floor tap clipped to
    ``n-2``, so values outside the frame repeat its edge row or column."""
    cc = coords.clamp(0.0, n - 1.0)
    i0 = torch.floor(cc).to(torch.int64).clamp(0, n - 2)
    f = (cc - i0.to(torch.float32))[..., None]
    src = torch.arange(n, device=coords.device)
    i0 = i0[..., None]
    return (1.0 - f) * (src == i0) + f * (src == i0 + 1)


def _crop(imgf: torch.Tensor, boxes: torch.Tensor, S: int, pad: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``imgf (T, H, W, 3)`` float32 BGR and ``boxes (T, K, 4)`` -> ``(crops
    (T, K, S, S, 3) float32 RGB in [0, 1], origins (T, K, 4))``."""
    T, H, W, _ = imgf.shape
    b = boxes.to(torch.float32)
    cx = (b[..., 0] + b[..., 2]) * 0.5
    cy = (b[..., 1] + b[..., 3]) * 0.5
    half = torch.maximum(b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]) \
        .clamp(min=2.0) * 0.5 * (1.0 + 2.0 * pad)
    x0, y0 = cx - half, cy - half
    side = 2.0 * half
    u = torch.arange(S, dtype=torch.float32, device=b.device) / (S - 1)
    gx = _interp_matrix(x0[..., None] + u * side[..., None], W)  # (T,K,S,W)
    gy = _interp_matrix(y0[..., None] + u * side[..., None], H)  # (T,K,S,H)
    with float32_exact():
        tmp = torch.einsum("thwc,tksw->tkhsc", imgf, gx)         # x-pass
        crops = torch.einsum("tkrh,tkhsc->tkrsc", gy, tmp)       # y-pass
    crops = crops.flip(-1) / 255.0                               # -> RGB
    return crops, torch.stack([x0, y0, side, side], dim=-1)


def crop_boxes_bilinear(frames: torch.Tensor, boxes: torch.Tensor,
                        out_size: int, pad: float = 0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded square crops around per-frame boxes.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
      boxes: ``(T, 4)`` int32 ``[x1, y1, x2, y2]``.
      pad: fractional margin a side (0.3 for self-refinement: the face
        then spans about 60% of the crop).
    Returns:
      ``(crops (T, S, S, 3) float32 RGB in [0, 1], origins (T, 4) float32
      [x0, y0, w, h])``; the origins map crop coordinates back to pixels.
    """
    crops, origins = _crop(frames.to(torch.float32), boxes[:, None],
                           out_size, pad)
    return crops[:, 0], origins[:, 0]


def _boxes_from_crop_landmarks(lm: torch.Tensor, origins: torch.Tensor,
                               W: int, H: int) -> torch.Tensor:
    """Crop-normalized landmarks ``(..., L, 2)`` and the crops' origins
    ``(..., 4)`` -> the clouds' min/max boxes in pixels ``(..., 4)`` int32,
    clipped to the frame."""
    px = origins[..., 0:1] + lm[..., 0] * origins[..., 2:3]
    py = origins[..., 1:2] + lm[..., 1] * origins[..., 3:4]
    return torch.stack([px.amin(-1).clamp(0, W - 1),
                        py.amin(-1).clamp(0, H - 1),
                        px.amax(-1).clamp(0, W - 1),
                        py.amax(-1).clamp(0, H - 1)],
                       dim=-1).to(torch.int32)


def refine_boxes(model: FaceLandmarker, frames: torch.Tensor,
                 boxes: torch.Tensor, valid: torch.Tensor,
                 threshold: float = 0.0, pad: float = 0.3
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine proposal boxes with the landmarker on padded crops.

    ``boxes`` is ``(T, 4)`` or ``(T, K, 4)`` (K slots a frame), ``valid``
    ``(T,)`` or ``(T, K)``.  Returns the refined ``(boxes, valid)``: an
    invalid proposal passes through unchanged, and one whose crop the
    landmarker rejects (presence not above ``threshold``) turns invalid.
    """
    single = boxes.dim() == 2
    b = boxes[:, None] if single else boxes
    T, H, W, _ = frames.shape
    K = b.shape[1]
    S, L = model.cfg.input_size, model.cfg.num_landmarks
    refined, presence = [], []
    with torch.no_grad():
        for s in range(0, T, _SLICE):
            crops, origins = _crop(frames[s:s + _SLICE].to(torch.float32),
                                   b[s:s + _SLICE], S, pad)
            t = crops.shape[0]
            lm, p = run_net(model, crops.reshape(t * K, S, S, 3))
            refined.append(_boxes_from_crop_landmarks(
                lm.reshape(t, K, L, 2), origins, W, H))
            presence.append(p.reshape(t, K))
    refined, presence = torch.cat(refined), torch.cat(presence)
    if single:
        refined, presence = refined[:, 0], presence[:, 0]
    ok = valid & (presence > threshold)
    return torch.where(ok[..., None], refined, boxes), ok


def make_refined_detector(params: Mapping[str, torch.Tensor],
                          cfg: LandmarkerConfig = LandmarkerConfig(),
                          threshold: float = 0.0, pad: float = 0.3,
                          passes: int = 1, device=None):
    """The single-face accuracy flagship: the full-frame landmarker
    proposes and ``passes`` more landmarker runs on a crop around the
    current box sharpen it.  ``frames (T, H, W, 3) u8 -> (boxes (T, 4),
    valid (T,))`` on ``device`` (the CUDA card by default), the interface
    of ``skin_detector.detect_faces``."""
    from .landmarker import _landmarks, landmarks_to_bbox_valid

    device = resolve_device(device)
    model = build_model(params, cfg, device)

    def detector(frames):
        frames = torch.as_tensor(frames, device=device)
        T, H, W, _ = frames.shape
        lm, presence = _landmarks(model, frames)
        boxes, valid = landmarks_to_bbox_valid(lm, presence, W, H, threshold)
        for _ in range(passes):
            boxes, valid = refine_boxes(model, frames, boxes, valid,
                                        threshold, pad)
        return boxes, valid

    return detector


def load_default_refined_detector(path: Optional[str] = None,
                                  threshold: float = 0.0, passes: int = 1,
                                  device=None):
    """The repo's landmarker weights wrapped as the self-refining
    detector."""
    from .landmarker import load_params

    device = resolve_device(device)
    return make_refined_detector(load_params(path, device),
                                 LandmarkerConfig(), threshold,
                                 passes=passes, device=device)


def _tile_windows(H: int, W: int, scales=(1.0, 0.6)):
    """Static (Python-time) square window grid covering the frame.

    Per scale ``s``: windows of side ``s * min(H, W)`` laid out with ~50%
    overlap along each axis (``linspace`` so the last window always touches
    the frame edge), plus one full-frame window for the large-single-face
    case.  Returns ``(Nw, 4)`` int32 ``[x1, y1, x2, y2]`` inclusive.
    """
    import numpy as np

    wins = []
    for s in scales:
        side = max(int(round(min(H, W) * s)), 8)
        stride = max(side // 2, 1)
        nx = max(1, int(np.ceil((W - side) / stride)) + 1)
        ny = max(1, int(np.ceil((H - side) / stride)) + 1)
        xs = np.round(np.linspace(0, W - side, nx)).astype(np.int32)
        ys = np.round(np.linspace(0, H - side, ny)).astype(np.int32)
        for y0 in ys:
            for x0 in xs:
                wins.append([x0, y0, x0 + side - 1, y0 + side - 1])
    wins.append([0, 0, W - 1, H - 1])
    return np.unique(np.array(wins, np.int32), axis=0)


def tiled_landmark_proposals(model: FaceLandmarker, frames: torch.Tensor,
                             scales=(1.0, 0.6),
                             window_batch: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Learned multi-face proposals: the single-face landmarker swept over
    the static window grid of :func:`_tile_windows`.  Each window yields the
    landmark box of the face it holds, mapped back to frame pixels, with
    the presence logit as its score.

    The frames go ``_SLICE`` at a time and, within a slice of ``t`` frames,
    the windows in groups of ``G = 512 // t`` (at most ``window_batch``):
    one crop pass and one net batch of ``G * t`` crops a group, so a short
    call (the live path) runs every window in one batch.

    Returns ``(boxes (T, Nw, 4) int32, scores (T, Nw) float32)``.
    """
    T, H, W, _ = frames.shape
    wins = torch.as_tensor(_tile_windows(H, W, scales), device=frames.device)
    Nw = wins.shape[0]
    S, L = model.cfg.input_size, model.cfg.num_landmarks
    boxes, scores = [], []
    with torch.no_grad():
        for s in range(0, T, _SLICE):
            imgf = frames[s:s + _SLICE].to(torch.float32)
            t = imgf.shape[0]
            cap = max(1, _GROUP_CROPS // t)
            G = max(1, min(Nw, cap if window_batch is None
                           else min(window_batch, cap)))
            b_s, s_s = [], []
            for g in range(0, Nw, G):
                grp = wins[g:g + G]
                crops, origins = _crop(
                    imgf, grp[None].expand(t, -1, -1), S, pad=0.0)
                n = grp.shape[0]
                lm, p = run_net(model, crops.reshape(t * n, S, S, 3))
                b_s.append(_boxes_from_crop_landmarks(
                    lm.reshape(t, n, L, 2), origins, W, H))
                s_s.append(p.reshape(t, n))
            boxes.append(torch.cat(b_s, dim=1))
            scores.append(torch.cat(s_s, dim=1))
    return torch.cat(boxes), torch.cat(scores)


def _iomin(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Intersection over the *smaller* area of ``box (..., 4)`` against each
    of ``boxes (..., N, 4)`` -> ``(..., N)``.  Unlike IoU it flags
    containment: a partial or merged detection that contains, or is
    contained by, an accepted face scores about 1."""
    def area(b):
        return ((b[..., 2] - b[..., 0] + 1).clamp(min=0)
                * (b[..., 3] - b[..., 1] + 1).clamp(min=0))
    box = box[..., None, :]
    ix1 = torch.maximum(box[..., 0], boxes[..., 0])
    iy1 = torch.maximum(box[..., 1], boxes[..., 1])
    ix2 = torch.minimum(box[..., 2], boxes[..., 2])
    iy2 = torch.minimum(box[..., 3], boxes[..., 3])
    inter = (ix2 - ix1 + 1).clamp(min=0) * (iy2 - iy1 + 1).clamp(min=0)
    denom = torch.minimum(area(box), area(boxes)).to(torch.float32)
    return inter.to(torch.float32) / denom.clamp(min=1.0)


def select_faces_nms(boxes: torch.Tensor, scores: torch.Tensor,
                     k_faces: int, threshold: float = 0.0,
                     suppress: float = 0.35,
                     min_area_fraction: float = 0.001,
                     frame_hw: Optional[Tuple[int, int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape greedy NMS of ``k_faces`` from window proposals, every
    frame at once.

    Score-descending with IoMin containment suppression: the presence head
    ranks clean single-face windows far above merged or partial views, so
    score order picks each true face before any merged box, and IoMin also
    drops a partial re-detection of a face already picked.  Ties go to the
    first window, as ``jnp.argmax``'s do.

    Args:
      boxes/scores: ``(T, Nw, 4)`` / ``(T, Nw)`` from
        :func:`tiled_landmark_proposals`.
    Returns:
      ``(boxes (T, K, 4) int32, valid (T, K) bool)`` in pick order.
    """
    H, W = frame_hw if frame_hw is not None else (None, None)
    min_area = (min_area_fraction * H * W) if frame_hw is not None else 0.0
    T = boxes.shape[0]
    area = ((boxes[..., 2] - boxes[..., 0] + 1)
            * (boxes[..., 3] - boxes[..., 1] + 1)).to(torch.float32)
    ok = scores > threshold
    if min_area:
        ok = ok & (area >= min_area)
    neg_inf = torch.tensor(-float("inf"), device=scores.device)
    key = torch.where(ok, scores, neg_inf)
    picked_b, picked_v = [], []
    for _ in range(k_faces):
        i = key.argmax(dim=1)                                  # (T,)
        keep = torch.isfinite(key.gather(1, i[:, None])[:, 0])
        b = boxes.gather(1, i[:, None, None].expand(T, 1, 4))[:, 0]
        picked_b.append(torch.where(keep[:, None], b, 0))
        picked_v.append(keep)
        overlap = _iomin(b, boxes) > suppress
        key = torch.where(keep[:, None] & overlap, neg_inf, key)
    return (torch.stack(picked_b, dim=1).to(torch.int32),
            torch.stack(picked_v, dim=1))


def make_tiled_detector_multi(params: Mapping[str, torch.Tensor],
                              cfg: LandmarkerConfig = LandmarkerConfig(),
                              k_faces: int = 2, scales=(1.0, 0.6),
                              threshold: float = 0.0, pad: float = 0.3,
                              suppress: float = 0.5, refine: bool = True,
                              device=None):
    """The fully learned multi-face detector: tiled landmarker proposals,
    containment selection and crop refinement of each slot.  ``frames ->
    (boxes (T, K, 4) int32, valid (T, K) bool)``, the valid faces in
    x-order, on ``device`` (the CUDA card by default); drops into
    ``pipeline.offline.extract_signals_multi(detector=...)``."""
    device = resolve_device(device)
    model = build_model(params, cfg, device)

    def detector(frames):
        frames = torch.as_tensor(frames, device=device)
        T, H, W, _ = frames.shape
        props, scores = tiled_landmark_proposals(model, frames, scales)
        boxes, valid = select_faces_nms(props, scores, k_faces, threshold,
                                        suppress, frame_hw=(H, W))
        if refine:
            boxes, valid = refine_boxes(model, frames, boxes, valid,
                                        threshold, pad)
            # Cross-slot dedupe: a half-face proposal at a window edge can
            # slip past NMS, but its refine crop re-centres on the face and
            # converges onto an earlier slot's box; the later (lower score)
            # slot is dropped.
            vv = list(valid.unbind(1))
            for j in range(1, k_faces):
                for i in range(j):
                    dup = vv[i] & (_iomin(boxes[:, j],
                                          boxes[:, i, None])[:, 0] > 0.6)
                    vv[j] = vv[j] & ~dup
            valid = torch.stack(vv, dim=1)
        # Stable x-order identity, as multiface.detect_faces_multi's.
        key = torch.where(valid, boxes[..., 0], W + 1)
        order = torch.argsort(key, dim=1, stable=True)
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        valid = torch.gather(valid, 1, order)
        return torch.where(valid[..., None], boxes, 0), valid

    return detector


def make_cascade_detector_multi(params: Mapping[str, torch.Tensor],
                                cfg: LandmarkerConfig = LandmarkerConfig(),
                                k_faces: int = 2,
                                det: SkinDetectorConfig = SkinDetectorConfig(),
                                threshold: float = 0.0, pad: float = 0.3,
                                device=None):
    """The multi-face cascade: the top-K skin proposals of
    ``multiface.detect_faces_multi``, each refined on its crop.  ``frames ->
    (boxes (T, K, 4), valid (T, K))`` on ``device`` (the CUDA card by
    default)."""
    from .multiface import detect_faces_multi

    device = resolve_device(device)
    model = build_model(params, cfg, device)

    def detector(frames):
        frames = torch.as_tensor(frames, device=device)
        boxes, valid = detect_faces_multi(frames, k_faces, det)
        return refine_boxes(model, frames, boxes, valid, threshold, pad)

    return detector
