"""The reference's production face pipeline (MediaPipe FaceLandmarker) in
PyTorch.

Port of ``vhr_tpu/models/mediapipe_face.py``: the weights of MediaPipe's
``face_landmarker.task`` (BlazeFace short-range detector + 478-point face
mesh) run through the port's own TFLite reader and executor
(:mod:`vhr_tpu_torch.models.tflite`, :mod:`vhr_tpu_torch.models.tflite_exec`),
and the graph logic around them — SSD anchors, box decode, weighted NMS,
rotated square ROI, 256x256 crop and landmark re-projection — is batched
tensor code.  Graph parameters (public MediaPipe graph configs):

* face detector: input 128x128 RGB in [-1, 1], letterboxed; 896 unit-size
  anchor centres (16x16x2 + 8x8x6); decode scale 128, 6 keypoints, sigmoid
  scores clipped at +-100, min score 0.5; weighted NMS at IoU 0.3.
* landmarks: ROI = detection box rotated so the eye keypoints are level,
  scaled 1.5x, long-side square; input 256x256 RGB in [0, 1]; outputs 478
  xyz landmarks in crop pixels and a face-presence logit (sigmoid, 0.5).

Crop modes: ``"axis"`` (default) samples the mesh crop axis-aligned as two
separable interpolation-matrix products (:func:`_crop_axis_mxu`); ``"exact"``
keeps MediaPipe's rotated bilinear sampling (:func:`_crop_rotated_ref`, the
4-tap form; the JAX package's packed-tap gather is a TPU workaround that is
bit-exact with it).

The nets and the full-resolution casts run over the frames in slices of
``_SLICE`` frames, which bounds device memory (a bf16 copy of 960 1080p
frames alone is 12 GB); with K faces a frame the mesh net takes ``K *
_SLICE`` crops a slice.  With ``fuse_stages`` the mesh net's four residual
stages run on kernel K5.

Four detectors share the stages: the single-face box
(:func:`make_mediapipe_detector`), K faces in x-order
(:func:`make_mediapipe_detector_multi`), the cheek ROI carved in the face's
rolled frame (:func:`make_mediapipe_roi_detector`) and the ring of mesh
vertices the polygon measure reads (:func:`make_mediapipe_poly_detector`).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import float32_exact, resolve_device

__all__ = ["blazeface_anchors", "load_face_models", "detect_faces_mp",
           "face_landmarks", "make_mediapipe_detector",
           "make_mediapipe_detector_multi", "make_mediapipe_roi_detector",
           "make_mediapipe_poly_detector", "default_task_path",
           "MediaPipeFaceParams"]

_MIN_DET_SCORE = 0.5          # TensorsToDetections min_score_thresh
_NMS_IOU = 0.3                # min_suppression_threshold
_ROI_SCALE = 1.5              # RectTransformation scale_x/scale_y
_MIN_PRESENCE = 0.5           # min_face_presence_confidence
_DET_SIZE = 128
_LM_SIZE = 256
# Frames per slice through the letterbox, the crops and the nets.
_SLICE = 64


def default_task_path() -> str:
    """The bundled model asset, ``checkpoints/face_landmarker.task`` at the
    root of the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "checkpoints", "face_landmarker.task")


def blazeface_anchors() -> np.ndarray:
    """(896, 2) anchor centers (x, y), normalized to the 128px square.

    SsdAnchorsCalculator with fixed_anchor_size=true: every anchor is unit
    sized, so only the center grid survives — 2 anchors per cell on the
    stride-8 16x16 map, 6 per cell on the merged stride-16 8x8 maps.
    """
    out = []
    for fm, per_cell in ((16, 2), (8, 6)):
        for y in range(fm):
            for x in range(fm):
                cx, cy = (x + 0.5) / fm, (y + 0.5) / fm
                out.extend([(cx, cy)] * per_cell)
    a = np.asarray(out, np.float32)
    assert a.shape == (896, 2)
    return a


class MediaPipeFaceParams(NamedTuple):
    det: dict                 # BlazeFace weights (tensor index -> tensor)
    lm: dict                  # face-mesh weights


_CACHE = {}


def load_face_models(task_path: Optional[str] = None, compute_dtype=None,
                     activation_dtype=None, fuse_stages=False, device=None):
    """Parse the .task zip once -> ``(params, det_apply, lm_apply)``.

    ``compute_dtype=torch.bfloat16`` rounds both nets' conv operands to
    bf16 with float32 accumulation; ``activation_dtype=torch.bfloat16``
    also stores every feature map in bf16, and the letterbox and crops hand
    the nets bf16 (``apply.io_dtype``).  ``fuse_stages`` runs the mesh net's
    residual stages on kernel K5 (``"auto"``: when ``device`` is a CUDA
    card).  ``device`` defaults to the CUDA card.  Cached per argument set.
    """
    task_path = task_path or default_task_path()
    device = resolve_device(device)
    if fuse_stages == "auto":
        fuse_stages = device.type == "cuda"
    fuse_stages = bool(fuse_stages)
    key = (task_path, str(compute_dtype), str(activation_dtype), fuse_stages,
           str(device))
    if key in _CACHE:
        return _CACHE[key]
    from .tflite import load_task_models
    from .tflite_exec import build_torch
    models = load_task_models(task_path)
    det_params, det_apply = build_torch(
        models["face_detector.tflite"].graph, compute_dtype=compute_dtype,
        activation_dtype=activation_dtype, device=device)
    lm_params, lm_apply = build_torch(
        models["face_landmarks_detector.tflite"].graph,
        compute_dtype=compute_dtype, activation_dtype=activation_dtype,
        fuse_stages=fuse_stages, device=device)
    det_apply.io_dtype = activation_dtype
    lm_apply.io_dtype = activation_dtype
    params = MediaPipeFaceParams(det=det_params, lm=lm_params)
    _CACHE[key] = (params, det_apply, lm_apply)
    return _CACHE[key]


# --- detector stage ---------------------------------------------------------

def _letterbox_geometry(H: int, W: int, size: int):
    """Static (Python-time) keep-aspect letterbox: scale + centered pads."""
    scale = size / max(H, W)
    h2, w2 = int(round(H * scale)), int(round(W * scale))
    pad_y, pad_x = (size - h2) // 2, (size - w2) // 2
    return scale, h2, w2, pad_x, pad_y


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) matrix equal to ``jax.image.resize('bilinear')``
    along one axis, including its antialiasing triangle kernel on
    downscale (a mirror of ``jax._src.image.scale.compute_weight_mat`` with
    translation=0, antialias=True, triangle kernel)."""
    scale = n_dst / n_src
    kernel_scale = max(1.0 / scale, 1.0)                 # antialias dilation
    sample_f = (np.arange(n_dst) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_src)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)                         # triangle kernel
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample_f >= -0.5) & (sample_f <= n_src - 0.5))[None, :],
                 w, 0.0)
    return np.asarray(w, np.float32).T


def _letterbox(frames_bgr_u8: torch.Tensor, size: int, lo: float, hi: float,
               dtype=torch.float32) -> torch.Tensor:
    """(T, H, W, 3) BGR u8 -> (T, size, size, 3) RGB in [lo, hi], in
    ``dtype``.

    The antialiased bilinear resize runs as two separable products with
    :func:`_resize_matrix`'s matrices straight off the frame cast to
    ``dtype`` (u8 values are exact in bf16); the resize is per channel, so
    the BGR->RGB flip is taken on the small result."""
    T, H, W, _ = frames_bgr_u8.shape
    dev = frames_bgr_u8.device
    scale, h2, w2, pad_x, pad_y = _letterbox_geometry(H, W, size)
    ax = torch.as_tensor(_resize_matrix(W, w2), device=dev).to(dtype)
    ay = torch.as_tensor(_resize_matrix(H, h2), device=dev).to(dtype)
    with float32_exact():
        bgr = frames_bgr_u8.to(dtype)
        tmp = torch.einsum("thwc,mw->thmc", bgr, ax)     # (T, H, w2, 3)
        small = torch.einsum("nh,thmc->tnmc", ay, tmp).flip(-1)
    canvas = torch.zeros((T, size, size, 3), dtype=dtype, device=dev)
    canvas[:, pad_y:pad_y + h2, pad_x:pad_x + w2] = small
    return canvas * torch.tensor((hi - lo) / 255.0, dtype=dtype) \
        + torch.tensor(lo, dtype=dtype)


def _decode_detections(reg: torch.Tensor, cls: torch.Tensor,
                       anchors: torch.Tensor):
    """Raw SSD outputs -> (boxes x1y1x2y2, scores, keypoints), letterbox-
    normalized.  reg (T, 896, 16): [cx, cy, w, h, 6x(kx, ky)] each /128
    relative to its (unit-size) anchor center."""
    s = 1.0 / _DET_SIZE
    cxy = reg[..., 0:2] * s + anchors                    # (T, 896, 2)
    wh = reg[..., 2:4] * s
    half = wh * 0.5
    boxes = torch.cat([cxy - half, cxy + half], dim=-1)
    kps = reg[..., 4:16].reshape(reg.shape[:-1] + (6, 2)) * s \
        + anchors[..., None, :]
    scores = torch.sigmoid(torch.clamp(cls[..., 0], -100.0, 100.0))
    return boxes, scores, kps


def _iou_one_vs_all(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of ``box (..., 4)`` with each of ``boxes (..., A, 4)``."""
    lt = torch.maximum(box[..., None, :2], boxes[..., :2])
    rb = torch.minimum(box[..., None, 2:], boxes[..., 2:])
    inter = torch.prod(torch.clamp_min(rb - lt, 0.0), dim=-1)
    a = torch.prod(torch.clamp_min(box[..., 2:] - box[..., :2], 0.0),
                   dim=-1)[..., None]
    b = torch.prod(torch.clamp_min(boxes[..., 2:] - boxes[..., :2], 0.0),
                   dim=-1)
    return inter / torch.clamp_min(a + b - inter, 1e-9)


def _weighted_nms(boxes, scores, kps, k_faces: int,
                  min_score: float = _MIN_DET_SCORE,
                  iou_thresh: float = _NMS_IOU):
    """MediaPipe WEIGHTED NonMaxSuppression, static top-K, batched over
    frames.

    Per slot: take the highest-scoring remaining candidate, blend every
    remaining candidate with IoU >= threshold into it (score-weighted box
    and keypoints), retire them.  boxes (T, A, 4), scores (T, A), kps
    (T, A, 6, 2) -> (T, K, 4), (T, K), (T, K, 6, 2), ok (T, K).
    """
    remaining = scores >= min_score
    out_b, out_s, out_kp, out_ok = [], [], [], []
    for _ in range(k_faces):
        masked = torch.where(remaining, scores,
                             torch.full_like(scores, -np.inf))
        i = torch.argmax(masked, dim=1, keepdim=True)   # (T, 1)
        top = torch.gather(masked, 1, i)[:, 0]
        box_i = torch.gather(boxes, 1, i[..., None].expand(-1, -1, 4))[:, 0]
        sim = remaining & (_iou_one_vs_all(box_i, boxes) >= iou_thresh)
        w = torch.where(sim, scores, torch.zeros_like(scores))[..., None]
        wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-9)      # (T, 1)
        out_b.append(torch.sum(boxes * w, dim=1) / wsum)
        out_kp.append(torch.sum(kps * w[..., None], dim=1) / wsum[..., None])
        out_s.append(top)
        out_ok.append(top >= min_score)
        remaining = remaining & ~sim
    return (torch.stack(out_b, 1), torch.stack(out_s, 1),
            torch.stack(out_kp, 1), torch.stack(out_ok, 1))


class _Rect(NamedTuple):
    cx: torch.Tensor          # image px
    cy: torch.Tensor
    side: torch.Tensor        # square side, image px
    rot: torch.Tensor         # radians


def _detection_to_rect(box, kps, H: int, W: int) -> _Rect:
    """Letterbox-normalized detection -> rotated square ROI in image px.

    DetectionsToRects (rotation: kp0 -> kp1 levelled to 0 deg) +
    RectTransformation (scale 1.5, square_long).
    """
    scale, h2, w2, pad_x, pad_y = _letterbox_geometry(H, W, _DET_SIZE)

    def to_px(p):
        return ((p[..., 0] * _DET_SIZE - pad_x) / scale,
                (p[..., 1] * _DET_SIZE - pad_y) / scale)

    x1, y1 = to_px(box[..., 0:2])
    x2, y2 = to_px(box[..., 2:4])
    kx, ky = to_px(kps)                                  # (..., 6)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    rot = -torch.atan2(-(ky[..., 1] - ky[..., 0]), kx[..., 1] - kx[..., 0])
    side = torch.maximum(x2 - x1, y2 - y1) * _ROI_SCALE
    return _Rect(cx=cx, cy=cy, side=side, rot=rot)


def _sample_grid(rect: _Rect, size: int):
    """Sample positions of a rotated square crop, ``(…, size, size)`` each
    for x and y, for rect fields of shape ``(…)``."""
    u = (torch.arange(size, dtype=torch.float32, device=rect.cx.device)
         + 0.5) / size - 0.5
    vv, uu = torch.meshgrid(u, u, indexing="ij")         # uu varies along x
    c, s = torch.cos(rect.rot)[..., None, None], \
        torch.sin(rect.rot)[..., None, None]
    side = rect.side[..., None, None]
    xs = rect.cx[..., None, None] + (uu * c - vv * s) * side
    ys = rect.cy[..., None, None] + (uu * s + vv * c) * side
    return xs, ys


def _crop_rotated_ref(frames_bgr_u8: torch.Tensor, rect: _Rect,
                      size: int) -> torch.Tensor:
    """Bilinear-sample a rotated square rect per face: frames ``(T, H, W,
    3)`` u8 BGR and rect fields ``(T, K)`` -> ``(T, K, size, size, 3)`` RGB
    in [0, 1], float32.  Taps are clamped into the frame (MediaPipe's
    ``exact`` crop)."""
    T, H, W, _ = frames_bgr_u8.shape
    img = frames_bgr_u8.flip(-1).to(torch.float32)
    xs, ys = _sample_grid(rect, size)                    # (T, K, s, s)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    t = torch.arange(T, device=img.device).reshape(T, 1, 1, 1)
    p00, p01 = img[t, y0i, x0i], img[t, y0i, x1i]
    p10, p11 = img[t, y1i, x0i], img[t, y1i, x1i]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    out = top * (1 - fy) + bot * fy
    return out / 255.0


def _interp_matrix(coords: torch.Tensor, n_src: int) -> torch.Tensor:
    """(..., n_out) float32 sample coordinates -> (..., n_out, n_src)
    bilinear interpolation matrix with :func:`_crop_rotated_ref`'s edge
    clamp (clip the floor tap into range, second tap = clip(+1))."""
    x0 = torch.floor(coords)
    f = (coords - x0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, n_src - 1)[..., None]
    x1i = torch.clamp(x0i + 1, 0, n_src - 1)
    src = torch.arange(n_src, device=coords.device)
    return (1.0 - f) * (src == x0i) + f * (src == x1i)


def _crop_axis_mxu(frames_bgr_u8: torch.Tensor, rect: _Rect, size: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Axis-aligned bilinear crop per face (rect.rot ignored) as two
    interpolation-matrix products: frames ``(T, H, W, 3)`` u8 BGR and rect
    fields ``(T, K)`` -> ``(T, K, size, size, 3)`` RGB in [0, 1], in
    ``dtype`` (u8 values are exact in bf16; the weights round to 2^-9)."""
    T, H, W, _ = frames_bgr_u8.shape
    u = (torch.arange(size, dtype=torch.float32,
                      device=frames_bgr_u8.device) + 0.5) / size - 0.5
    gx = _interp_matrix(rect.cx[..., None] + u * rect.side[..., None],
                        W).to(dtype)                     # (T, K, size, W)
    gy = _interp_matrix(rect.cy[..., None] + u * rect.side[..., None],
                        H).to(dtype)                     # (T, K, size, H)
    with float32_exact():
        img = frames_bgr_u8.to(dtype)
        tmp = torch.einsum("thwc,tkmw->tkhmc", img, gx)  # x-pass
        out = torch.einsum("tknh,tkhmc->tknmc", gy, tmp).flip(-1)
    return out / torch.tensor(255.0, dtype=dtype)


def _crop_faces(frames: torch.Tensor, rects: _Rect, size: int,
                mode: str = "exact", dtype=torch.float32) -> torch.Tensor:
    """(T, H, W, 3) BGR u8 + rects with (T, K) fields -> (T, K, size,
    size, 3) RGB [0, 1] crops.  ``mode="exact"``: rotated bilinear
    sampling; ``mode="axis"``: the separable crop (rect.rot must already be
    zeroed by the caller so projection agrees)."""
    if mode == "axis":
        return _crop_axis_mxu(frames, rects, size, dtype=dtype)
    if mode != "exact":
        raise ValueError(f"unknown crop mode {mode!r} ('axis' | 'exact')")
    return _crop_rotated_ref(frames, rects, size).to(dtype)


def _project_landmarks(lm_crop: torch.Tensor, rect: _Rect) -> torch.Tensor:
    """Crop-pixel landmarks (..., 478, 3) -> image-pixel (x, y)
    (..., 478, 2), for rect fields of shape (...)."""
    u = lm_crop[..., 0] / _LM_SIZE - 0.5
    v = lm_crop[..., 1] / _LM_SIZE - 0.5
    c, s = torch.cos(rect.rot)[..., None], torch.sin(rect.rot)[..., None]
    side = rect.side[..., None]
    x = rect.cx[..., None] + (u * c - v * s) * side
    y = rect.cy[..., None] + (u * s + v * c) * side
    return torch.stack([x, y], dim=-1)


def _slices(T: int):
    return [slice(s, min(T, s + _SLICE)) for s in range(0, T, _SLICE)]


# --- public stages ----------------------------------------------------------

def detect_faces_mp(params: MediaPipeFaceParams, det_apply, frames,
                    k_faces: int = 1):
    """BlazeFace over a frame batch: (T, H, W, 3) BGR u8 ->
    (rects, scores (T, K), ok (T, K)) — rotated square ROIs in image px."""
    T, H, W, _ = frames.shape
    io = det_apply.io_dtype or torch.float32
    anchors = torch.as_tensor(blazeface_anchors(), device=frames.device)
    outs = []
    with torch.no_grad():
        for sl in _slices(T):
            x = _letterbox(frames[sl], _DET_SIZE, -1.0, 1.0, dtype=io)
            reg, cls = det_apply(params.det, x)          # (t,896,16),(t,896,1)
            boxes, scores, kps = _decode_detections(reg, cls, anchors)
            outs.append(_weighted_nms(boxes, scores, kps, k_faces))
    b, s, kp, ok = (torch.cat(parts) for parts in zip(*outs))
    rects = _detection_to_rect(b, kp, H, W)              # fields (T, K)
    return rects, s, ok


def face_landmarks(params: MediaPipeFaceParams, lm_apply, frames, rects,
                   crop_mode: str = "axis"):
    """Face mesh over per-frame rects: -> (landmarks_px (T, K, 478, 2),
    presence (T, K)).  ``crop_mode="axis"`` (product default) feeds the
    mesh an unrotated crop: the ROI rotation is dropped from both sampling
    and re-projection; ``"exact"`` keeps MediaPipe's rotated sampling."""
    if crop_mode == "axis":
        rects = rects._replace(rot=torch.zeros_like(rects.rot))
    T = frames.shape[0]
    K = rects.cx.shape[-1]
    io = lm_apply.io_dtype or torch.float32
    lms, pres = [], []
    with torch.no_grad():
        for sl in _slices(T):
            rs = _Rect(*(f[sl] for f in rects))
            crops = _crop_faces(frames[sl], rs, _LM_SIZE, mode=crop_mode,
                                dtype=io)                # (t, K, 256, 256, 3)
            t = crops.shape[0]
            out = lm_apply(params.lm, crops.reshape(t * K, _LM_SIZE,
                                                    _LM_SIZE, 3))
            lms.append(out[0].reshape(t, K, 478, 3))
            pres.append(torch.sigmoid(out[1].reshape(t, K)))
    lm, presence = torch.cat(lms), torch.cat(pres)
    return _project_landmarks(lm, rects), presence


def _landmarks_to_bbox(lm_px: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Landmark cloud -> int bbox, the reference's `_bbox_from_landmarks`
    (analysis/utils/roi.py:43-51): min/max over all points, clipped."""
    x1 = torch.clamp(lm_px[..., 0].amin(-1), 0, W - 1)
    y1 = torch.clamp(lm_px[..., 1].amin(-1), 0, H - 1)
    x2 = torch.clamp(lm_px[..., 0].amax(-1), 0, W - 1)
    y2 = torch.clamp(lm_px[..., 1].amax(-1), 0, H - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1).to(torch.int32)


def _detect_multi(params: MediaPipeFaceParams, det_apply, lm_apply,
                  k_faces: int, frames: torch.Tensor,
                  crop_mode: str = "axis"):
    """K faces a frame: ``(boxes (T, K, 4) int32, valid (T, K))``, the valid
    faces first in the order of their ``x1`` (a stable sort: equal ``x1``
    keep the detector's order), invalid slots zeroed."""
    T, H, W, _ = frames.shape
    rects, _, det_ok = detect_faces_mp(params, det_apply, frames,
                                       k_faces=k_faces)
    lm_px, presence = face_landmarks(params, lm_apply, frames, rects,
                                     crop_mode=crop_mode)
    boxes = _landmarks_to_bbox(lm_px, H, W)               # (T, K, 4)
    valid = det_ok & (presence >= _MIN_PRESENCE)
    key = torch.where(valid, boxes[..., 0], W + 1)
    order = torch.argsort(key, dim=1, stable=True)
    boxes = torch.take_along_dim(boxes, order[..., None], dim=1)
    valid = torch.take_along_dim(valid, order, dim=1)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return boxes, valid


def _rotated_cheek_roi(lm_px: torch.Tensor, rot: torch.Tensor,
                       horizontal: float, top: float, bottom: float,
                       W: int, H: int) -> torch.Tensor:
    """Cheek ROI carved in the face's own (rolled) frame.

    The landmark cloud ``lm_px (..., 478, 2)`` is rotated by ``-rot`` (the
    detector's eye-line roll, ``(...)`` radians) into the face's frame; the
    ratio rectangle is carved from its min/max box there, its four corners
    are rotated back, and their axis-aligned box is returned, truncated
    toward zero and clipped: ``x1``/``y1`` to ``[0, W - 1]``/``[0, H -
    1]``, ``x2``/``y2`` to ``W``/``H``.  Returns ``(..., 4)`` int32.
    """
    c, s = torch.cos(rot)[..., None], torch.sin(rot)[..., None]
    px = lm_px[..., 0] * c + lm_px[..., 1] * s
    py = -lm_px[..., 0] * s + lm_px[..., 1] * c
    x1, x2 = px.amin(-1), px.amax(-1)
    y1, y2 = py.amin(-1), py.amax(-1)
    w, h = x2 - x1, y2 - y1
    lx1, lx2 = x1 + horizontal * w, x2 - horizontal * w
    ly1, ly2 = y1 + top * h, y1 + bottom * h
    cx = torch.stack([lx1, lx2, lx1, lx2], dim=-1)
    cy = torch.stack([ly1, ly1, ly2, ly2], dim=-1)
    qx = cx * c - cy * s
    qy = cx * s + cy * c
    return torch.stack([qx.amin(-1).to(torch.int32).clamp(0, W - 1),
                        qy.amin(-1).to(torch.int32).clamp(0, H - 1),
                        qx.amax(-1).to(torch.int32).clamp(0, W),
                        qy.amax(-1).to(torch.int32).clamp(0, H)], dim=-1)


def _single_face(params, det_apply, lm_apply, frames, crop_mode):
    """The one-face stages: ``(rects, landmarks (T, 478, 2), box (T, 4),
    valid (T,))``, the box zeroed where the face is not valid."""
    T, H, W, _ = frames.shape
    rects, _, det_ok = detect_faces_mp(params, det_apply, frames, k_faces=1)
    lm_px, presence = face_landmarks(params, lm_apply, frames, rects,
                                     crop_mode=crop_mode)
    valid = det_ok[:, 0] & (presence[:, 0] >= _MIN_PRESENCE)
    boxes = _landmarks_to_bbox(lm_px[:, 0], H, W)
    boxes = torch.where(valid[:, None], boxes, torch.zeros_like(boxes))
    return rects, lm_px[:, 0], boxes, valid


def _detect_single(params: MediaPipeFaceParams, det_apply, lm_apply,
                   frames: torch.Tensor, crop_mode: str = "axis"):
    """``(boxes (T, 4) int32, valid (T,))``: the landmark box of one face a
    frame, zeroed where invalid."""
    _, _, boxes, valid = _single_face(params, det_apply, lm_apply, frames,
                                      crop_mode)
    return boxes, valid


def _detect_single_roi(params: MediaPipeFaceParams, det_apply, lm_apply,
                       frames: torch.Tensor, roi_ratios,
                       crop_mode: str = "axis"):
    """``(boxes (T, 4), rois (T, 4), valid (T,))``: the landmark box and
    the cheek ROI of :func:`_rotated_cheek_roi`, zeroed where invalid."""
    _, H, W, _ = frames.shape
    rects, lm, boxes, valid = _single_face(params, det_apply, lm_apply,
                                           frames, crop_mode)
    rois = _rotated_cheek_roi(lm, rects.rot[:, 0], *roi_ratios, W, H)
    rois = torch.where(valid[:, None], rois, torch.zeros_like(rois))
    return boxes, rois, valid


def _detect_single_poly(params: MediaPipeFaceParams, det_apply, lm_apply,
                        frames: torch.Tensor, poly_idx,
                        crop_mode: str = "axis"):
    """``(boxes (T, 4), verts (T, E, 2) float32, valid (T,))``: the
    landmark box and the pixel positions of the mesh vertices
    ``poly_idx``, zeroed where invalid."""
    _, lm, boxes, valid = _single_face(params, det_apply, lm_apply, frames,
                                       crop_mode)
    idx = torch.as_tensor(poly_idx, dtype=torch.int64, device=lm.device)
    verts = torch.where(valid[:, None, None], lm[:, idx, :], 0.0)
    return boxes, verts, valid


def _factory(task_path, compute_dtype, activation_dtype, device):
    """The nets for a detector factory: bf16 activations by default, the
    mesh's stages on K5 on a CUDA card (``fuse_stages="auto"``), on
    ``device`` (the CUDA card by default)."""
    if activation_dtype == "default":
        activation_dtype = torch.bfloat16
    device = resolve_device(device)
    return device, load_face_models(
        task_path, compute_dtype, activation_dtype=activation_dtype,
        fuse_stages="auto", device=device)


def make_mediapipe_detector(task_path: Optional[str] = None,
                            compute_dtype=None, crop_mode: str = "axis",
                            activation_dtype="default", device=None):
    """The production-weight face detector as a pipeline detector:
    ``frames (T, H, W, 3) u8 -> (boxes (T, 4) int32, valid (T,) bool)`` —
    drops into ``pipeline.offline.extract_signals(detector=...)``.  Boxes
    are the landmark min/max, the reference's definition
    (analysis/utils/roi.py:43-51).  ``crop_mode``: "axis" or "exact".

    The product default stores activations in bf16 (the reference's own
    runtime executes these weights as fp16 TFLite kernels); pass
    ``activation_dtype=None`` for the full-float32 path.  The mesh net's
    residual stages run on K5 on a CUDA card and op by op on the CPU
    (``load_face_models(fuse_stages="auto")``).  ``device`` defaults to
    the CUDA card; frames are moved there.
    """
    device, (params, det_apply, lm_apply) = _factory(
        task_path, compute_dtype, activation_dtype, device)

    def detector(frames):
        return _detect_single(params, det_apply, lm_apply,
                              torch.as_tensor(frames, device=device),
                              crop_mode=crop_mode)
    return detector


def make_mediapipe_detector_multi(task_path: Optional[str] = None,
                                  k_faces: int = 2, compute_dtype=None,
                                  crop_mode: str = "axis",
                                  activation_dtype="default", device=None):
    """Multi-face :func:`make_mediapipe_detector`: ``frames -> (boxes (T,
    K, 4) int32, valid (T, K) bool)``, the valid faces in x-order, the
    ``extract_signals_multi`` / ``step_multi`` detector contract.  The mesh
    net runs on ``K`` crops a frame (K5 at ``K * 64`` crops a slice on a
    CUDA card)."""
    device, (params, det_apply, lm_apply) = _factory(
        task_path, compute_dtype, activation_dtype, device)

    def detector(frames):
        return _detect_multi(params, det_apply, lm_apply, k_faces,
                             torch.as_tensor(frames, device=device),
                             crop_mode=crop_mode)
    return detector


def make_mediapipe_roi_detector(task_path: Optional[str] = None,
                                compute_dtype=None, crop_mode: str = "axis",
                                roi_cfg=None, activation_dtype="default",
                                device=None):
    """Pose-robust ROI variant of :func:`make_mediapipe_detector`:
    ``frames -> (boxes (T, 4), rois (T, 4), valid (T,))``, the
    ``pipeline.offline.extract_signals_landmark_roi`` contract; the cheek
    ratios of ``roi_cfg`` (``ROIConfig()`` by default) are applied in the
    face's rolled frame (:func:`_rotated_cheek_roi`)."""
    from ..config import ROIConfig

    roi_cfg = roi_cfg or ROIConfig()
    ratios = (float(roi_cfg.cheek_horizontal), float(roi_cfg.cheek_top),
              float(roi_cfg.cheek_bottom))
    device, (params, det_apply, lm_apply) = _factory(
        task_path, compute_dtype, activation_dtype, device)

    def detector(frames):
        return _detect_single_roi(params, det_apply, lm_apply,
                                  torch.as_tensor(frames, device=device),
                                  ratios, crop_mode=crop_mode)
    return detector


def make_mediapipe_poly_detector(task_path: Optional[str] = None,
                                 compute_dtype=None, crop_mode: str = "axis",
                                 poly_idx=None, activation_dtype="default",
                                 device=None):
    """Mesh-polygon variant of :func:`make_mediapipe_detector`: ``frames ->
    (boxes (T, 4), verts (T, E, 2) float32, valid (T,))``, the
    ``pipeline.offline.extract_signals_polygon`` contract; ``verts`` are the
    pixel positions of the ``poly_idx`` mesh vertices (by default
    :data:`vhr_tpu_torch.ops.polyroi.CHEEK_POLY_IDX`, the cheek band's
    hull)."""
    from ..ops.polyroi import CHEEK_POLY_IDX

    poly_idx = tuple(poly_idx) if poly_idx is not None else CHEEK_POLY_IDX
    device, (params, det_apply, lm_apply) = _factory(
        task_path, compute_dtype, activation_dtype, device)

    def detector(frames):
        return _detect_single_poly(params, det_apply, lm_apply,
                                   torch.as_tensor(frames, device=device),
                                   poly_idx, crop_mode=crop_mode)
    return detector
