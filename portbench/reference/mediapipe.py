"""The MediaPipe FaceLandmarker's reference, one face a frame: the
landmark box and its validity per frame, in float32.

Frozen from ``vhr_tpu_torch/models/mediapipe_face.py`` at commit 523c5c8
(``blazeface_anchors``, ``_letterbox_geometry``, ``_resize_matrix``,
``_letterbox``, ``_decode_detections``, ``_iou_one_vs_all``,
``_weighted_nms``, ``_detection_to_rect``, ``_interp_matrix``,
``_crop_axis_mxu``, ``_project_landmarks``, ``_landmarks_to_bbox``,
``_single_face``; lines 71-520), the public MediaPipe graph parameters
those name (128x128 letterboxed detector input in [-1, 1], 896 unit
anchors, decode scale 128, sigmoid scores clipped at +-100, min score 0.5,
weighted NMS at IoU 0.3, ROI scaled 1.5x to a long-side square, 256x256
crop in [0, 1], presence 0.5).  Departures:

- one face a frame (``k_faces=1``) and the ``"axis"`` crop, the
  configuration's, only;
- everything in float32 (the port runs the nets, the letterbox and the
  crops in bf16) through :mod:`.executor`, TF32 off;
- ``precision="float8"`` is the control: the nets' weights and maps and
  the nets' inputs rounded to float8.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .executor import Graph, no_tf32, rounder
from .tflite_parse import load_task_models

MIN_SCORE, NMS_IOU, ROI_SCALE, MIN_PRESENCE = 0.5, 0.3, 1.5, 0.5
DET_SIZE, LM_SIZE = 128, 256


def anchors() -> np.ndarray:
    out = []
    for fm, per_cell in ((16, 2), (8, 6)):
        for y in range(fm):
            for x in range(fm):
                out.extend([((x + 0.5) / fm, (y + 0.5) / fm)] * per_cell)
    return np.asarray(out, np.float32)


def letterbox_geometry(H: int, W: int, size: int):
    scale = size / max(H, W)
    h2, w2 = int(round(H * scale)), int(round(W * scale))
    return scale, h2, w2, (size - w2) // 2, (size - h2) // 2


@lru_cache(maxsize=None)
def resize_matrix(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) antialiased bilinear resize along one axis (a
    triangle kernel dilated by the downscale)."""
    scale = n_dst / n_src
    kernel_scale = max(1.0 / scale, 1.0)
    sample_f = (np.arange(n_dst) + 0.5) / scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_src)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample_f >= -0.5) & (sample_f <= n_src - 0.5))[None, :],
                 w, 0.0)
    return np.asarray(w, np.float32).T


def letterbox(frames: torch.Tensor) -> torch.Tensor:
    """(t, H, W, 3) u8 BGR -> (t, 128, 128, 3) RGB in [-1, 1]."""
    t, H, W, _ = frames.shape
    dev = frames.device
    _, h2, w2, px, py = letterbox_geometry(H, W, DET_SIZE)
    ax = torch.as_tensor(resize_matrix(W, w2), device=dev)
    ay = torch.as_tensor(resize_matrix(H, h2), device=dev)
    tmp = torch.einsum("thwc,mw->thmc", frames.to(torch.float32), ax)
    small = torch.einsum("nh,thmc->tnmc", ay, tmp).flip(-1)
    canvas = torch.zeros((t, DET_SIZE, DET_SIZE, 3), device=dev)
    canvas[:, py:py + h2, px:px + w2] = small
    return canvas * (2.0 / 255.0) - 1.0


def decode(reg, cls, anc):
    s = 1.0 / DET_SIZE
    cxy = reg[..., 0:2] * s + anc
    half = reg[..., 2:4] * s * 0.5
    boxes = torch.cat([cxy - half, cxy + half], -1)
    kps = (reg[..., 4:16].reshape(reg.shape[:-1] + (6, 2)) * s
           + anc[..., None, :])
    scores = torch.sigmoid(cls[..., 0].clamp(-100.0, 100.0))
    return boxes, scores, kps


def iou(box, boxes):
    lt = torch.maximum(box[..., None, :2], boxes[..., :2])
    rb = torch.minimum(box[..., None, 2:], boxes[..., 2:])
    inter = (rb - lt).clamp_min(0.0).prod(-1)
    a = (box[..., 2:] - box[..., :2]).clamp_min(0.0).prod(-1)[..., None]
    b = (boxes[..., 2:] - boxes[..., :2]).clamp_min(0.0).prod(-1)
    return inter / (a + b - inter).clamp_min(1e-9)


def weighted_nms_top1(boxes, scores, kps):
    """The best candidate of each frame blended with every candidate at
    IoU >= 0.3 by score: (box (t, 4), keypoints (t, 6, 2), ok (t,))."""
    remaining = scores >= MIN_SCORE
    masked = torch.where(remaining, scores, torch.full_like(scores, -np.inf))
    i = masked.argmax(1, keepdim=True)
    top = masked.gather(1, i)[:, 0]
    box_i = boxes.gather(1, i[..., None].expand(-1, -1, 4))[:, 0]
    sim = remaining & (iou(box_i, boxes) >= NMS_IOU)
    w = torch.where(sim, scores, torch.zeros_like(scores))[..., None]
    wsum = w.sum(1).clamp_min(1e-9)
    return ((boxes * w).sum(1) / wsum,
            (kps * w[..., None]).sum(1) / wsum[..., None], top >= MIN_SCORE)


def to_rect(box, H: int, W: int):
    """Letterbox-normalised box -> (cx, cy, side) in image px; the axis
    crop drops the rotation."""
    scale, _, _, px, py = letterbox_geometry(H, W, DET_SIZE)
    x1 = (box[:, 0] * DET_SIZE - px) / scale
    y1 = (box[:, 1] * DET_SIZE - py) / scale
    x2 = (box[:, 2] * DET_SIZE - px) / scale
    y2 = (box[:, 3] * DET_SIZE - py) / scale
    return ((x1 + x2) * 0.5, (y1 + y2) * 0.5,
            torch.maximum(x2 - x1, y2 - y1) * ROI_SCALE)


def interp_matrix(coords: torch.Tensor, n_src: int) -> torch.Tensor:
    x0 = torch.floor(coords)
    f = (coords - x0)[..., None]
    x0i = x0.to(torch.int64).clamp(0, n_src - 1)[..., None]
    x1i = (x0i + 1).clamp(0, n_src - 1)
    src = torch.arange(n_src, device=coords.device)
    return (1.0 - f) * (src == x0i) + f * (src == x1i)


def crop_axis(frames, cx, cy, side) -> torch.Tensor:
    """(t, H, W, 3) u8 BGR -> (t, 256, 256, 3) RGB in [0, 1]."""
    t, H, W, _ = frames.shape
    u = (torch.arange(LM_SIZE, dtype=torch.float32, device=frames.device)
         + 0.5) / LM_SIZE - 0.5
    gx = interp_matrix(cx[:, None] + u * side[:, None], W)
    gy = interp_matrix(cy[:, None] + u * side[:, None], H)
    tmp = torch.einsum("thwc,tmw->thmc", frames.to(torch.float32), gx)
    out = torch.einsum("tnh,thmc->tnmc", gy, tmp).flip(-1)
    return out / 255.0


class FaceLandmarker:
    """The two nets from the ``.task`` bundle, on ``device``."""

    def __init__(self, task_path: str, device, precision: str = "float32"):
        models = load_task_models(task_path)
        self.det = Graph(models["face_detector.tflite"].graph, device,
                         precision)
        self.lm = Graph(models["face_landmarks_detector.tflite"].graph,
                        device, precision)
        self.q = rounder(precision)
        self.anchors = torch.as_tensor(anchors(), device=device)

    @torch.no_grad()
    def boxes(self, frames: torch.Tensor, slice_frames: int = 64):
        """(T, H, W, 3) u8 -> (landmark boxes (T, 4) int64, zero where not
        valid, valid (T,))."""
        T, H, W, _ = frames.shape
        out_b, out_v = [], []
        with no_tf32():
            for s in range(0, T, slice_frames):
                fr = frames[s:s + slice_frames]
                reg, cls = self.det(self.q(letterbox(fr)))
                box, _, ok = weighted_nms_top1(*decode(reg, cls,
                                                       self.anchors))
                cx, cy, side = to_rect(box, H, W)
                lm, presence = self.lm(self.q(crop_axis(fr, cx, cy,
                                                        side)))[:2]
                lm = lm.reshape(fr.shape[0], 478, 3)
                u = lm[..., 0] / LM_SIZE - 0.5
                v = lm[..., 1] / LM_SIZE - 0.5
                x = cx[:, None] + u * side[:, None]
                y = cy[:, None] + v * side[:, None]
                bb = torch.stack([x.amin(-1).clamp(0, W - 1),
                                  y.amin(-1).clamp(0, H - 1),
                                  x.amax(-1).clamp(0, W - 1),
                                  y.amax(-1).clamp(0, H - 1)], -1)
                valid = ok & (torch.sigmoid(presence.reshape(-1))
                              >= MIN_PRESENCE)
                bb = torch.where(valid[:, None], bb.to(torch.int32), 0)
                out_b.append(bb.to(torch.int64))
                out_v.append(valid)
        return torch.cat(out_b), torch.cat(out_v)
