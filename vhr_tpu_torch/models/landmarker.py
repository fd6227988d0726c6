"""The learned face landmarker in PyTorch.

Port of ``vhr_tpu/models/landmarker.py``: a depthwise-separable conv
backbone (stride-2 3x3 stem, four separable blocks with GroupNorm) and two
dense heads that regress 68 normalized landmarks and a face-presence logit
from a 96x96 RGB view of the frame.  The detectors built on it keep the
reference's box, the landmark cloud's min/max (``rppg_VIDEO.py:93-98``).

The net reproduces the Flax model's arithmetic, not only its layers:

* every conv pads as Flax's ``SAME`` does, on the high side only for a
  stride-2 conv of an even size (``(0, 1)``, not ``(1, 1)``);
* in a bf16 config each conv takes bf16-rounded operands, sums in float32
  and rounds its output to bf16 before its bias (itself rounded to bf16)
  is added, as XLA does;
* GroupNorm takes its statistics in float32 with Flax's epsilon 1e-6 and
  rounds its output to the compute dtype;
* the deep 3x3 map flattens in Flax's ``(h, w, c)`` order, and the trunk
  and heads run in float32.

The weights are the JAX package's checkpoints, exported to
``checkpoints/landmarker.npz`` and ``checkpoints/landmarker_distill.npz``
(``tools/export_landmarker_weights.py``) and read with numpy alone
(:func:`vhr_tpu_torch.interop.landmarker_params_from_jax`).  The detectors
run the resize and the net over the frames in slices of ``_SLICE`` frames,
which bounds device memory (a float32 copy of 960 1080p frames is 24 GB).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import float32_exact, resolve_device

__all__ = ["LandmarkerConfig", "FaceLandmarker", "preprocess_frames",
           "landmarks_to_bbox_valid", "make_detector", "make_roi_detector",
           "load_default_detector", "load_real_distilled_detector",
           "load_params", "build_model", "run_net", "default_weights_path"]

# Frames per slice through the resize and the crops; inputs per net call.
_SLICE = 64
_NET_BATCH = 512
_GN_GROUPS = 8
_GN_EPS = 1e-6                 # Flax's GroupNorm epsilon


@dataclasses.dataclass(frozen=True, unsafe_hash=True)
class LandmarkerConfig:
    input_size: int = 96
    num_landmarks: int = 68
    stem_features: int = 48
    block_features: Tuple[int, ...] = (64, 128, 256, 384)
    # "flatten" keeps the deep 3x3 spatial map (localization needs where
    # the face is); "gap" averages it away.
    pool: str = "flatten"
    compute_dtype: Any = torch.bfloat16


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """Flax/XLA ``SAME`` padding of one axis: the low side gets the floor
    of half the total, the high side the rest."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """``conv`` on ``x`` (values in ``dtype``) with Flax's SAME padding.

    The operands are rounded to ``dtype`` and convolved in float32 (their
    products are exact there), the sum is rounded to ``dtype`` and then
    the bias, rounded to ``dtype``, is added: the arithmetic of XLA's bf16
    convolution, bit for bit on the CPU.  Callers run it under
    ``float32_exact()``.
    """
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    ph, pw = _same_pad(x.shape[2], kh, sh), _same_pad(x.shape[3], kw, sw)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x.float(), conv.weight.to(dtype).float(), stride=conv.stride,
                 groups=conv.groups).to(dtype)
    return y + conv.bias.to(dtype)[:, None, None]


class _SeparableBlock(nn.Module):
    """Depthwise 3x3 (stride 2) + pointwise 1x1, GroupNorm, ReLU."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.dw = nn.Conv2d(c_in, c_in, 3, stride=2, groups=c_in)
        self.pw = nn.Conv2d(c_in, features, 1)
        self.norm = nn.GroupNorm(_GN_GROUPS, features, eps=_GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = _conv(_conv(x, self.dw, dtype), self.pw, dtype)
        x = F.group_norm(x.float(), _GN_GROUPS, self.norm.weight,
                         self.norm.bias, _GN_EPS).to(dtype)
        return F.relu(x)


class FaceLandmarker(nn.Module):
    """``(B, S, S, 3)`` float RGB in [0, 1] -> ``(landmarks (B, L, 2),
    presence logit (B,))``, the JAX package's ``FaceLandmarker``."""

    def __init__(self, cfg: LandmarkerConfig = LandmarkerConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv2d(3, cfg.stem_features, 3, stride=2)
        blocks, c, n = [], cfg.stem_features, -(-cfg.input_size // 2)
        for f in cfg.block_features:
            blocks.append(_SeparableBlock(c, f))
            c, n = f, -(-n // 2)
        self.blocks = nn.ModuleList(blocks)
        flat = c if cfg.pool == "gap" else n * n * c
        self.trunk = nn.Linear(flat, 256)
        self.landmark_head = nn.Linear(256, cfg.num_landmarks * 2)
        self.presence_head = nn.Linear(256, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        B = x.shape[0]
        x = x.to(c.compute_dtype).permute(0, 3, 1, 2)           # NCHW view
        x = F.relu(_conv(x, self.stem, c.compute_dtype))
        for blk in self.blocks:
            x = blk(x)
        if c.pool == "gap":
            x = x.mean(dim=(2, 3))
        else:                                   # Flax's (h, w, c) order
            x = x.permute(0, 2, 3, 1).reshape(B, -1)
        feat = F.relu(self.trunk(x.float()))
        lm = torch.sigmoid(self.landmark_head(feat))
        return (lm.reshape(B, c.num_landmarks, 2),
                self.presence_head(feat)[:, 0])


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_in, n_out)`` float32 weights of ``jax.image.resize``'s
    ``"linear"`` method along one axis: the triangle kernel on pixel
    centres, widened by ``n_in / n_out`` where the axis shrinks (the
    antialias), each column normalized to sum 1; computed in float64."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale,
                                                                 1.0)
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def preprocess_frames(frames: torch.Tensor, input_size: int) -> torch.Tensor:
    """``(B, H, W, 3)`` uint8 BGR -> ``(B, S, S, 3)`` float32 RGB in [0, 1].

    The resize is ``jax.image.resize(..., "linear")``'s, as two dense
    weight-matrix products in full float32 (:func:`_resize_weights`):
    bilinear on pixel centres, antialiased where an axis shrinks.
    """
    B, H, W, _ = frames.shape
    dev = frames.device
    wh = torch.as_tensor(_resize_weights(H, input_size), device=dev)
    ww = torch.as_tensor(_resize_weights(W, input_size), device=dev)
    x = frames.flip(-1).to(torch.float32) / 255.0
    with float32_exact():
        if H * input_size <= input_size * W:    # the smaller intermediate
            x = torch.einsum("bhwc,hs->bswc", x, wh)
            return torch.einsum("bswc,wt->bstc", x, ww)
        x = torch.einsum("bhwc,wt->bhtc", x, ww)
        return torch.einsum("bhtc,hs->bstc", x, wh)


def landmarks_to_bbox_valid(landmarks: torch.Tensor, presence: torch.Tensor,
                            width: int, height: int, threshold: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Landmark cloud -> ``(boxes (T, 4) int32, valid (T,) bool)``: the
    cloud's min/max in pixels (``ops.roi.bbox_from_landmarks``) and the
    presence logit against ``threshold``."""
    from ..ops.roi import bbox_from_landmarks
    return bbox_from_landmarks(landmarks, width, height), presence > threshold


def build_model(params: Mapping[str, torch.Tensor],
                cfg: LandmarkerConfig = LandmarkerConfig(),
                device=None) -> FaceLandmarker:
    """A :class:`FaceLandmarker` holding ``params`` (its ``state_dict``) on
    ``device`` (the CUDA card by default), in eval mode."""
    model = FaceLandmarker(cfg)
    model.load_state_dict(params)
    return model.to(resolve_device(device)).eval()


def run_net(model: FaceLandmarker, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model`` on ``x (B, S, S, 3)`` in batches of ``_NET_BATCH`` inputs,
    with float32 convolutions in full float32 (not TF32)."""
    lms, pres = [], []
    with torch.no_grad(), float32_exact():
        for s in range(0, x.shape[0], _NET_BATCH):
            lm, p = model(x[s:s + _NET_BATCH])
            lms.append(lm)
            pres.append(p)
    return torch.cat(lms), torch.cat(pres)


def _landmarks(model: FaceLandmarker, frames: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-frame landmarks and presence of ``frames (T, H, W, 3)`` u8,
    resized and run ``_SLICE`` frames at a time."""
    S = model.cfg.input_size
    lms, pres = [], []
    with torch.no_grad():
        for s in range(0, frames.shape[0], _SLICE):
            lm, p = run_net(model, preprocess_frames(frames[s:s + _SLICE], S))
            lms.append(lm)
            pres.append(p)
    return torch.cat(lms), torch.cat(pres)


def make_detector(params: Mapping[str, torch.Tensor],
                  cfg: LandmarkerConfig = LandmarkerConfig(),
                  threshold: float = 0.0, device=None):
    """Wrap weights as a pipeline detector: ``frames (T, H, W, 3) u8 ->
    (boxes (T, 4) int32, valid (T,) bool)``, the interface of
    ``skin_detector.detect_faces``, so it drops into
    ``pipeline.offline.extract_signals(detector=...)``.  Runs on ``device``
    (the CUDA card by default); frames are moved there.  The callable
    carries ``params`` and ``cfg``, which the apps re-wrap as the
    multi-face detectors (``apps.rppg_video._resolve_detector_multi``).
    """
    device = resolve_device(device)
    model = build_model(params, cfg, device)

    def detector(frames):
        frames = torch.as_tensor(frames, device=device)
        T, H, W, _ = frames.shape
        lm, presence = _landmarks(model, frames)
        return landmarks_to_bbox_valid(lm, presence, W, H, threshold)

    detector.params, detector.cfg = model.state_dict(), cfg
    return detector


def make_roi_detector(params: Mapping[str, torch.Tensor],
                      cfg: LandmarkerConfig = LandmarkerConfig(),
                      roi_cfg=None, threshold: float = 0.0, device=None):
    """Pose-robust ROI variant of :func:`make_detector`: ``frames -> (boxes
    (T, 4), rois (T, 4), valid (T,))``, the cheek ROI carved in the
    landmark cloud's own frame (``ops.roi.cheek_roi_from_landmarks``), the
    ``pipeline.offline.extract_signals_landmark_roi`` contract."""
    from ..config import ROIConfig
    from ..ops.roi import cheek_roi_from_landmarks

    roi_cfg = roi_cfg or ROIConfig()
    device = resolve_device(device)
    model = build_model(params, cfg, device)

    def detector(frames):
        frames = torch.as_tensor(frames, device=device)
        T, H, W, _ = frames.shape
        lm, presence = _landmarks(model, frames)
        boxes, valid = landmarks_to_bbox_valid(lm, presence, W, H, threshold)
        return boxes, cheek_roi_from_landmarks(lm, roi_cfg, W, H), valid

    return detector


def default_weights_path(name: str = "landmarker") -> str:
    """``checkpoints/<name>.npz`` at the root of the checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "checkpoints", f"{name}.npz")


def load_params(path: Optional[str] = None, device=None) -> dict:
    """The exported weights at ``path`` (default
    ``checkpoints/landmarker.npz``; the JAX package's checkpoint directory
    names its ``.npz`` beside it) as the port's ``state_dict`` on
    ``device``."""
    from ..interop import landmarker_params_from_jax

    path = path or default_weights_path()
    if os.path.isdir(path):
        path = path.rstrip(os.sep) + ".npz"
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files}
    return landmarker_params_from_jax(leaves, device=device)


def load_default_detector(path: Optional[str] = None, threshold: float = 0.0,
                          device=None):
    """The repo's trained synthetic-face weights as a detector on
    ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    return make_detector(load_params(path, device), LandmarkerConfig(),
                         threshold, device)


def load_real_distilled_detector(threshold: float = 0.0, device=None):
    """The real-photo-distilled weights (``checkpoints/
    landmarker_distill.npz``): fine-tuned on the bundled real portrait, it
    finds a real face (IoU 0.83 on the portrait against 0.20 for the
    default weights, the JAX package's measurement) at some cost on the
    flat synthetic fixtures."""
    return load_default_detector(default_weights_path("landmarker_distill"),
                                 threshold, device)
