"""Offline video heart-rate app: its detector choice.

Port of ``vhr_tpu/apps/rppg_video.py``'s ``_resolve_detector`` and
``_resolve_detector_multi``, which the live and serving apps share.  The
rest of the app (the three-filter analysis, the rendering, ``main``) is
not ported yet (ROADMAP queue 1, item 8b).
"""

from __future__ import annotations

import torch

_MEDIAPIPE = ("mediapipe", "mediapipe-bf16", "mediapipe-exact")
_NOT_PORTED = ("landmarker", "landmarker-real", "refined")
_CHOICES = "skin|landmarker|refined|mediapipe|mediapipe-bf16|mediapipe-exact"


def _resolve_detector(name: str, device=None):
    """CLI detector choice -> pipeline detector callable (or None for the
    skin detector).  The MediaPipe choices build the bundled
    FaceLandmarker (``models.mediapipe_face.make_mediapipe_detector``) on
    ``device`` (the CUDA card by default): ``-bf16`` rounds the convs'
    operands to bfloat16, ``-exact`` crops with the exact rotation."""
    if name == "skin":
        return None
    if name in _MEDIAPIPE:
        from ..models.mediapipe_face import make_mediapipe_detector
        cd = torch.bfloat16 if name.endswith("bf16") else None
        cm = "exact" if name.endswith("exact") else "axis"
        return make_mediapipe_detector(compute_dtype=cd, crop_mode=cm,
                                       device=device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"detector {name!r} needs models/landmarker.py and "
            f"models/cascade.py, not yet ported (ROADMAP queue 1, item 12)")
    raise SystemExit(f"unknown detector {name!r} ({_CHOICES})")


def _resolve_detector_multi(name: str, k_faces: int, device=None):
    """CLI detector choice -> multi-face detector callable.  Every
    multi-face choice, the chroma multiface path of ``skin`` too, is still
    to be ported (ROADMAP queue 1, item 12)."""
    if name in ("skin",) + _MEDIAPIPE + _NOT_PORTED:
        raise NotImplementedError(
            f"the multi-face {name!r} detector ({k_faces} faces) is not yet "
            f"ported (ROADMAP queue 1, item 12)")
    raise SystemExit(f"unknown detector {name!r} ({_CHOICES})")
