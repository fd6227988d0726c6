"""Sweep-wide options shared by the plugins.

Port of ``vhr_tpu/analysis/context.py``.  The reference's measurement
contract is ``measure(video_path) -> (N, 2)`` with no detector parameter
because its harness hard-codes MediaPipe
(the reference's ``analysis/utils/roi.py:17-20``).  Here the
face-localization family is a *harness-level* choice (`--detector` on
``analysis.main``), threaded to the plugins through this context so the
plugin contract stays exactly the reference's.

``set_detector`` accepts the app detector names
(``skin|landmarker|landmarker-real|refined|mediapipe[-bf16|-exact]``);
``current_detector()`` resolves lazily through
``apps.rppg_video._resolve_detector`` (weights load once per process and
device) and returns the pipeline detector callable, or ``None`` for the
default skin-chroma stage.  ``set_detect_every``/``current_detect_every``
thread the detection cadence the same way.

The device travels the same way: JAX picks its backend for the whole
process, PyTorch takes a device a call, and the contract has no device
parameter.  ``set_device``/``current_device`` hold it; ``None`` (the
default) is the CUDA card, resolved by ``device.resolve_device``, which
raises without one.
"""

from __future__ import annotations

from ..device import resolve_device

_detector_name = "skin"
_detect_every = 1
_device = None
_cache: dict = {}

__all__ = ["set_detector", "current_detector", "current_detector_name",
           "set_detect_every", "current_detect_every", "set_device",
           "current_device"]


def set_detector(name: str) -> None:
    global _detector_name
    _detector_name = name


def set_detect_every(n: int) -> None:
    global _detect_every
    if n < 1:
        raise ValueError("detect_every must be >= 1")
    _detect_every = int(n)


def current_detect_every() -> int:
    return _detect_every


def current_detector_name() -> str:
    return _detector_name


def set_device(device) -> None:
    """The device of the sweep's plugins: ``None`` for the CUDA card, or
    anything ``torch.device`` takes (``"cpu"``, ``"cuda:1"``)."""
    global _device
    _device = device


def current_device():
    """The sweep's device as a ``torch.device`` (raises when it is the
    CUDA card and there is none)."""
    return resolve_device(_device)


def current_detector():
    if _detector_name == "skin":
        return None
    device = current_device()
    key = (_detector_name, str(device))
    if key not in _cache:
        from ..apps.rppg_video import _resolve_detector
        _cache[key] = _resolve_detector(_detector_name, device=device)
    return _cache[key]
