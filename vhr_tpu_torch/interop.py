"""State carried across from the JAX package, given as numpy / plain data.

The skin detector's thresholds and the live configuration are parameters,
the tracking carries and the live state are state, and the MediaPipe face
nets have learned weights.  These functions turn the JAX package's versions
of them (as numpy arrays or ``dataclasses.asdict`` dicts — this module never
imports JAX) into the port's and back, so a stream started in one package
can continue in the other.  The serving pool's snapshots go through
:func:`live_state_to_numpy` and :func:`live_state_from_numpy`.  The learned
landmarker's weights come as the flat Flax leaves of
``tools/export_landmarker_weights.py`` (:func:`landmarker_params_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .config import HRBand, ROIConfig
from .device import resolve_device
from .models.landmarker import FaceLandmarker, LandmarkerConfig
from .models.mediapipe_face import MediaPipeFaceParams, default_task_path
from .models.skin_detector import SkinDetectorConfig
from .models.tflite import load_task_models
from .models.tflite_exec import (_find_residual_stages, const_inputs,
                                 fold_dequantize)
from .ops.roi import HoldoverCarry
from .pipeline.live import LiveConfig, LiveState, MultiLiveState

__all__ = ["skin_config_from_jax", "fused_carry_from_numpy",
           "fused_carry_to_numpy", "holdover_carry_from_numpy",
           "holdover_carry_to_numpy", "live_config_from_jax",
           "live_state_from_numpy", "live_state_to_numpy",
           "face_params_from_jax", "landmarker_params_from_jax"]

# The JAX LiveState's leaf types, field by field.
_LIVE_DTYPES = {"ring_raw": np.float32, "ring_filt": np.float32,
                "count": np.int32, "zi": np.float32, "last_box": np.int32,
                "hold_budget": np.int32, "has_last": np.bool_,
                "frame_idx": np.int32, "ring_bgr": np.float32}


def skin_config_from_jax(d: dict) -> SkinDetectorConfig:
    """``dataclasses.asdict`` of ``vhr_tpu``'s ``SkinDetectorConfig`` ->
    the port's config.  Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(SkinDetectorConfig)}
    if set(d) != names:
        raise ValueError(f"skin config fields differ: extra "
                         f"{sorted(set(d) - names)}, missing "
                         f"{sorted(names - set(d))}")
    return SkinDetectorConfig(**d)


def fused_carry_from_numpy(carry, device=None) -> torch.Tensor:
    """The fused kernel's ``(6,)`` int32 carry ``[x1, y1, x2, y2, budget,
    has_last]`` as a tensor on ``device``."""
    a = np.asarray(carry)
    if a.shape != (6,):
        raise ValueError(f"fused carry must be (6,), got {a.shape}")
    return torch.as_tensor(a.astype(np.int32), device=device)


def fused_carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    return carry.detach().cpu().numpy().astype(np.int32)


def holdover_carry_from_numpy(last_box, budget, has_last,
                              device=None) -> HoldoverCarry:
    """The holdover scan's ``(last_box (4,), budget, has_last)`` carry."""
    box = np.asarray(last_box)
    if box.shape != (4,):
        raise ValueError(f"last_box must be (4,), got {box.shape}")
    return (torch.as_tensor(box.astype(np.int32), device=device),
            torch.tensor(int(np.asarray(budget)), dtype=torch.int32,
                         device=device),
            torch.tensor(bool(np.asarray(has_last)), device=device))


def holdover_carry_to_numpy(carry: HoldoverCarry
                            ) -> Tuple[np.ndarray, np.int32, np.bool_]:
    box, budget, has = carry
    return (box.detach().cpu().numpy().astype(np.int32),
            np.int32(int(budget)), np.bool_(bool(has)))


def live_config_from_jax(d: dict) -> LiveConfig:
    """``dataclasses.asdict`` of ``vhr_tpu``'s ``LiveConfig`` -> the port's
    config (``band`` and ``roi`` may be dicts, as ``asdict`` leaves them).
    Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(LiveConfig)}
    if set(d) != names:
        raise ValueError(f"live config fields differ: extra "
                         f"{sorted(set(d) - names)}, missing "
                         f"{sorted(names - set(d))}")
    d = dict(d)
    if isinstance(d["band"], Mapping):
        d["band"] = HRBand(**d["band"])
    if isinstance(d["roi"], Mapping):
        d["roi"] = ROIConfig(**d["roi"])
    d["adaptive_methods"] = tuple(d["adaptive_methods"])
    return LiveConfig(**d)


def live_state_from_numpy(leaves, device=None, multi: bool = False):
    """A JAX ``LiveState`` as numpy leaves (a mapping by field name, or the
    NamedTuple itself) -> the port's :class:`LiveState` on ``device``.  The
    leaves may carry a leading slot axis (a pool's state) or not (one
    stream); the shapes must agree with each other.  ``multi``: a
    ``MultiLiveState`` (a face axis after the slot axis on every field but
    ``frame_idx``) -> :class:`MultiLiveState`."""
    d = leaves._asdict() if hasattr(leaves, "_asdict") else dict(leaves)
    if set(d) != set(_LIVE_DTYPES):
        raise ValueError(f"live state fields differ: extra "
                         f"{sorted(set(d) - set(_LIVE_DTYPES))}, missing "
                         f"{sorted(set(_LIVE_DTYPES) - set(d))}")
    a = {k: np.asarray(d[k]).astype(t) for k, t in _LIVE_DTYPES.items()}
    lead = a["count"].shape
    N = a["ring_raw"].shape[-1:]
    want = {"ring_raw": N, "ring_filt": N, "count": (), "zi": None,
            "last_box": (4,), "hold_budget": (), "has_last": (),
            "frame_idx": (), "ring_bgr": N + (3,)}
    for k, tail in want.items():
        shape = a[k].shape
        if multi and k == "frame_idx":
            ok = len(lead) >= 1 and shape == lead[:-1]
        else:
            ok = (shape[:len(lead)] == lead
                  and (tail is None and len(shape) == len(lead) + 2
                       and shape[-1] == 2 or shape[len(lead):] == tail))
        if not ok:
            raise ValueError(f"live state field {k} has shape {shape}, "
                             f"inconsistent with count {lead} and ring "
                             f"{N}")
    return (MultiLiveState if multi else LiveState)(
        **{k: torch.as_tensor(v, device=device) for k, v in a.items()})


def live_state_to_numpy(state: LiveState) -> Dict[str, np.ndarray]:
    """The port's :class:`LiveState` -> numpy leaves by field name, typed as
    the JAX package's ``LiveState`` leaves."""
    return {k: getattr(state, k).detach().cpu().numpy().astype(t)
            for k, t in _LIVE_DTYPES.items()}


def _net_weights(graph, leaves: Mapping, name: str, device) -> dict:
    """One net's JAX params (numpy leaves keyed by tensor index, plus the
    ``_fs{start}_{i}`` stage stacks when its stages are fused) -> tensors on
    ``device``, checked against the graph's keys and shapes."""
    graph = fold_dequantize(graph)
    want = {str(i): tuple(graph.tensors[i].shape)
            for i in const_inputs(graph)}
    if any(k.startswith("_fs") for k in leaves):
        for st in _find_residual_stages(graph.operators, graph.tensors):
            want.update({f"_fs{st['start']}_{f_i}": None for f_i in range(9)})
    if set(leaves) != set(want):
        raise ValueError(f"{name} params differ: extra "
                         f"{sorted(set(leaves) - set(want))[:8]}, missing "
                         f"{sorted(set(want) - set(leaves))[:8]}")
    out = {}
    for k, v in leaves.items():
        a = np.array(v, np.float32)
        if want[k] is not None and a.shape != want[k]:
            raise ValueError(f"{name} param {k} has shape {a.shape}, the "
                             f"graph's is {want[k]}")
        out[k] = torch.as_tensor(a, device=device)
    return out


def face_params_from_jax(det: Mapping, lm: Mapping,
                         device=None) -> MediaPipeFaceParams:
    """The JAX package's ``MediaPipeFaceParams`` leaves (``det`` and ``lm``
    dicts of arrays) -> the port's weights for the bundled ``.task``'s
    nets, on ``device`` (the CUDA card unless given).  Unknown or missing
    keys raise, as do shapes that differ from the graph's."""
    device = resolve_device(device)
    models = load_task_models(default_task_path())
    return MediaPipeFaceParams(
        det=_net_weights(models["face_detector.tflite"].graph, det,
                         "detector", device),
        lm=_net_weights(models["face_landmarks_detector.tflite"].graph, lm,
                        "mesh", device))


def _landmarker_key(path: str) -> str:
    """A Flax leaf path of the landmarker -> its port ``state_dict`` key
    (``block2/GroupNorm_0/scale`` -> ``blocks.2.norm.weight``)."""
    parts = path.split("/")
    if parts[0].startswith("block") and parts[0][5:].isdigit():
        parts = ["blocks", parts[0][5:]] + parts[1:]
    names = {"kernel": "weight", "scale": "weight", "GroupNorm_0": "norm"}
    return ".".join(names.get(p, p) for p in parts)


def landmarker_params_from_jax(leaves: Mapping,
                               cfg: LandmarkerConfig = LandmarkerConfig(),
                               device=None) -> Dict[str, torch.Tensor]:
    """The JAX landmarker's params as flat leaves keyed by Flax path
    (``stem/kernel``, ``block0/dw/kernel``, ``trunk/bias``, ...; the
    ``.npz`` of ``tools/export_landmarker_weights.py``) -> the port's
    :class:`FaceLandmarker` ``state_dict`` on ``device`` (the CUDA card
    unless given).

    Conv kernels go from HWIO to OIHW (a depthwise ``(3, 3, 1, C)`` kernel
    becomes ``(C, 1, 3, 3)``), Dense kernels from ``(in, out)`` to ``(out,
    in)``.  The trunk's rows stay in Flax's ``(h, w, c)`` flatten order,
    which the port flattens in too.  Unknown or missing keys raise, as do
    shapes that differ from the model's.
    """
    device = resolve_device(device)
    want = {k: tuple(v.shape) for k, v in FaceLandmarker(cfg).state_dict()
            .items()}
    got = {_landmarker_key(k): k for k in leaves}
    if set(got) != set(want) or len(got) != len(leaves):
        raise ValueError(f"landmarker params differ: extra "
                         f"{sorted(set(got) - set(want))[:8]}, missing "
                         f"{sorted(set(want) - set(got))[:8]}")
    out = {}
    for key, path in got.items():
        a = np.array(leaves[path], np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        if a.shape != want[key]:
            raise ValueError(f"landmarker param {path} has shape "
                             f"{np.shape(leaves[path])}, the model's "
                             f"{key} is {want[key]}")
        out[key] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return out
