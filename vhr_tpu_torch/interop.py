"""State carried across from the JAX package, given as numpy / plain data.

The offline green-channel slice has no learned weights: the skin detector's
thresholds are its parameters, and the tracking carries are its state.
These functions turn the JAX package's versions of them (as numpy arrays or
``dataclasses.asdict`` dicts — this module never imports JAX) into the
port's and back, so a stream started in one package can continue in the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .models.skin_detector import SkinDetectorConfig
from .ops.roi import HoldoverCarry

__all__ = ["skin_config_from_jax", "fused_carry_from_numpy",
           "fused_carry_to_numpy", "holdover_carry_from_numpy",
           "holdover_carry_to_numpy"]


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
