"""Dropout handling and streaming filtering for per-frame traces.

Port of ``vhr_tpu/dsp/filters.py`` (``forward_fill``, ``sos_stream_init``,
``sos_stream_push``).  The JAX scan of ``forward_fill`` becomes a
``cummax`` over the indices of valid samples followed by one gather.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["forward_fill", "sos_stream_init", "sos_stream_push"]


def sos_stream_init(sos: np.ndarray, batch_shape: Tuple[int, ...] = (),
                    device=None) -> torch.Tensor:
    """Zeroed streaming state ``batch_shape + (n_sections, 2)`` float32.

    The batch axes lead (the JAX package puts them last): the live state
    and the serving pool keep one ``(n_sections, 2)`` state per slot.
    """
    return torch.zeros(tuple(batch_shape) + (np.asarray(sos).shape[0], 2),
                       dtype=torch.float32, device=device)


def _r32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to float32 and back (one float32 rounding)."""
    return x.to(torch.float32).to(torch.float64)


def sos_stream_push(sos: np.ndarray, z: torch.Tensor, x_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter one new sample per stream and carry the state.

    ``z`` is ``(..., n_sections, 2)`` float32 and ``x_t`` the matching
    ``(...)`` samples; returns ``(y (...), new_z)``.  Each section computes
    ``y = b0 x + z0``, ``z0' = b1 x - a1 y + z1``, ``z1' = b2 x - a2 y`` in
    float32, rounded as XLA:CPU rounds the JAX version under ``jit``: XLA
    drops the multiplications by 1 of the band-pass sections, and LLVM
    contracts the rest into fused multiply-adds (which product it fuses
    depends on the coefficient's sign).  Each fma is computed in float64,
    where the product of two float32 values is exact, and rounded once to
    float32.
    """
    s32 = np.asarray(sos, dtype=np.float32).astype(np.float64)
    cur = _r32(x_t.to(torch.float64))
    z = z.to(torch.float64)
    ys, zs = [], []
    for s in range(s32.shape[0]):
        b0, b1, b2, _, a1, a2 = (float(v) for v in s32[s])
        z0, z1 = z[..., s, 0], z[..., s, 1]
        y = _r32(b0 * cur + z0)
        if b1 < 0:          # fma(-a1, y, b1 x), then + z1
            t0 = _r32(_r32(b1 * cur) - a1 * y)
        else:               # fma(b1, x, -(a1 y)), then + z1
            t0 = _r32(b1 * cur - _r32(a1 * y))
        n0 = _r32(t0 + z1)
        if b2 == 1.0:       # x - a2 y: fma(-a2, y, x)
            n1 = _r32(cur - a2 * y)
        else:               # fma(b2, x, -(a2 y))
            n1 = _r32(b2 * cur - _r32(a2 * y))
        zs.append(torch.stack([n0, n1], dim=-1))
        cur = y
    return cur.to(torch.float32), torch.stack(zs, dim=-2).to(torch.float32)


def forward_fill(x: torch.Tensor, valid: torch.Tensor,
                 init: str = "zeros") -> torch.Tensor:
    """Carry the last valid sample forward over dropout gaps.

    ``x`` is ``(T,)`` or ``(T, C)``; ``valid`` is ``(T,)``.  ``init`` selects
    what leading-invalid samples become: ``"zeros"`` or ``"first_valid"``
    (the sample at the first valid index, or ``x[0]`` if none is valid).
    """
    T = x.shape[0]
    valid = valid.to(torch.bool)
    idx = torch.arange(T, device=x.device)
    last = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)),
                        dim=0).values
    filled = x[last.clamp(min=0)]
    if init == "first_valid":
        start = x[torch.argmax(valid.to(torch.int32))]
    else:
        start = torch.zeros_like(x[0])
    lead = (last < 0).reshape((T,) + (1,) * (x.dim() - 1))
    return torch.where(lead, start, filled)
