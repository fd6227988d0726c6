"""Dropout handling for per-frame traces.

Port of ``vhr_tpu/dsp/filters.py::forward_fill``.  The JAX scan becomes a
``cummax`` over the indices of valid samples followed by one gather.
"""

from __future__ import annotations

import torch

__all__ = ["forward_fill"]


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
