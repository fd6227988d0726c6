"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``.

    ``None`` means the CUDA card and raises when there is none: the CPU
    runs only when the caller asks for it (``device="cpu"``).  A bare
    ``"cuda"`` becomes the current card's index.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card found; pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
