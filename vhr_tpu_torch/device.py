"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "float32_exact"]


@contextlib.contextmanager
def float32_exact():
    """Run float32 convolutions and matrix products in full float32.

    On the card cuDNN convolves float32 in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; matrix products are full float32 by default.  Inside
    this block both are full float32; the flags are restored on exit.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


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
