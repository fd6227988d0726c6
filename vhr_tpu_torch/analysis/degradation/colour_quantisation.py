"""Colour bit-depth reduction to {7, 6, 5, 4} bits per channel.

Port of ``vhr_tpu/analysis/degradation/colour_quantisation.py``: levels
below the assumed 8-bit source, control re-encode first, quantisation rule
``(frame // scale) * scale`` with ``scale = 256 >> bits`` — one u8 op per
chunk on the sweep's device (``analysis.context``), bit-equal to JAX's.
"""

from __future__ import annotations

import functools
from typing import Generator, Tuple

import numpy as np
import torch

from . import common
from .. import context

SOURCE_DEPTH = 8
COLOUR_DEPTHS = [7, 6, 5, 4]


def _quantise_op(bits: int):
    """``chunk (T, H, W, 3) u8 -> u8``, computed on the sweep's device."""
    device = context.current_device()
    scale = 256 // (2 ** bits)

    def op(chunk: np.ndarray) -> np.ndarray:
        frames = torch.as_tensor(chunk, device=device)
        return ((frames // scale) * scale).cpu().numpy()

    return op


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    root = common.output_root(input_path, "colour_quantisation")

    control = root / f"{SOURCE_DEPTH}-bit.mp4"
    yield common.cached_level(
        control, f"{SOURCE_DEPTH}-bit",
        lambda: common.per_frame_device_op(input_path, control, lambda x: x))

    for bits in COLOUR_DEPTHS:
        label = f"{bits}-bit"
        out = root / f"{label}.mp4"
        op = _quantise_op(bits)
        yield common.cached_level(
            out, label,
            functools.partial(common.per_frame_device_op, input_path, out, op))
