"""Additive Gaussian colour noise at sigma in {5, 10, 20, 40}.

Port of ``vhr_tpu/analysis/degradation/colour_noise.py`` (levels, control
``0std`` first, float add + clip to uint8), computed on the sweep's device
(``analysis.context``).  Deterministic per (video, sigma) as JAX's is: the
noise is drawn from a ``torch.Generator`` seeded ``_SEED + sigma`` anew for
every chunk, as JAX's fixed ``PRNGKey(seed)`` gives every chunk the same
draw.  The draws are PyTorch's, not JAX's bits; the add-and-clip step
(:func:`_add_noise`) is JAX's formula.
"""

from __future__ import annotations

import functools
from typing import Generator, Tuple

import numpy as np
import torch

from . import common
from .. import context

NOISE_LEVELS = [5, 10, 20, 40]
_SEED = 0x5EED


def _draw(shape, std_dev: float, seed: int, device) -> torch.Tensor:
    """``std_dev * N(0, 1)`` float32 noise of ``shape`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return std_dev * torch.randn(shape, generator=gen, device=device,
                                 dtype=torch.float32)


def _add_noise(frames: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """u8 frames plus float32 noise, clipped to [0, 255], truncated to u8."""
    return torch.clamp(frames.to(torch.float32) + noise, 0, 255).to(
        torch.uint8)


def _noisy_op(std_dev: float, seed: int):
    """``chunk (T, H, W, 3) u8 -> u8``, computed on the sweep's device."""
    device = context.current_device()

    def op(chunk: np.ndarray) -> np.ndarray:
        frames = torch.as_tensor(chunk, device=device)
        noise = _draw(frames.shape, std_dev, seed, device)
        return _add_noise(frames, noise).cpu().numpy()

    return op


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    root = common.output_root(input_path, "colour_noise")

    control = root / "0std.mp4"
    yield common.cached_level(
        control, "0std",
        lambda: common.per_frame_device_op(input_path, control, lambda x: x))

    for std in NOISE_LEVELS:
        label = f"{int(std)}std"
        out = root / f"{label}.mp4"
        op = _noisy_op(float(std), _SEED + std)
        yield common.cached_level(
            out, label,
            functools.partial(common.per_frame_device_op, input_path, out, op))
