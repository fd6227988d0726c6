"""Batched YIQ colorspace conversions.

Port of the YIQ half of ``vhr_tpu/ops/color.py``: colorsys's NTSC YIQ
coefficients, applied to float32 tensors (Python scalars times a float32
tensor round in float32, as JAX's weakly typed constants do).
"""

from __future__ import annotations

import torch

__all__ = ["rgb_to_yiq", "yiq_to_rgb", "bgr_u8_to_yiq", "yiq_to_bgr_u8"]


def rgb_to_yiq(rgb: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` RGB in [0,1] -> YIQ (colorsys.rgb_to_yiq coefficients)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.30 * r + 0.59 * g + 0.11 * b
    i = 0.74 * (r - y) - 0.27 * (b - y)
    q = 0.48 * (r - y) + 0.41 * (b - y)
    return torch.stack([y, i, q], dim=-1)


def yiq_to_rgb(yiq: torch.Tensor) -> torch.Tensor:
    """YIQ -> RGB in [0,1] (colorsys.yiq_to_rgb coefficients + clamp)."""
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    r = y + 0.9468822170900693 * i + 0.6235565819861433 * q
    g = y - 0.27478764629897834 * i - 0.6356910791873801 * q
    b = y - 1.1085450346420322 * i + 1.7090069284064666 * q
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def bgr_u8_to_yiq(frames: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` uint8 BGR -> float32 YIQ in [0,1] luminance scale."""
    rgb = frames.flip(-1).to(torch.float32) / 255.0
    return rgb_to_yiq(rgb)


def yiq_to_bgr_u8(yiq: torch.Tensor) -> torch.Tensor:
    """YIQ -> uint8 BGR, rounding half to even (as ``jnp.round``)."""
    bgr = yiq_to_rgb(yiq).flip(-1)
    return torch.clamp(torch.round(bgr * 255.0), 0, 255).to(torch.uint8)
