"""Eulerian colour magnification (EVM).

Port of ``vhr_tpu/pipeline/evm.py``:

  uint8 BGR -> YIQ -> Gaussian pyramid (separable binomial 5-tap blur,
  stride 2) -> ideal temporal band-pass on the coarsest level (one
  ``rfft``/``irfft`` over the whole time axis) -> amplify -> upsample ->
  add -> uint8 BGR.

With ``use_pallas`` (the JAX package's name; it needs ``W % 128 == 0`` and
at least one level, exactly as there) the full-resolution stages run on
kernels K6 (:mod:`..ops.evm_cuda`: first pyramid level fused with the
colour change) and K7 (:mod:`..ops.evm_recon_cuda`: upsample, add and u8
reconstruction).  The two routes round differently (K6 takes ``H//2`` rows
where the pyramid takes ``ceil(H/2)``; K7 rounds ``+0.5`` then truncates
where the plain route rounds half to even), so each is held to its own JAX
route.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import EVMConfig, HRBand
from ..ops import color
from ..ops.evm_cuda import yiq_pyrdown
from ..ops.evm_recon_cuda import evm_reconstruct, upsample

__all__ = ["gaussian_downsample", "gaussian_pyramid_level",
           "temporal_ideal_bandpass", "magnify", "magnified_pulse"]

_BINOMIAL = (np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0).tolist()

# The pyramid is per frame: clips whose frames hold more than this many
# elements in all are pyramided a slice of frames at a time, so the padded
# shifted adds of the first level stay within a few GB on the card.
_SLICE_ELEMS = 1 << 27


def _sep_conv(x: torch.Tensor, axis: int, stride: int) -> torch.Tensor:
    """Binomial 5-tap filter along ``axis`` of ``(T, H, W, C)``, edge-padded,
    keeping every ``stride``-th output (``ceil(n / stride)`` of them)."""
    n = x.shape[axis]
    first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
    xp = torch.cat([first, first, x, last, last], dim=axis)
    n_out = -(-n // stride)
    out = None
    for tap, k in enumerate(_BINOMIAL):
        sl = [slice(None)] * x.dim()
        sl[axis] = slice(tap, tap + stride * (n_out - 1) + 1, stride)
        term = k * xp[tuple(sl)]
        out = term if out is None else out + term
    return out


def gaussian_downsample(x: torch.Tensor) -> torch.Tensor:
    """One pyramid level: blur + 2x decimate in H and W of ``(T, H, W, C)``."""
    return _sep_conv(_sep_conv(x, axis=1, stride=2), axis=2, stride=2)


def gaussian_pyramid_level(x: torch.Tensor, levels: int) -> torch.Tensor:
    """``levels`` pyramid levels of ``(T, H, W, C)``."""
    def down(v):
        for _ in range(levels):
            v = gaussian_downsample(v)
        return v

    n = max(1, _SLICE_ELEMS // max(math.prod(x.shape[1:]), 1))
    if levels == 0 or x.shape[0] <= n:
        return down(x)
    return torch.cat([down(x[s:s + n]) for s in range(0, x.shape[0], n)])


def temporal_ideal_bandpass(x: torch.Tensor, fps: float, band: HRBand
                            ) -> torch.Tensor:
    """Zero out temporal-frequency content outside ``band`` (axis 0)."""
    T = x.shape[0]
    freqs = np.fft.rfftfreq(T, d=1.0 / fps)
    keep = torch.as_tensor(((freqs >= band.low_hz) & (freqs <= band.high_hz))
                           .astype(np.float32), device=x.device)
    X = torch.fft.rfft(x, dim=0)
    X = X * keep.reshape((len(freqs),) + (1,) * (x.dim() - 1))
    return torch.fft.irfft(X, n=T, dim=0).to(x.dtype)


def _kernel_route(W: int, levels: int, use_pallas: bool) -> bool:
    return bool(use_pallas) and W % 128 == 0 and levels >= 1


def magnify(frames: torch.Tensor, fps: float,
            cfg: EVMConfig = EVMConfig(),
            use_pallas: bool = False) -> torch.Tensor:
    """Amplify subtle colour oscillations in the EVM band.

    With ``use_pallas`` (and ``W % 128 == 0``) the full-resolution stages
    run on K6 and K7, so no full-resolution float tensor is made.

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR.
    Returns:
      magnified ``(T, H, W, 3)`` uint8 BGR.
    """
    T, H, W, _ = frames.shape
    gains = torch.tensor([cfg.amplification,
                          cfg.amplification * cfg.attenuate_chroma,
                          cfg.amplification * cfg.attenuate_chroma],
                         dtype=torch.float32, device=frames.device)
    if _kernel_route(W, cfg.pyramid_levels, use_pallas):
        low = yiq_pyrdown(frames).permute(0, 2, 3, 1)     # (T, H/2, W/2, 3)
        low = gaussian_pyramid_level(low, cfg.pyramid_levels - 1)
        band = temporal_ideal_bandpass(low, fps, cfg.band) * gains
        out = evm_reconstruct(frames.permute(0, 3, 1, 2),
                              band.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)
    yiq = color.bgr_u8_to_yiq(frames)
    low = gaussian_pyramid_level(yiq, cfg.pyramid_levels)
    band = temporal_ideal_bandpass(low, fps, cfg.band) * gains
    up = upsample(band.permute(0, 3, 1, 2), H, W).permute(0, 2, 3, 1)
    return color.yiq_to_bgr_u8(yiq + up)


def magnified_pulse(frames: torch.Tensor, fps: float, band: HRBand,
                    levels: int = 4, use_pallas: bool = False
                    ) -> torch.Tensor:
    """The EVM analysis signal: spatial mean of the band-passed coarse
    level's luminance+chroma per frame, shape ``(T, 3)`` -- a pulse trace
    that needs no face detection (whole-frame Eulerian pooling).

    With ``use_pallas`` (and ``W % 128 == 0``) the first pyramid level runs
    on K6.
    """
    if _kernel_route(frames.shape[2], levels, use_pallas):
        low = yiq_pyrdown(frames).permute(0, 2, 3, 1)
        low = gaussian_pyramid_level(low, levels - 1)
    else:
        yiq = color.bgr_u8_to_yiq(frames)
        low = gaussian_pyramid_level(yiq, levels)
    bp = temporal_ideal_bandpass(low, fps, band)
    return bp.mean(dim=(1, 2))
