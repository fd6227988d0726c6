"""Chrominance pulse projections: CHROM, POS and OMIT.

Port of ``vhr_tpu/dsp/projections.py``.  Each method projects the per-frame
BGR ROI means onto directions that cancel common-mode intensity changes
(lighting flicker, small motion) and keeps the blood-volume pulse:

* **CHROM** (de Haan & Jeanne 2013): per 50%-overlapping Hann interval,
  ``X = 3R - 2G``, ``Y = 1.5R + G - 1.5B`` of the normalised channels,
  pulse ``X - (sigma_X / sigma_Y) Y``, overlap-added;
* **POS** (Wang et al. 2017): per stride-1 window, ``S1 = G - B``,
  ``S2 = G + B - 2R``, pulse ``S1 + (sigma_1 / sigma_2) S2``, demeaned and
  overlap-added;
* **OMIT** (Face2PPG 2023): per 50%-overlapping Hann window, the green row
  of the channel matrix with its window-mean colour direction projected
  out, overlap-added.

Every window is one row of a gathered ``(..., n_windows, L)`` tensor, and
the functions take leading batch axes (``(..., T, 3)`` means, ``(..., T)``
validity): the serving pool runs them over all its rings at once.  The
overlap-add is a gather, not a scatter: a host-built ``(T, k)`` table lists
the (window, offset) samples that cover each frame, in the order the JAX
scatter adds them, and the sum runs along ``k`` in that order, so every
call gives the same bits on the card (atomic adds would not).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["chrom_pulse", "pos_pulse", "omit_pulse", "PULSES"]

_EPS = 1e-9


def _ffill_rows(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Forward-fill invalid frames of ``(..., T, 3)`` over ``(..., T)``;
    frames before the first valid one take its value (no fake step edge in
    the leading normalised windows), or ``x[..., 0, :]`` if none is
    valid."""
    T = x.shape[-2]
    valid = valid.to(torch.bool)
    idx = torch.arange(T, device=x.device)
    last = torch.cummax(torch.where(valid, idx, torch.full_like(idx, -1)),
                        dim=-1).values                          # (..., T)
    rows = torch.where(last < 0,
                       torch.argmax(valid.to(torch.int32), dim=-1,
                                    keepdim=True), last)
    return torch.gather(x, -2, rows[..., None].expand(x.shape))


def _windows(T: int, L: int, stride: int) -> np.ndarray:
    """Static ``(n_windows, L)`` frame-index table covering every frame;
    the last window ends exactly at ``T``, so a stride that does not divide
    ``T - L`` leaves no uncovered tail."""
    L = min(L, T)
    starts = np.arange(0, max(T - L, 0) + 1, stride)
    if len(starts) == 0:
        starts = np.array([0])
    if starts[-1] != T - L:
        starts = np.append(starts, T - L)
    return starts[:, None] + np.arange(L)[None, :]


@functools.lru_cache(maxsize=32)
def _overlap_plan(T: int, L: int, stride: int, hann: bool):
    """Host tables for one window layout: ``(idx (N, L), cover (T, k),
    window (L,) float32 or None, norm (T,) float32 or None)``.

    ``cover[t]`` lists the flat positions ``n * L + l`` with ``idx[n, l] ==
    t`` in increasing order, padded with ``N * L`` (a zero appended to the
    samples).  ``norm`` is the overlap-added window, summed in that order in
    float32 as the JAX scatter sums it.
    """
    idx = _windows(T, L, stride)
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=T)
    k = int(counts.max())
    cover = np.full((T, k), flat.size, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(flat.size) - np.repeat(starts, counts)
    cover[flat[order], rank] = order
    if not hann:
        return idx, cover, None, None
    win = np.hanning(idx.shape[1]).astype(np.float32)
    w_flat = np.append(np.broadcast_to(win, idx.shape).reshape(-1),
                       np.float32(0.0))
    norm = np.zeros(T, np.float32)
    for j in range(k):
        norm = norm + w_flat[cover[:, j]]
    return idx, cover, win, norm


@functools.lru_cache(maxsize=32)
def _device_plan(T: int, L: int, stride: int, hann: bool,
                 device: torch.device):
    """:func:`_overlap_plan`'s tables on ``device``, cached: a copy from the
    host in every call would wait for the card's queue."""
    return tuple(None if a is None else torch.as_tensor(a, device=device)
                 for a in _overlap_plan(T, L, stride, hann))


def _overlap_add(s: torch.Tensor, cover: torch.Tensor) -> torch.Tensor:
    """Sum ``(..., N, L)`` window samples onto ``(..., T)`` frames through
    the ``cover`` table, in its order (one add per column)."""
    flat = torch.cat([s.reshape(s.shape[:-2] + (-1,)),
                      s.new_zeros(s.shape[:-2] + (1,))], dim=-1)
    g = flat[..., cover]                                      # (..., T, k)
    out = g[..., 0]
    for j in range(1, g.shape[-1]):
        out = out + g[..., j]
    return out


def _std(x: torch.Tensor) -> torch.Tensor:
    """Standard deviation over the last axis, ``ddof=0`` (``jnp.std``)."""
    c = x - x.mean(-1, keepdim=True)
    return (c * c).mean(-1, keepdim=True).sqrt()


def _setup(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
           seconds: float, stride_half: bool, hann: bool
           ) -> Tuple[torch.Tensor, tuple]:
    """Window length, forward fill and the overlap plan shared by the three
    methods: ``(filled (..., T, 3), (idx, cover, window, norm) on the
    device)``."""
    T = bgr.shape[-2]
    L = int(max(4, min(T, round(seconds * fps))))
    stride = max(1, L // 2) if stride_half else 1
    filled = _ffill_rows(bgr, valid)
    return filled, _device_plan(T, L, stride, hann, bgr.device)


def _normalised(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(..., T)`` channel -> its ``(..., N, L)`` windows over their
    means."""
    w = c[..., idx]
    return w / (w.mean(-1, keepdim=True) + _EPS)


def chrom_pulse(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
                interval_seconds: float = 1.6) -> torch.Tensor:
    """CHROM pulse from ``(..., T, 3)`` BGR ROI means -> ``(..., T)``."""
    filled, (idx, cover, win, norm) = _setup(bgr, valid, fps,
                                             interval_seconds, True, True)
    b, g, r = filled[..., 0], filled[..., 1], filled[..., 2]
    rn, gn, bn = (_normalised(c, idx) for c in (r, g, b))
    x = 3.0 * rn - 2.0 * gn
    y = 1.5 * rn + gn - 1.5 * bn
    x = x - x.mean(-1, keepdim=True)
    y = y - y.mean(-1, keepdim=True)
    s = x - _std(x) / (_std(y) + _EPS) * y
    return _overlap_add(s * win, cover) / torch.clamp(norm, min=_EPS)


def pos_pulse(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
              window_seconds: float = 1.6) -> torch.Tensor:
    """POS pulse from ``(..., T, 3)`` BGR ROI means -> ``(..., T)``."""
    filled, (idx, cover, _, _) = _setup(bgr, valid, fps, window_seconds,
                                         False, False)
    b, g, r = filled[..., 0], filled[..., 1], filled[..., 2]
    rn, gn, bn = (_normalised(c, idx) for c in (r, g, b))
    s1 = gn - bn
    s2 = gn + bn - 2.0 * rn
    h = s1 + _std(s1) / (_std(s2) + _EPS) * s2
    h = h - h.mean(-1, keepdim=True)
    return _overlap_add(h, cover)


def omit_pulse(bgr: torch.Tensor, valid: torch.Tensor, fps: float,
               window_seconds: float = 1.6) -> torch.Tensor:
    """OMIT pulse from ``(..., T, 3)`` BGR ROI means -> ``(..., T)``.

    Per window, ``q`` is the normalised window-mean colour and the pulse is
    the green row of ``C - q (q^T C)`` (the JAX package's form of the
    published QR step).
    """
    filled, (idx, cover, win, norm) = _setup(bgr, valid, fps,
                                             window_seconds, True, True)
    # RGB rows of each window: (..., N, L) each.
    cr, cg, cb = (filled[..., c][..., idx] for c in (2, 1, 0))
    mr, mg, mb = (c.mean(-1, keepdim=True) for c in (cr, cg, cb))
    scale = (mr * mr + mg * mg + mb * mb).sqrt() + _EPS
    qr, qg, qb = mr / scale, mg / scale, mb / scale
    coef = qr * cr + qg * cg + qb * cb
    s = cg - qg * coef
    s = s - s.mean(-1, keepdim=True)
    return _overlap_add(s * win, cover) / torch.clamp(norm, min=_EPS)


# The methods by the names ``PipelineConfig`` and ``LiveConfig`` use.
PULSES = {"chrom": chrom_pulse, "pos": pos_pulse, "omit": omit_pulse}
