"""The acquisition ramp's growing-window DFT peak on a hand-written CUDA
kernel, one launch for every length and stream.

:func:`ramp_bpm_cuda` computes what the plain
:func:`vhr_tpu_torch.ops.windows._ramp_bpm` computes, from two integers
(the first and last length) and the band's scalars, and writes it straight
into the estimate's rows: no table leaves the host, so the launch never
waits on the card.  It launches ``csrc/ramp_dft.cu``, which replaces no TPU
kernel (the JAX package's ramp is plain ``jnp``); the note there says what
bounds it.  :func:`ramp_plan` sizes the launch from the stream count and
the longest length alone.  The entry
:func:`vhr_tpu_torch.ops.windows.ramp_bpm` takes the plain version for a
CPU tensor and this kernel for a CUDA one.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _build
from ..config import HRBand
from ..utils import profiling

__all__ = ["ramp_bpm_cuda", "ramp_plan", "RampPlan", "SMEM_BYTES"]

MAX_ROWS = 16                 # streams a block, at most
SMEM_BYTES = 64 * 1024        # a block's demeaned traces, at most


class RampPlan(NamedTuple):
    """One launch: ``rows`` (the kernel's instance: a power of two of
    streams, its shared rows), ``tile`` streams a block (at most
    ``rows``), ``tiles`` blocks a length, ``pitch`` floats a stream's row
    (``n_last`` rounded up to 4, for 16-byte loads)."""

    rows: int
    tile: int
    tiles: int
    pitch: int


def ramp_plan(S: int, n_last: int) -> RampPlan:
    """The launch for ``S`` streams and lengths up to ``n_last``.

    A block holds ``rows * pitch`` floats of demeaned traces in shared
    memory: ``rows`` is the power of two at or above ``min(S, 16)``, halved
    while that passes :data:`SMEM_BYTES`; the streams are then cut into
    ``tiles`` balanced tiles of at most ``rows``.  Lengths past 16,384
    (one stream's row over :data:`SMEM_BYTES`) are refused.
    """
    if S < 1 or n_last < 1:
        raise ValueError(f"bad ramp size S={S} n_last={n_last}")
    pitch = -(-n_last // 4) * 4
    rows = 1 << (min(S, MAX_ROWS) - 1).bit_length()
    while rows > 1 and rows * pitch * 4 > SMEM_BYTES:
        rows //= 2
    if pitch * 4 > SMEM_BYTES:
        raise ValueError(f"ramp lengths up to {n_last} do not fit a block's "
                         f"shared memory")
    tiles = -(-S // rows)
    return RampPlan(rows, -(-S // tiles), tiles, pitch)


def ramp_bpm_cuda(x: torch.Tensor, fps: float, band: HRBand, n_first: int,
                  n_last: int, bpm: torch.Tensor,
                  valid: torch.Tensor) -> None:
    """Growing-window FFT-peak estimates, one launch.

    Args:
      x: ``(T, *batch)`` float32 on a CUDA card, ``T >= n_last``.
      n_first, n_last: the window lengths ``N`` estimated,
        ``1 <= n_first <= n_last``.
      bpm, valid: contiguous ``(n_last - n_first + 1, *batch)`` float32
        and bool outputs on ``x``'s card; row ``N - n_first`` gets the
        window ``x[:N]``'s estimate, as
        :func:`vhr_tpu_torch.ops.windows._ramp_bpm` computes it.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the ramp kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the ramp kernel takes float32, got {x.dtype}")
    L = n_last - n_first + 1
    if not 1 <= n_first <= n_last <= x.shape[0]:
        raise ValueError(f"ramp lengths {n_first}..{n_last} outside "
                         f"1..{x.shape[0]}")
    shape = (L,) + tuple(x.shape[1:])
    for out, dt in ((bpm, torch.float32), (valid, torch.bool)):
        if (tuple(out.shape) != shape or out.dtype != dt
                or out.device != x.device or not out.is_contiguous()):
            raise ValueError(f"ramp outputs must be contiguous {shape} "
                             f"{dt} on {x.device}")
    S = math.prod(x.shape[1:])
    if S == 0:
        return
    plan = ramp_plan(S, n_last)
    xs = torch.empty((S, plan.pitch), dtype=torch.float32, device=x.device)
    xs[:, :n_last].copy_(x[:n_last].reshape(n_last, S).T)
    k_max = int(math.floor(band.high_hz * n_last / fps))
    profiling.count("ramp.launches")        # CUDA tensors only
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_build.library().vhr_ramp_dft(
        xs.data_ptr(), S, plan.pitch, n_first, n_last, k_max, fps,
        band.low_hz, band.high_hz, plan.tile, plan.rows, bpm.data_ptr(),
        valid.data_ptr(), stream), "vhr_ramp_dft")
