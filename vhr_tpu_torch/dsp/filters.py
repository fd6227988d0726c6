"""Temporal filtering: IIR and FIR application, dropout handling and
streaming filtering for per-frame traces.

Port of ``vhr_tpu/dsp/filters.py``.  Time runs along axis 0 and trailing
axes are batch, as in the JAX package; filter coefficients are host numpy
(``dsp.design``).  The recurrences (``sosfilt``, ``lfilter``) are a Python
loop over time steps, each step a few tensor operations over the whole
batch; ``sosfilt_parallel`` evaluates the same recurrence as a log-depth
doubling scan.  The JAX scan of ``forward_fill`` becomes a ``cummax`` over
the indices of valid samples followed by one gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import design

__all__ = ["sosfilt", "sosfilt_parallel", "sosfiltfilt", "lfilter",
           "filtfilt_fir", "odd_ext", "forward_fill", "sos_stream_init",
           "sos_stream_push"]


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


def _section_step(cur: torch.Tensor, z0: torch.Tensor, z1: torch.Tensor,
                  coeffs, rounding: Optional[str]) -> Tuple[torch.Tensor, ...]:
    """One DF2T biquad step ``y = b0 x + z0``, ``z0' = b1 x - a1 y + z1``,
    ``z1' = b2 x - a2 y`` -> ``(y, z0', z1')``.

    ``rounding=None`` computes the plain expressions in the tensors' dtype.
    Otherwise the tensors hold float32 values in float64 and each step is
    rounded as XLA:CPU rounds the JAX expressions: LLVM contracts them into
    fused multiply-adds, each computed here in float64 (the product of two
    float32 values is exact there) and rounded once to float32.  Which
    product an fma takes depends on what XLA knows of the coefficients:

    * ``"constants"`` (the jitted ``sos_stream_push``): XLA drops the
      multiplications by 1 of the band-pass sections, and the fused product
      depends on the coefficient's sign;
    * ``"operands"`` (the ``lax.scan`` of ``sosfilt``, whose coefficients
      are loop operands): always ``fma(b, x, -(a y))``.
    """
    b0, b1, b2, _, a1, a2 = (float(v) for v in coeffs)
    if rounding is None:
        y = b0 * cur + z0
        return y, b1 * cur - a1 * y + z1, b2 * cur - a2 * y
    y = _r32(b0 * cur + z0)
    consts = rounding == "constants"
    if consts and b1 < 0:           # fma(-a1, y, b1 x), then + z1
        t0 = _r32(_r32(b1 * cur) - a1 * y)
    else:                           # fma(b1, x, -(a1 y)), then + z1
        t0 = _r32(b1 * cur - _r32(a1 * y))
    if consts and b2 == 1.0:        # x - a2 y: fma(-a2, y, x)
        n1 = _r32(cur - a2 * y)
    else:                           # fma(b2, x, -(a2 y))
        n1 = _r32(b2 * cur - _r32(a2 * y))
    return y, _r32(t0 + z1), n1


def sos_stream_push(sos: np.ndarray, z: torch.Tensor, x_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter one new sample per stream and carry the state.

    ``z`` is ``(..., n_sections, 2)`` float32 and ``x_t`` the matching
    ``(...)`` samples; returns ``(y (...), new_z)``, rounded as XLA:CPU
    rounds the JAX version under ``jit`` (:func:`_section_step`'s
    ``"constants"``).
    """
    s32 = np.asarray(sos, dtype=np.float32).astype(np.float64)
    cur = _r32(x_t.to(torch.float64))
    z = z.to(torch.float64)
    zs = []
    for s in range(s32.shape[0]):
        cur, n0, n1 = _section_step(cur, z[..., s, 0], z[..., s, 1], s32[s],
                                    "constants")
        zs.append(torch.stack([n0, n1], dim=-1))
    return cur.to(torch.float32), torch.stack(zs, dim=-2).to(torch.float32)


def _broadcast_state(zi, x: torch.Tensor, n_state_axes: int
                     ) -> torch.Tensor:
    """``zi`` in ``x``'s dtype, with singleton batch axes appended when it
    has only its ``n_state_axes`` state axes (``(S, 2)`` sections, an
    ``(n,)`` FIR state)."""
    zi = torch.as_tensor(zi, device=x.device).to(x.dtype)
    if zi.dim() == n_state_axes:
        zi = zi.reshape(zi.shape + (1,) * (x.dim() - 1))
    return zi


def _sections(sos, dtype) -> np.ndarray:
    """The coefficients as the JAX package casts them, as float64 values
    (float32 values for a float32 signal)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return np.asarray(sos, dtype=np_dtype).astype(np.float64)


def sosfilt(sos, x: torch.Tensor, zi: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal cascaded-biquad filtering along axis 0 (direct form II
    transposed, ``scipy.signal.sosfilt``).

    ``x`` is ``(T, *batch)``; ``zi`` an optional ``(S, 2, *batch)`` or
    broadcastable ``(S, 2)`` state.  Returns ``(y, zf)``.  A float32 signal
    is rounded as XLA:CPU rounds the JAX ``lax.scan`` (:func:`_section_step`'s
    ``"operands"``): equal to it bit for bit on most inputs; XLA's
    vectorised loop rounds an occasional step of one batch lane otherwise,
    and the recurrence carries that difference at float32's scale.  Other
    dtypes compute in their own precision.
    """
    s = _sections(sos, x.dtype)
    exact = x.dtype == torch.float32
    work = torch.float64 if exact else x.dtype
    if zi is None:
        zi = torch.zeros((s.shape[0], 2) + x.shape[1:], dtype=x.dtype,
                         device=x.device)
    zi = _broadcast_state(zi, x, 2)
    z = [[zi[k, 0].to(work).expand(x.shape[1:]),
          zi[k, 1].to(work).expand(x.shape[1:])] for k in range(s.shape[0])]
    xs = x.to(work)
    ys = []
    for t in range(x.shape[0]):
        cur = xs[t]
        for k in range(s.shape[0]):
            cur, z[k][0], z[k][1] = _section_step(
                cur, z[k][0], z[k][1], s[k], "operands" if exact else None)
        ys.append(cur)
    y = torch.stack(ys).to(x.dtype) if ys else x.clone()
    zf = torch.stack([torch.stack(zk) for zk in z]).to(x.dtype)
    return y, zf


def sosfilt_parallel(sos, x: torch.Tensor, zi: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, None]:
    """:func:`sosfilt` with the time recurrence evaluated in log depth.

    Each biquad is the affine recurrence ``z[n] = A z[n-1] + u[n]`` with a
    constant 2x2 ``A`` and ``u[n] = B x[n]``; a doubling scan (step ``d``
    composes each element with the one ``d`` before it, for ``d`` = 1, 2,
    4, ...) gives every prefix in ``ceil(log2 T)`` rounds.  The final state
    is not materialised (``None``), as in the JAX package.
    """
    s_np = np.asarray(sos, dtype=np.float64)
    T, batch = x.shape[0], x.shape[1:]
    dt, dev = x.dtype, x.device
    sos_t = torch.as_tensor(s_np, dtype=dt, device=dev)
    if zi is None:
        zi = torch.zeros((s_np.shape[0], 2) + batch, dtype=dt, device=dev)
    zi = _broadcast_state(zi, x, 2).expand((s_np.shape[0], 2) + batch)
    cur = x
    for k in range(s_np.shape[0]):
        b0, b1, b2, a1, a2 = (sos_t[k, i] for i in (0, 1, 2, 4, 5))
        A = torch.stack([torch.stack([-a1, torch.ones_like(a1)]),
                         torch.stack([-a2, torch.zeros_like(a2)])])
        B = torch.stack([b1 - a1 * b0, b2 - a2 * b0])
        u = cur[..., None] * B                               # (T, *b, 2)
        u0 = torch.einsum("ij,j...->...i", A, zi[k])
        u = torch.cat([(u[0] + u0)[None], u[1:]])
        As = A.expand(T, 2, 2)
        d = 1
        while d < T:
            # Element t absorbs the prefix ending at t - d.
            u_new = torch.einsum("tij,t...j->t...i", As[d:], u[:-d]) + u[d:]
            As_new = torch.einsum("tij,tjk->tik", As[d:], As[:-d])
            u = torch.cat([u[:d], u_new])
            As = torch.cat([As[:d], As_new])
            d *= 2
        z0_prev = torch.cat([zi[k, 0][None], u[:-1, ..., 0]])
        cur = b0 * cur + z0_prev
    return cur, None


def odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension by ``n`` samples at each end of axis 0 (scipy's
    ``odd_ext``)."""
    if n < 1:
        return x
    left = 2 * x[0] - x[1:n + 1].flip(0)
    right = 2 * x[-1] - x[-(n + 1):-1].flip(0)
    return torch.cat([left, x, right])


def sosfiltfilt(sos: np.ndarray, x: torch.Tensor,
                padlen: Optional[int] = None,
                parallel: bool = False) -> torch.Tensor:
    """Zero-phase forward-backward SOS filtering along axis 0
    (``scipy.signal.sosfiltfilt``: odd extension, steady-state initial
    conditions scaled by the first sample of each pass).  ``parallel``
    takes :func:`sosfilt_parallel` for both passes."""
    sos_np = np.asarray(sos, dtype=np.float64)
    if padlen is None:
        padlen = design.sosfiltfilt_padlen(sos_np)
    if x.shape[0] <= padlen:
        raise ValueError(
            f"input length {x.shape[0]} must exceed padlen {padlen}")
    zi = _broadcast_state(design.sosfilt_zi(sos_np), x, 2)
    filt = sosfilt_parallel if parallel else sosfilt
    ext = odd_ext(x, padlen)
    y, _ = filt(sos_np, ext, zi * ext[0])
    y_rev = y.flip(0)
    y2, _ = filt(sos_np, y_rev, zi * y_rev[0])
    return y2.flip(0)[padlen:-padlen]


def lfilter(b, a, x: torch.Tensor, zi: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transfer-function filtering along axis 0 (direct form II transposed,
    ``scipy.signal.lfilter``) -> ``(y, zf)``.  The state has
    ``max(len(a), len(b)) - 1`` rows and updates as one tensor a step; a
    float32 signal is rounded as XLA:CPU rounds the JAX scan
    (``y = fma(b0, x, z0)``, ``z' = fma(b, x, -(a y)) + shift(z)``)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] != 1.0:
        b, a = b / a[0], a / a[0]
    n = max(len(a), len(b))
    b = np.pad(b, (0, n - len(b)))
    a = np.pad(a, (0, n - len(a)))
    exact = x.dtype == torch.float32
    work = torch.float64 if exact else x.dtype
    rnd = _r32 if exact else (lambda v: v)
    bw, aw = _sections(b, x.dtype), _sections(a, x.dtype)
    batch = x.shape[1:]
    shape = (n - 1,) + (1,) * len(batch)
    b_rest, a_rest = (torch.as_tensor(c[1:], dtype=work,
                                      device=x.device).reshape(shape)
                      for c in (bw, aw))
    if zi is None:
        z = torch.zeros((n - 1,) + batch, dtype=work, device=x.device)
    else:
        z = _broadcast_state(zi, x, 1).to(work).expand((n - 1,) + batch)
    pad = torch.zeros((1,) + batch, dtype=work, device=x.device)
    xs = x.to(work)
    ys = []
    for t in range(x.shape[0]):
        y = rnd(float(bw[0]) * xs[t] + z[0])
        z = rnd(rnd(b_rest * xs[t] - rnd(a_rest * y))
                + torch.cat([z[1:], pad]))
        ys.append(y)
    y = torch.stack(ys).to(x.dtype) if ys else x.clone()
    return y, z.to(x.dtype)


def filtfilt_fir(b: np.ndarray, x: torch.Tensor,
                 padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase FIR filtering along axis 0,
    ``scipy.signal.filtfilt(b, [1.], x)``."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.array([1.0])
    if padlen is None:
        padlen = design.filtfilt_padlen(b, a)
    if x.shape[0] <= padlen:
        raise ValueError(
            f"input length {x.shape[0]} must exceed padlen {padlen}")
    zi = _broadcast_state(design.lfilter_zi(b, a), x, 1)
    ext = odd_ext(x, padlen)
    y, _ = lfilter(b, a, ext, zi * ext[0])
    y_rev = y.flip(0)
    y2, _ = lfilter(b, a, y_rev, zi * y_rev[0])
    return y2.flip(0)[padlen:-padlen]


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
