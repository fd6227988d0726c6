"""FastICA: batched blind source separation for the ICA rPPG method.

Port of ``vhr_tpu/dsp/ica.py``: ``sklearn.decomposition.FastICA`` as the
reference configures it (3 components, parallel algorithm, logcosh,
``max_iter=300``, ``tol=1e-6``, unit-variance whitening, ``random_state=
0``), over a batch of windows at once.  Whitening is an SVD, the symmetric
decorrelation a batched 3x3 ``eigh``.

:func:`ica_sources` is natively batched: one loop over iterations for all
windows, each window keeping its own iteration count and freezing its
unmixing matrix once it has converged -- what ``vmap`` of the JAX
``lax.while_loop`` gives.  The loop stops when no window runs any more, a
test that (like every ``eigh`` and ``svd`` on the card) waits for the
device.  Non-convergence is a boolean, not a warning, so callers can mask
the windows out.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["ICAResult", "fastica", "default_w_init", "ica_sources"]


class ICAResult(NamedTuple):
    sources: torch.Tensor     # (..., T, C) estimated independent components
    converged: torch.Tensor   # (...) bool -- False mirrors ConvergenceWarning
    n_iter: torch.Tensor      # (...) int32


def default_w_init(n_components: int, seed: int = 0) -> np.ndarray:
    """The exact ``w_init`` sklearn draws from ``RandomState(seed)``."""
    return np.random.RandomState(seed).normal(
        size=(n_components, n_components))


def _sym_decorrelation(W: torch.Tensor) -> torch.Tensor:
    """``W <- (W W^T)^{-1/2} W`` over ``(..., C, C)`` via ``eigh``."""
    s, u = torch.linalg.eigh(W @ W.mT)
    s = torch.clamp(s, min=1e-12)
    return (u * (1.0 / torch.sqrt(s))[..., None, :]) @ u.mT @ W


def _whiten_unit_variance(X: torch.Tensor, n_components: int,
                          mask: torch.Tensor, n: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sklearn's SVD whitening with trailing samples masked out.

    ``X`` is ``(..., T, F)``, ``mask`` ``(..., 1, T)`` and ``n`` the
    ``(..., 1, 1)`` valid counts; returns ``(X1 (..., C, T), K (..., C,
    F))``.  Masked columns are zero after centring and leave the left
    singular vectors and the singular values unchanged.
    """
    XT = X.mT                                          # (..., F, T)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    mean = torch.where(mask, XT, zero).sum(-1, keepdim=True) / n
    XT = torch.where(mask, XT - mean, zero)
    u, d, _ = torch.linalg.svd(XT, full_matrices=False)
    u = u * torch.sign(u[..., :1, :])                  # sklearn's sign
    K = (u / d[..., None, :]).mT[..., :n_components, :]
    return (K @ XT) * torch.sqrt(n), K


def ica_sources(windows: torch.Tensor, w_init: np.ndarray,
                max_iter: int = 300, tol: float = 1e-6,
                n_valid=None) -> ICAResult:
    """FastICA over ``(..., T, F)`` windows at once.

    ``n_valid`` (a number or a tensor of the leading shape): only the first
    ``n_valid`` rows of a window are data, the rest padding; the result
    equals a run on the unpadded window (padded source rows are zero).
    Returns unit-variance sources ``(..., T, C)``, ``converged`` and
    ``n_iter`` per window.
    """
    dt, dev = windows.dtype, windows.device
    lead, T = windows.shape[:-2], windows.shape[-2]
    if n_valid is None:
        n_valid = T
    nv = torch.as_tensor(n_valid, device=dev).expand(lead)
    n = nv.to(dt)[..., None, None]                     # (..., 1, 1)
    mask = (torch.arange(T, device=dev) < nv[..., None])[..., None, :]
    X1, _ = _whiten_unit_variance(windows, w_init.shape[0], mask, n)
    W = _sym_decorrelation(torch.as_tensor(w_init, dtype=dt, device=dev)
                           ).expand(lead + w_init.shape).clone()
    n_iter = torch.zeros(lead, dtype=torch.int32, device=dev)
    lim = torch.full(lead, float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for _ in range(max_iter):
        running = lim >= tol               # each window's while-loop test
        if not bool(running.any()):
            break
        gwtx = torch.tanh(W @ X1)                      # padded columns 0
        g_wtx = torch.where(mask, 1.0 - gwtx * gwtx, zero).sum(-1) / n[..., 0]
        W1 = _sym_decorrelation(gwtx @ X1.mT / n - g_wtx[..., None] * W)
        lim1 = (torch.diagonal(W1 @ W.mT, dim1=-2, dim2=-1).abs() - 1.0
                ).abs().amax(-1)
        W = torch.where(running[..., None, None], W1, W)
        lim = torch.where(running, lim1, lim)
        n_iter = n_iter + running.to(torch.int32)
    S = (W @ X1).mT / torch.sqrt(n)                    # (..., T, C)
    # Unit variance over the valid rows (sources are zero-mean).
    S = S / torch.sqrt((S * S).sum(-2, keepdim=True) / n)
    S = torch.where(mask.mT, S, zero)
    return ICAResult(sources=S, converged=lim < tol, n_iter=n_iter)


def fastica(X: torch.Tensor, w_init: np.ndarray, max_iter: int = 300,
            tol: float = 1e-6, n_valid=None) -> ICAResult:
    """FastICA (parallel, logcosh, unit-variance) on one ``(T, F)``
    window: :func:`ica_sources` without batch axes."""
    return ica_sources(X, w_init, max_iter, tol, n_valid)
