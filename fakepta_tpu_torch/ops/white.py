"""White-noise kernels: EFAC/EQUAD variances, ECORR sampling and epoch
grouping (port of fakepta_tpu.ops.white).

Per-backend TOA variance ``sigma^2 = efac^2 toaerr^2 + 10^(2
log10_tnequad)``; ECORR adds a fully-correlated block within each observing
epoch of one backend, with the ENTERPRISE block variance ``10^(2
log10_ecorr)``. The rank-1-per-epoch covariance ``diag(sigma^2) + ecorr_var
1 1^T`` is sampled exactly with one extra standard normal per epoch,
gathered by epoch id: O(ntoa), no Cholesky. :func:`quantise_epochs` is the
host-side grouping the cadence scenarios and the facade share.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import rng


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x)


def white_sigma2(toaerrs, efac, tnequad_log10) -> torch.Tensor:
    """Per-TOA variance ``efac^2 toaerr^2 + 10^(2 q)`` from per-TOA
    parameter arrays, at the dtype and device of ``toaerrs``."""
    toaerrs = _t(toaerrs)
    return (_t(efac, toaerrs) ** 2 * toaerrs ** 2
            + 10.0 ** (2.0 * _t(tnequad_log10, toaerrs)))


def draw_white(key, sigma2, mask=None) -> torch.Tensor:
    """Normal residuals with per-TOA variance ``sigma2``, drawn at its dtype
    (float32 or float64) from ``key`` ((..., 2) keys broadcast over leading
    axes)."""
    sigma2 = _t(sigma2)
    r = rng.normal(key.to(sigma2.device), sigma2.shape[-1:],
                   dtype=sigma2.dtype) * torch.sqrt(sigma2)
    if mask is not None:
        r = torch.where(_t(mask).to(r.device), r, r.new_zeros(()))
    return r


def draw_white_ecorr(key, sigma2, ecorr_var, epoch_idx, n_epochs: int,
                     epoch_weight=None) -> torch.Tensor:
    """White noise plus epoch-block ECORR in one shot:
    ``sqrt(sigma2) z + sqrt(ecorr_var) u[epoch_idx]``, ``u ~ N(0,
    I_{n_epochs})``, exact because the block part is rank 1 per epoch. The
    two draws come from ``split(fold_in(key, 0x0E))``, at the dtype of
    ``sigma2``. ``epoch_weight`` (n_epochs,) 0/1 turns ECORR off on
    singleton epochs."""
    sigma2 = _t(sigma2)
    k = rng.split(rng.fold_in(key.to(sigma2.device), 0x0E), 2)
    z = rng.normal(k[..., 0, :], sigma2.shape[-1:], dtype=sigma2.dtype)
    u = rng.normal(k[..., 1, :], int(n_epochs), dtype=sigma2.dtype)
    if epoch_weight is not None:
        u = u * _t(epoch_weight, u)
    idx = _t(epoch_idx).to(device=u.device, dtype=torch.int64)
    return (torch.sqrt(sigma2) * z
            + torch.sqrt(_t(ecorr_var, sigma2)) * u[..., idx])


def white_ecorr_covariance(sigma2, ecorr_var, epoch_idx, epoch_weight=None
                           ) -> torch.Tensor:
    """Dense covariance of :func:`draw_white_ecorr`."""
    sigma2 = _t(sigma2)
    epoch_idx = _t(epoch_idx).to(sigma2.device)
    same = epoch_idx[:, None] == epoch_idx[None, :]
    amp = torch.sqrt(_t(ecorr_var, sigma2))
    block = amp[:, None] * amp[None, :] * same
    if epoch_weight is not None:
        w = _t(epoch_weight, sigma2)[epoch_idx.long()]
        block = block * (w[:, None] * w[None, :])
    return torch.diag(sigma2) + block


def quantise_epochs(times: np.ndarray, backend_codes: np.ndarray,
                    dt: float = 86400.0):
    """Greedy epoch grouping per backend (host-side, numpy).

    A new epoch starts when a TOA is at least ``dt`` after the *first* TOA
    of the current group, per backend; the final group of each backend is
    kept. Epoch ids run over the backends in ``np.unique`` order.

    Returns (epoch_idx (ntoa,) int array, n_epochs, counts (n_epochs,)).
    """
    times = np.asarray(times)
    backend_codes = np.asarray(backend_codes)
    epoch_idx = np.full(len(times), -1, dtype=np.int64)
    next_epoch = 0
    for code in np.unique(backend_codes):
        sel = np.flatnonzero(backend_codes == code)
        if len(sel) == 0:
            continue
        order = sel[np.argsort(times[sel], kind="stable")]
        t = times[order]
        n = len(t)
        # epoch g spans [start, first index with t >= t[start] + dt): one
        # searchsorted per epoch instead of a Python step per TOA
        start = 0
        while start < n:
            # max(..., start+1): dt <= 0 (or NaN anchors) degrades to
            # one-TOA epochs instead of spinning forever
            stop = max(int(np.searchsorted(t, t[start] + dt, side="left")),
                       start + 1)
            epoch_idx[order[start:stop]] = next_epoch
            next_epoch += 1
            start = stop
    n_epochs = next_epoch
    counts = np.bincount(epoch_idx, minlength=n_epochs)
    return epoch_idx, n_epochs, counts
