"""White-noise epoch grouping (port of fakepta_tpu.ops.white, host part).

Only :func:`quantise_epochs` is ported: the cadence scenarios group ECORR
epochs with it. The JAX module's device draw helpers (``white_sigma2``,
``draw_white``, ``draw_white_ecorr``, ``white_ecorr_covariance``) serve the
reference-compatible facade and come with it.
"""

from __future__ import annotations

import numpy as np


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
