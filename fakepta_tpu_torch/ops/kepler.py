"""Vectorized fixed-iteration Kepler solvers (port of fakepta_tpu.ops.kepler).

Newton's iteration for ``E - e sin E = M`` converges quadratically from
``E0 = M + e sin M`` for any planetary eccentricity (max |e| ~ 0.21 for
Mercury), so a fixed small iteration count vectorizes over every TOA at once
with no data-dependent control flow. The count stays fixed even where the
iteration has converged: an early exit would make a rerun's bits depend on
the data.

Two implementations of the same math: a numpy one (float64 host path used by
:mod:`..ephemeris`, where orbit *differences* demand f64) and a torch one
that runs on the tensors' own device at their dtype.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_ITERS = 10


def kepler_newton_np(M, e, iters: int = _DEFAULT_ITERS):
    """Eccentric anomaly E solving E - e sin E = M (numpy, vectorized, float64)."""
    M = np.asarray(M, dtype=np.float64)
    e = np.broadcast_to(np.asarray(e, dtype=np.float64), M.shape)
    E = M + e * np.sin(M)
    for _ in range(iters):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def kepler_newton(M: torch.Tensor, e, iters: int = _DEFAULT_ITERS):
    """Eccentric anomaly on tensors (fixed iteration count)."""
    E = M + e * torch.sin(M)
    for _ in range(iters):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    return E


def delta_trig(sin_a: torch.Tensor, cos_a: torch.Tensor, d: torch.Tensor):
    """Stable ``(sin(a+d) - sin a, cos(a+d) - cos a)`` from the nominal pair.

    Uses the half-angle identities ``2 sin(d/2) cos(a + d/2)`` /
    ``-2 sin(d/2) sin(a + d/2)`` so no large angle is ever evaluated and every
    output is O(d).
    """
    sin_half = torch.sin(0.5 * d)
    cos_half = torch.cos(0.5 * d)
    sin_mid = sin_a * cos_half + cos_a * sin_half
    cos_mid = cos_a * cos_half - sin_a * sin_half
    return 2.0 * cos_mid * sin_half, -2.0 * sin_mid * sin_half


def kepler_delta_newton(sinE: torch.Tensor, cosE: torch.Tensor, e, d_M, d_e,
                        iters: int = _DEFAULT_ITERS):
    """Perturbation ``dE = E' - E`` of the eccentric anomaly, cancellation-free.

    Given the nominal solution ``E - e sin E = M`` (passed as its sine and
    cosine), solves the *difference* of the perturbed Kepler equation
    ``(E+dE) - (e+de) sin(E+dE) = M + dM`` directly for ``dE``:

        f(dE)  = dE - 2 e sin(dE/2) cos(E + dE/2) - de sin(E + dE) - dM
        f'(dE) = 1 - (e + de) cos(E + dE)

    Every term is O(perturbation), so the solve is accurate in float32 even
    though ``E' - E`` from two separate float32 Kepler solves would be pure
    round-off.
    """
    dE = (d_M + d_e * sinE) / (1.0 - e * cosE)
    for _ in range(iters):
        d_sin, d_cos = delta_trig(sinE, cosE, dE)
        # e [sin(E+dE) - sin E] through the stable difference; the full-angle
        # values only multiply the already-small d_e
        f = dE - e * d_sin - d_e * (sinE + d_sin) - d_M
        fp = 1.0 - (e + d_e) * (cosE + d_cos)
        dE = dE - f / fp
    return dE
