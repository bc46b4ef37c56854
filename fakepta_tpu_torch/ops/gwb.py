"""Cross-pulsar correlation matrices (ORFs) and their Cholesky factor.

Port of :mod:`fakepta_tpu.ops.gwb`. The ORF builders and the factorization
stay host numpy float64, exactly as in the JAX package: they are one-time
O(npsr^2) setup, and the monopole (rank 1) and dipole (rank 3) ORFs are
exactly singular, so a float32 factorization returns silent NaNs. Callers
cast the factor to their compute dtype and device.
"""

from __future__ import annotations

import numpy as np
import torch


def _pos64(pos) -> np.ndarray:
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    return np.asarray(pos, dtype=np.float64)


def hd_orf(pos) -> np.ndarray:
    """Hellings-Downs ORF matrix from unit positions (npsr, 3).

    Off-diagonal ``1.5 x ln x - 0.25 x + 0.5`` with ``x = (1 - cos theta)/2``;
    diagonal 1.
    """
    pos = _pos64(pos)
    cosang = np.clip(pos @ pos.T, -1.0, 1.0)
    x = (1.0 - cosang) / 2.0
    x_safe = np.where(x > 0.0, x, 1.0)  # ln(1)=0 on/near the diagonal
    off = 1.5 * x_safe * np.log(x_safe) - 0.25 * x_safe + 0.5
    return np.where(np.eye(pos.shape[0], dtype=bool), 1.0, off)


def dipole_orf(pos) -> np.ndarray:
    """cos(theta_ab) off-diagonal, 1 on the diagonal."""
    pos = _pos64(pos)
    cosang = np.clip(pos @ pos.T, -1.0, 1.0)
    return np.where(np.eye(pos.shape[0], dtype=bool), 1.0, cosang)


def monopole_orf(pos) -> np.ndarray:
    """All-ones matrix."""
    return np.ones((_pos64(pos).shape[0],) * 2)


def curn_orf(pos) -> np.ndarray:
    """Common uncorrelated red noise: identity."""
    return np.eye(_pos64(pos).shape[0])


ORF_BUILDERS = {
    "hd": hd_orf,
    "monopole": monopole_orf,
    "dipole": dipole_orf,
    "curn": curn_orf,
}


def build_orf(orf: str, pos, h_map=None) -> np.ndarray:
    """Dispatch an ORF by name (``'hd' | 'monopole' | 'dipole' | 'curn'``)."""
    if orf in ORF_BUILDERS:
        return ORF_BUILDERS[orf](pos)
    if orf == "anisotropic":
        raise NotImplementedError(
            "the anisotropic ORF needs the HEALPix module, which the PyTorch "
            "port does not carry yet; use 'hd', 'monopole', 'dipole' or "
            "'curn'")
    raise KeyError(f"unknown ORF {orf!r}; known: "
                   f"{sorted(ORF_BUILDERS) + ['anisotropic']}")


def orf_cholesky(orf, jitter: float = 1e-10) -> np.ndarray:
    """Host-float64 Cholesky factor of the (jittered) ORF."""
    orf64 = np.asarray(orf, dtype=np.float64)
    n = orf64.shape[0]
    scaled = jitter * max(float(np.mean(np.diag(orf64))), 1.0)
    return np.linalg.cholesky(orf64 + scaled * np.eye(n))
