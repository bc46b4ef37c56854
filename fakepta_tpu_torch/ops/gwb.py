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

from .healpix import npix2nside, pix2ang_ring


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


def antenna_patterns(pos, gwtheta, gwphi):
    """F+, Fx, cosMu for a batch of pulsars against a batch of GW directions.

    pos: (npsr, 3); gwtheta/gwphi: (nsrc,). Returns (npsr, nsrc) each.
    """
    pos = _pos64(pos)
    gwtheta = np.asarray(gwtheta, dtype=np.float64)
    gwphi = np.asarray(gwphi, dtype=np.float64)
    sin_t, cos_t = np.sin(gwtheta), np.cos(gwtheta)
    sin_p, cos_p = np.sin(gwphi), np.cos(gwphi)
    m = np.stack([sin_p, -cos_p, np.zeros_like(gwphi)], axis=-1)  # (nsrc, 3)
    n = np.stack([-cos_t * cos_p, -cos_t * sin_p, sin_t], axis=-1)
    omhat = np.stack([-sin_t * cos_p, -sin_t * sin_p, -cos_t], axis=-1)
    mdp = pos @ m.T                                              # (npsr, nsrc)
    ndp = pos @ n.T
    odp = pos @ omhat.T
    fplus = 0.5 * (mdp**2 - ndp**2) / (1.0 + odp)
    fcross = mdp * ndp / (1.0 + odp)
    return fplus, fcross, -odp


def anisotropic_orf(pos, h_map) -> np.ndarray:
    """ORF from a HEALPix (RING) intensity map.

    ``orf_ab = 1.5 k_ab sum_pix (F+_a F+_b + Fx_a Fx_b) h_pix / npix`` with
    ``k_ab = 2`` on the diagonal.
    """
    pos = _pos64(pos)
    h_map = np.asarray(h_map, dtype=np.float64)
    npix = h_map.shape[0]
    theta, phi = pix2ang_ring(npix2nside(npix), np.arange(npix))
    fplus, fcross, _ = antenna_patterns(pos, theta, phi)
    weighted = ((fplus * h_map[None, :]) @ fplus.T
                + (fcross * h_map[None, :]) @ fcross.T)
    orf = 1.5 * weighted / npix
    return np.where(np.eye(pos.shape[0], dtype=bool), 2.0 * orf, orf)


ORF_BUILDERS = {
    "hd": hd_orf,
    "monopole": monopole_orf,
    "dipole": dipole_orf,
    "curn": curn_orf,
}


def build_orf(orf: str, pos, h_map=None) -> np.ndarray:
    """Dispatch an ORF by name (``'hd' | 'monopole' | 'dipole' | 'curn' |
    'anisotropic'``; the last needs ``h_map``, a HEALPix RING map)."""
    if orf in ORF_BUILDERS:
        return ORF_BUILDERS[orf](pos)
    if orf == "anisotropic":
        if h_map is None:
            raise ValueError("anisotropic ORF requires h_map")
        return anisotropic_orf(pos, h_map)
    raise KeyError(f"unknown ORF {orf!r}; known: "
                   f"{sorted(ORF_BUILDERS) + ['anisotropic']}")


def orf_cholesky(orf, jitter: float = 1e-10) -> np.ndarray:
    """Host-float64 Cholesky factor of the (jittered) ORF."""
    orf64 = np.asarray(orf, dtype=np.float64)
    n = orf64.shape[0]
    scaled = jitter * max(float(np.mean(np.diag(orf64))), 1.0)
    return np.linalg.cholesky(orf64 + scaled * np.eye(n))


def draw_correlated_coeffs(key: torch.Tensor, chol, psd, shape_prefix=(),
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Raw GWB Fourier coefficients with exact cross-pulsar correlation.

    ``key`` is one (2,) key; returns ``(*shape_prefix, 2, ncomp, npsr)``
    coefficients at ``dtype`` (float32 or float64) on ``key``'s device:
    standard normals ``z`` drawn at that shape and dtype, coupled as ``z @
    chol.T`` (at full float32, no TF32, on a float32 draw) and scaled by
    ``sqrt(psd_c)`` per component: the JAX package's draw, op for op, in
    its float32 mode, or under x64 at ``dtype=torch.float64``. ``chol``
    (npsr, npsr) is the host float64 factor of :func:`orf_cholesky` (cast
    here), ``psd`` (ncomp,).
    """
    from ..utils import rng
    from .megakernel import full_f32

    dev = key.device

    def cast(x):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x, dtype=np.float64))
        return x.to(device=dev, dtype=dtype)

    chol, psd = cast(chol), cast(psd)
    z = rng.normal(key, (*shape_prefix, 2, psd.shape[0], chol.shape[0]),
                   dtype=dtype)
    with full_f32():
        corr = z @ chol.T
    return corr * torch.sqrt(psd)[:, None]
