"""Minimal HEALPix (RING scheme) pixel -> angle mapping (port of
fakepta_tpu.ops.healpix).

The anisotropic ORF turns an intensity map into source directions with
``npix2nside`` + ``pix2ang``. This is a dependency-free, vectorized copy of
the JAX package's implementation of that surface, following the standard
RING-scheme pixel geometry (Gorski et al. 2005): polar caps with ring index
from the quadratic pixel count, equatorial belt with alternating half-pixel
phase shifts. Host numpy float64: pixel geometry is one-time setup.
"""

from __future__ import annotations

import numpy as np


def npix2nside(npix: int) -> int:
    """Inverse of ``npix = 12 nside^2`` (validates the input)."""
    nside = int(round((npix / 12.0) ** 0.5))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix pixel count")
    return nside


def pix2ang_ring(nside: int, ipix):
    """(theta, phi) centers of RING-ordered pixels; vectorized over
    ``ipix``."""
    ipix = np.asarray(ipix, dtype=np.int64)
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    p = ipix.astype(np.float64)

    with np.errstate(invalid="ignore", divide="ignore"):
        # north polar cap: ring index from cumulative 2i(i-1) pixel count
        i_n = np.floor(0.5 * (1.0 + np.sqrt(1.0 + 2.0 * p))).astype(np.int64)
        i_n = np.maximum(i_n, 1)
        j_n = (ipix + 1 - 2 * i_n * (i_n - 1)).astype(np.float64)
        z_n = 1.0 - i_n.astype(np.float64) ** 2 / (3.0 * nside**2)
        phi_n = (j_n - 0.5) * np.pi / (2.0 * i_n)

        # equatorial belt
        ip = ipix - ncap
        i_e = ip // (4 * nside) + nside
        j_e = (ip % (4 * nside) + 1).astype(np.float64)
        fodd = np.where((i_e + nside) % 2 == 1, 1.0, 0.5)
        z_e = (2.0 * nside - i_e.astype(np.float64)) * 2.0 / (3.0 * nside)
        phi_e = (j_e - fodd) * np.pi / (2.0 * nside)

        # south polar cap (mirror of north)
        ps = (npix - ipix).astype(np.float64)
        i_s = np.floor(0.5 * (1.0 + np.sqrt(np.maximum(2.0 * ps - 1.0, 1.0)))
                       ).astype(np.int64)
        i_s = np.maximum(i_s, 1)
        fi_s = i_s.astype(np.float64)
        j_s = 4.0 * fi_s + 1.0 - (ps - 2.0 * fi_s * (fi_s - 1.0))
        z_s = -1.0 + fi_s**2 / (3.0 * nside**2)
        phi_s = (j_s - 0.5) * np.pi / (2.0 * fi_s)

    north = ipix < ncap
    south = ipix >= npix - ncap
    z = np.where(north, z_n, np.where(south, z_s, z_e))
    phi = np.where(north, phi_n, np.where(south, phi_s, phi_e))
    return np.arccos(np.clip(z, -1.0, 1.0)), phi


def pix2ang(nside: int, ipix, nest: bool = False):
    """healpy-compatible signature; only RING ordering is supported."""
    if nest:
        raise NotImplementedError("NESTED ordering is not supported")
    return pix2ang_ring(nside, ipix)


def pixel_directions(npix: int) -> np.ndarray:
    """Unit vectors (npix, 3) of all RING pixel centers — the
    anisotropic-ORF grid."""
    theta, phi = pix2ang_ring(npix2nside(npix), np.arange(npix))
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], axis=-1)
