"""PulsarBatch: the padded, masked representation of a PTA, as torch tensors.

Port of :mod:`fakepta_tpu.batch`. Every per-pulsar quantity is one padded
``(npsr, max_toa)`` tensor plus a validity mask; the batch stores
*normalized* times (``t/Tspan_pulsar`` and ``t/Tspan_array``), so Fourier
phases ``2 pi n t_norm`` stay float32-exact to ~1e-5 rad.

The engine has no trained weights: the batch (and the GWB PSD) is its whole
state. :meth:`PulsarBatch.from_numpy` carries a batch across from the JAX
package leaf for leaf; :meth:`PulsarBatch.synthetic` repeats the JAX
construction in numpy, so the two give bit-identical leaves at one seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device

# leaves that are not float: their dtype is fixed, never the batch dtype
_BOOL_FIELDS = ("mask", "sys_mask")
_INT_FIELDS = ("epoch_idx",)


@dataclasses.dataclass(frozen=True)
class PulsarBatch:
    """Device-ready PTA state. All arrays padded to (npsr, max_toa)."""

    t_own: torch.Tensor        # (P, T) toas normalized by each pulsar's Tspan
    t_common: torch.Tensor     # (P, T) toas normalized by the array Tspan
    mask: torch.Tensor         # (P, T) bool validity
    freqs: torch.Tensor        # (P, T) observing frequency [MHz]
    sigma2: torch.Tensor       # (P, T) white-noise variance per TOA [s^2]
    pos: torch.Tensor          # (P, 3) sky unit vectors
    red_psd: torch.Tensor      # (P, NR) red-noise PSD (0 = off)
    dm_psd: torch.Tensor       # (P, ND) DM-noise PSD (0 = off)
    chrom_psd: torch.Tensor    # (P, NC) chromatic (idx=4) PSD (0 = off)
    epoch_idx: torch.Tensor    # (P, T) int64 per-TOA epoch id (for ECORR)
    ecorr_amp: torch.Tensor    # (P, T) per-TOA ECORR amplitude [s] (0 = off)
    sys_psd: torch.Tensor      # (P, B, NS) per-backend system-noise PSD
    sys_mask: torch.Tensor     # (P, B, T) TOA membership of each band
    df_own: torch.Tensor       # (P,) per-pulsar bin width 1/Tspan_p [Hz]
    tspan_common: torch.Tensor  # () array Tspan [s]

    @property
    def npsr(self) -> int:
        return self.t_own.shape[0]

    @property
    def max_toa(self) -> int:
        return self.t_own.shape[1]

    @property
    def device(self) -> torch.device:
        return self.t_own.device

    @property
    def dtype(self) -> torch.dtype:
        return self.t_own.dtype

    def to(self, device: DeviceLike) -> "PulsarBatch":
        """The same batch on another device (leaves copied as they are)."""
        dev = resolve_device(device)
        return PulsarBatch(**{f.name: getattr(self, f.name).to(dev)
                              for f in dataclasses.fields(self)})

    def numpy(self) -> Dict[str, np.ndarray]:
        """Leaf name -> host numpy array (the inverse of :meth:`from_numpy`)."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, leaves: Dict[str, np.ndarray],
                   device: DeviceLike = None,
                   dtype: Optional[torch.dtype] = None) -> "PulsarBatch":
        """Build a batch from ``{field name: numpy array}``.

        This is how state crosses from the JAX package:
        ``{f.name: np.asarray(getattr(jb, f.name)) for f in fields(jb)}``
        gives the same arrays here. Float leaves keep their dtype unless
        ``dtype`` is given; masks become bool and epoch ids int64.
        """
        dev = resolve_device(device)
        names = [f.name for f in dataclasses.fields(cls)]
        missing = sorted(set(names) - set(leaves))
        if missing:
            raise KeyError(f"from_numpy is missing leaves {missing}")
        out = {}
        for name in names:
            arr = np.asarray(leaves[name])
            if name in _BOOL_FIELDS:
                t = torch.tensor(arr.astype(bool))
            elif name in _INT_FIELDS:
                t = torch.tensor(arr.astype(np.int64))
            else:
                t = torch.tensor(arr)
                if dtype is not None:
                    t = t.to(dtype)
            out[name] = t.to(dev)
        return cls(**out)

    @classmethod
    def synthetic(cls, npsr: int = 100, ntoa: int = 780,
                  tspan_years: float = 15.0, toaerr: float = 1e-7,
                  n_red: int = 30, n_dm: int = 100, n_chrom: int = 30,
                  red_log10_A: float = -14.0, red_gamma: float = 13 / 3,
                  dm_log10_A: float = -13.8, dm_gamma: float = 3.0,
                  chrom_log10_A: Optional[float] = None,
                  chrom_gamma: float = 3.0, seed: int = 0,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> "PulsarBatch":
        """A synthetic uniform-cadence array, built exactly as the JAX
        package builds it (host numpy at float64, one cast to ``dtype``)."""
        from . import constants as const
        from . import spectrum as spectrum_lib

        rng = np.random.default_rng(seed)
        tspan = tspan_years * const.yr
        toas = np.linspace(0.0, tspan, ntoa)
        costh = rng.uniform(-1, 1, npsr)
        phi = rng.uniform(0, 2 * np.pi, npsr)
        pos = np.stack([np.sqrt(1 - costh**2) * np.cos(phi),
                        np.sqrt(1 - costh**2) * np.sin(phi), costh], axis=-1)

        t_norm = np.tile(toas / tspan, (npsr, 1))
        f_red = np.arange(1, n_red + 1) / tspan
        f_dm = np.arange(1, n_dm + 1) / tspan
        red = spectrum_lib.powerlaw(f_red, red_log10_A, red_gamma).numpy()
        dm = spectrum_lib.powerlaw(f_dm, dm_log10_A, dm_gamma).numpy()
        if chrom_log10_A is None:
            chrom = np.zeros(n_chrom)                    # signal off (default)
        else:
            f_chrom = np.arange(1, n_chrom + 1) / tspan
            chrom = spectrum_lib.powerlaw(f_chrom, chrom_log10_A,
                                          chrom_gamma).numpy()

        leaves = dict(
            t_own=t_norm, t_common=t_norm,
            mask=np.ones((npsr, ntoa), dtype=bool),
            freqs=np.full((npsr, ntoa), 1400.0),
            sigma2=np.full((npsr, ntoa), toaerr**2),
            pos=pos,
            red_psd=np.tile(red, (npsr, 1)),
            dm_psd=np.tile(dm, (npsr, 1)),
            chrom_psd=np.tile(chrom, (npsr, 1)),
            epoch_idx=np.tile(np.arange(ntoa), (npsr, 1)),
            ecorr_amp=np.zeros((npsr, ntoa)),
            sys_psd=np.zeros((npsr, 1, 1)),
            sys_mask=np.zeros((npsr, 1, ntoa), dtype=bool),
            df_own=np.full(npsr, 1.0 / tspan),
            tspan_common=np.asarray(tspan),
        )
        return cls.from_numpy(leaves, device=device, dtype=dtype)


def fourier_basis_norm(t_norm: torch.Tensor, nbin: int, scale=None,
                       bin_offset: int = 0) -> torch.Tensor:
    """(…, T, 2, N) cos/sin basis from normalized time: phase = 2 pi n t_norm.

    The float32 operation order of the JAX basis, ``(2 pi t) n``, so the two
    agree to the rounding of ``cos``/``sin`` alone.
    """
    n = torch.arange(bin_offset + 1, bin_offset + nbin + 1,
                     dtype=t_norm.dtype, device=t_norm.device)
    phase = (2.0 * np.pi) * t_norm[..., :, None] * n
    basis = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-2)
    if scale is not None:
        basis = basis * scale[..., :, None, None]
    return basis
