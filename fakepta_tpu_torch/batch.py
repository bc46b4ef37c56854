"""PulsarBatch: the padded, masked representation of a PTA, as torch tensors.

Port of :mod:`fakepta_tpu.batch`. Every per-pulsar quantity is one padded
``(npsr, max_toa)`` tensor plus a validity mask; the batch stores
*normalized* times (``t/Tspan_pulsar`` and ``t/Tspan_array``), so Fourier
phases ``2 pi n t_norm`` stay float32-exact to ~1e-5 rad.

The engine has no trained weights: the batch (and the GWB PSD) is its whole
state. :meth:`PulsarBatch.from_numpy` carries a batch across from the JAX
package leaf for leaf; :meth:`PulsarBatch.synthetic` and
:meth:`PulsarBatch.from_pulsars` (a facade-built or ENTERPRISE-style pulsar
list) repeat the JAX constructions in host numpy, so the two packages give
the same leaves from the same inputs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .utils.masks import stack_ragged

# leaves that are not float: their dtype is fixed, never the batch dtype
_BOOL_FIELDS = ("mask", "sys_mask")
_INT_FIELDS = ("epoch_idx",)
# the GP bands from_pulsars packs, with their canonical chromatic indices
_BATCHED_GPS = (("red_noise", 0.0), ("dm_gp", 2.0), ("chrom_gp", 4.0))


def _host(x) -> np.ndarray:
    """A numpy view of a host array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    def from_pulsars(cls, psrs: Sequence, n_red: int = 30, n_dm: int = 100,
                     n_chrom: int = 30, n_sys: int = 30, ecorr: bool = False,
                     ecorr_dt: float = 1.0, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> "PulsarBatch":
        """Pack a list of (facade or ENTERPRISE-style) pulsars into a batch.

        The JAX package's construction, leaf for leaf: TOAs padded to a
        multiple of 128 under a mask; red / DM / chromatic PSDs from each
        pulsar's ``signal_model`` (zero-padded to the batch bin counts, a
        non-default ``freqf`` folded into the PSD), else zero; white
        variances from the noisedict per backend; with ``ecorr`` the
        per-backend ``log10_ecorr`` amplitudes on epochs of ``ecorr_dt``
        days (singleton epochs get none); per-backend system noises as
        masked bands. Bands must sit on the standard n/Tspan grid; signals
        this packer does not batch are warned about.
        """
        from .ops.white import quantise_epochs

        toas_list = [np.asarray(p.toas, dtype=np.float64) for p in psrs]
        tmin = min(t.min() for t in toas_list)
        tmax = max(t.max() for t in toas_list)
        tspan_common = tmax - tmin

        toas_pad, mask = stack_ragged(toas_list)
        npsr, T = toas_pad.shape

        t_own = np.zeros((npsr, T))
        freqs = np.zeros((npsr, T))
        sigma2 = np.zeros((npsr, T))
        targets = {"red_noise": np.zeros((npsr, n_red)),
                   "dm_gp": np.zeros((npsr, n_dm)),
                   "chrom_gp": np.zeros((npsr, n_chrom))}
        epoch_idx = np.zeros((npsr, T), dtype=np.int64)
        ecorr_amp = np.zeros((npsr, T))
        sys_bands = []              # per pulsar: list of (mask (T,), psd)
        df_own = np.zeros(npsr)
        pos = np.stack([np.asarray(p.pos, dtype=np.float64) for p in psrs])

        for i, p in enumerate(psrs):
            n = len(toas_list[i])
            tspan = toas_list[i].max() - toas_list[i].min()
            df_own[i] = 1.0 / tspan
            t_own[i, :n] = (toas_list[i] - toas_list[i].min()) / tspan
            freqs[i, :n] = np.asarray(p.freqs, dtype=np.float64)[:n]
            freqs[i, n:] = 1400.0
            flags = np.asarray(p.backend_flags)
            efac = np.ones(n)
            equad = np.full(n, -np.inf)
            for backend in np.unique(flags):
                sel = flags == backend
                efac[sel] = p.noisedict.get(f"{p.name}_{backend}_efac", 1.0)
                equad[sel] = p.noisedict.get(
                    f"{p.name}_{backend}_log10_tnequad", -8.0)
            sigma2[i, :n] = (efac ** 2 * np.asarray(p.toaerrs[:n]) ** 2
                             + 10.0 ** (2.0 * equad))
            if ecorr:
                flags_n = flags[:n]
                idx, _, ep_counts = quantise_epochs(
                    toas_list[i] - toas_list[i].min(), flags_n,
                    dt=ecorr_dt * 86400.0)
                epoch_idx[i, :n] = idx
                for backend in np.unique(flags_n):
                    sel = flags_n == backend
                    ecorr_amp[i, :n][sel] = 10.0 ** p.noisedict.get(
                        f"{p.name}_{backend}_log10_ecorr", -np.inf)
                ecorr_amp[i, :n][ep_counts[idx] < 2] = 0.0

            def check_grid(key, entry, p=p, tspan=tspan):
                # every batched band lives on the standard n/Tspan_pulsar
                # grid (df_own scaling assumes it)
                f = _host(entry.get("f", []))
                expect = np.arange(1, len(f) + 1) / tspan
                if f.size and not np.allclose(f, expect, rtol=1e-6):
                    raise ValueError(
                        f"{p.name}.{key} uses a custom frequency grid; the "
                        f"batch engine requires the standard n/Tspan grid")

            model = getattr(p, "signal_model", {})
            known = {name for name, _ in _BATCHED_GPS}
            unhandled = [key for key in model
                         if key not in known and "system_noise_" not in key]
            if unhandled:
                warnings.warn(
                    f"{p.name}: signal_model entries {sorted(unhandled)} are "
                    f"not batched by PulsarBatch.from_pulsars and will be "
                    f"absent from ensemble simulations (pass GWBConfig / "
                    f"CGWConfig / RoemerConfig to EnsembleSimulator "
                    f"instead)", stacklevel=2)

            bands = []
            for key, entry in model.items():
                if "system_noise_" not in key:
                    continue
                if float(entry.get("idx", 0.0)) != 0.0:
                    raise ValueError(f"{p.name}.{key} has idx={entry['idx']}"
                                     f"; system bands assume idx=0")
                check_grid(key, entry)
                backend = key.split("system_noise_")[-1]
                bmask = np.zeros(T, dtype=bool)
                bmask[:n] = flags[:n] == backend
                if not bmask.any():
                    raise ValueError(f"{p.name}.{key}: backend {backend!r} "
                                     f"has no TOAs")
                bpsd = np.zeros(n_sys)
                k = min(len(entry["psd"]), n_sys)
                bpsd[:k] = _host(entry["psd"])[:k]
                bands.append((bmask, bpsd))
            sys_bands.append(bands)
            for signal, idx in _BATCHED_GPS:
                target = targets[signal]
                entry = model.get(signal)
                if entry is None:
                    continue
                if float(entry.get("idx", idx)) != idx:
                    raise ValueError(
                        f"{p.name}.{signal} has idx={entry['idx']}; the "
                        f"batch engine assumes the canonical chromatic index "
                        f"{idx}")
                check_grid(signal, entry)
                # a non-default reference frequency is a constant factor
                # absorbed into the PSD: sqrt(S)(freqf/nu)^idx =
                # sqrt(S (freqf/1400)^2idx)(1400/nu)^idx
                freqf = float(entry.get("freqf", 1400.0))
                k = min(len(entry["psd"]), target.shape[1])
                target[i, :k] = (_host(entry["psd"])[:k]
                                 * (freqf / 1400.0) ** (2.0 * idx))

        t_common = (toas_pad - tmin) / tspan_common * mask
        n_bands = max(1, max((len(b) for b in sys_bands), default=0))
        sys_psd = np.zeros((npsr, n_bands, n_sys))
        sys_mask = np.zeros((npsr, n_bands, T), dtype=bool)
        for i, bands in enumerate(sys_bands):
            for b, (bmask, bpsd) in enumerate(bands):
                sys_mask[i, b] = bmask
                sys_psd[i, b] = bpsd

        leaves = dict(
            t_own=t_own, t_common=t_common, mask=mask, freqs=freqs,
            sigma2=sigma2, pos=pos, red_psd=targets["red_noise"],
            dm_psd=targets["dm_gp"], chrom_psd=targets["chrom_gp"],
            epoch_idx=epoch_idx, ecorr_amp=ecorr_amp, sys_psd=sys_psd,
            sys_mask=sys_mask, df_own=df_own,
            tspan_common=np.asarray(tspan_common))
        return cls.from_numpy(leaves, device=device, dtype=dtype)

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


def padded_abs_toas(psrs: Sequence) -> np.ndarray:
    """(npsr, max_toa) float64 absolute TOAs [s], zero-padded: the host
    epochs the deterministic signals (CGW, BayesEphem) need beside
    :meth:`PulsarBatch.from_pulsars`' normalized times."""
    toas_pad, _ = stack_ragged(
        [np.asarray(p.toas, dtype=np.float64) for p in psrs])
    return toas_pad


def padded_toaerr2(psrs: Sequence) -> np.ndarray:
    """(npsr, max_toa) raw squared TOA errors [s^2], zero-padded: what a
    drawn efac multiplies in per-realization white sampling (the batch's
    ``sigma2`` bakes the noisedict's efac/equad in)."""
    err2, _ = stack_ragged(
        [np.asarray(p.toaerrs, dtype=np.float64) ** 2 for p in psrs])
    return err2


def padded_backend_ids(psrs: Sequence):
    """((npsr, max_toa) int32 backend index, n_backends): each pulsar's
    backend flags indexed into its own sorted unique set (padding TOAs get
    id 0); ``n_backends`` is the largest set in the array."""
    ids = []
    n_backends = 1
    for p in psrs:
        uniq, idx = np.unique(np.asarray(p.backend_flags),
                              return_inverse=True)
        n_backends = max(n_backends, len(uniq))
        ids.append(idx.astype(np.int32))
    bid, _ = stack_ragged(ids)
    return bid.astype(np.int32), n_backends


def padded_pdist(psrs: Sequence) -> np.ndarray:
    """(npsr, 2) pulsar-distance (mean, sigma) pairs in kpc; a scalar
    ``pdist`` (copy_array replays store one number) gets sigma 0."""
    out = np.zeros((len(psrs), 2))
    for i, p in enumerate(psrs):
        pd = getattr(p, "pdist", (1.0, 0.2))
        if np.ndim(pd) == 0:
            out[i] = (float(pd), 0.0)
        else:
            out[i] = (float(pd[0]), float(pd[1]))
    return out


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
