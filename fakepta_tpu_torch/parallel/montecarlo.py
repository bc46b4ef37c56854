"""Monte-Carlo ensemble engine over a (real, psr) device mesh (port of fakepta_tpu.parallel.montecarlo).

Simulates thousands of independent PTA realizations (white + ECORR + red +
DM + chromatic + system noise + correlated GWB) and reduces each to the
angular-binned cross-correlation curve and the mean auto-correlation.

Streams: per-realization keys are ``fold_in(key(seed), index)`` on the
threefry key tree of :mod:`fakepta_tpu_torch.utils.rng`, with the JAX
package's domain tags (0x51 noise, 0x6B GWB, 0x9C noise-hyperparameter
sampling, 0xE1 white sampling) and global pulsar-index folds, so every
draw equals the JAX engine's to a few float32 ULP, a rerun is
bit-identical and a realization's draws depend neither on the chunk size
nor on the mesh shape.

Per-realization hyperparameter sampling: :class:`NoiseSampling` draws a
registered spectrum's hyperparameters per realization (per pulsar for
red / DM / chromatic, per pulsar and backend band for system noise, once
for the GWB) and :class:`WhiteSampling` draws (efac, log10_tnequad,
log10_ecorr) per pulsar and backend; the sampled weights and variances
replace the batch's fixed ones, and every statistic path reads them the
same way.

Mesh (:mod:`.mesh`): one process drives every shard. The ``'real'`` axis
splits each chunk's realizations into contiguous blocks; the ``'psr'`` axis
gives each shard its rows of every per-pulsar field, built once at
construction. A psr shard draws its own pulsars' noise, draws the full GWB
z and keeps its own columns of the coupled coefficients, correlates its
rows against the all-gathered array with its rows of the statistic
weights, and the shards' partial statistics are psum'ed in shard order. On
a one-shard mesh every step is the shared single-device code.

Statistic paths (``stat_path``):

- ``"einsum"``: residuals, then torch einsums for the correlation and the
  binning (the JAX package's XLA path; the engine-level plain reference);
- ``"fused"`` (default): residuals through the hand-written
  binned-correlation kernel (:mod:`..ops.binned_corr`); with
  ``pallas_mxu_binning=False`` through its per-slot-reduction variant;
- ``"mega"``: residual base + GP coefficients through the whole-chunk
  kernel (:mod:`..ops.megakernel`), which rebuilds the Fourier bases on
  chip.

Not ported yet: multi-host meshes, TOA sharding, the run pipeline,
checkpoints, the observability report, the OS / lnlike / serve-lane
outputs and the deterministic and sampled signals (CGW, Roemer): the
``cgw``, ``roemer``, ``roemer_sample``, ``ephem``, ``cgw_sample`` and
``toas_abs`` arguments are accepted by name and raise
``NotImplementedError`` when given. The ``"det"`` stage name is accepted
and adds nothing (there are no deterministic sources to add).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import spectrum as spectrum_lib
from ..batch import PulsarBatch, fourier_basis_norm
from ..device import DeviceLike
from ..ops import binned_corr as binned_corr_ops
from ..ops import gwb as gwb_ops
from ..ops import megakernel as mega_ops
from ..utils import rng
from .mesh import (PSR_AXIS, REAL_AXIS, TOA_AXIS, Mesh, all_gather,
                   make_mesh, psum)

#: realizations per chunk (fakepta_tpu/tune/defaults.py DEFAULT_CHUNK)
DEFAULT_CHUNK = 1024

STAT_PATHS = ("einsum", "fused", "mega")
STAGES = ("white", "ecorr", "red", "dm", "chrom", "sys", "gwb", "det")

# key-domain tags, unchanged from the JAX engine: 0x51 noise, 0x6B GWB,
# 0x9C hyperparameter sampling (one subtag per target), 0xE1 white
# sampling; 0xD7 (the OS null stream) is reserved for the lane a later
# slice ports
_NOISE_TAG = 0x51
_GWB_TAG = 0x6B
_HYPER_TAG = 0x9C
_HYPER_SUBTAG = {"red": 0, "dm": 1, "chrom": 2, "gwb": 3, "sys": 4}
_WHITE_TAG = 0xE1
_NULL_TAG = 0xD7

# spectrum hyperparameters that are per-frequency-bin vectors; NoiseSampling
# draws one independent value per bin for these
_PER_BIN_PARAMS = ("log10_rho", "alphas", "alphas_adapt")


@dataclasses.dataclass(frozen=True)
class GWBConfig:
    """Common correlated signal: PSD on the grid n/Tspan_array, ORF name,
    chromatic index ``idx`` at reference frequency ``freqf``. Pass a
    sequence to inject several signals; config 0 keeps the single-signal
    key stream."""

    psd: np.ndarray
    orf: str = "hd"
    h_map: Optional[np.ndarray] = None
    idx: float = 0.0
    freqf: float = 1400.0


@dataclasses.dataclass(frozen=True)
class NoiseSampling:
    """Per-realization spectrum hyperparameter sampling for a GP stage.

    - ``target='red' | 'dm' | 'chrom'``: each pulsar draws its own
      hyperparameters per realization; the sampled PSD replaces the batch's
      ``<target>_psd`` for that stage.
    - ``target='sys'``: each (pulsar, backend band) draws its own; the
      sampled PSD replaces ``sys_psd``, the band membership (``sys_mask``)
      stays the batch's.
    - ``target='gwb'``: one draw per realization; replaces the first
      ``GWBConfig``'s ``psd`` (its ORF and chromatic index stay).

    ``spectrum`` names any registered PSD model; ``params`` maps
    hyperparameter names to ``(a, b)`` ranges (``log10_A`` / ``gamma`` are
    shorthands merged into it). Per-frequency parameters (``log10_rho``,
    ``alphas``, ``alphas_adapt``) draw one value per bin. ``dist='uniform'``
    draws U(a, b), ``'normal'`` N(mean=a, std=b); a mapping gives one per
    parameter (unlisted ones uniform). Zero-width ranges pin a parameter.

    Keys fold the realization key with the 0x9C tag, the target's subtag
    and, for per-pulsar targets, the global pulsar index (then the band for
    ``'sys'``), so the draws are the JAX engine's on any mesh, and the
    coefficient, white and GWB streams do not move.
    """

    target: str
    log10_A: Optional[Tuple[float, float]] = None
    gamma: Optional[Tuple[float, float]] = None
    dist: Union[str, dict] = "uniform"
    spectrum: str = "powerlaw"
    params: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class WhiteSampling:
    """Per-realization white-noise / ECORR hyperparameter sampling.

    Each realization draws an ``(efac, log10_tnequad, log10_ecorr)`` triple
    per (pulsar, backend) and rebuilds ``sigma^2 = efac^2 toaerr^2 +
    10^(2 log10_tnequad)`` from the raw squared TOA errors
    (``EnsembleSimulator(toaerr2=..., backend_id=...)``). Ranges follow
    :class:`NoiseSampling`'s convention; ``None`` pins a parameter at its
    neutral value (efac 1, no EQUAD, the batch's fixed ``ecorr_amp``).
    ``sigma2`` is replaced only when efac or EQUAD is drawn; a drawn ECORR
    replaces ``ecorr_amp`` only where the batch has ECORR active. Keys fold
    the realization key with the 0xE1 tag and the global pulsar index.
    """

    efac: Optional[Tuple[float, float]] = (0.5, 2.5)
    log10_tnequad: Optional[Tuple[float, float]] = (-8.0, -5.0)
    log10_ecorr: Optional[Tuple[float, float]] = None
    dist: str = "uniform"


@dataclasses.dataclass(frozen=True)
class CGWSampling:
    """The JAX package's per-realization CGW source prior (its fields, for
    :meth:`..scenarios.registry.Scenario.sim_kwargs`). The engine does not
    run it yet: passing one raises ``NotImplementedError``."""

    costheta: Tuple[float, float] = (-1.0, 1.0)
    phi: Tuple[float, float] = (0.0, 2.0 * np.pi)
    cosinc: Tuple[float, float] = (-1.0, 1.0)
    log10_mc: Tuple[float, float] = (8.5, 9.5)
    log10_fgw: Tuple[float, float] = (-8.5, -7.5)
    log10_h: Optional[Tuple[float, float]] = (-14.5, -13.5)
    phase0: Tuple[float, float] = (0.0, 2.0 * np.pi)
    psi: Tuple[float, float] = (0.0, np.pi)
    psrterm: bool = False
    tref: float = 0.0
    log10_dist: Optional[Tuple[float, float]] = None
    sample_pdist: bool = False
    dist: Union[str, dict] = "uniform"


@dataclasses.dataclass(frozen=True)
class RoemerSampling:
    """The JAX package's per-realization BayesEphem prior (its fields). The
    engine does not run it yet: passing one raises
    ``NotImplementedError``."""

    planet: str
    s_mass: float = 0.0
    s_Om: float = 0.0
    s_omega: float = 0.0
    s_inc: float = 0.0
    s_a: float = 0.0
    s_e: float = 0.0
    s_l0: float = 0.0


def _resolve_dists(dist, names):
    """Normalize a NoiseSampling str-or-mapping ``dist`` to one value per
    name."""
    if isinstance(dist, str):
        dmap = {n: dist for n in names}
    else:
        bad = [k for k in dist if k not in names]
        if bad:
            raise ValueError(f"NoiseSampling dist mapping names {bad} are "
                             f"not sampled parameters {list(names)}")
        dmap = {n: dist.get(n, "uniform") for n in names}
    for d in dmap.values():
        if d not in ("uniform", "normal"):
            raise ValueError(f"NoiseSampling dist must be 'uniform' or "
                             f"'normal', got {d!r}")
    return tuple(dmap[n] for n in names)


def _resolve_noise_sampling(cfg: NoiseSampling):
    """Validate one NoiseSampling config against the spectrum registry.

    Returns ``(static, ranges)``: ``(target, spectrum, names, per_bin
    flags, dist per param)`` and the ``(n_params, 2)`` range rows in draw
    order.
    """
    if cfg.spectrum not in spectrum_lib.SPECTRA:
        raise ValueError(f"NoiseSampling spectrum {cfg.spectrum!r} is not "
                         f"registered; known: {sorted(spectrum_lib.SPECTRA)}")
    reg = spectrum_lib.SPECTRA[cfg.spectrum]
    ranges = {}
    if cfg.log10_A is not None:
        ranges["log10_A"] = tuple(cfg.log10_A)
    if cfg.gamma is not None:
        ranges["gamma"] = tuple(cfg.gamma)
    if cfg.params:
        ranges.update({k: tuple(v) for k, v in cfg.params.items()})
    if not ranges:
        raise ValueError(f"NoiseSampling({cfg.target!r}) has no parameters "
                         f"to sample: give log10_A/gamma or params ranges")
    unknown = [k for k in ranges if k not in reg.params]
    if unknown:
        raise ValueError(f"params {unknown} are not hyperparameters of "
                         f"{cfg.spectrum!r} (has {list(reg.params)})")
    if "nfreq" in ranges:
        # a bin INDEX selecting where alphas_adapt applies, not a
        # continuous hyperparameter
        raise ValueError("'nfreq' (a bin index) cannot be sampled; register "
                         "a partial spectrum with nfreq bound instead")
    names = tuple(ranges)
    per_bin = tuple(n in _PER_BIN_PARAMS for n in names)
    static = (cfg.target, cfg.spectrum, names, per_bin,
              _resolve_dists(cfg.dist, names))
    return static, [list(ranges[n]) for n in names]


@dataclasses.dataclass(frozen=True)
class _Hyper:
    """Per-realization hyperparameter sampling state on one shard's device:
    the resolved NoiseSampling descriptors with their (n, 2) range rows,
    and the WhiteSampling flags, (3, 2) ranges and this shard's rows of the
    raw squared TOA errors and backend ids."""

    noise: Tuple[Tuple[tuple, torch.Tensor], ...] = ()
    white: Optional[tuple] = None            # (efac, equad, ecorr, dist)
    white_params: Optional[torch.Tensor] = None     # (3, 2)
    toaerr2: Optional[torch.Tensor] = None          # (P, T)
    backend_id: Optional[torch.Tensor] = None       # (P, T) int64
    white_nb: int = 1

    def rows(self, lo: int, n: int, dev: torch.device) -> "_Hyper":
        """A psr shard's rows on ``dev``."""
        def take(x):
            return None if x is None else \
                x.narrow(0, lo, n).contiguous().to(dev)
        return dataclasses.replace(
            self, noise=tuple((st, r.to(dev)) for st, r in self.noise),
            white_params=(None if self.white_params is None
                          else self.white_params.to(dev)),
            toaerr2=take(self.toaerr2), backend_id=take(self.backend_id))


def _affine(a, z, scale):
    """``a + z * scale`` in float32 with the product and sum fused (one
    rounding), as XLA contracts the JAX engine's ``a + z * (b - a)``."""
    return (z.double() * scale.double() + a.double()).float()


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """``10 ** x`` at float64, rounded once to ``x``'s dtype: the same bits
    at every tensor shape (torch's CPU ``pow`` rounds its vector lanes and
    its scalar tail differently, which would tie a realization's value to
    the chunk size)."""
    return torch.pow(10.0, x.double()).to(x.dtype)


def _draw_hyper(k: torch.Tensor, names, per_bin, dists, ranges,
                nbin: int) -> dict:
    """name -> sampled value for a batch of keys ``k`` (..., 2): scalars
    (...,), per-bin parameters (..., nbin). The scalar uniforms ride one
    vector in declaration order, the scalar normals one vector under
    ``fold_in(k, 1)``, each per-bin parameter its own ``fold_in(k, 16 +
    i)`` key: the JAX engine's layout."""
    n_scalar = sum(1 for pb in per_bin if not pb)
    any_norm = any(d == "normal" for pb, d in zip(per_bin, dists) if not pb)
    u = rng.uniform(k, n_scalar) if n_scalar else None
    g = rng.normal(rng.fold_in(k, 1), n_scalar) if any_norm else None
    out, zi = {}, 0
    for i, (name, pb, d) in enumerate(zip(names, per_bin, dists)):
        a, b = ranges[i, 0], ranges[i, 1]
        if pb:
            kb = rng.fold_in(k, 16 + i)
            z = rng.uniform(kb, nbin) if d == "uniform" \
                else rng.normal(kb, nbin)
        else:
            z = (u if d == "uniform" else g)[..., zi]
            zi += 1
        out[name] = _affine(a, z, (b - a) if d == "uniform" else b)
    return out


def _sampled_weights(keys: torch.Tensor, batch: PulsarBatch, hyper: _Hyper,
                     gidx: torch.Tensor, n_gwb: int) -> dict:
    """target -> per-realization spectrum weights ``sqrt(psd * df)``:
    (R, P, N) per pulsar, (R, P, B, N) per band, (R, N) for the GWB."""
    out = {}
    root = rng.fold_in(keys, _HYPER_TAG)                            # (R, 2)
    dev, dtype = keys.device, batch.dtype
    for (target, spectrum, names, per_bin, dists), ranges in hyper.noise:
        kt = rng.fold_in(root, _HYPER_SUBTAG[target])
        if target == "gwb":
            nbin, df, k = n_gwb, 1.0 / batch.tspan_common, kt
        elif target == "sys":
            # the GLOBAL pulsar index, then the band index
            nbin = batch.sys_psd.shape[2]
            df = batch.df_own[:, None, None]
            bands = torch.arange(batch.sys_psd.shape[1], device=dev)
            k = rng.fold_in(rng.fold_in(kt[:, None, :], gidx)[:, :, None, :],
                            bands)                               # (R, P, B)
        else:
            nbin = getattr(batch, f"{target}_psd").shape[1]
            df = batch.df_own[:, None]
            k = rng.fold_in(kt[:, None, :], gidx)                # (R, P)
        vals = _draw_hyper(k, names, per_bin, dists, ranges, nbin)
        kwargs = {n: (vals[n] if pb else vals[n][..., None])
                  for n, pb in zip(names, per_bin)}
        if spectrum == "free_spectrum":
            # psd * df = 10^(2 rho) by definition: the weights are 10^rho
            out[target] = _pow10(kwargs["log10_rho"])
        else:
            f = torch.arange(1, nbin + 1, dtype=dtype, device=dev) * df
            psd = spectrum_lib.evaluate(spectrum, f, **kwargs)
            out[target] = torch.sqrt(psd * df)
    return out


def _sampled_white(keys: torch.Tensor, batch: PulsarBatch, hyper: _Hyper,
                   gidx: torch.Tensor, inc_white: bool):
    """(sigma2, ecorr_amp) with the WhiteSampling draws: (R, P, T) where
    drawn, else the batch's (P, T) leaves."""
    s_efac, s_equad, s_ecorr, dist = hyper.white
    kp = rng.fold_in(rng.fold_in(keys, _WHITE_TAG)[:, None, :], gidx)
    shape = (hyper.white_nb, 3)
    zw = rng.uniform(kp, shape) if dist == "uniform" \
        else rng.normal(kp, shape)                             # (R, P, B, 3)
    prm = hyper.white_params
    scale = prm[:, 1] - prm[:, 0] if dist == "uniform" else prm[:, 1]
    vals = _affine(prm[:, 0], zw, scale)
    bid = hyper.backend_id.expand(keys.shape[0], *hyper.backend_id.shape)

    def gather(x):
        """A per-(pulsar, backend) value (R, P, B) at each TOA (R, P, T);
        the powers of ten are taken before the gather, on B values, not T"""
        return torch.gather(x, 2, bid)

    sigma2, ecorr = batch.sigma2, batch.ecorr_amp
    if inc_white and (s_efac or s_equad):
        # the raw toaerr^2 replaces sigma2 only when efac/equad is drawn:
        # ecorr-only sampling keeps the batch's fixed white variance
        sigma2 = hyper.toaerr2
        if s_efac:
            efac = gather(vals[..., 0])
            sigma2 = efac * efac * sigma2
        if s_equad:
            sigma2 = sigma2 + gather(_pow10(2.0 * vals[..., 1]))
    if s_ecorr:
        # padding TOAs and single-TOA epochs stay excluded
        ecorr = torch.where(batch.ecorr_amp > 0.0,
                            gather(_pow10(vals[..., 2])), 0.0)
    return sigma2, ecorr


def _as_config_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _chunk_keys(base_key: torch.Tensor, offset: int,
                nreal: int) -> torch.Tensor:
    """(nreal, 2) keys ``fold_in(base_key, offset + i)``: the absolute-index
    stream, identical at any chunk size."""
    idx = torch.arange(offset, offset + nreal, dtype=torch.int64,
                       device=base_key.device)
    return rng.fold_in(base_key, idx)


def pack_stats(curves, autos, *extras):
    """(n, nbins+1+...) packed statistic lanes: curves, the auto, extras."""
    return torch.cat([curves, autos[:, None], *extras], dim=1)


def unpack_stats(packed, nbins: int):
    """Inverse of :func:`pack_stats`: (curves (n, nbins), autos (n,))."""
    return packed[:, :nbins], packed[:, nbins]


@dataclasses.dataclass(frozen=True)
class _StageTerms:
    """Per-stage weights and bases that do not depend on the realization
    (the JAX package recomputes them inside each jitted chunk program)."""

    red_w: torch.Tensor                   # (P, NR)
    dm_w: torch.Tensor                    # (P, ND)
    chrom_w: Optional[torch.Tensor]       # (P, NC)
    sys_w: Optional[torch.Tensor]         # (P, B, NS)
    sys_basis: Optional[torch.Tensor]     # (P, T, 2, NS)
    gp_basis: Optional[torch.Tensor]      # (P, T, K) concatenated GP basis
    gwb_group: Tuple[int, ...]            # config -> basis group
    n_groups: int


def _stage_terms(batch: PulsarBatch, gwb_ws, gwb_idxs, gwb_freqfs,
                 include) -> _StageTerms:
    """Weights and bases of ``_simulate_block``, in the JAX stage order:
    red, dm, chrom, then one basis group per distinct GWB
    ``(idx, freqf, ncomp)`` signature (configs sharing a group sum their
    coefficients: the projection is linear)."""
    (_, _, inc_red, inc_dm, inc_chrom, inc_sys, inc_gwb) = include
    p, t = batch.t_own.shape
    df = batch.df_own
    red_w = torch.sqrt(batch.red_psd * df[:, None])
    dm_w = torch.sqrt(batch.dm_psd * df[:, None])
    chrom_w = sys_w = sys_basis = None
    bases = []
    if inc_red:
        bases.append(fourier_basis_norm(batch.t_own, batch.red_psd.shape[1]))
    if inc_dm:
        bases.append(fourier_basis_norm(batch.t_own, batch.dm_psd.shape[1],
                                        scale=(1400.0 / batch.freqs) ** 2))
    if inc_chrom:
        chrom_w = torch.sqrt(batch.chrom_psd * df[:, None])
        bases.append(fourier_basis_norm(batch.t_own,
                                        batch.chrom_psd.shape[1],
                                        scale=(1400.0 / batch.freqs) ** 4))
    if inc_sys:
        sys_w = torch.sqrt(batch.sys_psd * df[:, None, None])
        sys_basis = fourier_basis_norm(batch.t_own, batch.sys_psd.shape[2])
    group, seen = [], {}
    if inc_gwb:
        for idx_j, freqf_j, w_j in zip(gwb_idxs, gwb_freqfs, gwb_ws):
            sig = (idx_j, freqf_j, int(w_j.shape[0]))
            if sig not in seen:
                seen[sig] = len(seen)
                scale = (freqf_j / batch.freqs) ** idx_j if idx_j else None
                bases.append(fourier_basis_norm(batch.t_common, sig[2],
                                                scale=scale))
            group.append(seen[sig])
    gp_basis = (torch.cat([b.reshape(p, t, -1) for b in bases], dim=-1)
                if bases else None)
    return _StageTerms(red_w, dm_w, chrom_w, sys_w, sys_basis, gp_basis,
                       tuple(group), len(seen))


def _simulate_block(keys: torch.Tensor, batch: PulsarBatch, chols, gwb_ws,
                    include, terms: _StageTerms, split_gp: bool = False,
                    p_offset: int = 0, hyper: Optional[_Hyper] = None):
    """Residual blocks for a chunk of realizations.

    keys: (R, 2) per-realization keys. ``batch`` holds this psr shard's
    pulsars, global indices ``p_offset .. p_offset + P - 1``; ``chols`` are
    the full (npsr, npsr) ORF Cholesky factors. ``include`` is the 7-flag
    tuple (white, ecorr, red, dm, chrom, sys, gwb). Returns (R, P, T)
    TOA-masked residuals, or with ``split_gp=True`` (the megakernel
    contract) the masked base without the GP projection and the (R, P, K)
    coefficients in stage order. ``hyper`` carries this shard's
    hyperparameter sampling (None: the batch's fixed spectra and white
    levels). Draw keys, shapes and order are the JAX engine's, so the two
    streams agree draw for draw on any mesh.
    """
    (inc_white, inc_ecorr, inc_red, inc_dm, inc_chrom, inc_sys,
     inc_gwb) = include
    R = keys.shape[0]
    p, T = batch.t_own.shape
    dev = keys.device

    # noise keys fold the 0x51 tag, then the GLOBAL pulsar index, then
    # split six ways: (white, red, dm, chrom, ecorr, sys)
    noise_root = rng.fold_in(keys, _NOISE_TAG)                      # (R, 2)
    gidx = torch.arange(p_offset, p_offset + p, dtype=torch.int64,
                        device=dev)
    psr_keys = rng.split(rng.fold_in(noise_root[:, None, :], gidx), 6)
    kw, kr, kd, kc, ke, ks = psr_keys.unbind(2)                     # (R,P,2)

    # sampled spectrum weights (R, P, N), (R, P, B, N) or (R, N) replace
    # the fixed ones of their stage; sampled white levels replace sigma2
    # and ecorr_amp. Their keys live in their own domains (0x9C, 0xE1), so
    # the streams below are the same with or without sampling
    hyper = _Hyper() if hyper is None else hyper
    w_samp = (_sampled_weights(keys, batch, hyper, gidx, gwb_ws[0].shape[0])
              if hyper.noise else {})
    sigma2, ecorr_amp = batch.sigma2, batch.ecorr_amp
    if hyper.white is not None and (inc_white or inc_ecorr):
        sigma2, ecorr_amp = _sampled_white(keys, batch, hyper, gidx,
                                           inc_white)

    res = torch.zeros((R, p, T), dtype=batch.dtype, device=dev)
    if inc_white:
        res = res + torch.sqrt(sigma2) * rng.normal(kw, T)
    if inc_ecorr:
        # sigma^2 I + c^2 11^T per epoch == white plus ONE shared normal per
        # epoch, indexed by the per-TOA epoch id
        epoch_draws = rng.normal(ke, T)
        shared = torch.gather(epoch_draws, 2,
                              batch.epoch_idx.expand(R, p, T))
        res = res + ecorr_amp * shared
    coeffs = []
    for inc, name, k in ((inc_red, "red", kr), (inc_dm, "dm", kd),
                         (inc_chrom, "chrom", kc)):
        if inc:
            w = w_samp.get(name, getattr(terms, f"{name}_w"))
            c = rng.normal(k, (2, w.shape[-1])) * w.unsqueeze(-2)
            coeffs.append(c.reshape(R, p, -1))
    if inc_sys:
        # per-(pulsar, band) GP on the shared basis, masked to the band
        n_bands, n_sys = terms.sys_w.shape[1:]
        c = rng.normal(ks, (n_bands, 2, n_sys)) \
            * w_samp.get("sys", terms.sys_w).unsqueeze(-2)    # (R,P,B,2,NS)
        for b in range(n_bands):
            contrib = torch.einsum("ptkn,rpkn->rpt", terms.sys_basis,
                                   c[:, :, b])
            res = res + torch.where(batch.sys_mask[:, b], contrib, 0.0)
    if inc_gwb:
        # one z per realization (not folded with the pulsar index): the
        # (npsr x npsr) ORF coupling couples every pulsar's coefficients,
        # so each psr shard draws the full z, couples it and keeps its own
        # columns
        tag = rng.fold_in(keys, _GWB_TAG)
        gwb_c = [None] * terms.n_groups
        for j, (chol_j, w_j) in enumerate(zip(chols, gwb_ws)):
            kg = tag if j == 0 else rng.fold_in(tag, j)
            zg = rng.normal(kg, (2, w_j.shape[0], chol_j.shape[0]))
            corr = torch.matmul(zg, chol_j.T)                    # (R,2,C,P)
            if corr.shape[-1] != p:
                corr = corr[..., p_offset:p_offset + p]
            w_eff = w_samp.get("gwb", w_j) if j == 0 else w_j
            c = corr * (w_eff[:, None, :, None] if w_eff.dim() == 2
                        else w_eff[None, None, :, None])
            c = c.permute(0, 3, 1, 2).reshape(R, p, -1)          # (R,P,2C)
            g = terms.gwb_group[j]
            gwb_c[g] = c if gwb_c[g] is None else gwb_c[g] + c
        coeffs.extend(gwb_c)
    if split_gp:
        c_all = (torch.cat(coeffs, dim=-1).contiguous() if coeffs
                 else torch.zeros((R, p, 0), dtype=batch.dtype, device=dev))
        return torch.where(batch.mask, res, 0.0), c_all
    if coeffs:
        c_all = torch.cat(coeffs, dim=-1)
        res = res + torch.einsum("ptk,rpk->rpt", terms.gp_basis, c_all)
    return torch.where(batch.mask, res, 0.0)


def _correlation_rows(res_local: torch.Tensor,
                      res_full: Optional[torch.Tensor] = None,
                      stats_bf16: bool = False):
    """(R, PL, PF) raw pair-product sums of local rows against the full
    array (``res_full=None``: the rows against themselves), f32
    accumulation; ``stats_bf16`` rounds the operands to bf16 first (the
    einsum path's bf16 mode)."""
    if stats_bf16:
        res_local = binned_corr_ops.round_bf16(res_local)
        if res_full is not None:
            res_full = binned_corr_ops.round_bf16(res_full)
    return torch.einsum("rpt,rqt->rpq", res_local,
                        res_local if res_full is None else res_full)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One psr shard's static state on its device: its rows of the batch,
    of the statistic weights and of the megakernel tables, plus what every
    shard holds whole (the ORF factors, the GWB weights and the gathered
    megakernel tables, which are static and so gathered once here)."""

    p_offset: int                       # global index of the first row
    batch: PulsarBatch                  # (PL, ...) rows
    chols: Tuple[torch.Tensor, ...]     # (npsr, npsr) each
    gwb_ws: Tuple[torch.Tensor, ...]
    terms: _StageTerms
    weights: torch.Tensor               # (nbins+1, PL, npsr)
    times: torch.Tensor                 # (2, PL, T)
    scales: torch.Tensor                # (S, PL, T)
    times_full: torch.Tensor            # (2, npsr, T)
    scales_full: torch.Tensor           # (S, npsr, T)
    hyper: _Hyper                       # sampling state, this shard's rows

    @property
    def device(self) -> torch.device:
        return self.batch.device


def _cat(parts, dim: int = 0):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class EnsembleSimulator:
    """Monte-Carlo engine over a (real, psr) device mesh.

    ``mesh`` (:func:`.mesh.make_mesh`) defaults to a 1x1x1 mesh on
    ``device``, which defaults to ``"cuda"`` and raises without a GPU
    unless ``device="cpu"``; pass one of the two. ``stat_path``:
    ``"einsum"``, ``"fused"`` (default) or ``"mega"`` (see the module
    docstring). ``pallas_precision`` is the fused path's default statistic
    precision (``'bf16'``: bf16 operands, f32 accumulation; ``'f32'``: full
    f32); the mega and einsum paths default to ``'f32'``, and
    ``run(precision=...)`` overrides per run. ``pallas_mxu_binning=False``
    sends the fused path through the per-slot-reduction kernel.

    ``noise_sample`` (:class:`NoiseSampling`, one or a sequence) and
    ``white_sample`` (:class:`WhiteSampling`, with the raw squared TOA
    errors ``toaerr2`` and the per-TOA ``backend_id``, both (P, T)) turn
    on per-realization hyperparameter sampling, validated as the JAX
    engine validates it.
    """

    def __init__(self, batch: PulsarBatch,
                 gwb: Optional[Union[GWBConfig, Sequence[GWBConfig]]] = None,
                 mesh: Optional[Mesh] = None,
                 include: Sequence[str] = ("white", "ecorr", "red", "dm",
                                           "chrom", "sys", "gwb"),
                 nbins: int = 15, stat_path: Optional[str] = None,
                 pallas_precision: str = "bf16",
                 pallas_mxu_binning: bool = True,
                 noise_sample: Optional[Union[NoiseSampling,
                                              Sequence[NoiseSampling]]] = None,
                 white_sample: Optional[WhiteSampling] = None,
                 toaerr2=None, backend_id=None,
                 cgw=None, roemer=None, roemer_sample=None, ephem=None,
                 cgw_sample=None, toas_abs=None,
                 device: DeviceLike = None):
        # the JAX engine's arguments whose signals are not ported yet
        unported = {"cgw": cgw, "roemer": roemer,
                    "roemer_sample": roemer_sample, "ephem": ephem,
                    "cgw_sample": cgw_sample, "toas_abs": toas_abs}
        for name, value in unported.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet: the deterministic and "
                    f"sampled CGW / Roemer signals (CGWSampling, "
                    f"RoemerSampling) are ROADMAP Queue 1 item 4")
        if mesh is None:
            mesh = make_mesh(["cuda" if device is None else device])
        elif device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.mesh = mesh
        n_real, n_psr, n_toa = (mesh.shape[a] for a in
                                (REAL_AXIS, PSR_AXIS, TOA_AXIS))
        if batch.npsr % n_psr != 0:
            raise ValueError(
                f"npsr={batch.npsr} must be divisible by the psr mesh axis "
                f"({n_psr}); pad the batch")
        if batch.max_toa % n_toa != 0:
            raise ValueError(
                f"max_toa={batch.max_toa} must be divisible by the toa mesh "
                f"axis ({n_toa}); pad the batch")
        if n_toa > 1:
            raise NotImplementedError(
                "toa_shards > 1 is not ported yet (ROADMAP Queue 1 item 3)")
        self.device = mesh.devices.flat[0]
        if batch.dtype != torch.float32:
            raise TypeError(f"the port runs float32 batches, got "
                            f"{batch.dtype}")
        unknown = sorted(set(include) - set(STAGES))
        if unknown:
            raise ValueError(f"unknown stages {unknown}; known: {STAGES}")
        stat_path = "fused" if stat_path is None else stat_path
        if stat_path not in STAT_PATHS:
            raise ValueError(f"stat_path must be one of {STAT_PATHS}, got "
                             f"{stat_path!r}")
        if pallas_precision not in ("bf16", "f32"):
            raise ValueError(f"pallas_precision must be 'bf16' or 'f32', "
                             f"got {pallas_precision!r}")
        self.stat_path = stat_path
        self.pallas_precision = pallas_precision
        self.pallas_mxu_binning = bool(pallas_mxu_binning)
        self.batch = batch = batch.to(self.device)
        self.nbins = nbins
        dtype = batch.dtype
        host = batch.numpy()

        gwb_cfgs = _as_config_list(gwb)
        if gwb_cfgs and "gwb" in include:
            # 1/Tspan at the batch dtype, as the JAX engine forms it
            df_common = 1.0 / batch.tspan_common
            chols, ws = [], []
            for cfg in gwb_cfgs:
                orf = gwb_ops.build_orf(cfg.orf, host["pos"], cfg.h_map)
                chols.append(torch.as_tensor(gwb_ops.orf_cholesky(orf))
                             .to(dtype).to(self.device))
                psd = torch.tensor(np.asarray(cfg.psd, dtype=np.float64)).to(dtype)
                ws.append(torch.sqrt(psd.to(self.device) * df_common))
            self._chol = tuple(chols)
            self._gwb_w = tuple(ws)
            self._gwb_idx = tuple(cfg.idx for cfg in gwb_cfgs)
            self._gwb_freqf = tuple(cfg.freqf for cfg in gwb_cfgs)
        else:
            self._chol = (torch.eye(batch.npsr, dtype=dtype,
                                    device=self.device),)
            self._gwb_w = (torch.zeros((1,), dtype=dtype,
                                       device=self.device),)
            self._gwb_idx = (0.0,)
            self._gwb_freqf = (1400.0,)

        hyper = self._resolve_sampling(batch, host, include, gwb_cfgs,
                                       noise_sample, white_sample, toaerr2,
                                       backend_id)
        sampled = {st[0] for st, _ in hyper.noise}

        # optional stages enter only where their parameters are nonzero; a
        # sampled stage is always live (its PSD comes from the draws)
        has_chrom = bool(np.any(host["chrom_psd"] > 0.0)) \
            or "chrom" in sampled
        has_ecorr = bool(np.any(host["ecorr_amp"] > 0.0))
        has_sys = bool(np.any(host["sys_psd"] > 0.0)) or "sys" in sampled
        self._include = (("white" in include),
                         ("ecorr" in include and has_ecorr),
                         ("red" in include), ("dm" in include),
                         ("chrom" in include and has_chrom),
                         ("sys" in include and has_sys),
                         ("gwb" in include and bool(gwb_cfgs)))
        self._terms = _stage_terms(batch, self._gwb_w, self._gwb_idx,
                                   self._gwb_freqf, self._include)

        # angular bins and pair-count normalization: host float64 setup on
        # the FULL array (every shard's rows use the full pair and bin
        # counts), folded into static statistic weights
        pos = np.asarray(host["pos"], dtype=np.float64)
        ang = np.arccos(np.clip(pos @ pos.T, -1, 1))
        edges = np.linspace(0.0, np.pi, nbins + 1)
        bin_idx = np.clip(np.digitize(ang, edges) - 1, 0, nbins - 1)
        offdiag = ~np.eye(batch.npsr, dtype=bool)
        onehot = np.zeros((batch.npsr, batch.npsr, nbins))
        onehot[np.arange(batch.npsr)[:, None], np.arange(batch.npsr)[None, :],
               bin_idx] = 1.0
        onehot *= offdiag[:, :, None]
        self.bin_centers = edges[:-1] + 0.5 * (edges[1] - edges[0])
        mask_np = np.asarray(host["mask"], dtype=np.float64)
        raw_counts = mask_np @ mask_np.T
        self.pair_counts = raw_counts
        counts_full = np.maximum(raw_counts, 1.0)
        bc = np.maximum(onehot.sum((0, 1)), 1.0)
        w_bins = onehot / counts_full[:, :, None] / bc
        w_auto = np.eye(batch.npsr) / counts_full / batch.npsr
        self._counts = torch.as_tensor(counts_full).to(dtype) \
            .to(self.device)
        # one (nbins+1, P, P) stack for every path: slot n < nbins is
        # onehot/(pair counts * bin count), slot nbins the auto trace
        stack = np.concatenate([np.moveaxis(w_bins, 2, 0), w_auto[None]])
        self._stat_weights = torch.tensor(stack).to(dtype).to(
            self.device).contiguous()
        self._mega_tables = self._build_mega_tables()
        _, times, scales = self._mega_tables
        # the whole array as one shard: the single-device state
        self._full = _Shard(0, batch, self._chol, self._gwb_w, self._terms,
                            self._stat_weights, times, scales, times, scales,
                            hyper)
        self._shards = self._build_shards()

    @property
    def include(self) -> Tuple[bool, ...]:
        return self._include

    def _resolve_sampling(self, batch, host, include, gwb_cfgs,
                          noise_sample, white_sample, toaerr2,
                          backend_id) -> _Hyper:
        """Validate ``noise_sample`` / ``white_sample`` with the JAX
        engine's rules and messages; the whole array's sampling state."""
        dtype, dev = batch.dtype, self.device
        seen, noise = set(), []
        for cfg in _as_config_list(noise_sample):
            if cfg.target not in _HYPER_SUBTAG:
                raise ValueError(f"NoiseSampling target {cfg.target!r} not "
                                 f"in {sorted(_HYPER_SUBTAG)}")
            if cfg.target in seen:
                raise ValueError(f"duplicate NoiseSampling target "
                                 f"{cfg.target!r}")
            seen.add(cfg.target)
            if cfg.target not in include:
                raise ValueError(f"NoiseSampling target {cfg.target!r} needs "
                                 f"stage {cfg.target!r} in include")
            if cfg.target == "sys" and not bool(np.any(host["sys_mask"])):
                raise ValueError(
                    "NoiseSampling('sys') needs system-noise bands: build "
                    "the batch with system-noise bands (the band TOA "
                    "membership comes from sys_mask; only the PSD is "
                    "replaced by the draws)")
            if cfg.target == "gwb" and not gwb_cfgs:
                raise ValueError("NoiseSampling('gwb') needs a GWBConfig (its "
                                 "orf/idx and psd length set the program; the "
                                 "psd values are replaced by the draws)")
            static, rows = _resolve_noise_sampling(cfg)
            noise.append((static, torch.tensor(rows, dtype=torch.float64)
                          .to(dtype).to(dev)))
        if white_sample is None:
            return _Hyper(noise=tuple(noise))
        ws = white_sample
        if not isinstance(ws, WhiteSampling):
            raise TypeError(f"white_sample must be a WhiteSampling, got "
                            f"{type(ws).__name__}")
        if ws.dist not in ("uniform", "normal"):
            raise ValueError(f"WhiteSampling dist must be 'uniform' or "
                             f"'normal', got {ws.dist!r}")
        if (ws.efac is None and ws.log10_tnequad is None
                and ws.log10_ecorr is None):
            # all-None would swap sigma2 for raw toaerr^2 while sampling
            # nothing
            raise ValueError("WhiteSampling has no parameters to sample: "
                             "give an efac/log10_tnequad/log10_ecorr range")
        if "white" not in include:
            raise ValueError("WhiteSampling needs stage 'white' in include")
        if ws.log10_ecorr is not None and not (
                "ecorr" in include and bool(np.any(host["ecorr_amp"] > 0.0))):
            raise ValueError(
                "WhiteSampling.log10_ecorr needs a live ECORR stage: build "
                "the batch with ecorr=True (epochs + nonzero ecorr_amp) "
                "and keep 'ecorr' in include")
        if toaerr2 is None:
            # the batch's sigma2 is the raw toaerr^2 only when no efac or
            # EQUAD was baked into it, which the batch cannot tell; an
            # ecorr-only sampling never reads toaerr2
            if ws.efac is not None or ws.log10_tnequad is not None:
                warnings.warn(
                    "WhiteSampling with no explicit toaerr2: treating "
                    "batch.sigma2 as the raw toaerr^2 (exact for synthetic "
                    "batches; WRONG if the batch baked noisedict efac/equad "
                    "into sigma2 — pass the raw squared TOA errors as "
                    "toaerr2)", stacklevel=3)
            toaerr2 = host["sigma2"]
        toaerr2 = np.asarray(toaerr2, dtype=np.float64)
        shape = tuple(batch.t_own.shape)
        if toaerr2.shape != shape:
            raise ValueError(f"toaerr2 shape {toaerr2.shape} != batch "
                             f"{shape}")
        if backend_id is None:
            backend_id = np.zeros(shape, dtype=np.int32)
        backend_id = np.asarray(backend_id, dtype=np.int32)
        if backend_id.shape != shape:
            raise ValueError(f"backend_id shape {backend_id.shape} != "
                             f"batch {shape}")
        rows = [list(ws.efac or (1.0, 1.0)),
                list(ws.log10_tnequad or (-8.0, -8.0)),
                list(ws.log10_ecorr or (-8.0, -8.0))]
        return _Hyper(
            noise=tuple(noise),
            white=(ws.efac is not None, ws.log10_tnequad is not None,
                   ws.log10_ecorr is not None, ws.dist),
            white_params=torch.tensor(rows, dtype=torch.float64).to(dtype)
            .to(dev),
            toaerr2=torch.tensor(toaerr2).to(dtype).to(dev),
            backend_id=torch.tensor(backend_id.astype(np.int64)).to(dev),
            white_nb=int(backend_id.max()) + 1)

    def _build_shards(self):
        """(real, psr) grid of shard states; a (psr index, device) pair is
        built once however often the mesh repeats it."""
        n_psr = self.mesh.shape[PSR_AXIS]
        p_local = self.batch.npsr // n_psr
        made, grid = {}, []
        for r in range(self.mesh.shape[REAL_AXIS]):
            row = []
            for s in range(n_psr):
                dev = self.mesh.devices[r, s, 0]
                if (s, dev) not in made:
                    made[(s, dev)] = self._make_shard(s, p_local, dev)
                row.append(made[(s, dev)])
            grid.append(row)
        return grid

    def _make_shard(self, s: int, p_local: int,
                    dev: torch.device) -> _Shard:
        full = self._full
        if p_local == full.batch.npsr and dev == self.device:
            return full
        lo, hi = s * p_local, (s + 1) * p_local

        def rows(x, dim=0):
            return x.narrow(dim, lo, p_local).contiguous().to(dev)

        batch = PulsarBatch(**{
            f.name: (getattr(full.batch, f.name).to(dev)
                     if f.name == "tspan_common"
                     else rows(getattr(full.batch, f.name)))
            for f in dataclasses.fields(PulsarBatch)})
        chols = tuple(c.to(dev) for c in full.chols)
        ws = tuple(w.to(dev) for w in full.gwb_ws)
        terms = _stage_terms(batch, ws, self._gwb_idx, self._gwb_freqf,
                             self._include)
        return _Shard(lo, batch, chols, ws, terms, rows(full.weights, 1),
                      rows(full.times, 1), rows(full.scales, 1),
                      full.times.to(dev), full.scales.to(dev),
                      full.hyper.rows(lo, p_local, dev))

    def _build_mega_tables(self):
        """Stage descriptors + (2, P, T) time and (S, P, T) scale tables for
        the megakernel, in ``_simulate_block``'s GP stage order and GWB
        basis-group dedup; scale rows carry the TOA mask."""
        batch = self.batch
        rows, row_idx = [], {}

        def scale_row(key, build):
            if key not in row_idx:
                row_idx[key] = len(rows)
                rows.append(torch.where(batch.mask, build(), 0.0)
                            .to(batch.dtype))
            return row_idx[key]

        plain = scale_row(("plain",), lambda: torch.ones(
            (), dtype=batch.dtype, device=self.device))
        stages = []
        (_, _, inc_red, inc_dm, inc_chrom, _, inc_gwb) = self._include
        T_OWN, T_COMMON = mega_ops.T_OWN, mega_ops.T_COMMON
        if inc_red:
            stages.append(mega_ops.MegaStage(batch.red_psd.shape[1], T_OWN,
                                             plain))
        if inc_dm:
            stages.append(mega_ops.MegaStage(
                batch.dm_psd.shape[1], T_OWN,
                scale_row(("chrom", 2.0),
                          lambda: (1400.0 / batch.freqs) ** 2)))
        if inc_chrom:
            stages.append(mega_ops.MegaStage(
                batch.chrom_psd.shape[1], T_OWN,
                scale_row(("chrom", 4.0),
                          lambda: (1400.0 / batch.freqs) ** 4)))
        if inc_gwb:
            seen = set()
            for idx_j, freqf_j, w_j in zip(self._gwb_idx, self._gwb_freqf,
                                           self._gwb_w):
                sig = (idx_j, freqf_j, int(w_j.shape[0]))
                if sig in seen:
                    continue
                seen.add(sig)
                scol = plain if not idx_j else scale_row(
                    ("gwb", idx_j, freqf_j),
                    lambda f=freqf_j, i=idx_j: (f / batch.freqs) ** i)
                stages.append(mega_ops.MegaStage(sig[2], T_COMMON, scol))
        times = torch.stack([batch.t_own, batch.t_common]).contiguous()
        return tuple(stages), times, torch.stack(rows).contiguous()

    def _resolve_precision(self, path: str, precision) -> str:
        if precision is None:
            return self.pallas_precision if path == "fused" else "f32"
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got "
                             f"{precision!r}")
        return precision

    def _residuals(self, keys, split_gp=False, shard: Optional[_Shard] = None):
        """One shard's residual rows (default: the whole array on the
        mesh's first device)."""
        sh = self._full if shard is None else shard
        return _simulate_block(keys, sh.batch, sh.chols, sh.gwb_ws,
                               self._include, sh.terms, split_gp=split_gp,
                               p_offset=sh.p_offset, hyper=sh.hyper)

    def _fused_kernel(self):
        return (binned_corr_ops.binned_correlation if self.pallas_mxu_binning
                else binned_corr_ops.binned_correlation_vpu)

    def step(self, base_key: torch.Tensor, offset: int, nreal: int,
             path: str, precision: str, with_corr: bool = False):
        """One chunk: (packed (nreal, nbins+1) statistics, corr or None),
        on the mesh's first device. ``nreal`` splits into one contiguous
        block of realizations per real shard."""
        n_real = len(self._shards)
        if nreal % n_real != 0:
            raise ValueError(f"nreal per chunk ({nreal}) must be divisible "
                             f"by the real mesh axis ({n_real})")
        keys = _chunk_keys(base_key, offset, nreal)
        r_local = nreal // n_real
        packed, corrs = [], []
        for r, shards in enumerate(self._shards):
            k = keys[r * r_local:(r + 1) * r_local]
            if len(shards) == 1:
                p, c = self._step_shared(shards[0], k.to(shards[0].device),
                                         path, precision, with_corr)
            else:
                p, c = self._step_sharded(shards, k, path, precision,
                                          with_corr)
            packed.append(p.to(self.device))
            if with_corr:
                corrs.append(c.to(self.device))
        return _cat(packed), (_cat(corrs) if with_corr else None)

    def _step_shared(self, sh: _Shard, keys, path: str, precision: str,
                     with_corr: bool):
        """One shard holding every pulsar: one operand set."""
        if path == "einsum":
            corr = _correlation_rows(self._residuals(keys, shard=sh),
                                     stats_bf16=precision == "bf16")
            # curve + auto lanes: one contraction against the combined
            # weight stack, as the kernels bin
            out = torch.einsum("rpq,npq->rn", corr, sh.weights)
            curves, autos = unpack_stats(out, self.nbins)
            return (pack_stats(curves, autos),
                    corr / self._counts.to(corr.device) if with_corr
                    else None)
        if path == "fused":
            res = self._residuals(keys, shard=sh)
            curves, autos = self._fused_kernel()(
                res, res, sh.weights, self.nbins, precision=precision)
            return pack_stats(curves, autos), None
        base, coefs = self._residuals(keys, split_gp=True, shard=sh)
        if precision == "bf16":
            # bf16 STORAGE of the kernel's two big reads; the projection and
            # every accumulation stay f32 inside the kernel
            base = base.to(torch.bfloat16)
            coefs = coefs.to(torch.bfloat16)
        curves, autos = mega_ops.chunk_stats(
            base, coefs, sh.times, sh.scales, sh.weights,
            stages=self._mega_tables[0], nbins=self.nbins,
            precision=precision)
        return pack_stats(curves, autos), None

    def _step_sharded(self, shards, keys, path: str, precision: str,
                      with_corr: bool):
        """Pulsar-sharded chunk block: each shard's rows against the
        all-gathered array with its rows of the weights, then the psum of
        the partial statistics in shard order."""
        dev0 = shards[0].device
        bf16 = precision == "bf16"
        split = path == "mega"
        local = [self._residuals(keys.to(sh.device), split_gp=split,
                                 shard=sh) for sh in shards]
        if path == "mega":
            if bf16:
                # cast per shard BEFORE the gather, as the JAX engine does
                local = [(b.to(torch.bfloat16), c.to(torch.bfloat16))
                         for b, c in local]
            base_f = all_gather([b for b, _ in local])
            coef_f = all_gather([c for _, c in local])
            parts = [pack_stats(*mega_ops.chunk_stats(
                bf, cf, sh.times_full, sh.scales_full, sh.weights,
                stages=self._mega_tables[0], nbins=self.nbins,
                precision=precision, base_local=b, coef_local=c,
                times_local=sh.times, scales_local=sh.scales))
                for sh, (b, c), bf, cf in zip(shards, local, base_f, coef_f)]
            return psum(parts, dev0), None
        if path == "einsum":
            full = all_gather(local)
            corrs = [_correlation_rows(x, f, stats_bf16=bf16)
                     for x, f in zip(local, full)]
            parts = [torch.einsum("rpq,npq->rn", c, sh.weights)
                     for c, sh in zip(corrs, shards)]
            corr = None
            if with_corr:
                corr = torch.cat([c.to(dev0) for c in corrs], dim=1) \
                    / self._counts.to(dev0)
            return psum(parts, dev0), corr
        full = all_gather(local)
        kernel = self._fused_kernel()
        parts = [pack_stats(*kernel(x, f, sh.weights, self.nbins,
                                    precision=precision))
                 for x, f, sh in zip(local, full, shards)]
        return psum(parts, dev0), None

    def run(self, nreal: int, seed: int = 0, chunk: int = DEFAULT_CHUNK,
            keep_corr: bool = False,
            precision: Optional[str] = None) -> dict:
        """Run the ensemble in chunks of ``chunk`` realizations.

        Returns numpy ``curves`` (nreal, nbins), ``autos`` (nreal,),
        ``bin_centers`` (nbins,) and, with ``keep_corr`` (which takes the
        einsum path), ``corr`` (nreal, P, P) normalized pair correlations.
        The chunk is clamped to ``nreal`` and rounded down to a multiple of
        the real mesh axis (at least one realization per real shard). Every
        chunk runs at the full chunk size (the last one overshoots and is
        truncated).
        """
        path = "einsum" if keep_corr else self.stat_path
        prec = self._resolve_precision(path, precision)
        nreal = int(nreal)
        if nreal <= 0:
            raise ValueError(f"nreal must be > 0, got {nreal}")
        n_real = len(self._shards)
        chunk = max(1, min(int(chunk), nreal))
        chunk = max(chunk - chunk % n_real, n_real)
        base = rng.key(seed, device=self.device)
        packed, corrs = [], []
        with torch.no_grad():
            for offset in range(0, nreal, chunk):
                p, c = self.step(base, offset, chunk, path, prec,
                                 with_corr=keep_corr)
                packed.append(p)
                if keep_corr:
                    corrs.append(c)
            packed_h = torch.cat(packed)[:nreal].cpu().numpy()
        if not np.isfinite(packed_h).all():
            raise FloatingPointError("run produced non-finite statistics")
        curves, autos = unpack_stats(packed_h, self.nbins)
        out = {"curves": curves, "autos": autos,
               "bin_centers": np.asarray(self.bin_centers),
               "statistic_path": path, "precision": prec}
        if keep_corr:
            out["corr"] = torch.cat(corrs)[:nreal].cpu().numpy()
        return out
