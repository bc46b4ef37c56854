"""Monte-Carlo ensemble engine over a (real, psr) device mesh (port of fakepta_tpu.parallel.montecarlo).

Simulates thousands of independent PTA realizations (white + ECORR + red +
DM + chromatic + system noise + correlated GWB) and reduces each to the
angular-binned cross-correlation curve and the mean auto-correlation.

Streams: per-realization keys are ``fold_in(key(seed), index)`` on the
threefry key tree of :mod:`fakepta_tpu_torch.utils.rng`, with the JAX
package's domain tags (0x51 noise, 0x6B GWB, 0x9C noise-hyperparameter
sampling, 0xE1 white sampling, 0x77 BayesEphem sampling, 0xC6 CGW
sampling) and global pulsar-index folds, so every
draw equals the JAX engine's to a few ULP of the batch's dtype, a rerun is
bit-identical and a realization's draws depend neither on the chunk size
nor on the mesh shape.

Precision: the draws, the residuals and the sums run at the batch's dtype,
as the JAX engine's do (``dtype = batch.t_own.dtype``). A float32 batch
runs every path; a float64 batch (the JAX engine's under ``jax_enable_x64``)
runs the einsum path, its default, on every mesh and with every stage,
sampler and lane, and the kernel paths refuse it (their kernels take
float32). The correlation's pair sums are float32 on either, as the JAX
contraction's ``preferred_element_type`` makes them.

Per-realization hyperparameter sampling: :class:`NoiseSampling` draws a
registered spectrum's hyperparameters per realization (per pulsar for
red / DM / chromatic, per pulsar and backend band for system noise, once
for the GWB) and :class:`WhiteSampling` draws (efac, log10_tnequad,
log10_ecorr) per pulsar and backend; the sampled weights and variances
replace the batch's fixed ones, and every statistic path reads them the
same way.

Mesh (:mod:`.mesh`): one process drives every shard, or on a
multi-process mesh (:func:`.mesh.initialize_multihost`) each rank drives
the shards it owns, the gathers and psums cross ranks in shard order and
each chunk's rows are gathered to every rank. The ``'real'`` axis
splits each chunk's realizations into contiguous blocks; the ``'psr'`` axis
gives each shard its rows of every per-pulsar field, built once at
construction. A psr shard draws its own pulsars' noise, draws the full GWB
z and keeps its own columns of the coupled coefficients, correlates its
rows against the all-gathered array with its rows of the statistic
weights, and the shards' partial statistics are psum'ed in shard order. On
a one-shard mesh every step is the shared single-device code.

The ``'toa'`` axis (``toa_shards > 1``, the einsum path only) makes a shard
a (psr, toa) cell holding a window of every TOA-width field (the batch's,
the orbit states, the CGW epochs, the sampled white levels' raw TOA errors
and backend ids). A cell draws only its window's counters of each per-TOA
draw (:func:`..utils.rng.normal`'s ``start``), so the values per global TOA
are the unsharded stream's bit for bit; ECORR epoch normals index global
epoch ids, so an epoch that straddles two windows gets one shared normal.
Each cell correlates its window; the partial pair sums are added over the
toa cells in a fixed order, then binned.

The detection lane (``run(os=...)``, :mod:`..detect`): the optimal
statistic's per-ORF weight matrices ride as extra weight slots between the
angular bins and the auto trace, in the same contraction or kernel launch
as the curve. ``OSSpec(null=True)`` adds the paired noise-only stream: the
same noise stages and sampled noise nuisances (and sampled Roemer terms)
under ``fold_in(key, 0xD7)``, without the GWB, the deterministic block and
the sampled CGW sources, through a second contraction or launch per chunk
with the OS slots and a zero auto slot (on the mega path with the GWB-free
stage set).

Statistic paths (``stat_path``):

- ``"einsum"``: residuals, then torch einsums for the correlation and the
  binning (the JAX package's XLA path; the engine-level plain reference);
- ``"fused"`` (default): residuals through the hand-written
  binned-correlation kernel (:mod:`..ops.binned_corr`); with
  ``pallas_mxu_binning=False`` through its per-slot-reduction variant;
- ``"mega"``: residual base + GP coefficients through the whole-chunk
  kernel (:mod:`..ops.megakernel`), which rebuilds the Fourier bases on
  chip.

The run loop (:meth:`EnsembleSimulator.run`): chunks dispatch on the
device's current stream; with ``pipeline_depth`` d > 0 each chunk's packed
statistics copy to a pinned host buffer on a copy stream while later
chunks run, and a writer thread drains them (checkpoint append, progress)
with at most d chunks in flight (:mod:`.pipeline`). ``checkpoint=`` resumes
an interrupted run bit for bit (:mod:`..utils.io`), ``lanes=`` runs
per-request RNG lanes, and every run returns a
:class:`..obs.report.RunReport`.

Deterministic and sampled signals: ``cgw=`` (:class:`CGWConfig`),
``roemer=`` (:class:`RoemerConfig`) and ``waveform=`` (arrays or
callables) are evaluated once at construction into one (P, T) delay block
(the ``"det"`` stage); :class:`RoemerSampling` (BayesEphem nuisances, tag
0x77) and :class:`CGWSampling` (a continuous-wave source per realization,
tag 0xC6) are drawn per realization and added after it, in the JAX
engine's order. They need the padded absolute epochs ``toas_abs``.

The likelihood lane (``run(lnlike=...)``, :mod:`..infer`): per
realization and per theta point the GP-marginalized Woodbury lnL (and its
forward-mode gradient and Hessian) from the chunk's residual blocks, in
the same chunk as the statistic: beside the correlation einsum, beside
the fused kernel, or, on the mega path, from the same split coefficients
projected through the dense basis outside the kernel. Its moment parts
are TOA sums, added over a psr shard's toa cells before the ECORR
downdate; the psr shards' partial lnL are added in shard order.

Recovery (``run(recovery=...)``, :mod:`..faults`): by default a transient
chunk failure (an injected one, a CUDA out-of-memory error) is retried on
the same keys, bit-identical; a hand-written kernel's launch failure on
the mega path steps it down to ``fused`` (on the fused path it is fatal:
no run falls back to the kernels' plain einsum version) and a bf16
certification failure re-dispatches at f32, each step counted, recorded
and reported as the run's ``statistic_path`` / ``precision``.

``run(eventlog=dir)`` writes each rank's report as an event-log shard
(:mod:`..obs.trace` merges them).

The tuner (:mod:`..tune`): ``run(tuned=True | knobs | TunedConfig)`` fills
the dispatch knobs the caller left unset (chunk, depth, path, precision)
from the store or the given config; ``dispatch_surface``,
``chunk_cost``, ``warm_start`` and ``clear_executables`` are the hooks
the tuner and the serve pool call.
"""

from __future__ import annotations

import collections
import dataclasses
import pathlib
import threading
import warnings
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import constants as const
from .. import faults
from .. import spectrum as spectrum_lib
from ..batch import PulsarBatch, fourier_basis_norm
from ..device import DeviceLike
from ..ephemeris import Ephemeris
from ..models import cgw as cgw_model
from ..models import roemer as roemer_model
from ..obs import flightrec
from ..obs import metrics as obs_metrics
from ..obs import memwatch
from ..obs.memwatch import HbmSampler, PackedLedger
from ..obs.report import RunReport
from ..obs.timing import now, span
from ..ops import binned_corr as binned_corr_ops
from ..ops import gwb as gwb_ops
from ..ops import megakernel as mega_ops
from ..tune import defaults as tune_defaults
from ..utils import rng
from ..utils.io import EnsembleCheckpoint
from . import pipeline
from .mesh import PSR_AXIS, REAL_AXIS, TOA_AXIS, Mesh
from .mesh import backend as mesh_backend
from .mesh import make_mesh, process_count, process_index

#: realizations per chunk (the knob table, ..tune.defaults)
DEFAULT_CHUNK = tune_defaults.DEFAULT_CHUNK
#: chunks in flight before the loop waits for the oldest one's drain
#: (the knob table, ..tune.defaults)
DEFAULT_PIPELINE_DEPTH = tune_defaults.DEFAULT_PIPELINE_DEPTH

STAT_PATHS = ("einsum", "fused", "mega")
STAGES = ("white", "ecorr", "red", "dm", "chrom", "sys", "gwb", "det")

# key-domain tags, unchanged from the JAX engine: 0x51 noise, 0x6B GWB,
# 0x9C hyperparameter sampling (one subtag per target), 0xE1 white
# sampling, 0x77 BayesEphem sampling, 0xC6 CGW sampling, 0xD7 the OS
# lane's paired null stream
_NOISE_TAG = 0x51
_GWB_TAG = 0x6B
_HYPER_TAG = 0x9C
_HYPER_SUBTAG = {"red": 0, "dm": 1, "chrom": 2, "gwb": 3, "sys": 4}
_WHITE_TAG = 0xE1
_ROEMER_TAG = 0x77
_CGW_TAG = 0xC6
_NULL_TAG = 0xD7

# PulsarBatch fields whose last axis is the TOA axis (a toa shard holds a
# window of them); sys_mask carries it behind the band axis
_BATCH_TOA_FIELDS = ("t_own", "t_common", "mask", "freqs", "sigma2",
                     "epoch_idx", "ecorr_amp")

# RoemerSampling's draw order (one normal per parameter)
_ROEMER_PARAMS = ("d_mass", "d_Om", "d_omega", "d_inc", "d_a", "d_e",
                  "d_l0")

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
class CGWConfig:
    """A deterministic continuous-wave source, parameterized as the
    facade's ``Pulsar.add_cgw`` (reference ``fake_pta.py:422-442``);
    evaluated once at construction at float64 on the host
    (:func:`..models.cgw.cw_delay_batched`)."""

    costheta: float
    phi: float
    cosinc: float
    log10_mc: float
    log10_fgw: float
    log10_h: Optional[float] = None
    log10_dist: Optional[float] = None
    phase0: float = 0.0
    psi: float = 0.0
    psrterm: bool = False


@dataclasses.dataclass(frozen=True)
class RoemerConfig:
    """A fixed BayesEphem-style ephemeris perturbation (units of
    ``Ephemeris.roemer_delay``: degrees, AU, kg), evaluated once at
    construction through the float32-stable difference form
    (:func:`..models.roemer.roemer_delay_dev`)."""

    planet: str
    d_mass: float = 0.0
    d_Om: float = 0.0
    d_omega: float = 0.0
    d_inc: float = 0.0
    d_a: float = 0.0
    d_e: float = 0.0
    d_l0: float = 0.0


@dataclasses.dataclass(frozen=True)
class CGWSampling:
    """Per-realization CGW source sampling.

    Each realization draws one circular-SMBHB source, every parameter from
    its ``(a, b)`` range (``dist='uniform'``: U(a, b); ``'normal'``:
    N(mean=a, std=b); a mapping gives one per parameter), and adds its
    evolving waveform, evaluated at float32 from the epochs relative to
    ``tref`` (host-f64 subtraction). A ``log10_dist`` range samples the
    distance in log10(Mpc) and takes precedence over ``log10_h``.

    Keys fold the realization key with the 0xC6 tag and the config index
    only, so one source is common to the array and the stream does not
    depend on the mesh. ``psrterm=True`` adds the pulsar term at the
    engine's ``pdist`` means; ``sample_pdist=True`` also draws each
    pulsar's distance nuisance ``N(0, 1)`` (in units of its ``pdist``
    sigma) per realization, folding the global pulsar index. The pulsar
    term's retarded phase (~1e3-1e4 rad) is precomputed per (realization,
    pulsar) at float64 on the host from the same draw chain
    (:func:`..models.cgw.psrterm_phase_bulk`), so the device only evaluates
    the O(10 rad) rest (:func:`..models.cgw.cw_delay_psrterm_split`).
    """

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
    """Per-realization BayesEphem nuisance sampling.

    Each realization draws ``d_<param> ~ N(0, s_<param>)`` (units of
    :class:`RoemerConfig`) and runs them through the float32-stable
    difference form against the nominal orbit, propagated once on the host
    in float64. Keys fold the realization key with the 0x77 tag and the
    config index only: every psr shard perturbs the same solar system. A
    sequence samples several bodies, independently; a config whose scales
    are all zero is skipped.
    """

    planet: str
    s_mass: float = 0.0
    s_Om: float = 0.0
    s_omega: float = 0.0
    s_inc: float = 0.0
    s_a: float = 0.0
    s_e: float = 0.0
    s_l0: float = 0.0


def _resolve_dists(dist, names, label: str = "NoiseSampling"):
    """Normalize a str-or-mapping ``dist`` (of :class:`NoiseSampling` or
    :class:`CGWSampling`, named by ``label``) to one value per name."""
    if isinstance(dist, str):
        dmap = {n: dist for n in names}
    else:
        bad = [k for k in dist if k not in names]
        if bad:
            raise ValueError(f"{label} dist mapping names {bad} are "
                             f"not sampled parameters {list(names)}")
        dmap = {n: dist.get(n, "uniform") for n in names}
    for d in dmap.values():
        if d not in ("uniform", "normal"):
            raise ValueError(f"{label} dist must be 'uniform' or "
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

    def rows(self, lo: int, n: int, dev: torch.device, t_lo: int = 0,
             t_n: Optional[int] = None) -> "_Hyper":
        """A shard's rows on ``dev``, and of a toa shard its TOA window
        ``t_lo .. t_lo + t_n - 1``."""
        def take(x):
            return None if x is None else _window(x, lo, n, t_lo, t_n, dev)
        return dataclasses.replace(
            self, noise=tuple((st, r.to(dev)) for st, r in self.noise),
            white_params=(None if self.white_params is None
                          else self.white_params.to(dev)),
            toaerr2=take(self.toaerr2), backend_id=take(self.backend_id))


def _window(x: torch.Tensor, lo: int, n: int, t_lo: int,
            t_n: Optional[int], dev: torch.device) -> torch.Tensor:
    """Rows ``lo .. lo + n - 1`` of ``x`` and, when ``t_n`` is given, its
    TOA window ``t_lo .. t_lo + t_n - 1`` along axis 1, contiguous on
    ``dev``."""
    x = x.narrow(0, lo, n)
    if t_n is not None:
        x = x.narrow(1, t_lo, t_n)
    return x.contiguous().to(dev)


def _affine(a, z, scale):
    """``a + z * scale`` with the product and sum fused (one rounding), as
    XLA contracts the JAX engine's ``a + z * (b - a)``: at float32 through
    the exact float64 product and sum, rounded once; at float64 through
    ``torch.addcmul`` (a fused multiply-add)."""
    if z.dtype == torch.float64:
        return torch.addcmul(a, z, scale)
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
    i)`` key: the JAX engine's layout. The draws are at the dtype of
    ``ranges``, the batch's."""
    dt = ranges.dtype
    n_scalar = sum(1 for pb in per_bin if not pb)
    any_norm = any(d == "normal" for pb, d in zip(per_bin, dists) if not pb)
    u = rng.uniform(k, n_scalar, dtype=dt) if n_scalar else None
    g = (rng.normal(rng.fold_in(k, 1), n_scalar, dtype=dt) if any_norm
         else None)
    out, zi = {}, 0
    for i, (name, pb, d) in enumerate(zip(names, per_bin, dists)):
        a, b = ranges[i, 0], ranges[i, 1]
        if pb:
            kb = rng.fold_in(k, 16 + i)
            z = rng.uniform(kb, nbin, dtype=dt) if d == "uniform" \
                else rng.normal(kb, nbin, dtype=dt)
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
    prm = hyper.white_params
    zw = rng.uniform(kp, shape, dtype=prm.dtype) if dist == "uniform" \
        else rng.normal(kp, shape, dtype=prm.dtype)            # (R, P, B, 3)
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


@dataclasses.dataclass(frozen=True)
class _Signals:
    """Deterministic and sampled signal state on one shard's device: the
    fixed delay block, per sampled body its nominal orbit, (7,) scales and
    which of them are zero, per sampled source its static descriptor
    ``(psrterm, mode, dists, sample_pdist)``, (8, 2) ranges and epochs
    relative to its ``tref``, and the (P, 2) pulsar distances."""

    det: Optional[torch.Tensor] = None                          # (P, T)
    roemer: Tuple[Tuple[roemer_model.OrbitState, torch.Tensor, tuple],
                  ...] = ()
    cgw: Tuple[Tuple[tuple, torch.Tensor, torch.Tensor], ...] = ()
    pdist: Optional[torch.Tensor] = None                        # (P, 2)

    def rows(self, lo: int, n: int, dev: torch.device, t_lo: int = 0,
             t_n: Optional[int] = None) -> "_Signals":
        """A shard's rows on ``dev``, and of a toa shard its TOA window
        ``t_lo .. t_lo + t_n - 1`` (the fixed block, the orbit states, the
        CGW epochs)."""
        def take(x):
            return None if x is None else _window(x, lo, n, t_lo, t_n, dev)

        def orbit(st):
            st = st.rows(lo, n)
            return (st if t_n is None else st.toas(t_lo, t_n)).to(dev)
        return _Signals(
            det=take(self.det),
            roemer=tuple((orbit(st), sc.to(dev), zero)
                         for st, sc, zero in self.roemer),
            cgw=tuple((stat, rg.to(dev), take(trel))
                      for stat, rg, trel in self.cgw),
            pdist=None if self.pdist is None else _window(
                self.pdist, lo, n, 0, None, dev))


def _sampled_roemer(keys: torch.Tensor, state, scales: torch.Tensor,
                    zero: tuple, pos: torch.Tensor, tag: int) -> torch.Tensor:
    """(R, P, T) per-realization BayesEphem delays: ``N(0, 1) * scales``
    under ``fold_in(fold_in(key, 0x77), tag)``, never the shard index.
    A parameter whose scale is zero is passed as the number 0 (its draw
    times zero), which lets a mass-only body skip the orbit deltas."""
    kz = rng.fold_in(rng.fold_in(keys, _ROEMER_TAG), tag)          # (R, 2)
    d = rng.normal(kz, 7, dtype=scales.dtype) * scales             # (R, 7)
    kw = {name: (0.0 if z else d[:, i].reshape(-1, 1, 1))
          for i, (name, z) in enumerate(zip(_ROEMER_PARAMS, zero))}
    with span("roemer"):
        return roemer_model.roemer_delay_dev(state, pos, **kw)


def _cgw_draws(keys: torch.Tensor, ranges: torch.Tensor, static: tuple,
               tag: int, gidx: torch.Tensor):
    """One source's parameters per realization, (R, 8) in CGWSampling's
    field order (row 5 the amplitude), and with ``sample_pdist`` the
    (R, P) distance nuisances of the pulsars ``gidx`` (else None): the JAX
    engine's draw chain, on any device, at the dtype of ``ranges``."""
    _, _, dists, sample_pdist = static
    dt = ranges.dtype
    kz = rng.fold_in(rng.fold_in(keys, _CGW_TAG), tag)
    u = rng.uniform(kz, 8, dtype=dt)
    v = _affine(ranges[:, 0], u, ranges[:, 1] - ranges[:, 0])
    normal = [d == "normal" for d in dists]
    if any(normal):
        g = rng.normal(rng.fold_in(kz, 1), 8, dtype=dt)
        v = torch.where(torch.tensor(normal, device=v.device),
                        _affine(ranges[:, 0], g, ranges[:, 1]), v)
    pd = None
    if sample_pdist:
        kpd = rng.fold_in(kz, 2)
        pd = rng.normal(rng.fold_in(kpd[:, None, :], gidx), (),
                        dtype=dt)                                  # (R, P)
    return v, pd


def _sampled_cgw(keys: torch.Tensor, t_rel: torch.Tensor, pos: torch.Tensor,
                 pdist: torch.Tensor, ranges: torch.Tensor, static: tuple,
                 tag: int, gidx: torch.Tensor,
                 bulk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, P, T) per-realization CGW delays at this shard's epochs
    ``t_rel`` (relative to the config's ``tref``). ``bulk`` (psrterm
    configs) is this shard's (R, P) host-f64 retarded-phase bulk, mod
    2pi."""
    psrterm, mode, _, _ = static
    v, pd = _cgw_draws(keys, ranges, static, tag, gidx)

    def col(i):
        return v[:, i:i + 1]                     # (R, 1) against (P, 3)

    kw = dict(cos_gwtheta=col(0), gwphi=col(1), cos_inc=col(2),
              log10_mc=col(3), log10_fgw=col(4), phase0=col(6), psi=col(7),
              p_dist=0.0 if pd is None else pd)
    kw["log10_h" if mode == "h" else "log10_dist"] = col(5)
    pd_pair = (pdist[:, 0], pdist[:, 1])
    with span("cgw"):
        if bulk is not None:
            return cgw_model.cw_delay_psrterm_split(t_rel, pos, pd_pair,
                                                    bulk, **kw)
        return cgw_model.cw_delay(t_rel, pos, pd_pair, psrTerm=psrterm,
                                  evolve=True, **kw)


def _validated_toas_abs(shape, toas_abs, what: str) -> np.ndarray:
    """Absolute host-f64 epochs of the padded batch ``shape``."""
    if toas_abs is None:
        raise ValueError(
            f"{what} needs toas_abs: the padded (npsr, max_toa) absolute "
            f"MJD-second TOAs (float64 host array)")
    toas_abs = np.asarray(toas_abs, dtype=np.float64)
    if toas_abs.shape != tuple(shape):
        raise ValueError(f"toas_abs shape {toas_abs.shape} != batch "
                         f"{tuple(shape)}")
    return toas_abs


def _build_deterministic(batch: PulsarBatch, host: dict, cgw, roemer, ephem,
                         toas_abs, pdist, waveform=None):
    """(P, T) summed deterministic delay block on the batch's device, or
    None if nothing is configured.

    ``waveform`` is the engine counterpart of the facade's
    ``add_deterministic`` hook (reference ``fake_pta.py:444-455``): a
    padded (P, T) delay array, or a callable invoked ``fn(toas=...)`` on
    one pulsar's real (unpadded) absolute epochs at host float64; a
    sequence mixes both and sums. CGW sources sharing a (psrterm,
    amplitude mode) signature are evaluated as one parameter batch at
    float64 on the host (absolute epochs of ~4.6e9 s lose ~550 s at
    float32); Roemer deltas go through the float32-stable difference form
    on the device. The terms add in the JAX engine's order: waveforms,
    CGW groups, Roemer configs.
    """
    cgw_list = _as_config_list(cgw)
    roe_list = _as_config_list(roemer)
    wf_list = _as_config_list(waveform)
    if not cgw_list and not roe_list and not wf_list:
        return None
    shape = tuple(batch.t_own.shape)
    if cgw_list or roe_list or any(callable(w) for w in wf_list):
        toas_abs = _validated_toas_abs(
            shape, toas_abs, "cgw/roemer/waveform deterministic signals")
    dtype, dev = batch.dtype, batch.device

    def put(arr):
        return torch.from_numpy(np.asarray(arr, dtype=np.float64)).to(
            dtype).to(dev)

    det = torch.zeros(shape, dtype=dtype, device=dev)
    for wf in wf_list:
        if callable(wf):
            arr = np.zeros(shape)
            for i in range(batch.npsr):
                n = int(host["mask"][i].sum())
                row = np.asarray(wf(toas=toas_abs[i, :n]), dtype=np.float64)
                if row.shape != (n,):
                    raise ValueError(
                        f"deterministic waveform returned shape {row.shape} "
                        f"for pulsar {i} ({n} epochs); the callable contract "
                        f"is fn(toas=...) -> delays per pulsar, as in the "
                        f"facade's add_deterministic (pre-bind extra kwargs "
                        f"with functools.partial)")
                arr[i, :n] = row
        else:
            arr = np.asarray(wf, dtype=np.float64)
            if arr.shape != shape:
                raise ValueError(
                    f"deterministic waveform array has shape {arr.shape}; "
                    f"expected the padded batch shape {shape}")
        det = det + put(arr)
    if cgw_list:
        if pdist is None:
            pdist = np.zeros((batch.npsr, 2))
        pdist = np.asarray(pdist, dtype=np.float64).reshape(batch.npsr, 2)
        pos64 = np.asarray(host["pos"], dtype=np.float64)
        groups = {}
        for cfg in cgw_list:
            mode = "h" if cfg.log10_h is not None else "dist"
            groups.setdefault((bool(cfg.psrterm), mode), []).append(cfg)
        for (psrterm, mode), cfgs in groups.items():
            amp = np.array([c.log10_h if mode == "h" else c.log10_dist
                            for c in cfgs])
            kw = {("log10_h" if mode == "h" else "log10_dist"): amp}
            delay = cgw_model.cw_delay_batched(
                torch.from_numpy(toas_abs), torch.from_numpy(pos64),
                torch.from_numpy(pdist),
                cos_gwtheta=np.array([c.costheta for c in cfgs]),
                gwphi=np.array([c.phi for c in cfgs]),
                cos_inc=np.array([c.cosinc for c in cfgs]),
                log10_mc=np.array([c.log10_mc for c in cfgs]),
                log10_fgw=np.array([c.log10_fgw for c in cfgs]),
                phase0=np.array([c.phase0 for c in cfgs]),
                psi=np.array([c.psi for c in cfgs]),
                psrTerm=psrterm, evolve=True, **kw)
            det = det + delay.to(dtype).to(dev)
    if roe_list:
        ephem = Ephemeris() if ephem is None else ephem
        for cfg in roe_list:
            state = roemer_model.nominal_state(ephem, cfg.planet, toas_abs,
                                               dtype=dtype, device=dev)
            det = det + roemer_model.roemer_delay_dev(
                state, batch.pos, d_mass=cfg.d_mass, d_Om=cfg.d_Om,
                d_omega=cfg.d_omega, d_inc=cfg.d_inc, d_a=cfg.d_a,
                d_e=cfg.d_e, d_l0=cfg.d_l0)
    return torch.where(batch.mask, det, 0.0)


def _lane_mode(offset) -> bool:
    """True when a dispatch carries RNG lanes (a vector offset)."""
    return isinstance(offset, torch.Tensor) and offset.dim() > 0


def _chunk_keys(base_key: torch.Tensor, offset,
                nreal: int) -> torch.Tensor:
    """(nreal, 2) per-realization keys for one chunk, in either key mode.

    Batch mode (int ``offset``): ``fold_in(base_key, offset + i)``, the
    absolute-index stream, identical at any chunk size (checkpoint resume
    identity).

    Lane mode: ``base_key`` is an (nreal,) integer vector of per-slot
    request seeds and ``offset`` the matching vector of within-request
    indices; slot i draws ``fold_in(key(seed_i), within_i)``, exactly the
    key ``run(n, seed=seed_i)`` gives its realization ``within_i``.
    """
    if _lane_mode(offset):
        seeds = base_key.to(torch.int64)
        keys = torch.stack([seeds >> 32, seeds & rng.M32], dim=-1)
        return rng.fold_in(keys, offset)
    idx = torch.arange(offset, offset + nreal, dtype=torch.int64,
                       device=base_key.device)
    return rng.fold_in(base_key, idx)


def _lane_arrays(lanes, nreal):
    """Per-slot (request seed, within-request index) int32 vectors for a
    lane run.

    ``lanes`` is a sequence of ``(seed, n)`` pairs in slot order; slots
    past the last lane are padding (seed 0, continuing indices) whose
    results callers discard.
    """
    seeds = np.zeros(nreal, dtype=np.int32)
    within = np.arange(nreal, dtype=np.int32)
    pos = 0
    for s, n in lanes:
        s, n = int(s), int(n)
        if n <= 0:
            raise ValueError(f"lane realization count must be > 0, got {n}")
        if not 0 <= s < 2 ** 31:
            # the JAX engine carries lane seeds as int32; key(s) of an
            # int32 equals key(python s) on this range only
            raise ValueError(f"lane seed must be in [0, 2**31), got {s}")
        if pos + n > nreal:
            raise ValueError(f"lanes need {pos + n} slots but the run has "
                             f"nreal={nreal}")
        seeds[pos:pos + n] = s
        within[pos:pos + n] = np.arange(n, dtype=np.int32)
        pos += n
    return seeds, within


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
    # (P, T, K) concatenated GP basis at the batch dtype (rounded to
    # bfloat16 values under bases_dtype='bf16')
    gp_basis: Optional[torch.Tensor]
    gwb_group: Tuple[int, ...]            # config -> basis group
    n_groups: int
    bases_bf16: bool = False              # round the coefficients too


def _stage_terms(batch: PulsarBatch, gwb_ws, gwb_idxs, gwb_freqfs,
                 include, bases_bf16: bool = False) -> _StageTerms:
    """Weights and bases of ``_simulate_block``, in the JAX stage order:
    red, dm, chrom, then one basis group per distinct GWB
    ``(idx, freqf, ncomp)`` signature (configs sharing a group sum their
    coefficients: the projection is linear). ``bases_bf16`` rounds the
    concatenated GP basis to bfloat16 values once, here, and keeps it at
    the batch dtype."""
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
    if bases_bf16 and gp_basis is not None:
        gp_basis = binned_corr_ops.round_bf16(gp_basis)
    return _StageTerms(red_w, dm_w, chrom_w, sys_w, sys_basis, gp_basis,
                       tuple(group), len(seen), bases_bf16)


def _simulate_block(keys: torch.Tensor, batch: PulsarBatch, chols, gwb_ws,
                    include, terms: _StageTerms, split_gp: bool = False,
                    p_offset: int = 0, hyper: Optional[_Hyper] = None,
                    t_offset: int = 0,
                    ecorr_window: Optional[Tuple[int, int]] = None):
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

    A toa shard's ``batch`` holds the TOA window starting at global slot
    ``t_offset``: the white normals are that window's counters of the
    full-width per-pulsar draw, and the ECORR epoch normals are drawn over
    ``ecorr_window = (first epoch id, count)`` (default: every slot) and
    gathered by the global epoch ids, so both equal the unsharded draws
    bit for bit. Every draw is at the batch's dtype.
    """
    (inc_white, inc_ecorr, inc_red, inc_dm, inc_chrom, inc_sys,
     inc_gwb) = include
    R = keys.shape[0]
    p, T = batch.t_own.shape
    dev, dt = keys.device, batch.dtype

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
        res = res + torch.sqrt(sigma2) * rng.normal(kw, T, start=t_offset,
                                                    dtype=dt)
    if inc_ecorr:
        # sigma^2 I + c^2 11^T per epoch == white plus ONE shared normal per
        # epoch, indexed by the per-TOA (global) epoch id; a TOA outside the
        # window has no ECORR (its amplitude is 0), so its clamped index
        # adds 0
        e_lo, e_n = (0, T) if ecorr_window is None else ecorr_window
        epoch_draws = rng.normal(ke, e_n, start=e_lo, dtype=dt)
        idx = batch.epoch_idx if e_lo == 0 and e_n == T else \
            (batch.epoch_idx - e_lo).clamp(0, e_n - 1)
        shared = torch.gather(epoch_draws, 2, idx.expand(R, p, T))
        res = res + ecorr_amp * shared
    coeffs = []
    for inc, name, k in ((inc_red, "red", kr), (inc_dm, "dm", kd),
                         (inc_chrom, "chrom", kc)):
        if inc:
            w = w_samp.get(name, getattr(terms, f"{name}_w"))
            c = rng.normal(k, (2, w.shape[-1]), dtype=dt) * w.unsqueeze(-2)
            coeffs.append(c.reshape(R, p, -1))
    if inc_sys:
        # per-(pulsar, band) GP on the shared basis, masked to the band
        n_bands, n_sys = terms.sys_w.shape[1:]
        c = rng.normal(ks, (n_bands, 2, n_sys), dtype=dt) \
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
            zg = rng.normal(kg, (2, w_j.shape[0], chol_j.shape[0]), dtype=dt)
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
        if terms.bases_bf16:
            # the JAX engine's bases_dtype='bf16': bf16 basis (rounded
            # once, in _stage_terms) times bf16 coefficients; their
            # products are exact in float32, and the sums run at the
            # batch dtype
            c_all = binned_corr_ops.round_bf16(c_all)
        # the null stream's coefficients stop before the GWB groups, whose
        # columns are the basis's last
        basis = terms.gp_basis[..., :c_all.shape[-1]]
        res = res + torch.einsum("ptk,rpk->rpt", basis, c_all)
    return torch.where(batch.mask, res, 0.0)


def _correlation_rows(res_local: torch.Tensor,
                      res_full: Optional[torch.Tensor] = None,
                      stats_bf16: bool = False):
    """(R, PL, PF) raw pair-product sums of local rows against the full
    array (``res_full=None``: the rows against themselves), float32, as
    the JAX contraction's ``preferred_element_type=float32`` returns them:
    a float64 batch's sums run at float64 and are rounded once to float32
    (what the JAX XLA path gives under x64; ROADMAP Queue 3). ``stats_bf16``
    rounds the operands to bf16 first (the einsum path's bf16 mode)."""
    if stats_bf16:
        res_local = binned_corr_ops.round_bf16(res_local)
        if res_full is not None:
            res_full = binned_corr_ops.round_bf16(res_full)
    return torch.einsum("rpt,rqt->rpq", res_local,
                        res_local if res_full is None else res_full
                        ).to(torch.float32)


def stat_weight_stack(pos: np.ndarray, counts_full: np.ndarray, nbins: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """The (nbins+1, P, P) statistic weights on the host, at ``dtype``:
    slot n < nbins is the angular bin's one-hot over the off-diagonal pairs
    divided by the pair counts and then by the bin's pair count (float64,
    in that order, as the JAX engine forms them), slot nbins the auto
    trace. Built one slot at a time, so the host holds the stack at
    ``dtype`` and one float64 (P, P) slot, not the (P, P, nbins) one-hot."""
    npsr = pos.shape[0]
    ang = np.arccos(np.clip(pos @ pos.T, -1, 1))
    edges = np.linspace(0.0, np.pi, nbins + 1)
    bin_idx = np.clip(np.digitize(ang, edges) - 1, 0, nbins - 1)
    del ang
    np.fill_diagonal(bin_idx, -1)        # no self pair in any bin
    # each bin's pair count (a sum of ones: exact in any order)
    bc = np.maximum(np.bincount(bin_idx[bin_idx >= 0], minlength=nbins)
                    .astype(np.float64), 1.0)
    idx = torch.from_numpy(bin_idx)
    counts = torch.from_numpy(np.ascontiguousarray(counts_full,
                                                   dtype=np.float64))
    stack = torch.empty((nbins + 1, npsr, npsr), dtype=dtype)
    w = torch.empty((npsr, npsr), dtype=torch.float64)
    for n in range(nbins):
        torch.eq(idx, n, out=w)          # the slot's one-hot: 1.0 or 0.0
        w.div_(counts).div_(float(bc[n]))
        stack[n].copy_(w)
    stack[nbins].copy_(torch.from_numpy(np.eye(npsr) / counts_full / npsr))
    return stack


def _bin(corr: torch.Tensor, weights: torch.Tensor, nbins: int):
    """(curves (R, nbins), autos (R,)) of raw pair sums against a weight
    stack (nbins + 1 slots, the auto trace last), at the weights' dtype
    (full float32, not TF32, on a float32 batch: the JAX engine bins at
    ``Precision.HIGHEST``)."""
    with mega_ops.full_f32():
        out = torch.einsum("rpq,npq->rn", corr.to(weights.dtype), weights)
    return out[:, :nbins], out[:, nbins]


@dataclasses.dataclass(frozen=True)
class _OSLanes:
    """A run's OS lane (``run(os=...)``): its spec, the host-f64 operators,
    and per shard (keyed by ``id``) its rows of the two weight stacks: the
    main launch's (nbins + n_os + 1, PL, P) (the bins, the OS slots, the
    auto trace) and the null stream's (n_os + 1, PL, P) with a zero auto
    slot (None without ``null``)."""

    spec: object
    ops: tuple
    n_os: int
    null: bool
    weights: dict

    @property
    def n_extra(self) -> int:
        """Packed lanes after the auto: the OS values, then the null's."""
        return self.n_os * (2 if self.null else 1)


@dataclasses.dataclass(frozen=True)
class _LnlLanes:
    """A run's likelihood lane (``run(lnlike=...)``): its spec and compiled
    model, the (K, D) host theta, the K*L packed lanes after the auto, and
    per psr shard (keyed by ``id`` of the shard that heads its toa cells)
    the residual-independent state staged once per run: each cell's basis
    and epoch table, the theta on the shard's device, and the finished
    fixed moments (M, lndetN, n_valid, ECORR corr) after the cells' parts
    are added in toa order."""

    spec: object
    compiled: object
    theta: np.ndarray
    k: int
    per_point: int
    num_epochs: int
    cells: dict          # id(cell shard) -> (basis (PL, Tw, 2M), onehot)
    heads: dict          # id(head shard) -> (theta, (M, lndetN, nv, corr))

    @property
    def n_extra(self) -> int:
        """Packed lanes after the auto: K points of L lanes each."""
        return self.k * self.per_point


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One shard's static state on its device: its rows of the batch, of
    the statistic weights and of the megakernel tables, plus what every
    shard holds whole (the ORF factors, the GWB weights and the gathered
    megakernel tables, which are static and so gathered once here). A toa
    shard (a (psr, toa) cell) holds a TOA window of every TOA-width field,
    starting at global slot ``t_offset``; ``ecorr_window`` is the (first
    epoch id, count) its ECORR draws cover (None: every slot)."""

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
    signals: _Signals                   # CGW / Roemer state, its rows
    t_offset: int = 0                   # global index of the first TOA
    ecorr_window: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.batch.device


class _RowComms:
    """The collectives of one real row's entries (psr-major, as the row's
    shard list): ``row`` over all of them, ``psr[t]`` over the psr shards
    of toa window t, ``toa[s]`` over psr shard s's toa cells and ``heads``
    over each psr shard's first cell."""

    def __init__(self, mesh: Mesh, r: int):
        n_psr, n_toa = mesh.shape[PSR_AXIS], mesh.shape[TOA_AXIS]
        self.row = mesh.comm([(r, s, t) for s in range(n_psr)
                              for t in range(n_toa)])
        self.psr = [mesh.comm([(r, s, t) for s in range(n_psr)])
                    for t in range(n_toa)]
        self.toa = [mesh.comm([(r, s, t) for t in range(n_toa)])
                    for s in range(n_psr)]
        self.heads = self.psr[0]


def _some(fn, *lists):
    """``fn`` over the zipped entries whose first item is not None (a
    rank's own shards), None elsewhere."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*lists)]


def _cat(parts, dim: int = 0):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _sum_parts(parts, comm) -> dict:
    """Moment-part dicts (:mod:`..ops.woodbury`) of a psr shard's toa
    cells (None where another rank owns the cell; this rank owns one at
    least), added key by key in toa order over ``comm`` on this rank's
    first cell's device."""
    first = next(p for p in parts if p is not None)
    return {k: comm.psum([None if p is None else p[k] for p in parts])
            for k in first}


_F64_ONLY = ("stat_path={!r} runs float32 batches (its kernels take "
             "float32; got {}); a float64 batch runs on stat_path='einsum', "
             "the JAX package's XLA path and the default for it")


def _check_path(path: str, *, toa_shards: int, dtype, stats_bf16: bool,
                bases_bf16: bool) -> None:
    """Raise when ``stat_path=path`` cannot run on a simulator with these
    settings: the constructor's rules for its path, which a tuned path
    meets too before a run takes it."""
    if path == "einsum":
        return
    if dtype != torch.float32:
        # the kernels take float32; the float64 path is the einsum one
        raise TypeError(_F64_ONLY.format(path, dtype))
    if toa_shards > 1:
        raise ValueError(
            f"stat_path={path!r} is incompatible with toa sharding (its "
            f"kernels assume each shard holds the full TOA axis); use "
            f"stat_path='einsum' or toa_shards=1")
    if bases_bf16 and path == "mega":
        raise ValueError(
            "bases_dtype='bf16' is inert under stat_path='mega' (the "
            "megakernel builds its bases on chip and never reads the dense "
            "one); use run(precision='bf16') for the bf16-storage mode "
            "instead")
    if stats_bf16:
        raise ValueError(
            "stats_dtype='bf16' applies to the einsum statistic path only "
            "(the kernels' precision is pallas_precision); drop one of the "
            "two")


def _lnl_point(compiled, mode: str, theta, moments, batch,
               psr_offset: int) -> torch.Tensor:
    """(R, L) likelihood lanes of one theta point: lnL, then per mode its
    gradient (D) and its Hessian (D*D, row-major). The derivatives are
    forward mode (``torch.func.jacfwd``) over the D parameters, where the
    JAX lane takes ``jacrev`` of its (R,)-valued function: reverse mode
    would pull R cotangents back through the (P, 2M, R) triangular solve,
    about (R, P, 2M, R) floats (~134 GB at R = 1024 on the flagship)."""
    from torch.func import jacfwd

    def f(t):
        return compiled.lnl_local(t, moments, batch, psr_offset)

    if mode == "lnlike":
        return f(theta)[:, None]

    def with_value(t):
        v = f(t)
        return v, v

    if mode == "grad":
        grad, val = jacfwd(with_value, has_aux=True)(theta)
        return torch.cat([val[:, None], grad], dim=1)

    def with_grad(t):
        grad, val = jacfwd(with_value, has_aux=True)(t)
        return grad, (grad, val)

    hess, (grad, val) = jacfwd(with_grad, has_aux=True)(theta)
    return torch.cat([val[:, None], grad, hess.reshape(val.shape[0], -1)],
                     dim=1)


class EnsembleSimulator:
    """Monte-Carlo engine over a (real, psr) device mesh.

    ``mesh`` (:func:`.mesh.make_mesh`) defaults to a 1x1x1 mesh on
    ``device``, which defaults to ``"cuda"`` and raises without a GPU
    unless ``device="cpu"``; pass one of the two. ``stat_path``:
    ``"einsum"``, ``"fused"`` (the default on a float32 batch) or
    ``"mega"`` (see the module docstring); a float64 batch defaults to
    ``"einsum"``, and ``"fused"`` / ``"mega"`` refuse it (``TypeError``).
    ``pallas_precision`` is the fused path's default statistic precision
    (``'bf16'``: bf16 operands, f32 accumulation; ``'f32'``: full f32);
    the mega and einsum paths default to ``'f32'``, and
    ``run(precision=...)`` overrides per run. ``pallas_mxu_binning=False``
    sends the fused path through the per-slot-reduction kernel.

    ``bases_dtype='bf16'`` rounds the dense GP basis and the coefficients
    of the residuals' projection to bfloat16 values (``"einsum"`` and
    ``"fused"``; the mega path builds its bases on chip, so there it is
    refused); products and sums stay float32. This is bf16 rounding, not
    bf16 storage: the basis is rounded once and kept in float32, since the
    port has no bf16-operand einsum with float32 output yet, so the knob
    gives the JAX option's numbers but not its memory saving. ``stats_dtype='bf16'`` makes bf16
    operands the einsum path's default statistic precision (refused off
    the einsum path, whose kernels have ``pallas_precision``).

    ``noise_sample`` (:class:`NoiseSampling`, one or a sequence) and
    ``white_sample`` (:class:`WhiteSampling`, with the raw squared TOA
    errors ``toaerr2`` and the per-TOA ``backend_id``, both (P, T)) turn
    on per-realization hyperparameter sampling, validated as the JAX
    engine validates it.

    Signals (the JAX engine's options and semantics): ``cgw``
    (:class:`CGWConfig`, one or a sequence), ``roemer``
    (:class:`RoemerConfig`) and ``waveform`` (padded (P, T) arrays or
    callables ``fn(toas=...)``) build the fixed ``"det"`` block once, only
    when ``"det"`` is in ``include``; ``roemer_sample``
    (:class:`RoemerSampling`) and ``cgw_sample`` (:class:`CGWSampling`)
    draw per realization whatever ``include`` says. ``toas_abs`` are the
    padded absolute MJD-second epochs (host float64) they need, ``pdist``
    the (npsr, 2) pulsar distances (mean, sigma) in kpc, ``ephem`` a host
    :class:`..ephemeris.Ephemeris` (default: the JPL table).
    """

    def __init__(self, batch: PulsarBatch,
                 gwb: Optional[Union[GWBConfig, Sequence[GWBConfig]]] = None,
                 mesh: Optional[Mesh] = None,
                 include: Sequence[str] = ("white", "ecorr", "red", "dm",
                                           "chrom", "sys", "gwb", "det"),
                 nbins: int = 15, stat_path: Optional[str] = None,
                 pallas_precision: str = "bf16",
                 pallas_mxu_binning: bool = True,
                 bases_dtype: str = "f32", stats_dtype: str = "f32",
                 noise_sample: Optional[Union[NoiseSampling,
                                              Sequence[NoiseSampling]]] = None,
                 white_sample: Optional[WhiteSampling] = None,
                 toaerr2=None, backend_id=None,
                 cgw=None, roemer=None, roemer_sample=None, ephem=None,
                 cgw_sample=None, toas_abs=None, pdist=None, waveform=None,
                 device: DeviceLike = None):
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
            # every batch leaf whose last axis is the TOA width must be in
            # the window list, else a toa shard would hold it at full width
            # beside its windowed siblings
            known = set(_BATCH_TOA_FIELDS) | {"sys_mask"}
            for fld in dataclasses.fields(PulsarBatch):
                arr = getattr(batch, fld.name)
                if (arr.dim() >= 2 and arr.shape[-1] == batch.max_toa
                        and fld.name not in known):
                    raise AssertionError(
                        f"PulsarBatch.{fld.name} has a TOA-width trailing "
                        f"axis but is not listed in _BATCH_TOA_FIELDS; add "
                        f"it (or, if the width match is coincidental, e.g. "
                        f"a bin count equal to max_toa, rename this check's "
                        f"exemptions)")
        # this rank's first entry: the whole-array state and the results
        self.device = mesh.local_device
        unknown = sorted(set(include) - set(STAGES))
        if unknown:
            raise ValueError(f"unknown stages {unknown}; known: {STAGES}")
        if batch.dtype not in rng.DTYPES:
            raise TypeError(f"the engine runs float32 or float64 batches, "
                            f"got {batch.dtype}")
        if stat_path is None:
            # a float64 batch's default is the JAX default path (XLA, the
            # port's einsum): the kernel paths take float32
            stat_path = "fused" if batch.dtype == torch.float32 else "einsum"
        if stat_path not in STAT_PATHS:
            raise ValueError(f"stat_path must be one of {STAT_PATHS}, got "
                             f"{stat_path!r}")
        if pallas_precision not in ("bf16", "f32"):
            raise ValueError(f"pallas_precision must be 'bf16' or 'f32', "
                             f"got {pallas_precision!r}")
        for name, value in (("bases_dtype", bases_dtype),
                            ("stats_dtype", stats_dtype)):
            if value not in ("f32", "bf16"):
                raise ValueError(f"{name} must be 'f32' or 'bf16', got "
                                 f"{value!r}")
        self._bases_bf16 = bases_dtype == "bf16"
        self._stats_bf16 = stats_dtype == "bf16"
        _check_path(stat_path, toa_shards=n_toa, dtype=batch.dtype,
                    stats_bf16=self._stats_bf16, bases_bf16=self._bases_bf16)
        self.stat_path = stat_path
        self.pallas_precision = pallas_precision
        self.pallas_mxu_binning = bool(pallas_mxu_binning)
        self.last_report: Optional[RunReport] = None
        self._lnl_compiled: dict = {}     # LikelihoodSpec -> compiled model
        self._chunk_costs: dict = {}      # chunk_cost's memo
        # the library workspaces on the mesh's cards, the fixed term beside
        # the chunk model (none on a host mesh, which has no device
        # allocator); measured at its first read
        self._workspaces = memwatch.WorkspaceTerm(mesh.local_devices)
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
                                   self._gwb_freqf, self._include,
                                   self._bases_bf16)

        # angular bins and pair-count normalization: host float64 setup on
        # the FULL array (every shard's rows use the full pair and bin
        # counts), folded into static statistic weights
        pos = np.asarray(host["pos"], dtype=np.float64)
        edges = np.linspace(0.0, np.pi, nbins + 1)
        self.bin_centers = edges[:-1] + 0.5 * (edges[1] - edges[0])
        mask_np = np.asarray(host["mask"], dtype=np.float64)
        raw_counts = mask_np @ mask_np.T
        self.pair_counts = raw_counts
        counts_full = np.maximum(raw_counts, 1.0)
        self._counts = torch.as_tensor(counts_full).to(dtype) \
            .to(self.device)
        self._stat_weights = stat_weight_stack(pos, counts_full, nbins,
                                               dtype).to(self.device)
        stages, self._mega_stages_null, times, scales = \
            self._build_mega_tables()
        self._mega_tables = (stages, times, scales)
        # the whole array as one shard: the single-device state
        signals = self._resolve_signals(batch, host, include, cgw, roemer,
                                        roemer_sample, ephem, cgw_sample,
                                        toas_abs, pdist, waveform)
        self._full = _Shard(0, batch, self._chol, self._gwb_w, self._terms,
                            self._stat_weights, times, scales, times, scales,
                            hyper, signals)
        self._shards = self._build_shards()
        if not any(sh is self._full for row in self._shards for sh in row):
            # no shard is the whole array, so no kernel reads its weights:
            # they wait on the host for the lanes' per-shard slices (the
            # (nbins+1, P, P) stack would otherwise sit on the first card
            # beside that card's own rows: 6.4 GB at 10,000 pulsars)
            self._stat_weights = self._stat_weights.cpu()
            self._full = dataclasses.replace(self._full,
                                             weights=self._stat_weights)

    @property
    def include(self) -> Tuple[bool, ...]:
        return self._include

    @property
    def static_reservation_bytes(self) -> Optional[int]:
        """The fixed device bytes beside the per-device chunk model, now:
        the cuBLAS and cuBLASLt workspaces present on the card of this
        simulator's mesh that holds the most
        (:func:`..obs.memwatch.library_workspace_bytes`; one set per
        (thread, stream) that ran a product in this process, this
        simulator's own tensors excluded), where the JAX engine reads its
        compiled program's reservation; None on a host mesh, or where the
        workspace sizes could not be measured."""
        terms = self._workspace_terms()
        if not terms or None in terms.values():
            return None
        return max(terms.values())

    def _workspace_terms(self, *extra, device_allocs=None) -> dict:
        """The library workspaces by card index
        (:class:`..obs.memwatch.WorkspaceTerm`), excluding this simulator's
        tensors and those reachable from ``extra`` (a run's lanes and
        outputs); empty on a host mesh."""
        return self._workspaces.read(
            lambda: memwatch.device_tensor_ptrs(
                (self.batch, self._full, self._shards, self._stat_weights,
                 self._counts, self._mega_tables, extra)),
            device_allocs)

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

    def _resolve_signals(self, batch, host, include, cgw, roemer,
                         roemer_sample, ephem, cgw_sample, toas_abs, pdist,
                         waveform) -> _Signals:
        """Validate the signal options with the JAX engine's rules and
        messages and build the whole array's signal state."""
        det = (_build_deterministic(batch, host, cgw, roemer, ephem,
                                    toas_abs, pdist, waveform=waveform)
               if "det" in include else None)
        dtype, dev, shape = batch.dtype, self.device, batch.t_own.shape

        def put(x):
            return torch.tensor(np.asarray(x, dtype=np.float64)).to(
                dtype).to(dev)

        # a body whose scales are all zero has nothing to sample
        active = [(cfg, [cfg.s_mass, cfg.s_Om, cfg.s_omega, cfg.s_inc,
                         cfg.s_a, cfg.s_e, cfg.s_l0])
                  for cfg in _as_config_list(roemer_sample)]
        active = [(cfg, sc) for cfg, sc in active if any(x != 0.0
                                                         for x in sc)]
        roe = ()
        if active:
            toas64 = _validated_toas_abs(shape, toas_abs, "roemer_sample")
            ephem = Ephemeris() if ephem is None else ephem
            roe = tuple(
                (roemer_model.nominal_state(ephem, cfg.planet, toas64,
                                            dtype=dtype, device=dev),
                 put(sc), tuple(x == 0.0 for x in sc))
                for cfg, sc in active)

        cgw_cfgs = _as_config_list(cgw_sample)
        statics, ranges = [], []
        for c in cgw_cfgs:
            mode = "dist" if c.log10_dist is not None else "h"
            amp = c.log10_dist if mode == "dist" else c.log10_h
            if amp is None:
                raise ValueError("CGWSampling needs a log10_h or log10_dist "
                                 "amplitude range")
            names = ("costheta", "phi", "cosinc", "log10_mc", "log10_fgw",
                     "log10_dist" if mode == "dist" else "log10_h",
                     "phase0", "psi")
            dists = _resolve_dists(c.dist, names, "CGWSampling")
            if c.sample_pdist and not c.psrterm:
                raise ValueError("CGWSampling(sample_pdist=True) needs "
                                 "psrterm=True (the distance nuisance only "
                                 "enters through the pulsar term)")
            if c.sample_pdist and (pdist is None
                                   or not np.any(np.asarray(pdist)[..., -1])):
                warnings.warn("CGWSampling(sample_pdist=True) with all-zero "
                              "pdist sigmas draws a nuisance that cannot move "
                              "anything; pass pdist=(mean, sigma) pairs",
                              stacklevel=3)
            statics.append((bool(c.psrterm), mode, dists,
                            bool(c.sample_pdist)))
            ranges.append([list(c.costheta), list(c.phi), list(c.cosinc),
                           list(c.log10_mc), list(c.log10_fgw), list(amp),
                           list(c.phase0), list(c.psi)])
        cgw_state = ()
        if cgw_cfgs:
            toas64 = _validated_toas_abs(shape, toas_abs, "cgw_sample")
            cgw_state = tuple((st, put(rg), put(toas64 - c.tref))
                              for st, rg, c in zip(statics, ranges,
                                                   cgw_cfgs))
        # the psrterm configs' indices, and the distances and positions at
        # host precision for their retarded-phase bulks
        self._cgw_psrterm = tuple(j for j, st in enumerate(statics) if st[0])
        self._pdist_host = np.asarray(
            np.zeros((batch.npsr, 2)) if pdist is None else pdist,
            dtype=np.float64).reshape(batch.npsr, 2)
        self._pos64 = np.asarray(host["pos"], dtype=np.float64)
        return _Signals(det=det, roemer=roe, cgw=cgw_state,
                        pdist=put(self._pdist_host))

    def _host_cgw_bulks(self, keys: torch.Tensor) -> tuple:
        """Per-chunk host-f64 retarded-phase bulks of the psrterm CGW
        configs: one (R, npsr) batch-dtype CPU tensor per config (an empty
        tuple when there is none).

        Replays the device draw chain (0xC6 tag, config index, global
        pulsar folds) on the CPU with the same threefry, so the host sees
        the sampled sky, frequency and distance nuisances the device will
        draw, then evaluates each realization's pulsar-term phase
        ``dph(-tau)`` at float64 and reduces it mod 2pi
        (:func:`..models.cgw.psrterm_phase_bulk`).
        """
        if not self._cgw_psrterm:
            return ()
        keys = keys.cpu()
        npsr = self.batch.npsr
        gidx = torch.arange(npsr, dtype=torch.int64)
        pos, pdist = self._pos64, self._pdist_host
        out = []
        for j in self._cgw_psrterm:
            static, ranges, _ = self._full.signals.cgw[j]
            v, pd = _cgw_draws(keys, ranges.cpu(), static, j, gidx)
            v = v.double().numpy()
            pd = (np.zeros((keys.shape[0], npsr)) if pd is None
                  else pd.double().numpy())
            # cos(mu) at f64 from the sampled sky (the geometry of
            # models.cgw.antenna_pattern)
            sin_t = np.sqrt(np.maximum(1.0 - v[:, 0] ** 2, 0.0))
            cosmu = (sin_t[:, None] * np.cos(v[:, 1])[:, None]
                     * pos[None, :, 0]
                     + sin_t[:, None] * np.sin(v[:, 1])[:, None]
                     * pos[None, :, 1]
                     + v[:, 0][:, None] * pos[None, :, 2])
            dist_sec = ((pdist[None, :, 0] + pdist[None, :, 1] * pd)
                        * const.kpc / const.c)
            tau = dist_sec * (1.0 - cosmu)
            bulk = cgw_model.psrterm_phase_bulk(tau, v[:, 3][:, None],
                                                v[:, 4][:, None])
            out.append(torch.from_numpy(bulk).to(self.batch.dtype))
        return tuple(out)

    def _build_shards(self):
        """Per real row, its shard states in (psr, toa) order (psr index
        major: the psr shards of toa window t are ``row[t::n_toa]``) and
        its collectives (:class:`_RowComms`); a (psr index, toa index,
        device) cell is built once however often the mesh repeats it. On a
        multi-process mesh a rank builds only the entries it owns (None
        for the others)."""
        n_psr, n_toa = self.mesh.shape[PSR_AXIS], self.mesh.shape[TOA_AXIS]
        p_local = self.batch.npsr // n_psr
        t_local = self.batch.max_toa // n_toa
        made, grid, comms = {}, [], []
        for r in range(self.mesh.shape[REAL_AXIS]):
            row = []
            for s in range(n_psr):
                for t in range(n_toa):
                    dev = self.mesh.devices[r, s, t]
                    if not self.mesh.owns((r, s, t)):
                        row.append(None)
                        continue
                    if (s, t, dev) not in made:
                        made[(s, t, dev)] = self._make_shard(
                            s, t, p_local, t_local, dev)
                    row.append(made[(s, t, dev)])
            grid.append(row)
            comms.append(_RowComms(self.mesh, r))
        self._comms = comms
        return grid

    def _make_shard(self, s: int, t: int, p_local: int, t_local: int,
                    dev: torch.device) -> _Shard:
        full = self._full
        T = full.batch.max_toa
        if (p_local == full.batch.npsr and t_local == T
                and dev == self.device):
            return full
        lo, t_lo = s * p_local, t * t_local
        win = None if t_local == T else t_local

        def rows(x, dim=0):
            return x.narrow(dim, lo, p_local).contiguous().to(dev)

        def field(name):
            x = getattr(full.batch, name)
            if name == "tspan_common":
                return x.to(dev)
            if win is not None and name in _BATCH_TOA_FIELDS:
                return _window(x, lo, p_local, t_lo, win, dev)
            if win is not None and name == "sys_mask":
                return x.narrow(0, lo, p_local).narrow(
                    2, t_lo, win).contiguous().to(dev)
            return rows(x)

        def tables(x):
            """(n, P, T) megakernel tables: the shard's rows and window"""
            x = x.narrow(2, t_lo, t_local)
            return x.narrow(1, lo, p_local).contiguous().to(dev), \
                x.contiguous().to(dev)

        batch = PulsarBatch(**{f.name: field(f.name)
                               for f in dataclasses.fields(PulsarBatch)})
        chols = tuple(c.to(dev) for c in full.chols)
        ws = tuple(w.to(dev) for w in full.gwb_ws)
        terms = _stage_terms(batch, ws, self._gwb_idx, self._gwb_freqf,
                             self._include, self._bases_bf16)
        times, times_full = tables(full.times)
        scales, scales_full = tables(full.scales)
        ecorr_window = None
        if win is not None:
            # the global epoch ids this window's ECORR TOAs use
            live = batch.ecorr_amp > 0.0
            ids = batch.epoch_idx[live]
            ecorr_window = ((int(ids.min()), int(ids.max() - ids.min()) + 1)
                            if ids.numel() else (0, 1))
        return _Shard(lo, batch, chols, ws, terms, rows(full.weights, 1),
                      times, scales, times_full, scales_full,
                      full.hyper.rows(lo, p_local, dev, t_lo, win),
                      full.signals.rows(lo, p_local, dev, t_lo, win),
                      t_offset=t_lo, ecorr_window=ecorr_window)

    def _build_mega_tables(self):
        """``(stages, stages_null, times (2, P, T), scales (S, P, T))``
        for the megakernel: stage descriptors in ``_simulate_block``'s GP
        stage order and GWB basis-group dedup, the null stream's without the
        GWB stages (its coefficients carry no common signal); scale rows
        carry the TOA mask."""
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
        stages_null = tuple(stages)     # the 0xD7 stream has no GWB stage
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
        return (tuple(stages), stages_null, times,
                torch.stack(rows).contiguous())

    def _resolve_precision(self, path: str, precision) -> str:
        """The run's statistic precision: ``precision``, or the path's
        default (einsum: ``stats_dtype``; fused: ``pallas_precision``;
        mega: 'f32')."""
        if precision is None:
            if path == "einsum":
                return "bf16" if self._stats_bf16 else "f32"
            return self.pallas_precision if path == "fused" else "f32"
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got "
                             f"{precision!r}")
        return precision

    def _residuals(self, keys, split_gp=False, shard: Optional[_Shard] = None,
                   bulks: Optional[tuple] = None, null: bool = False):
        """One shard's residual rows (default: the whole array on the
        mesh's first device).

        The terms add in the JAX engine's frozen order: the noise block,
        the deterministic block, the sampled Roemer bodies, the sampled CGW
        sources, each sampled term masked to the valid TOAs. Under
        ``split_gp`` they go into the base, so the GP projection lands last
        (in the megakernel). ``bulks``: the psrterm CGW configs' (R, npsr)
        host bulks (:meth:`_host_cgw_bulks`; computed from ``keys`` when
        not given). ``null=True`` is the OS lane's paired noise-only stream
        (``keys`` are then the 0xD7-folded ones): the same noise stages,
        sampled noise and white nuisances and sampled Roemer terms, without
        the GWB, the deterministic block and the sampled CGW sources.
        """
        sh = self._full if shard is None else shard
        include = self._include[:6] + (False,) if null else self._include
        out = _simulate_block(keys, sh.batch, sh.chols, sh.gwb_ws,
                              include, sh.terms, split_gp=split_gp,
                              p_offset=sh.p_offset, hyper=sh.hyper,
                              t_offset=sh.t_offset,
                              ecorr_window=sh.ecorr_window)
        sig = sh.signals
        det = None if null else sig.det
        cgw = () if null else sig.cgw
        if det is None and not sig.roemer and not cgw:
            return out
        res, coefs = out if split_gp else (out, None)
        mask, pos = sh.batch.mask, sh.batch.pos
        if det is not None:
            res = res + det
        for j, (state, scales, zero) in enumerate(sig.roemer):
            term = _sampled_roemer(keys, state, scales, zero, pos, j)
            res = res + torch.where(mask, term, 0.0)
        if cgw:
            if bulks is None:
                bulks = self._host_cgw_bulks(keys)
            p, dev = sh.batch.npsr, keys.device
            by_cfg = {j: b[:, sh.p_offset:sh.p_offset + p].to(dev)
                      for j, b in zip(self._cgw_psrterm, bulks)}
            gidx = torch.arange(sh.p_offset, sh.p_offset + p,
                                dtype=torch.int64, device=dev)
            for j, (static, ranges, t_rel) in enumerate(cgw):
                term = _sampled_cgw(keys, t_rel, pos, sig.pdist, ranges,
                                    static, j, gidx, bulk=by_cfg.get(j))
                res = res + torch.where(mask, term, 0.0)
        return (res, coefs) if split_gp else res

    def _fused_kernel(self):
        return (binned_corr_ops.binned_correlation if self.pallas_mxu_binning
                else binned_corr_ops.binned_correlation_vpu)

    def _prepare_lanes(self, os, lnlike=None):
        """The run's packed statistic lane, or None: the OS lane
        (``run(os=...)``: the host-f64 operators of
        :func:`..detect.operators.build_operators` on the batch's
        positions, mask, white variances and full pair counts, and every
        shard's rows of the two weight stacks) or the likelihood lane
        (``run(lnlike=...)``, :meth:`_prepare_lnlike`), staged once per
        run. A run carries one of the two."""
        if lnlike is not None:
            if os is not None:
                raise ValueError(
                    "run(os=..., lnlike=...) cannot combine the detection "
                    "and likelihood lanes in one run (one packed-extras "
                    "layout per run); run them separately")
            return self._prepare_lnlike(lnlike)
        if os is None:
            return None
        from ..detect import operators as detect_ops
        spec = detect_ops.as_spec(os)
        host = self.batch.numpy()
        ops = detect_ops.build_operators(spec, self._pos64, host["mask"],
                                         host["sigma2"],
                                         pair_counts=self.pair_counts)
        w_os = torch.tensor(np.stack([op.weights for op in ops])).to(
            self.batch.dtype).to(self._stat_weights.device)
        nb = self.nbins
        main = torch.cat([self._stat_weights[:nb], w_os,
                          self._stat_weights[nb:]])
        null = (torch.cat([w_os, torch.zeros_like(w_os[:1])])
                if spec.null else None)
        weights = {}
        for row in self._shards:
            for sh in filter(None, row):
                weights[id(sh)] = tuple(
                    None if w is None else w.narrow(
                        1, sh.p_offset, sh.batch.npsr).contiguous().to(
                            sh.device)
                    for w in (main, null))
        return _OSLanes(spec, ops, len(ops), bool(spec.null), weights)

    def _prepare_lnlike(self, lnlike) -> _LnlLanes:
        """The likelihood lane's per-run state (:class:`_LnlLanes`): the
        compiled model (cached per model), and per psr shard its cells'
        bases and ECORR epoch tables and the finished fixed moments, whose
        parts are plain TOA sums added over the shard's toa cells in toa
        order before the (nonlinear) ECORR downdate, as the JAX lane adds
        them over 'toa'. The ECORR blocks enter the model when the ECORR
        stage is live."""
        from ..infer import model as infer_model
        from ..ops import woodbury

        spec = infer_model.as_spec(lnlike)
        compiled = self._lnl_compiled.get(spec.model)
        if compiled is None:
            compiled = infer_model.build(spec.model, self.batch)
            self._lnl_compiled[spec.model] = compiled
        theta = compiled.validate_theta(spec.theta)
        num_ep = self.batch.max_toa if self._include[1] else 0
        n_toa = self.mesh.shape[TOA_AXIS]
        cells, heads, seen = {}, {}, set()
        with span("lnlike_moments"):
            for r, (row, comms) in enumerate(zip(self._shards,
                                                 self._comms)):
                for i in range(0, len(row), n_toa):
                    group = row[i:i + n_toa]
                    head = group[0]
                    # a group the mesh repeats (the same cells on the same
                    # devices) is finished once, decided alike on every rank
                    s = i // n_toa
                    key = (s, tuple(zip(self.mesh.ranks[r, s],
                                        self.mesh.devices[r, s])))
                    if key in seen or not any(group):
                        continue
                    seen.add(key)
                    parts = []
                    for sh in group:
                        if sh is None:
                            parts.append(None)
                            continue
                        b = sh.batch
                        if id(sh) not in cells:
                            cells[id(sh)] = (
                                compiled.basis(b),
                                woodbury.epoch_onehot(b.epoch_idx, num_ep,
                                                      b.dtype)
                                if num_ep else None)
                        tmat, onehot = cells[id(sh)]
                        parts.append(woodbury.fixed_parts(
                            tmat, b.sigma2, b.mask, b.epoch_idx,
                            b.ecorr_amp, num_epochs=num_ep, onehot=onehot))
                    total = _sum_parts(parts, comms.toa[i // n_toa])
                    if head is None:
                        continue    # another rank's head finishes them
                    th = torch.from_numpy(theta).to(self.batch.dtype).to(
                        head.device)
                    heads[id(head)] = (th, woodbury.finish_fixed(
                        {k: v.to(head.device) for k, v in total.items()}))
        return _LnlLanes(spec, compiled, theta, theta.shape[0],
                         infer_model.lanes_per_point(spec.mode, compiled.D),
                         num_ep, cells, heads)

    def _lane_residuals(self, sh: _Shard, res, path: str):
        """A shard's full residual rows for the likelihood lane. On the
        mega path the statistic reads the split (base, coefficients); the
        lane projects the same coefficients through the dense basis
        (:func:`..ops.megakernel.dense_basis`, a plain product), so no draw
        runs twice."""
        if path != "mega":
            return res
        base, coefs = res
        with span("gp_project"):
            basis = mega_ops.dense_basis(sh.times, sh.scales,
                                         self._mega_tables[0])
            with mega_ops.full_f32():
                proj = torch.einsum("ptk,rpk->rpt", basis, coefs)
            return base + torch.where(sh.batch.mask, proj, 0.0)

    def _lnlike_partial(self, lanes: _LnlLanes, group, res,
                        comm) -> Optional[torch.Tensor]:
        """(R, K*L) likelihood lanes of one psr shard's pulsars, on its
        head cell's device: the residual moment parts of its toa cells
        (``group``, with their residual windows ``res``), added in toa
        order over ``comm``, then per theta point the rank-2M
        factorization and the batched solves; ``grad`` and ``fisher``
        lanes are forward-mode derivatives over the D parameters (theta
        enters only through phi, so the data-side moments are shared).
        None on a rank that owns no cell of the group, or not its head."""
        from ..ops import woodbury

        if not any(sh is not None for sh in group):
            return None
        with span("lnlike_moments"):
            parts = []
            for sh, r in zip(group, res):
                if sh is None:
                    parts.append(None)
                    continue
                tmat, onehot = lanes.cells[id(sh)]
                b = sh.batch
                parts.append(woodbury.res_parts(
                    r, tmat, b.sigma2, b.mask, b.epoch_idx, b.ecorr_amp,
                    num_epochs=lanes.num_epochs, onehot=onehot))
            total = _sum_parts(parts, comm)
            head = group[0]
            if head is None:
                return None
            th, (M, lndetN, nv, corr) = lanes.heads[id(head)]
            d0, dT = woodbury.finish_res(
                {k: v.to(head.device) for k, v in total.items()}, corr)
        moments = (M, lndetN, nv, d0, dT)
        with span("lnlike"):
            points = [_lnl_point(lanes.compiled, lanes.spec.mode, t, moments,
                                 head.batch, head.p_offset) for t in th]
        return torch.stack(points, dim=1).reshape(d0.shape[0], -1)

    def _lane_weights(self, sh: _Shard, lanes):
        """(the main launch's weight rows, the null stream's or None) of a
        shard: its statistic weights when the run has no OS lane."""
        if not isinstance(lanes, _OSLanes):
            return sh.weights, None
        return lanes.weights[id(sh)]

    def _pack(self, curves, autos, *after):
        """Packed lanes: the bins, the auto, the OS slots that ride after
        the bins in ``curves`` (when any), then the given lanes (the null
        stream's or the likelihood's; None entries are skipped)."""
        nb = self.nbins
        extras = [curves[:, nb:]] if curves.shape[1] > nb else []
        extras += [a for a in after if a is not None]
        return pack_stats(curves[:, :nb], autos, *extras)

    def step(self, base_key: torch.Tensor, offset, nreal: int,
             path: str, precision: str, with_corr: bool = False,
             bulks: Optional[tuple] = None, lanes=None):
        """One chunk: (packed (nreal, nbins + 1 + n_extra) statistics, corr
        or None), on this rank's first device. ``nreal`` splits into one
        contiguous block of realizations per real shard. ``base_key`` /
        ``offset`` are a key and an int, or lane vectors
        (:func:`_chunk_keys`). ``bulks``: the chunk's psrterm CGW bulks,
        precomputed on the host (:meth:`_host_cgw_bulks`; each shard
        computes its own when not given). ``lanes``: the run's packed lane
        (:meth:`_prepare_lanes`): the OS lane, whose amp2 values and then
        the null stream's pack after the auto, or the likelihood lane,
        whose K*L values do. On a multi-process mesh a rank steps only the
        rows it has entries in, and the rows' results are gathered across
        ranks, so every rank returns the whole chunk."""
        n_real = len(self._shards)
        if nreal % n_real != 0:
            raise ValueError(f"nreal per chunk ({nreal}) must be divisible "
                             f"by the real mesh axis ({n_real})")
        with span("keys"):
            keys = _chunk_keys(base_key, offset, nreal)
        r_local = nreal // n_real
        packed, corrs = [], []
        for r, shards in enumerate(self._shards):
            if not any(sh is not None for sh in shards):
                packed.append(None)     # another rank's row
                corrs.append(None)
                continue
            k = keys[r * r_local:(r + 1) * r_local]
            b = None if bulks is None else tuple(
                x[r * r_local:(r + 1) * r_local] for x in bulks)
            if len(shards) == 1:
                p, c = self._step_shared(r, shards[0],
                                         k.to(shards[0].device), path,
                                         precision, with_corr, b, lanes)
            else:
                p, c = self._step_sharded(r, shards, k, path, precision,
                                          with_corr, b, lanes)
            packed.append(None if p is None else p.to(self.device))
            corrs.append(c.to(self.device) if with_corr and c is not None
                         else None)
        if not self.mesh.multiprocess:
            return _cat(packed), (_cat(corrs) if with_corr else None)
        with span("gather_real"):
            width = self.nbins + 1 + (0 if lanes is None else lanes.n_extra)
            out = self.mesh.gather_real(packed, (r_local, width),
                                        self.batch.dtype, self.device)
            corr = None
            if with_corr:
                P = self.batch.npsr
                corr = self.mesh.gather_real(corrs, (r_local, P, P),
                                             self.batch.dtype, self.device)
        return out, corr

    def _step_shared(self, r: int, sh: _Shard, keys, path: str,
                     precision: str, with_corr: bool,
                     bulks: Optional[tuple] = None, lanes=None):
        """Real row ``r``'s one shard, holding every pulsar: one operand
        set."""
        split = path == "mega"
        w, w_null = self._lane_weights(sh, lanes)
        with span("residuals"):
            res = self._residuals(keys, split_gp=split, shard=sh,
                                  bulks=bulks)
        with span("statistic"):
            curves, autos, corr = self._shared_statistic(
                sh, res, path, precision, w, w.shape[0] - 1,
                self._mega_tables[0])
        lnl = None
        if isinstance(lanes, _LnlLanes):
            lnl = self._lnlike_partial(
                lanes, [sh], [self._lane_residuals(sh, res, path)],
                self._comms[r].toa[0])
        del res     # the null stream's residuals may take its memory
        null = None
        if w_null is not None:
            with span("null"):
                res0 = self._residuals(rng.fold_in(keys, _NULL_TAG),
                                       split_gp=split, shard=sh, null=True)
                null, _, _ = self._shared_statistic(
                    sh, res0, path, precision, w_null, lanes.n_os,
                    self._mega_stages_null)
        return (self._pack(curves, autos, null, lnl),
                corr / self._counts.to(corr.device) if with_corr else None)

    def _shared_statistic(self, sh: _Shard, res, path: str, precision: str,
                          weights, nb: int, stages):
        """(curves (R, nb), autos (R,), raw pair sums on the einsum path
        else None) of one operand set against ``weights`` (nb + 1 slots,
        the auto last), on ``stages`` on the mega path."""
        if path == "einsum":
            corr = _correlation_rows(res, stats_bf16=precision == "bf16")
            return (*_bin(corr, weights, nb), corr)
        if path == "fused":
            curves, autos = self._fused_kernel()(res, res, weights, nb,
                                                 precision=precision)
            return curves, autos, None
        base, coefs = res
        if precision == "bf16":
            # bf16 STORAGE of the kernel's two big reads; the projection
            # and every accumulation stay f32 inside the kernel
            base = base.to(torch.bfloat16)
            coefs = coefs.to(torch.bfloat16)
        curves, autos = mega_ops.chunk_stats(
            base, coefs, sh.times, sh.scales, weights, stages=stages,
            nbins=nb, precision=precision)
        return curves, autos, None

    def _step_sharded(self, r: int, shards, keys, path: str, precision: str,
                      with_corr: bool, bulks: Optional[tuple] = None,
                      lanes=None):
        """Sharded chunk block of real row ``r``: each shard's rows against
        the all-gathered array with its rows of the weights, then the psum
        of the partial statistics in shard order (toa cells: their window's
        pair sums, added over the windows first). The likelihood lane's
        partials are per psr shard (its cells' moment parts added over the
        windows first) and are psum'ed in shard order too. ``shards``
        holds None for another rank's entries; the packed result is None
        on a rank that holds no psr shard's head."""
        comms = self._comms[r]
        n_toa = self.mesh.shape[TOA_AXIS]
        split = path == "mega"
        ws = _some(lambda sh: self._lane_weights(sh, lanes), shards)
        nb = next(w for w in ws if w is not None)[0].shape[0] - 1
        with span("residuals"):
            local = _some(lambda sh: self._residuals(
                keys.to(sh.device), split_gp=split, shard=sh, bulks=bulks),
                shards)
        with span("statistic"):
            out, corr = self._sharded_statistic(
                comms, shards, local, path, precision, with_corr,
                [None if w is None else w[0] for w in ws], nb,
                self._mega_tables[0])
        lnl = None
        if isinstance(lanes, _LnlLanes):
            lnl = comms.heads.psum([self._lnlike_partial(
                lanes, shards[i:i + n_toa],
                _some(lambda sh, x: self._lane_residuals(sh, x, path),
                      shards[i:i + n_toa], local[i:i + n_toa]),
                comms.toa[i // n_toa])
                for i in range(0, len(shards), n_toa)])
        del local   # the null stream's residuals may take its memory
        null = None
        if lanes is not None and getattr(lanes, "null", False):
            with span("null"):
                nkeys = rng.fold_in(keys, _NULL_TAG)
                local0 = _some(lambda sh: self._residuals(
                    nkeys.to(sh.device), split_gp=split, shard=sh,
                    null=True), shards)
                null, _ = self._sharded_statistic(
                    comms, shards, local0, path, precision, False,
                    [None if w is None else w[1] for w in ws], lanes.n_os,
                    self._mega_stages_null)
                null = None if null is None else null[:, :lanes.n_os]
        if out is None:
            return None, None
        return self._pack(out[:, :nb], out[:, nb], null, lnl), corr

    def _sharded_statistic(self, comms: _RowComms, shards, local, path: str,
                           precision: str, with_corr: bool, weights,
                           nb: int, stages):
        """The shards' partial statistics from their residual rows
        (``local``) against their rows of ``weights`` (nb + 1 slots, the
        auto last), psum'ed over the row (``comms``): ((R, nb + 1), the
        normalized pair correlations or None), both None on a rank that
        holds no psr shard's head."""
        bf16 = precision == "bf16"
        if path == "mega":
            if bf16:
                # cast per shard BEFORE the gather, as the JAX engine does
                local = _some(lambda x: (x[0].to(torch.bfloat16),
                                         x[1].to(torch.bfloat16)), local)
            base_f = comms.row.all_gather(
                [None if x is None else x[0] for x in local])
            coef_f = comms.row.all_gather(
                [None if x is None else x[1] for x in local])
            parts = _some(lambda sh, x, bf, cf, w: pack_stats(
                *mega_ops.chunk_stats(
                    bf, cf, sh.times_full, sh.scales_full, w, stages=stages,
                    nbins=nb, precision=precision, base_local=x[0],
                    coef_local=x[1], times_local=sh.times,
                    scales_local=sh.scales)),
                shards, local, base_f, coef_f, weights)
            return comms.row.psum(parts), None
        if path == "fused":
            full = comms.row.all_gather(local)
            kernel = self._fused_kernel()
            parts = _some(lambda x, f, w: pack_stats(
                *kernel(x, f, w, nb, precision=precision)),
                local, full, weights)
            return comms.row.psum(parts), None
        # einsum: each toa window's psr shards gathered; a psr shard's pair
        # sums are its cells' window sums, added in toa order
        n_toa = self.mesh.shape[TOA_AXIS]
        full = [None] * len(shards)
        for t in range(n_toa):
            idx = range(t, len(shards), n_toa)
            got = comms.psr[t].all_gather([local[i] for i in idx])
            for i, f in zip(idx, got):
                full[i] = f
        corrs = _some(lambda x, f: _correlation_rows(x, f, stats_bf16=bf16),
                      local, full)
        heads = range(0, len(shards), n_toa)
        rows = [comms.toa[i // n_toa].psum(corrs[i:i + n_toa])
                if any(c is not None for c in corrs[i:i + n_toa]) else None
                for i in heads]
        # a head's owner bins its psr shard's pair sums
        parts = [None if shards[i] is None else
                 pack_stats(*_bin(c.to(shards[i].device), weights[i], nb))
                 for c, i in zip(rows, heads)]
        out = comms.heads.psum(parts)
        if out is None:
            return None, None
        corr = None
        if with_corr:
            dev0 = out.device
            full_rows = comms.heads.all_gather(
                [None if shards[i] is None else rows[k]
                 for k, i in enumerate(heads)])
            got = next(f for f in full_rows if f is not None)
            corr = got.to(dev0) / self._counts.to(dev0)
        return out, corr

    def _normalize_chunk(self, chunk: int, nreal: int) -> int:
        """Clamp the chunk to ``nreal`` and round it down to a multiple of
        the real mesh axis (at least one realization per real shard)."""
        n_real = len(self._shards)
        chunk = max(1, min(int(chunk), nreal))
        return max(chunk - chunk % n_real, n_real)

    def _base_key(self, seed) -> torch.Tensor:
        """``key(seed)`` on the mesh's first device; ``seed`` must be an
        integer."""
        if not isinstance(seed, (int, np.integer)):
            raise TypeError(f"seed must be an integer, got "
                            f"{type(seed).__name__}")
        return rng.key(int(seed), device=self.device)

    def model_bytes_per_chunk(self, chunk: int, path: Optional[str] = None,
                              precision: Optional[str] = None) -> int:
        """Analytic device-memory bytes of one chunk's statistic dataflow,
        :func:`..ops.megakernel.chunk_bytes_model` (the JAX package's model;
        the einsum path is its ``'xla'`` mode)."""
        path = path or self.stat_path
        prec = self._resolve_precision(path, precision)
        mode = {"einsum": "xla", "fused": "fused"}.get(
            path, "mega_bf16" if prec == "bf16" else "mega")
        return mega_ops.chunk_bytes_model(
            self._normalize_chunk(chunk, chunk), self.batch.npsr,
            self.batch.max_toa, mega_ops.stage_k(self._mega_tables[0]),
            mode=mode, psr_shards=self.mesh.shape[PSR_AXIS],
            dtype_bytes=self.batch.dtype.itemsize)

    def dispatch_surface(self) -> dict:
        """The problem-shaped identity and model inputs of this
        simulator's chunks: what the tuner (:mod:`..tune`) keys its store
        on and feeds its models. Knob-free: pulsar/TOA/bin counts, the GP
        coefficient width ``k_coef`` (the mega stage table's ``stage_k``,
        the width ``chunk_bytes_model`` prices) and the batch dtype; the
        JAX engine's dict for the same batch. Two simulators with equal
        surfaces share one TunedConfig family whatever their mesh, path or
        precision."""
        return {"npsr": int(self.batch.npsr),
                "max_toa": int(self.batch.max_toa),
                "nbins": int(self.nbins),
                "k_coef": int(mega_ops.stage_k(self._mega_tables[0])),
                "dtype": str(self.batch.dtype).replace("torch.", ""),
                "dtype_bytes": int(self.batch.dtype.itemsize)}

    def _chunk_flops(self, chunk: int, path: str, n_os: int,
                     null: bool) -> float:
        """The projection's and the statistic's FLOPs of one chunk, counted
        as ``chip_smoke.py::bound`` counts a kernel's: per psr shard the
        correlation's pairs (the P (P + 1) / 2 distinct ones on the shared
        set), their binning into the weight slots and the GP projection
        2 R rows K T (on a psr-sharded mega mesh each shard projects its
        local and full rows); the null stream adds its own pass at its
        slots and the GWB-free K."""
        P, T = self.batch.npsr, self.batch.max_toa
        S = self.mesh.shape[PSR_AXIS]
        pairs = P * (P + 1) / 2 if S == 1 else float(P * P)
        rows = S * (P // S + P) if path == "mega" and S > 1 else P

        def one(nb: int, k: int) -> float:
            return 2.0 * chunk * (pairs * T + nb * pairs + rows * k * T)

        flops = one(self.nbins + 1 + n_os,
                    mega_ops.stage_k(self._mega_tables[0]))
        if null:
            flops += one(n_os + 1, mega_ops.stage_k(self._mega_stages_null))
        return flops

    def chunk_cost(self, chunk: int, *, os=None, lnlike=None,
                   keep_corr: bool = False, precision=None) -> dict:
        """The analytic cost of ONE chunk, without running it: torch has
        no compiler cost analysis, so where the JAX engine reads XLA's,
        this returns ``{"bytes_per_chunk": model_bytes_per_chunk(...),
        "flops_per_chunk": ...}`` (:meth:`_chunk_flops`: the projection
        and the statistic, with the OS lane's slots and its null stream;
        the likelihood lane's factorizations are not counted), memoized
        per (chunk, path, precision, lane) (:meth:`clear_executables` drops
        the memo), and on a card :attr:`static_reservation_bytes` as it
        stands at the call."""
        chunk = self._normalize_chunk(chunk, chunk)
        path = "einsum" if keep_corr else self.stat_path
        prec = self._resolve_precision(path, precision)
        lane, n_os, null = None, 0, False
        if os is not None:
            if lnlike is not None:
                raise ValueError("chunk_cost(os=..., lnlike=...): a run "
                                 "carries one of the two lanes")
            from ..detect import operators as detect_ops
            spec = detect_ops.as_spec(os)
            n_os, null = len(spec.orfs), bool(spec.null)
            lane = ("os", n_os, null)
        elif lnlike is not None:
            lane = ("lnlike",)
        key = (chunk, path, prec, lane)
        if key not in self._chunk_costs:
            self._chunk_costs[key] = {
                "bytes_per_chunk": self.model_bytes_per_chunk(chunk, path,
                                                              prec),
                "flops_per_chunk": self._chunk_flops(chunk, path, n_os,
                                                     null)}
        cost = dict(self._chunk_costs[key])
        static = self.static_reservation_bytes
        if static is not None:
            cost["static_reservation_bytes"] = static
        return cost

    def warm_start(self, chunk: int, *, keep_corr: bool = False, os=None,
                   lnlike=None, precision=None, lane_keys: bool = False,
                   ) -> float:
        """Make the first :meth:`run` of this shape start warm; returns the
        seconds spent.

        Builds and loads every kernel library the run will launch
        (:func:`..ops._build.build` / ``load``; none off the card), then
        runs one step at exactly the run's shape (this chunk, lane
        configuration and precision; ``lane_keys=True`` the serve pool's
        RNG-lane form) on a fixed key, synchronizes and discards it: that
        primes the cuBLAS and cuSOLVER handles, the kernel modules' first
        launch and the caching allocator. Its events go to a throwaway
        collector, as the JAX engine's compile capture does, and it touches
        no realization stream, so a later run is bit-identical to a cold
        one. On a multi-process mesh every rank calls it (the step's
        collectives cross ranks)."""
        t0 = now()
        chunk = self._normalize_chunk(chunk, chunk)
        path = "einsum" if keep_corr else self.stat_path
        prec = self._resolve_precision(path, precision)
        with obs_metrics.collect(obs_metrics.Collector()):
            lanes = self._prepare_lanes(os, lnlike)
            cards = {d for d in self.mesh.local_devices if d.type == "cuda"}
            libs = {"einsum": (), "fused": ("binned_corr",),
                    "mega": ("megakernel", "binned_corr")}[path]
            if cards and libs:
                from ..ops import _build
                _build.build(libs)
                for name in libs:
                    _build.load(name)
            if lane_keys:
                base = torch.zeros((chunk,), dtype=torch.int64,
                                   device=self.device)
                offset = torch.arange(chunk, dtype=torch.int64,
                                      device=self.device)
            else:
                base, offset = self._base_key(0), 0
            self.step(base, offset, chunk, path, prec, with_corr=keep_corr,
                      lanes=lanes)
            for dev in cards:
                torch.cuda.synchronize(dev)
        return now() - t0

    def clear_executables(self) -> None:
        """Drop every derived per-simulator memo: the likelihood lane's
        compiled models and :meth:`chunk_cost`'s memo (the serve pool's
        hook for a simulator whose outputs went non-finite). The kernel
        libraries are process-wide and stay loaded; a sticky CUDA error
        (an illegal address, a device-side assert) leaves the context
        unusable and stays fatal. Host-staged data is input, not derived
        state, and stays."""
        self._lnl_compiled.clear()
        self._chunk_costs.clear()
        flightrec.note("executables_cleared")

    def _path_refusal(self, path: str) -> Optional[str]:
        """Why the constructor would refuse ``stat_path=path`` on this
        simulator (None when it would take it): a tuned path meets the
        constructor's own rules (:func:`_check_path`) before a run takes
        it."""
        try:
            _check_path(path, toa_shards=self.mesh.shape[TOA_AXIS],
                        dtype=self.batch.dtype, stats_bf16=self._stats_bf16,
                        bases_bf16=self._bases_bf16)
        except (TypeError, ValueError) as exc:
            return str(exc)
        return None

    def _tuned_knobs(self, tuned, keep_corr: bool):
        """``run(tuned=...)``'s knobs and the path it may take: ``(knobs
        or None, tuned path or None)``. ``tuned`` is True (the store's
        entry for this simulator's devices and family; a miss is noted,
        not an error), a knob dict or a TunedConfig. A JAX-package path of
        ``"xla"`` is the port's ``"einsum"``; a path this simulator's
        constructor would refuse (a kernel path on a toa-sharded mesh, for
        one) is ignored with a ``tune_path_illegal`` note."""
        if isinstance(tuned, dict):
            knobs = dict(tuned)
        elif hasattr(tuned, "knobs"):
            knobs = dict(tuned.knobs)
        else:
            from .. import tune as tune_mod
            cfg = tune_mod.resolve_for_sim(self)
            if cfg is None:
                flightrec.note("tune_miss", npsr=int(self.batch.npsr))
                return None, None
            knobs = dict(cfg.knobs)
        from ..tune.model import JAX_PATH
        path = JAX_PATH.get(knobs.get("path"), knobs.get("path"))
        if path not in STAT_PATHS or keep_corr:
            return knobs, None
        why = self._path_refusal(path)
        if why is not None:
            flightrec.note("tune_path_illegal", path=path, why=why)
            return knobs, None
        return knobs, path

    def run(self, nreal: int, seed=0, chunk: Optional[int] = None,
            keep_corr: bool = False, checkpoint=None,
            progress: Optional[Callable[[int, int], None]] = None,
            os=None, lnlike=None, pipeline_depth: Optional[int] = None,
            precision: Optional[str] = None, eventlog=None, lanes=None,
            recovery=None, tuned=None) -> dict:
        """Run the ensemble in chunks of ``chunk`` realizations.

        Returns numpy ``curves`` (nreal, nbins), ``autos`` (nreal,),
        ``bin_centers`` (nbins,), the ``statistic_path`` and ``precision``
        it ran, ``report`` (a :class:`..obs.report.RunReport`, also
        ``self.last_report``) and, with ``keep_corr`` (which takes the
        einsum path), ``corr`` (nreal, P, P) normalized pair correlations.
        ``chunk`` (default 1024) is clamped to ``nreal`` and rounded down to
        a multiple of the real mesh axis. Every chunk runs at the full chunk
        size (the last one overshoots and is truncated).

        ``pipeline_depth`` (default 2): chunks in flight before the loop
        waits for the oldest one's drain. At depth d > 0 each chunk's
        packed statistics copy to a pinned host buffer on a copy stream
        behind the chunk's last kernel, and one writer thread drains the
        chunks in order (waits for the copy, appends the checkpoint chunk,
        calls ``progress``) while later chunks run; the loop reuses a
        drained chunk's device and host buffers for chunk ``i + d``, so a
        run holds d of each however many chunks it has. Depth 0 is the
        serial loop: it syncs once per chunk only for a checkpoint, a
        ``progress`` callback or ``keep_corr``, else it fetches once at the
        end. The statistics are bit-identical at every depth.

        ``checkpoint``: a path. After every chunk the run appends that
        chunk's outputs to ``<path>.c<k>.npz`` and updates the manifest at
        ``<path>`` (the JAX package's layout). A matching manifest for the
        same (seed, nreal, chunk) resumes the run after its last completed
        chunk, bit-identical to an unbroken run; a torn chunk file rolls
        back to the chunk before it. The files are removed when the run
        completes. Needs an integer seed (``TypeError`` otherwise).

        ``progress``: ``(done, nreal) -> None`` after each chunk, in order
        (on the writer thread when pipelined). An exception it raises ends
        the run and reaches the caller.

        ``lanes``: per-request RNG lanes, ``(seed, n)`` pairs in slot
        order. Slot ``i`` of lane ``(s, n)`` draws from ``fold_in(key(s),
        i)``, the key ``run(n, seed=s)`` gives its realization ``i``; slots
        past the last lane are padding. ``seed`` is then not used for the
        keys, and a checkpoint is refused (``ValueError``).

        The report carries per-chunk records (``wall_s``: the host's
        dispatch time, or the chunk's whole time where ``synced``;
        ``stall_s``: waits of the dispatch loop on the depth bound;
        ``ckpt_wait_s``: the checkpoint append; ``execute_s``: the device
        time between CUDA events recorded before and after the chunk's
        dispatch, read once the chunk's output has landed), the run
        timeline, ``model_bytes_per_chunk``, the allocator's peak over the
        mesh's CUDA devices (``memory["peak_hbm_bytes"]``; the run resets
        each device's peak counter when it starts), the fixed library
        workspaces inside it (``memory["static_reservation_bytes"]``, on
        the peak's card) and the ring
        accounting, whose bound the run asserts before it returns. A run
        that raises dumps the flight recorder beside its checkpoint
        (:mod:`..obs.flightrec`).

        ``os``: the on-device optimal-statistic lane, an ORF name
        (``'hd'``, ``'monopole'``, ``'dipole'``, ``'anisotropic'``), a
        sequence of them or a :class:`..detect.OSSpec` (noise weighting, a
        per-pulsar ``sigma2`` override, ``null=True`` for the paired
        noise-only stream under ``fold_in(key, 0xD7)``). Each realization's
        amp2 per ORF is one more weight slot of the chunk's contraction or
        kernel launch, packed beside the curves; the null stream is a second
        one per chunk. Results land under ``out["os"]`` (schema
        ``fakepta_tpu.detect/1``, :func:`..detect.operators.assemble`):
        per ORF ``amp2``, ``sigma``, ``snr`` and with ``null`` the
        ``null_amp2`` sample, its quantiles and per-realization
        ``p_value``. Every statistic path and mesh takes it; a checkpoint
        records the lane count, so a resume with other lanes is refused.

        ``lnlike``: the GP-marginalized likelihood lane, an
        :class:`..infer.InferSpec` (a :class:`..infer.LikelihoodSpec`, a
        (K, D) theta batch and a mode). Each realization's Woodbury lnL at
        each theta point (and per mode its gradient, or gradient and
        Hessian) is computed from the chunk's residual blocks, beside the
        statistic kernel, and packed after the auto; results land under
        ``out["lnlike"]`` (schema ``fakepta_tpu.infer/1``,
        :func:`..infer.model.assemble`). Every statistic path, psr mesh and
        toa cell takes it; not together with ``os`` (``ValueError``); a
        checkpoint records the lane count, as for the OS lane. The lanes
        are the caller's to read: a non-finite lnL is not a fault.

        ``recovery``: the recovery policy (:class:`..faults.RecoveryPolicy`;
        ``None``, the default, is the default policy, ``False`` disables
        it and every failure propagates; anything else is a
        ``TypeError``). A transient chunk failure (an injected
        ``TransientFault``, a CUDA out-of-memory error, after which the
        allocator's free blocks go back to the card) is retried with
        bounded backoff on the same keys: bit-identical to the unfaulted
        run. A hand-written kernel's launch failure steps the statistic
        path down ``mega -> fused`` at the same precision (on ``fused`` it
        propagates: the einsum path below is the kernels' plain version,
        and a run does not fall back to it), a bf16
        certification failure re-dispatches at ``'f32'``; each step is
        counted (``faults.degradations``), flight-recorded, on the
        timeline, in ``meta`` (``degraded_path`` / ``degraded_precision``)
        and in ``out["statistic_path"]`` / ``out["precision"]``. A kernel
        build failure and a sticky CUDA error (illegal address,
        device-side assert) stay fatal. A failed ring reuse (the
        ``mc.recycle`` site) stops the reuse for the rest of the run and
        withdraws the ring's bound (``meta["degraded_donation"]``).
        ``RecoveryPolicy(watchdog_s=...)`` bounds the wait for the oldest
        in-flight drain and the final flush: a hung drain raises
        :class:`..faults.WatchdogTimeout` with a flight-recorder dump. A
        transient drain failure retries in place. Non-finite curves or
        autos abort loudly before any checkpoint write.

        ``eventlog``: a directory; after the run each process writes its
        report there as ``events-p<process_index:03d>.jsonl``. A
        multi-process run gives one shard per rank; ``python -m
        fakepta_tpu_torch.obs trace <dir>/events-p*.jsonl -o trace.json``
        merges them into one Perfetto timeline with a pid lane per rank.

        A multi-process mesh (:func:`.mesh.initialize_multihost`): every
        rank steps only its own shards, the gathers and psums cross ranks,
        and every rank returns the whole run. The drain is serial (no
        writer thread) whenever more than one process runs; only rank 0
        appends to and deletes the checkpoint (a resume reads the path each
        rank is given: shared storage is the caller's contract, as in the
        JAX engine). Recovery there: a dispatch failure cannot be retried
        or stepped down on one rank alone (the others would wait inside a
        collective), so it raises on the rank that sees it, and the other
        ranks' next collective raises when its connections close or at the
        group's timeout (``initialize_multihost(timeout_s=...)``).

        ``tuned``: the tuner's knobs (:mod:`..tune`): ``True`` takes the
        store's entry for this simulator's devices and spec family
        (``tune.resolve_for_sim``; a miss runs the hand-set defaults with a
        ``tune_miss`` note), a dict or a ``TunedConfig`` gives them. Only
        the knobs the caller left unset are filled: ``chunk``,
        ``pipeline_depth``, ``precision`` and the statistic path (a JAX
        knob of ``"xla"`` is ``"einsum"``; a path this simulator's
        constructor would refuse, such as a kernel path on a toa-sharded
        mesh, is ignored with a ``tune_path_illegal`` note). A
        ``psr_shards`` other than the mesh's is noted
        (``tune_mesh_mismatch``): the mesh is built by the caller. The
        applied knobs land in ``meta["tuned"]``, and the summary's
        ``tuned`` reads 1.
        """
        tuned_applied, tuned_path = None, None
        if tuned:
            knobs, tuned_path = self._tuned_knobs(tuned, keep_corr)
            if knobs:
                tuned_applied = {}
                if chunk is None and knobs.get("chunk"):
                    chunk = int(knobs["chunk"])
                    tuned_applied["chunk"] = chunk
                if pipeline_depth is None \
                        and knobs.get("pipeline_depth") is not None:
                    pipeline_depth = int(knobs["pipeline_depth"])
                    tuned_applied["pipeline_depth"] = pipeline_depth
                if precision is None and knobs.get("precision"):
                    precision = knobs["precision"]
                    tuned_applied["precision"] = precision
                if tuned_path is not None:
                    tuned_applied["path"] = tuned_path
                shards_t = knobs.get("psr_shards")
                if shards_t and int(shards_t) != self.mesh.shape[PSR_AXIS]:
                    flightrec.note("tune_mesh_mismatch", want=int(shards_t),
                                   have=int(self.mesh.shape[PSR_AXIS]))
        policy = faults.as_policy(recovery)
        multi = self.mesh.multiprocess
        rank, n_proc = process_index(), process_count()
        t_run0 = now()
        collector = obs_metrics.Collector()
        chunk_records: list = []
        nreal = int(nreal)
        if nreal <= 0:
            raise ValueError(f"nreal must be > 0, got {nreal}")
        path = "einsum" if keep_corr else (tuned_path or self.stat_path)
        prec = self._resolve_precision(path, precision)
        chunk = self._normalize_chunk(
            DEFAULT_CHUNK if chunk is None else chunk, nreal)
        depth = max(int(DEFAULT_PIPELINE_DEPTH if pipeline_depth is None
                        else pipeline_depth), 0)
        # a multi-process run drains serially, as the JAX engine does
        pipelined = depth > 0 and n_proc == 1
        ring_size = max(depth, 1)
        nb = self.nbins
        stat_lanes = self._prepare_lanes(os, lnlike)
        n_extra = 0 if stat_lanes is None else stat_lanes.n_extra
        os_lanes = stat_lanes if isinstance(stat_lanes, _OSLanes) else None
        lnl_lanes = stat_lanes if isinstance(stat_lanes, _LnlLanes) else None

        lane_seeds = lane_within = None
        if lanes is not None:
            if checkpoint is not None:
                raise ValueError(
                    "run(lanes=...) cannot checkpoint: the resume identity "
                    "is keyed on one (seed, nreal, chunk) triple, not a "
                    "cohort of lanes")
            if self._cgw_psrterm:
                raise ValueError(
                    "run(lanes=...) is incompatible with psrterm CGW "
                    "sampling (its host-f64 bulk staging replays the scalar "
                    "base-key chain; lane keys have no single base key)")
            seeds, within = _lane_arrays(lanes, nreal)
            # padding slots for the last chunk's overshoot; one upload
            # before the loop (an upload inside it would sync per chunk)
            n_slots = -(-nreal // chunk) * chunk
            seeds = np.concatenate([seeds, np.zeros(n_slots - nreal,
                                                    np.int32)])
            within = np.concatenate([within, np.arange(nreal, n_slots,
                                                       dtype=np.int32)])
            lane_seeds = torch.from_numpy(seeds.astype(np.int64)).to(
                self.device)
            lane_within = torch.from_numpy(within.astype(np.int64)).to(
                self.device)

        ckpt, done, packed_out, corr_out = None, 0, [], []
        if checkpoint is not None:
            if not isinstance(seed, (int, np.integer)):
                raise TypeError("checkpointing requires an integer seed (the "
                                "checkpoint stores it to validate a resume)")
            ckpt = EnsembleCheckpoint(checkpoint)
            state = ckpt.load(seed, nreal, chunk, keep_corr=keep_corr,
                              n_extra=n_extra)
            if state is not None:
                done = int(state["done"])
                if state["rolled_back"]:
                    collector.count("faults.rollbacks", state["rolled_back"])
                packed_out.append(np.concatenate(
                    [state["curves"], state["autos"][:, None]]
                    + ([state["extra"]] if n_extra else []), axis=1))
                if keep_corr:
                    if "corr" not in state:
                        raise ValueError("checkpoint was written without "
                                         "keep_corr; cannot resume with it")
                    corr_out.append(state["corr"])
        base = self._base_key(seed)
        sync_each = ckpt is not None and not pipelined
        on_card = self.device.type == "cuda"

        # run identity, built before the loop so that a crash dump has it
        meta = {
            "nreal": nreal, "chunk": int(chunk),
            "keep_corr": bool(keep_corr), "fused": path != "einsum",
            "statistic_path": path, "precision": prec,
            "platform": "gpu" if on_card else "cpu",
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if on_card else "cpu"),
            # distinct devices: a mesh may list one card several times
            "n_devices": len(set(zip(self.mesh.ranks.flat,
                                     self.mesh.devices.flat))),
            "mesh_shape": {k: int(v) for k, v in self.mesh.shape.items()},
            "npsr": int(self.batch.npsr),
            "max_toa": int(self.batch.max_toa),
            "pipeline_depth": depth,
            "process_index": rank, "process_count": n_proc,
            "backend": mesh_backend(), "seed": int(seed),
        }
        if tuned_applied is not None:
            # which knobs the tuner set (the summary's `tuned` flag)
            meta["tuned"] = {"knobs": dict(tuned_applied)}
        if lanes is not None:
            meta["serve_lanes"] = len(list(lanes))
        if os_lanes is not None:
            meta["os"] = {"orfs": list(os_lanes.spec.orfs),
                          "weighting": os_lanes.spec.weighting,
                          "null": os_lanes.null}
        if lnl_lanes is not None:
            meta["lnlike"] = {"k": lnl_lanes.k, "d": lnl_lanes.compiled.D,
                              "mode": lnl_lanes.spec.mode,
                              "params": list(lnl_lanes.compiled.param_names)}

        timeline: list = []
        ledger = PackedLedger(chunk * (nb + 1 + n_extra)
                              * self.batch.dtype.itemsize,
                              ring_size, pipelined)
        # the workspace probe (the first run's in this process) goes before
        # the peak's reset, so its idle set is in the peak it is counted in
        self._workspaces.measure()
        sampler = HbmSampler(self.mesh.local_devices)
        sampler.start()
        flightrec.note("run_start", spec_hash=flightrec.spec_hash(meta),
                       nreal=nreal, chunk=int(chunk), path=path,
                       depth=depth, resume_done=done)
        compute = torch.cuda.current_stream(self.device) if on_card else None
        copy_stream = (torch.cuda.Stream(self.device)
                       if on_card and pipelined else None)
        # in-flight pipelined chunks; maxlen pins the depth bound (the loop
        # pops the oldest before every append at capacity, so the cap is
        # never exercised: it is the invariant)
        ring: collections.deque = collections.deque(maxlen=ring_size)
        exec_events: dict = {}          # chunk idx -> (start, end) events

        def execute_span(rec: dict, t_ready: Optional[float]) -> None:
            """The chunk's execute span: the device time between its CUDA
            events (both complete: the caller saw the chunk's output), or
            on the host, dispatch start to outputs materialized."""
            events = exec_events.get(rec["idx"])
            if events is not None:
                dur = events[0].elapsed_time(events[1]) / 1e3
            elif t_ready is not None:
                dur = max(t_ready - t_run0 - rec["t0_s"], 0.0)
            else:
                return
            rec["execute_s"] = dur
            timeline.append({"name": "execute", "tid": "device",
                             "t0": rec["t0_s"], "dur": dur,
                             "chunk": rec["idx"]})

        def drain(job: dict) -> None:
            """One chunk's host work, in the serial loop's order: its
            outputs on the host, the checkpoint append, the progress call.
            A transient failure retries in place (the drain is idempotent:
            a fixed slot, the same checkpoint chunk file, the same progress
            counts). Sets the chunk's drained event even when it fails, so
            the dispatch loop cannot wait forever."""
            rec = job["rec"]
            idx, slot = rec["idx"], job["slot"]
            t_d0 = now()
            t_ready = None

            def body() -> None:
                nonlocal t_ready
                # chaos site: the writer-thread drain; a 'hang' here
                # outlasts the dispatch loop's watchdog
                faults.check("pipeline.writer", idx=idx)
                arr = None
                if pipelined:
                    arr = pipeline.materialize_copy(job["host"],
                                                    job["copied"])
                elif sync_each:
                    arr = job["packed"].cpu().numpy()
                if arr is None:
                    packed_out[slot] = job["packed"]
                else:
                    packed_out[slot] = arr
                    t_ready = now()
                if keep_corr:
                    if job["events"] is not None:
                        # the writer thread's current stream need not be
                        # the one the step ran on: wait for the step first
                        job["events"][1].synchronize()
                    corr_out[slot] = job["corr"].cpu().numpy()
                    t_ready = now()
                if arr is not None and not np.isfinite(arr[:, :nb + 1]).all():
                    # a non-finite curve or auto fails before the checkpoint
                    # can take the chunk in; the extra (OS / null /
                    # likelihood) lanes are the caller's to read, as in the
                    # JAX engine
                    flightrec.note("poisoned_chunk", idx=idx)
                    raise FloatingPointError(
                        f"chunk {idx} produced non-finite packed statistics")
                if ckpt is not None and rank == 0:
                    # only rank 0 writes: every rank holds the whole chunk,
                    # and N processes renaming the same files on shared
                    # storage would race
                    t_ck = now()
                    ckpt.save(int(seed), nreal, chunk, job["done"],
                              arr[:, :nb], arr[:, nb],
                              corr_out[slot] if keep_corr else None,
                              extra=arr[:, nb + 1:] if n_extra else None)
                    t_now = now()
                    rec["ckpt_wait_s"] = t_now - t_ck
                    timeline.append({"name": "ckpt_append", "tid": "writer",
                                     "t0": t_ck - t_run0,
                                     "dur": t_now - t_ck, "chunk": idx})
                if progress is not None:
                    if t_ready is None:
                        if job["events"] is not None:
                            job["events"][1].synchronize()
                        t_ready = now()
                    progress(min(job["done"], nreal), nreal)
                flightrec.note("chunk_drained", idx=idx)

            try:
                pipeline.run_drain_with_retry(
                    body, policy,
                    on_retry=lambda a: collector.count("faults.retries"))
            finally:
                # the chunk's device outputs are no longer the run's: the
                # caching allocator may reuse them (record_stream keeps a
                # copy in flight safe), and the ledger stops counting them
                job["packed"] = job["corr"] = None
                if t_ready is not None:
                    rec["t_ready_s"] = t_ready - t_run0
                    execute_span(rec, t_ready)
                timeline.append({"name": "drain", "tid": "writer",
                                 "t0": t_d0 - t_run0,
                                 "dur": now() - t_d0, "chunk": idx})
                if job["drained"] is not None:
                    job["drained"].set()

        # psrterm CGW sampling: each chunk's host-f64 retarded-phase bulks.
        # Chunk 0's are the one precompute the first dispatch waits on;
        # every later chunk's are computed right after the previous
        # dispatch, while the device works
        base_cpu = base.cpu() if self._cgw_psrterm else None

        def stage_bulks(offset: int, name: str, idx: int):
            if not self._cgw_psrterm:
                return ()
            t0 = now()
            got = self._host_cgw_bulks(_chunk_keys(base_cpu, offset, chunk))
            timeline.append({"name": name, "tid": "main", "t0": t0 - t_run0,
                             "dur": now() - t0, "chunk": idx})
            return got

        # the statistic path and precision the chunks dispatch on: a cell,
        # because the recovery ladders may step it down mid-run
        exec_sel = {"path": path, "prec": prec}

        def degrade_to(new_path: str, new_prec: str, idx: int,
                       why: str) -> None:
            """Step the dispatch down one ladder rung, loudly."""
            frm = f"{exec_sel['path']}/{exec_sel['prec']}"
            to = f"{new_path}/{new_prec}"
            exec_sel.update(path=new_path, prec=new_prec)
            collector.count("faults.degradations")
            flightrec.note("degrade", idx=idx, frm=frm, to=to,
                           error=why[:200])
            timeline.append({"name": "degrade", "tid": "main",
                             "t0": now() - t_run0, "dur": None,
                             "chunk": idx, "from": frm, "to": to})
            meta["degraded_path"] = new_path
            meta["degraded_precision"] = new_prec

        def dispatch_recover(idx: int, offset: int, bulks):
            """One chunk's dispatch under the recovery policy: bounded
            exponential-backoff retry of transient failures on the same
            keys (bit-identical to the unfaulted run), the ladders on a
            kernel or precision failure, and NaN poisoning of the packed
            output when the chaos harness asks for it (the drain's finite
            guard then aborts loudly)."""
            attempts, delay = 0, policy.backoff_s
            while True:
                try:
                    act = faults.check("mc.dispatch", idx=idx,
                                       offset=int(offset))
                    if lane_seeds is not None:
                        packed, corr = self.step(
                            lane_seeds[offset:offset + chunk],
                            lane_within[offset:offset + chunk], chunk,
                            exec_sel["path"], exec_sel["prec"],
                            with_corr=keep_corr, lanes=stat_lanes)
                    else:
                        packed, corr = self.step(
                            base, offset, chunk, exec_sel["path"],
                            exec_sel["prec"], with_corr=keep_corr,
                            bulks=bulks, lanes=stat_lanes)
                    if act == "poison":
                        packed = packed * float("nan")
                    return packed, corr
                except Exception as exc:  # noqa: BLE001 — triaged below;
                    # unrecognized failures re-raise unchanged (KillFault is
                    # a BaseException and never enters this clause)
                    if multi:
                        # a retry or a ladder step on this rank alone would
                        # leave the others inside a collective
                        raise
                    kind = faults.classify(exc)
                    if kind == "transient" and attempts < policy.max_retries:
                        attempts += 1
                        if faults.is_oom(exc) and on_card:
                            # give the caching allocator's free blocks
                            # back before the same chunk asks again
                            torch.cuda.empty_cache()
                        collector.count("faults.retries")
                        flightrec.note("chunk_retry", idx=idx,
                                       attempt=attempts,
                                       error=repr(exc)[:200])
                        timeline.append({"name": "retry", "tid": "main",
                                         "t0": now() - t_run0, "dur": delay,
                                         "chunk": idx, "attempt": attempts})
                        faults.sleep(delay)
                        delay = policy.next_backoff(delay)
                        continue
                    if (kind == "pallas" and policy.degrade_paths
                            and exec_sel["path"] in faults.PATH_LADDER):
                        # one rung down at the SAME precision: degrading
                        # the path must not change the precision too
                        degrade_to(faults.PATH_LADDER[exec_sel["path"]],
                                   exec_sel["prec"], idx, repr(exc))
                        continue
                    if (kind == "precision" and policy.degrade_precision
                            and exec_sel["prec"] == "bf16"):
                        degrade_to(exec_sel["path"], "f32", idx, repr(exc))
                        continue
                    raise

        bulks = stage_bulks(done, "stage_inputs", 0)
        writer = pipeline.make_writer(pipelined)
        reuse_on = True
        try:
            with obs_metrics.collect(collector):
                while done < nreal:
                    t_chunk0 = now()
                    idx = len(chunk_records)
                    rec = {"idx": idx, "wall_s": 0.0, "stall_s": 0.0,
                           "ckpt_wait_s": 0.0,
                           "synced": bool(sync_each or (
                               not pipelined
                               and (keep_corr or progress is not None))),
                           "t0_s": t_chunk0 - t_run0}
                    reuse = None
                    if len(ring) >= ring_size:
                        # the depth bound: wait for the oldest chunk's
                        # drain, then reuse its pinned host buffer. The wait
                        # is the watchdog's deadline when the policy arms
                        # one: a drain that never completes aborts the run
                        # with a flight-recorder dump
                        reuse = ring.popleft()
                        t_wait = now()
                        if not reuse["drained"].wait(policy.watchdog_s):
                            late = reuse["rec"]["idx"]
                            flightrec.note("watchdog_abort", idx=late,
                                           deadline_s=policy.watchdog_s)
                            raise faults.WatchdogTimeout(
                                f"drain of chunk {late} exceeded the "
                                f"watchdog deadline ({policy.watchdog_s}s); "
                                f"aborting, see the flight-recorder dump")
                        t_now = now()
                        rec["stall_s"] += t_now - t_wait
                        timeline.append({"name": "stall", "tid": "main",
                                         "t0": t_wait - t_run0,
                                         "dur": t_now - t_wait,
                                         "chunk": idx})
                    events = None
                    if on_card:
                        events = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                        events[0].record(compute)
                    packed, corr = dispatch_recover(idx, done, bulks)
                    if on_card:
                        events[1].record(compute)
                        exec_events[idx] = events
                    flightrec.note("chunk_dispatch", idx=idx, offset=done)
                    rec["live_packed"] = ledger.track(packed)
                    host = copied = drained = None
                    if pipelined:
                        if reuse is not None and reuse_on:
                            # the ring's buffer reuse; the chaos harness can
                            # fake a failed one (the JAX engine's donation
                            # miss), which stops the reuse for the rest of
                            # the run and withdraws the ring's bound, loudly
                            missed = faults.check("mc.recycle",
                                                  idx=idx) == "donation"
                            if missed and policy.degrade_pipeline:
                                reuse_on = False
                                ledger.disable()
                                collector.count("faults.degradations")
                                flightrec.note("degrade_donation", idx=idx)
                                timeline.append(
                                    {"name": "degrade", "tid": "main",
                                     "t0": now() - t_run0, "dur": None,
                                     "chunk": idx, "from": "ring-reuse",
                                     "to": "no-reuse"})
                                meta["degraded_donation"] = True
                            elif missed:
                                ledger.miss()
                        if reuse is None or not reuse_on:
                            host = pipeline.host_buffer(packed)
                        else:
                            host = reuse["host"]
                            timeline.append(
                                {"name": "recycle", "tid": "main",
                                 "t0": now() - t_run0, "dur": None,
                                 "chunk": idx,
                                 "from_chunk": reuse["rec"]["idx"]})
                        copied = pipeline.start_d2h(
                            packed, host, after=events and events[1],
                            stream=copy_stream)
                        collector.count("pipeline.d2h_async")
                        drained = threading.Event()
                    done += chunk
                    if done < nreal and self._cgw_psrterm:
                        bulks = stage_bulks(done, "precompute", idx + 1)
                        collector.count("pipeline.h2d_prefetch")
                    packed_out.append(None)
                    if keep_corr:
                        corr_out.append(None)
                    job = {"rec": rec, "slot": len(packed_out) - 1,
                           "done": done, "packed": packed, "corr": corr,
                           "host": host, "copied": copied,
                           "drained": drained, "events": events}
                    if pipelined:
                        rec["stall_s"] += writer.submit(
                            lambda job=job: drain(job), drained.set)
                        ring.append(job)
                    else:
                        writer.submit(lambda job=job: drain(job))
                    rec["wall_s"] = now() - t_chunk0
                    timeline.append({"name": "dispatch", "tid": "main",
                                     "t0": rec["t0_s"], "dur": rec["wall_s"],
                                     "chunk": idx})
                    chunk_records.append(rec)
                # the watchdog also bounds the final flush: a drain hung at
                # close would otherwise block the join forever
                writer.close(timeout=(policy.watchdog_s * (len(ring) + 2)
                                      if policy.watchdog_s else None))
                ring.clear()
                ledger.check()
                t_f0 = now()
                packed_h = np.concatenate(
                    [p if isinstance(p, np.ndarray) else p.cpu().numpy()
                     for p in packed_out])[:nreal]
                timeline.append({"name": "final_fetch", "tid": "main",
                                 "t0": t_f0 - t_run0,
                                 "dur": now() - t_f0})
                if not np.isfinite(packed_h[:, :nb + 1]).all():
                    flightrec.note("poisoned_output")
                    raise FloatingPointError(
                        "run produced non-finite statistics")
        except BaseException as exc:
            writer.abort()
            flightrec.note("run_abort", error=repr(exc)[:500])
            # the post-mortem artifact beside the checkpoint; a failed dump
            # returns None and never masks the exception
            rec_dir = flightrec.dump_dir(checkpoint)
            if rec_dir is not None:
                flightrec.dump(rec_dir, meta, chunks=chunk_records,
                               error=repr(exc)[:500], process_index=rank)
            raise
        total_s = now() - t_run0
        flightrec.note("run_end", total_s=round(total_s, 3))
        for rec in chunk_records:
            if "execute_s" not in rec:
                execute_span(rec, None)     # every event is complete now
        curves, autos = unpack_stats(packed_h, nb)
        path, prec = exec_sel["path"], exec_sel["prec"]
        out = {"curves": curves, "autos": autos,
               "bin_centers": np.asarray(self.bin_centers),
               "statistic_path": path, "precision": prec}
        if os_lanes is not None:
            from ..detect import operators as detect_ops
            n_os = os_lanes.n_os
            out["os"] = detect_ops.assemble(
                os_lanes.spec, os_lanes.ops, packed_h[:, nb + 1:nb + 1 + n_os],
                packed_h[:, nb + 1 + n_os:nb + 1 + 2 * n_os]
                if os_lanes.null else None)
        if lnl_lanes is not None:
            from ..infer import model as infer_model
            out["lnlike"] = infer_model.assemble(
                lnl_lanes.spec, lnl_lanes.compiled, packed_h[:, nb + 1:])
        if keep_corr:
            out["corr"] = np.concatenate(corr_out)[:nreal]
        if ckpt is not None and rank == 0:
            ckpt.delete()

        # the report: telemetry only, after every output is on the host
        collector.count("obs.chunks", len(chunk_records))
        memory = sampler.stop()
        memory.update(ledger.memory_fields())
        if memory.get("peak_bytes_in_use"):
            memory["peak_hbm_bytes"] = memory["peak_bytes_in_use"]
            memory["peak_hbm_source"] = "allocator"
        static = self._workspace_terms(
            stat_lanes, packed_out, corr_out, device_allocs={
                i: st["device_allocs"]
                for i, st in sampler.per_device.items()}).get(
            sampler.peak_device)
        if static is not None:
            # the fixed term inside that peak, on the peak's card: the
            # library workspaces present at the run's end (a run's thread
            # takes its own at its first product, and none is ever freed)
            memory["static_reservation_bytes"] = static
        report = RunReport.from_collector(
            collector, meta, retraces=0, total_s=total_s,
            cost={"model_bytes_per_chunk": self.model_bytes_per_chunk(
                chunk, path, prec)},
            memory=memory)
        report.chunks = chunk_records
        report.spans = sorted(collector.spans)
        report.timeline = sorted(timeline, key=lambda e: e.get("t0", 0.0))
        self.last_report = report
        out["report"] = report
        if eventlog is not None:
            # this rank's event-log shard; `obs trace <dir>/events-p*.jsonl`
            # merges the shards into one timeline, a pid lane per rank
            shard_dir = pathlib.Path(eventlog)
            shard_dir.mkdir(parents=True, exist_ok=True)
            report.save(shard_dir / f"events-p{rank:03d}.jsonl")
        return out
