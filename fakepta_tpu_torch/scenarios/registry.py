"""Declarative, hashable PTA scenario specs (port of the JAX registry).

A :class:`Scenario` is one frozen, JSON-expressible description of a PTA
dataset: population size and geometry seed, timespan, a telescope-cadence
arrival process (:mod:`.cadence`), the per-family noise menu (red, DM and
chromatic GPs, per-backend ECORR and system-noise bands), the GWB
(including the HEALPix anisotropic ORF) and per-realization population
draws (noise and white hyperpriors, a CGW source population, BayesEphem
nuisances). The field list, the named entries and therefore
:meth:`Scenario.spec_hash` are the JAX package's, so a scenario has one
identity in both packages.

Materialization goes through the ordinary
:class:`~fakepta_tpu_torch.parallel.montecarlo.EnsembleSimulator`
constructor: :meth:`Scenario.build` takes ``mesh=`` or ``device=`` like the
engine (``device`` defaults to ``"cuda"``) and forwards engine options
such as ``stat_path``. ``SCENARIOS`` holds ``flagship_100``, ``ng15``,
``ipta_dr3`` and ``ska_10k``; :func:`register` adds more.
:meth:`Scenario.serve_spec` names a scenario's serve identity; the
golden-run harness and the ``ska_10k`` memory lane are :mod:`.golden`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..obs import flightrec

# spec-dict discriminator (shared namespace with the serve layer's ArraySpec)
_KIND = "Scenario"

#: CPU-stand-in reduction targets (:meth:`Scenario.reduced`)
REDUCED_MAX_PSR = 16
REDUCED_MAX_TOA = 160
#: The memory-scaling lane's endpoint reduction keeps more pulsars (the
#: sweep needs headroom over its smaller points) at a very sparse cadence.
REDUCED_MAX_PSR_MEM = 64


def _powlaw_psd(tspan_s: float, nbin: int, log10_A: float,
                gamma: float) -> np.ndarray:
    """Host-float64 power law on the grid n / tspan_s."""
    from .. import spectrum as spectrum_lib
    f = np.arange(1, nbin + 1) / tspan_s
    return spectrum_lib.powerlaw(f, log10_A, gamma).numpy()


def _anis_h_map(nside: int, seed: int) -> np.ndarray:
    """Deterministic anisotropic GWB power map on a HEALPix grid:
    isotropic baseline plus a seeded dipole-dominated modulation, mean 1."""
    from ..ops import healpix

    npix = 12 * nside * nside
    vecs = healpix.pixel_directions(npix)
    rng = np.random.default_rng((seed, 0xA215))
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    amp = rng.uniform(0.3, 0.7)
    h_map = 1.0 + amp * vecs @ direction
    return h_map * (npix / h_map.sum())      # mean-1 normalization


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered PTA scenario (module docstring). All fields are
    JSON-expressible primitives/tuples, so :meth:`spec_hash` is stable and
    equals the JAX package's hash of the same scenario."""

    name: str
    description: str = ""

    # -- population / geometry ------------------------------------------
    npsr: int = 100
    tspan_years: float = 15.0
    toaerr: float = 1e-7
    data_seed: int = 0
    #: cadence family (:data:`.cadence.CADENCES`); "uniform" materializes
    #: through ``PulsarBatch.synthetic``, bit-identical to the JAX
    #: package's flagship batch
    cadence: str = "uniform"
    #: uniform-cadence TOA count (telescope cadences derive their own)
    ntoa: int = 780
    #: cadence thinning multiplier (the reduced/stand-in knob: same
    #: arrival process, sparser sampling)
    cadence_thin: int = 1

    # -- per-pulsar noise menu ------------------------------------------
    n_red: int = 30
    n_dm: int = 100
    n_chrom: int = 0
    red_log10_A: float = -14.0
    red_gamma: float = 13.0 / 3.0
    dm_log10_A: float = -13.8
    dm_gamma: float = 3.0
    chrom_log10_A: Optional[float] = None
    chrom_gamma: float = 3.0
    #: per-backend ECORR epochs (telescope cadences only)
    ecorr: bool = False
    log10_ecorr: float = -7.0
    ecorr_dt_days: float = 1.0
    #: per-backend system-noise bands (0 = off; telescope cadences only)
    n_sys: int = 0
    sys_log10_A: float = -14.5
    sys_gamma: float = 2.5

    # -- per-realization population draws -------------------------------
    #: red-noise hyperprior ((log10_A lo, hi), (gamma lo, hi)) or None
    red_draws: Optional[Tuple[Tuple[float, float],
                              Tuple[float, float]]] = None
    #: per-(pulsar, backend) efac/equad hyperprior draws
    white_draws: bool = False
    #: per-realization circular-SMBHB source population (CGWSampling)
    cgw_population: bool = False
    cgw_log10_h: Tuple[float, float] = (-14.5, -13.5)
    cgw_log10_fgw: Tuple[float, float] = (-8.5, -7.5)
    #: BayesEphem nuisance sampling (Jupiter-mass scale draw per
    #: realization, RoemerSampling)
    ephem_draws: bool = False
    ephem_s_mass: float = 1.5e23    # ~1e-4 M_jup [kg], BayesEphem scale

    # -- GWB -------------------------------------------------------------
    gwb_log10_A: float = float(np.log10(2e-15))
    gwb_gamma: float = 13.0 / 3.0
    gwb_ncomp: int = 30
    #: '' disables the common signal; 'anisotropic' uses the healpix map
    gwb_orf: str = "hd"
    gwb_nside: int = 0
    gwb_anis_seed: int = 0

    # -- identity --------------------------------------------------------
    def spec_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = _KIND
        return d

    def spec_hash(self) -> str:
        """Stable identity: the flight-recorder hash over the spec dict."""
        return flightrec.spec_hash(self.spec_dict())

    # -- scaling ---------------------------------------------------------
    def reduced(self, max_psr: int = REDUCED_MAX_PSR,
                max_toa: int = REDUCED_MAX_TOA) -> "Scenario":
        """The CPU-stand-in rendition: same name, noise menu and cadence
        family, proportionally fewer pulsars/TOAs (multiples of 8);
        telescope cadences thin instead of shrinking the span."""
        if self.npsr <= max_psr and self.ntoa <= max_toa:
            return self
        npsr = max(8, min(self.npsr, max_psr) // 8 * 8)
        ntoa = max(32, min(self.ntoa, max_toa) // 8 * 8)
        # epoch count scales ~ tspan/cadence, so the thinning factor is the
        # TOA ratio (rounded up): gaps and seams survive the reduction
        thin = self.cadence_thin
        if self.cadence != "uniform":
            thin = max(thin, math.ceil(self.ntoa / ntoa))
        return dataclasses.replace(
            self, npsr=npsr, ntoa=ntoa, cadence_thin=thin,
            n_red=min(self.n_red, 16), n_dm=min(self.n_dm, 16),
            n_chrom=min(self.n_chrom, 8),
            n_sys=min(self.n_sys, 8),
            gwb_ncomp=min(self.gwb_ncomp, 16))

    # -- materialization -------------------------------------------------
    def batch_parts(self, dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None):
        """``(batch, toas_abs, backend_id, n_backends)``: the cadence- or
        synthetic-path batch on ``device`` (default ``"cuda"``) plus the
        host companions the sampling lanes need (absolute float64 epochs,
        per-TOA backend ids)."""
        from . import cadence as cadence_mod

        dtype = torch.float32 if dtype is None else dtype
        if self.cadence != "uniform":
            return cadence_mod.build_batch(self, dtype=dtype, device=device)
        from ..batch import PulsarBatch

        batch = PulsarBatch.synthetic(
            npsr=self.npsr, ntoa=self.ntoa, tspan_years=self.tspan_years,
            toaerr=self.toaerr, n_red=self.n_red, n_dm=self.n_dm,
            **({"n_chrom": self.n_chrom,
                "chrom_log10_A": self.chrom_log10_A,
                "chrom_gamma": self.chrom_gamma} if self.n_chrom else {}),
            red_log10_A=self.red_log10_A, red_gamma=self.red_gamma,
            dm_log10_A=self.dm_log10_A, dm_gamma=self.dm_gamma,
            seed=self.data_seed, dtype=dtype, device=device)
        span = float(batch.tspan_common)
        toas_abs = np.tile(
            cadence_mod.MJD0_S + np.linspace(0.0, span, self.ntoa),
            (self.npsr, 1))
        backend_id = np.zeros((self.npsr, batch.max_toa), dtype=np.int32)
        return batch, toas_abs, backend_id, 1

    def gwb_h_map(self) -> Optional[np.ndarray]:
        """The anisotropic background's HEALPix map (None for another
        ORF): the one :meth:`sim_kwargs` gives the engine, and the one an
        anisotropic OS template of this array takes."""
        if self.gwb_orf != "anisotropic":
            return None
        return _anis_h_map(self.gwb_nside or 4, self.gwb_anis_seed)

    def sim_kwargs(self, batch, toas_abs, backend_id, n_backends) -> dict:
        """The ``EnsembleSimulator`` constructor kwargs this scenario's
        menu implies (GWB config incl. anisotropic h_map, population draws,
        BayesEphem sampling): the JAX package's, name for name."""
        from ..parallel.montecarlo import (CGWSampling, GWBConfig,
                                           NoiseSampling, RoemerSampling,
                                           WhiteSampling)

        kw: dict = {}
        if self.gwb_orf:
            tspan = float(batch.tspan_common)
            psd = _powlaw_psd(tspan, self.gwb_ncomp, self.gwb_log10_A,
                              self.gwb_gamma)
            kw["gwb"] = GWBConfig(psd=psd, orf=self.gwb_orf,
                                  h_map=self.gwb_h_map())
        noise_samples = []
        if self.red_draws is not None:
            noise_samples.append(NoiseSampling(
                "red", log10_A=tuple(self.red_draws[0]),
                gamma=tuple(self.red_draws[1])))
        if noise_samples:
            kw["noise_sample"] = noise_samples
        if self.white_draws:
            kw["white_sample"] = WhiteSampling(
                efac=(0.5, 2.5), log10_tnequad=(-8.0, -5.0))
            kw["toaerr2"] = np.full(
                (batch.npsr, batch.max_toa), self.toaerr ** 2)
            kw["backend_id"] = backend_id
        if self.cgw_population:
            kw["cgw_sample"] = CGWSampling(
                log10_h=tuple(self.cgw_log10_h),
                log10_fgw=tuple(self.cgw_log10_fgw))
        if self.ephem_draws:
            kw["roemer_sample"] = RoemerSampling(
                "jupiter", s_mass=self.ephem_s_mass)
        if self.cgw_population or self.ephem_draws:
            kw["toas_abs"] = toas_abs
        return kw

    def build(self, mesh=None, device: DeviceLike = None,
              dtype: Optional[torch.dtype] = None, **engine_kw):
        """Construct the :class:`EnsembleSimulator` this scenario
        describes, on ``mesh`` or ``device`` (default ``"cuda"``);
        ``engine_kw`` (``stat_path``, ``pallas_precision``, ...) go to the
        engine beside :meth:`sim_kwargs`."""
        from ..parallel.montecarlo import EnsembleSimulator

        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        where = mesh.local_device if mesh is not None else device
        parts = self.batch_parts(dtype=dtype, device=where)
        kw = self.sim_kwargs(*parts)
        return EnsembleSimulator(parts[0], mesh=mesh, device=device,
                                 **kw, **engine_kw)

    def serve_spec(self, reduced: bool = False):
        """The closest :class:`..serve.spec.ArraySpec`: the JSON-routable
        serve identity for this scenario's array family (richer menus
        serve through ``ServePool.register`` with a prebuilt simulator;
        the fleet and gateway lanes only need the spec family). Field for
        field the JAX package's, so one scenario names one spec hash in
        both."""
        from ..serve.spec import ArraySpec

        scn = self.reduced() if reduced else self
        return ArraySpec(
            npsr=scn.npsr, ntoa=scn.ntoa, tspan_years=scn.tspan_years,
            toaerr=scn.toaerr, n_red=scn.n_red, n_dm=scn.n_dm,
            data_seed=scn.data_seed, gwb_log10_A=scn.gwb_log10_A,
            gwb_gamma=scn.gwb_gamma, gwb_ncomp=scn.gwb_ncomp,
            gwb_orf=scn.gwb_orf if scn.gwb_orf in
            ("", "hd", "curn", "monopole", "dipole") else "hd")

    def est_cost(self, chunk: int = 1024) -> dict:
        """Analytic per-chunk cost estimate (no device work): the memory
        traffic model (``ops/megakernel.chunk_bytes_model``) at this
        scenario's array shape."""
        from ..ops.megakernel import chunk_bytes_model

        if self.cadence == "uniform":
            ntoa = self.ntoa
        else:
            from .cadence import CADENCES
            fastest = min(t.cadence_days for t in CADENCES[self.cadence])
            # ~1.5 telescope/band tracks per pulsar on the fastest cadence
            ntoa = max(32, int(self.tspan_years * 365.25
                               / (fastest * self.cadence_thin) * 1.5))
        k_coef = 2 * (self.n_red + self.n_dm + self.n_chrom
                      + self.gwb_ncomp)
        return {
            "model_bytes_per_chunk": chunk_bytes_model(
                chunk, self.npsr, ntoa, k_coef),
            "array_values": self.npsr * ntoa,
            "est_ntoa": ntoa,
        }


def _flagship() -> Scenario:
    return Scenario(
        name="flagship_100",
        description="The historical flagship: 100 psr x 15 yr, weekly "
                    "uniform cadence, white + red + DM noise, HD GWB — "
                    "bit-identical to the bench.py north-star config.",
    )


def _ng15() -> Scenario:
    return Scenario(
        name="ng15",
        description="NANOGrav-15yr-like: 68 psr x 16 yr on the ng15 "
                    "telescope cadence (Arecibo collapse at 85% of the "
                    "span), per-backend ECORR + system bands, chromatic "
                    "noise, white hyperprior draws, HD GWB.",
        npsr=68, tspan_years=16.0, cadence="ng15", ntoa=280,
        n_red=30, n_dm=30, n_chrom=15, chrom_log10_A=-14.2,
        ecorr=True, n_sys=10, white_draws=True,
        gwb_log10_A=float(np.log10(2.4e-15)), data_seed=15)


def _ipta_dr3() -> Scenario:
    return Scenario(
        name="ipta_dr3",
        description="IPTA-DR3-like: 120 psr x 25 yr over five "
                    "observatories (staggered commissioning, maintenance "
                    "gaps, legacy retirements), anisotropic GWB on a "
                    "healpix nside=4 map, per-pulsar red hyperprior "
                    "draws, CGW source population, BayesEphem nuisances.",
        npsr=120, tspan_years=25.0, cadence="ipta", ntoa=400,
        n_red=30, n_dm=30, ecorr=True, n_sys=10,
        red_draws=((-17.0, -13.0), (1.0, 5.0)),
        cgw_population=True, ephem_draws=True,
        gwb_orf="anisotropic", gwb_nside=4, gwb_anis_seed=3,
        data_seed=33)


def _ska_10k() -> Scenario:
    return Scenario(
        name="ska_10k",
        description="SKA-era scale-out: 10,000 psr x 30 yr at monthly "
                    "SKA cadence, lean per-pulsar noise menu, CURN "
                    "common signal — the memory-scaling lane's endpoint "
                    "(peak-HBM vs n_psr under psr sharding).",
        npsr=10_000, tspan_years=30.0, cadence="ska", ntoa=360,
        toaerr=3e-8, n_red=10, n_dm=10, gwb_ncomp=10, gwb_orf="curn",
        data_seed=77)


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in (_flagship(), _ng15(), _ipta_dr3(), _ska_10k())
}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (idempotent for identical specs;
    re-registering a name with a *different* spec raises: names are
    identities)."""
    existing = SCENARIOS.get(scenario.name)
    if existing is not None and existing.spec_hash() != scenario.spec_hash():
        raise ValueError(
            f"scenario {scenario.name!r} is already registered with a "
            f"different spec (hash {existing.spec_hash()} != "
            f"{scenario.spec_hash()}); pick a new name")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def names() -> Tuple[str, ...]:
    return tuple(SCENARIOS)


def flagship_batch(dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None):
    """The flagship batch on ``device`` (default ``"cuda"``), from the
    registry's ``flagship_100`` entry."""
    return get("flagship_100").batch_parts(dtype=dtype, device=device)[0]
