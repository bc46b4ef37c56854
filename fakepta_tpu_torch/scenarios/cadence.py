"""Telescope-cadence arrival processes (port of fakepta_tpu.scenarios.cadence).

The flagship's uniform grid observes every pulsar every week. Real PTA data
does not: each pulsar is timed by a subset of telescopes, each telescope
has its own cadence, duty cycle, receiver bands, commissioning and
retirement dates and maintenance shutdowns. :func:`draw_cadence` draws
those arrival processes and :func:`build_batch` turns them into a padded,
masked :class:`~fakepta_tpu_torch.batch.PulsarBatch` with per-backend
white levels, ECORR epochs and per-backend system-noise bands.

The epoch draws are host numpy, element for element the JAX package's
(same generators, same call order), so a scenario's sky is a pure function
of ``(cadence name, tspan, npsr, seed, thin)`` in both packages. So is the
stream lane's append schedule (:func:`history_block`,
:func:`append_schedule`, :func:`as_append_requests`): the cadence tail as
timed ``AppendRequest`` traffic for a served stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as const
from ..device import DeviceLike

DAY_S = 86400.0
#: MJD-seconds origin of every scenario's absolute epochs (the engine's
#: deterministic lanes need absolute float64 TOAs).
MJD0_S = 53000.0 * DAY_S


@dataclasses.dataclass(frozen=True)
class Telescope:
    """One telescope's observing pattern over the scenario span.

    ``cadence_days`` is the scheduled epoch spacing; ``duty_cycle`` the
    fraction of scheduled epochs actually observed (weather/scheduling
    losses, drawn per epoch); ``maintenance`` a tuple of
    ``(start_frac, end_frac)`` downtime windows in units of the scenario
    span; ``start_frac``/``end_frac`` the commissioning/retirement dates
    (Arecibo ends, MeerKAT begins); ``bands_mhz`` the receiver bands —
    each (telescope, band) pair is one backend with its own white-noise
    ``efac`` seam; ``jitter_days`` scatters epochs off the scheduled grid.
    """

    name: str
    cadence_days: float = 14.0
    duty_cycle: float = 0.9
    jitter_days: float = 1.0
    start_frac: float = 0.0
    end_frac: float = 1.0
    maintenance: Tuple[Tuple[float, float], ...] = ()
    bands_mhz: Tuple[float, ...] = (1400.0,)
    efac: float = 1.0


#: Named cadence families the registry's scenarios reference. ``uniform``
#: is the degenerate single-telescope always-on grid (the flagship's
#: cadence, built through ``PulsarBatch.synthetic``); the others are
#: stylized real arrays.
CADENCES: Dict[str, Tuple[Telescope, ...]] = {
    "uniform": (Telescope("uniform", cadence_days=7.0, duty_cycle=1.0,
                          jitter_days=0.0),),
    # NANOGrav-15yr-like: Arecibo collapses at ~85% of the span, GBT runs
    # throughout with a maintenance summer, two bands per telescope
    "ng15": (
        Telescope("arecibo", cadence_days=21.0, duty_cycle=0.85,
                  jitter_days=2.0, end_frac=0.85,
                  bands_mhz=(430.0, 1400.0), efac=0.9),
        Telescope("gbt", cadence_days=21.0, duty_cycle=0.8, jitter_days=2.0,
                  maintenance=((0.55, 0.58),), bands_mhz=(820.0, 1400.0),
                  efac=1.1),
    ),
    # IPTA-DR3-like: five observatories joining at different dates, legacy
    # backends retiring, long maintenance gaps, three receiver generations
    "ipta": (
        Telescope("effelsberg", cadence_days=28.0, duty_cycle=0.8,
                  jitter_days=3.0, bands_mhz=(1400.0, 2600.0), efac=1.2),
        Telescope("parkes", cadence_days=21.0, duty_cycle=0.75,
                  jitter_days=3.0, maintenance=((0.42, 0.45),),
                  bands_mhz=(700.0, 1400.0, 3100.0), efac=1.0),
        Telescope("arecibo", cadence_days=28.0, duty_cycle=0.85,
                  jitter_days=2.0, end_frac=0.8, bands_mhz=(1400.0,),
                  efac=0.9),
        Telescope("gbt", cadence_days=28.0, duty_cycle=0.8, jitter_days=2.0,
                  bands_mhz=(820.0, 1400.0), efac=1.1),
        Telescope("meerkat", cadence_days=14.0, duty_cycle=0.9,
                  jitter_days=1.0, start_frac=0.75, bands_mhz=(1300.0,),
                  efac=0.7),
    ),
    # SKA-era: two dense high-duty stations, monthly per pulsar (10k
    # pulsars share the dishes), one wide band each
    "ska": (
        Telescope("ska_mid", cadence_days=30.0, duty_cycle=0.95,
                  jitter_days=2.0, bands_mhz=(1400.0,), efac=0.6),
        Telescope("ska_low", cadence_days=30.0, duty_cycle=0.95,
                  jitter_days=2.0, start_frac=0.1, bands_mhz=(350.0,),
                  efac=0.8),
    ),
}


def _telescope_epochs(tel: Telescope, tspan_s: float, thin: int,
                      rng: np.random.Generator) -> np.ndarray:
    """One telescope's observed epoch times [s] over ``tspan_s``."""
    step = tel.cadence_days * max(int(thin), 1) * DAY_S
    lo, hi = tel.start_frac * tspan_s, tel.end_frac * tspan_s
    # phase-offset grid so telescopes never alias onto a common week
    grid = np.arange(lo + rng.uniform(0.0, step), hi, step)
    if grid.size == 0:
        return grid
    keep = rng.uniform(size=grid.size) < tel.duty_cycle
    for m_lo, m_hi in tel.maintenance:
        keep &= ~((grid >= m_lo * tspan_s) & (grid < m_hi * tspan_s))
    t = grid[keep] + rng.normal(0.0, tel.jitter_days * DAY_S,
                                keep.sum())
    return np.sort(np.clip(t, 0.0, tspan_s * (1.0 - 1e-9)))


@dataclasses.dataclass(frozen=True)
class PulsarCadence:
    """One pulsar's drawn arrival process: sorted epoch times [s since
    span start], per-TOA observing frequency [MHz], per-TOA backend index
    into ``backends`` (``"<telescope>:<band>"`` labels), and the
    per-backend white-noise efac."""

    t: np.ndarray
    freqs: np.ndarray
    backend: np.ndarray
    backends: Tuple[str, ...]
    efacs: np.ndarray


def draw_cadence(cadence: str, tspan_years: float, npsr: int, seed: int,
                 thin: int = 1,
                 min_toa: int = 8) -> List[PulsarCadence]:
    """Draw every pulsar's arrival process for a named cadence family.

    Each pulsar is observed by a random non-empty subset of the family's
    telescopes (dense arrays share dishes: the subset is weighted toward
    1-2 telescopes); every (telescope, band) pair it sees becomes one of
    its backends. ``thin`` multiplies every cadence (the reduced /
    CPU-stand-in knob — same process, sparser sampling). Deterministic in
    ``(cadence, tspan_years, npsr, seed, thin)``.
    """
    if cadence not in CADENCES:
        raise KeyError(f"unknown cadence family {cadence!r}; "
                       f"known: {sorted(CADENCES)}")
    tels = CADENCES[cadence]
    tspan_s = tspan_years * const.yr
    out: List[PulsarCadence] = []
    for i in range(npsr):
        rng = np.random.default_rng((seed, 0x5CAD, i))
        n_tel = 1 + int(rng.uniform() < 0.5) if len(tels) > 1 else 1
        n_tel = min(n_tel + int(rng.uniform() < 0.2), len(tels))
        picked = sorted(rng.choice(len(tels), size=n_tel, replace=False))
        t_all: List[np.ndarray] = []
        f_all: List[np.ndarray] = []
        b_all: List[np.ndarray] = []
        backends: List[str] = []
        efacs: List[float] = []
        for k in picked:
            tel = tels[k]
            t = _telescope_epochs(tel, tspan_s, thin, rng)
            if t.size == 0:
                continue
            band = rng.integers(0, len(tel.bands_mhz), t.size)
            for bi, mhz in enumerate(tel.bands_mhz):
                sel = band == bi
                if not sel.any():
                    continue
                b_idx = len(backends)
                backends.append(f"{tel.name}:{int(mhz)}")
                efacs.append(tel.efac)
                t_all.append(t[sel])
                f_all.append(np.full(sel.sum(), mhz))
                b_all.append(np.full(sel.sum(), b_idx, dtype=np.int32))
        if not t_all or sum(t.size for t in t_all) < min_toa:
            # a pulsar nobody observed enough: fall back to the first
            # telescope's full grid so the batch never carries an
            # un-invertible empty row
            tel = tels[0]
            t = np.linspace(0.0, tspan_s * (1 - 1e-9),
                            max(min_toa, int(tspan_s / (
                                tel.cadence_days * max(thin, 1) * DAY_S))))
            t_all, f_all = [t], [np.full(t.size, tel.bands_mhz[0])]
            b_all = [np.zeros(t.size, dtype=np.int32)]
            backends, efacs = [f"{tel.name}:{int(tel.bands_mhz[0])}"], \
                [tel.efac]
        t = np.concatenate(t_all)
        order = np.argsort(t, kind="stable")
        out.append(PulsarCadence(
            t=t[order], freqs=np.concatenate(f_all)[order],
            backend=np.concatenate(b_all)[order],
            backends=tuple(backends), efacs=np.array(efacs)))
    return out


def build_batch(scenario, dtype: torch.dtype = torch.float32,
                device: DeviceLike = None):
    """Materialize a telescope-cadence scenario as a batch on ``device``
    (default ``"cuda"``).

    Returns ``(batch, toas_abs, backend_id, n_backends)``: the
    :class:`~fakepta_tpu_torch.batch.PulsarBatch` (uneven per-pulsar TOA
    counts padded + masked, per-backend white levels, ECORR epochs,
    per-backend system-noise bands), the (P, T) float64 absolute
    MJD-second epochs, and the (P, T) int32 backend-index array + count
    (``WhiteSampling``), the last three as host numpy. Every leaf is built
    in host float64 and cast once to ``dtype``, as the JAX package does.
    The padded TOA count is rounded up to a multiple of 8.
    """
    from .. import spectrum as spectrum_lib
    from ..batch import PulsarBatch
    from ..ops.white import quantise_epochs
    from ..utils.masks import stack_ragged

    cads = draw_cadence(scenario.cadence, scenario.tspan_years,
                        scenario.npsr, scenario.data_seed,
                        thin=scenario.cadence_thin)
    toas_list = [c.t for c in cads]
    tmin = min(t.min() for t in toas_list)
    tmax = max(t.max() for t in toas_list)
    tspan_common = tmax - tmin

    toas_pad, mask = stack_ragged(toas_list)
    npsr, T = toas_pad.shape
    if T % 8:                                  # toa mesh-axis divisibility
        pad = 8 - T % 8
        toas_pad = np.pad(toas_pad, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
        T += pad

    rng = np.random.default_rng((scenario.data_seed, 0x5C10))
    costh = rng.uniform(-1, 1, npsr)
    phi = rng.uniform(0, 2 * np.pi, npsr)
    pos = np.stack([np.sqrt(1 - costh**2) * np.cos(phi),
                    np.sqrt(1 - costh**2) * np.sin(phi), costh], axis=-1)

    t_own = np.zeros((npsr, T))
    freqs = np.full((npsr, T), 1400.0)
    sigma2 = np.zeros((npsr, T))
    epoch_idx = np.zeros((npsr, T), dtype=np.int32)
    ecorr_amp = np.zeros((npsr, T))
    backend_id = np.zeros((npsr, T), dtype=np.int32)
    df_own = np.zeros(npsr)
    n_backends = max(len(c.backends) for c in cads)

    def own_grid_psd(tspan, nbin, log10_A, gamma):
        f = np.arange(1, nbin + 1) / tspan
        return spectrum_lib.powerlaw(f, log10_A, gamma).numpy()

    red = np.zeros((npsr, scenario.n_red))
    dm = np.zeros((npsr, scenario.n_dm))
    chrom = np.zeros((npsr, max(scenario.n_chrom, 1)))
    sys_psd = np.zeros((npsr, max(n_backends, 1), max(scenario.n_sys, 1)))
    sys_mask = np.zeros((npsr, max(n_backends, 1), T), dtype=bool)

    for i, c in enumerate(cads):
        n = c.t.size
        tspan_p = c.t.max() - c.t.min()
        df_own[i] = 1.0 / tspan_p
        t_own[i, :n] = (c.t - c.t.min()) / tspan_p
        freqs[i, :n] = c.freqs
        backend_id[i, :n] = c.backend
        efac_toa = c.efacs[c.backend]
        sigma2[i, :n] = (efac_toa * scenario.toaerr) ** 2
        red[i] = own_grid_psd(tspan_p, scenario.n_red,
                              scenario.red_log10_A, scenario.red_gamma)
        dm[i] = own_grid_psd(tspan_p, scenario.n_dm,
                             scenario.dm_log10_A, scenario.dm_gamma)
        if scenario.chrom_log10_A is not None and scenario.n_chrom:
            chrom[i, :scenario.n_chrom] = own_grid_psd(
                tspan_p, scenario.n_chrom, scenario.chrom_log10_A,
                scenario.chrom_gamma)
        if scenario.ecorr:
            flags = np.array([c.backends[b] for b in c.backend])
            idx, _, ep_counts = quantise_epochs(
                c.t - c.t.min(), flags,
                dt=scenario.ecorr_dt_days * DAY_S)
            epoch_idx[i, :n] = idx
            amp = np.full(n, 10.0 ** scenario.log10_ecorr)
            # single-TOA epochs get white noise only; at a 1-day epoch
            # window on these cadences every epoch holds one TOA, so the
            # amplitudes all come out 0 (as in the JAX package)
            amp[ep_counts[idx] < 2] = 0.0
            ecorr_amp[i, :n] = amp
        if scenario.n_sys:
            band_psd = own_grid_psd(tspan_p, scenario.n_sys,
                                    scenario.sys_log10_A,
                                    scenario.sys_gamma)
            for b in range(len(c.backends)):
                sel = np.zeros(T, dtype=bool)
                sel[:n] = c.backend == b
                if sel.any():
                    sys_mask[i, b] = sel
                    sys_psd[i, b] = band_psd

    t_common = (toas_pad - tmin) / tspan_common * mask
    toas_abs = np.where(mask, MJD0_S + toas_pad, 0.0)

    batch = PulsarBatch.from_numpy(dict(
        t_own=t_own, t_common=t_common, mask=mask, freqs=freqs,
        sigma2=sigma2, pos=pos, red_psd=red, dm_psd=dm, chrom_psd=chrom,
        epoch_idx=epoch_idx, ecorr_amp=ecorr_amp, sys_psd=sys_psd,
        sys_mask=sys_mask, df_own=df_own,
        tspan_common=np.asarray(tspan_common)), device=device, dtype=dtype)
    return batch, toas_abs, backend_id, n_backends


@dataclasses.dataclass(frozen=True)
class AppendBlock:
    """One observing window of the cadence tail, shaped for
    ``StreamState.append``: ``toas`` is (P, B) seconds from the stream's
    shared origin (the template's t=0) with the valid prefix per pulsar
    marked by ``counts`` (a pulsar nobody observed that window has count
    0), ``freqs`` the matching band frequencies, and ``t_start_s`` the
    window's wall-clock offset from the schedule start; the replay timer
    for timed append traffic."""

    t_start_s: float
    toas: np.ndarray
    counts: np.ndarray
    freqs: np.ndarray


def history_block(scenario, history_frac: float = 0.85) -> AppendBlock:
    """Everything observed BEFORE the ``history_frac`` cut, as one bulk
    append block: the stream lane's staging load (bulk history first,
    then :func:`append_schedule`'s timed tail)."""
    cads = draw_cadence(scenario.cadence, scenario.tspan_years,
                        scenario.npsr, scenario.data_seed,
                        thin=scenario.cadence_thin)
    t0 = history_frac * scenario.tspan_years * const.yr
    rows = [(c.t[c.t < t0], c.freqs[c.t < t0]) for c in cads]
    width = max(max((t.size for t, _ in rows), default=1), 1)
    toas = np.zeros((scenario.npsr, width))
    freqs = np.full((scenario.npsr, width), 1400.0)
    counts = np.zeros(scenario.npsr, dtype=np.int64)
    for i, (t, f) in enumerate(rows):
        counts[i] = t.size
        toas[i, :t.size] = t
        freqs[i, :t.size] = f
    return AppendBlock(t_start_s=0.0, toas=toas, counts=counts, freqs=freqs)


def append_schedule(scenario, history_frac: float = 0.85,
                    window_days: float = 30.0,
                    max_blocks: Optional[int] = None) -> List[AppendBlock]:
    """Split the cadence tail after ``history_frac`` into observing-window
    append blocks.

    The window walks the tail in fixed ``window_days`` steps; windows where
    no telescope observed produce NO block (real silent weeks; the
    zero-recompile contract has to hold across the resulting bucket
    mix), and block widths vary with how many backends happened to
    observe, exercising the bucket ladder the way uniform synthetic
    appends cannot.
    """
    cads = draw_cadence(scenario.cadence, scenario.tspan_years,
                        scenario.npsr, scenario.data_seed,
                        thin=scenario.cadence_thin)
    tspan_s = scenario.tspan_years * const.yr
    t0 = history_frac * tspan_s
    step = window_days * DAY_S
    blocks: List[AppendBlock] = []
    lo = t0
    while lo < tspan_s:
        hi = lo + step
        rows = []
        for c in cads:
            sel = (c.t >= lo) & (c.t < hi)
            rows.append((c.t[sel], c.freqs[sel]))
        width = max((t.size for t, _ in rows), default=0)
        if width:
            toas = np.zeros((scenario.npsr, width))
            freqs = np.full((scenario.npsr, width), 1400.0)
            counts = np.zeros(scenario.npsr, dtype=np.int64)
            for i, (t, f) in enumerate(rows):
                counts[i] = t.size
                # stream-origin seconds (StreamState's shared origin is the
                # template's t=0, NOT MJD); padding slots replay the
                # window start so normalization stays in range; counts
                # masks them out
                toas[i, :t.size] = t
                toas[i, t.size:] = lo
                freqs[i, :t.size] = f
            blocks.append(AppendBlock(t_start_s=lo - t0, toas=toas,
                                      counts=counts, freqs=freqs))
        lo = hi
        if max_blocks is not None and len(blocks) >= max_blocks:
            break
    return blocks


def as_append_requests(blocks: Sequence[AppendBlock], stream: str,
                       spec=None, *, toaerr: float = 1e-7,
                       seed: int = 0, ecorr_dt: Optional[float] = None):
    """Wrap an append schedule as served ``AppendRequest`` traffic.

    The first request carries the stream-opening ``spec``/``ecorr_dt``;
    residuals are white draws at the scenario's TOA error (the served
    stream measures ingestion, not astrophysics). Returns
    ``[(t_start_s, AppendRequest), ...]``; the caller replays them
    against a pool/fleet on the schedule's clock (or as fast as it
    wants; ``t_start_s`` preserves the arrival process either way).
    """
    from ..serve.spec import AppendRequest

    rng = np.random.default_rng((seed, 0xA99))
    out = []
    for k, blk in enumerate(blocks):
        res = rng.normal(0.0, toaerr, blk.toas.shape)
        out.append((blk.t_start_s, AppendRequest(
            stream=stream, toas=blk.toas, residuals=res,
            counts=blk.counts, freqs=blk.freqs,
            spec=spec if k == 0 else None,
            ecorr_dt=ecorr_dt if k == 0 else None)))
    return out
