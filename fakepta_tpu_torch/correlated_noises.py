"""Cross-pulsar correlated signals: ORFs, the GWB injectors, correlation
diagnostics (port of fakepta_tpu.correlated_noises).

Public-API parity with the reference's ``correlated_noises.py``
(``get_correlation`` / ``get_correlations`` / ``bin_curve`` /
``create_gw_antenna_pattern`` / ``hd`` / ``anisotropic`` / ``monopole`` /
``dipole`` / ``curn`` / ``add_common_correlated_noise`` /
``add_roemer_delay``) and the JAX package's additions
(``optimal_statistic``, ``add_common_correlated_noise_gp``):

- ORF matrices are closed-form host-float64 expressions on the (npsr, 3)
  position block (:mod:`.ops.gwb`);
- the GWB draw factorizes the ORF once and draws every (cos/sin, component)
  amplitude in one correlated block (:func:`.ops.gwb.draw_correlated_coeffs`,
  at the pulsars' dtype, the JAX facade's keys and draw shape), then
  projects each pulsar's column on its host-float64 phase table, on the
  device the pulsars hold; a uniform array (one TOA count, one device and
  dtype, uniform re-injection state) projects in one batch, any other
  pulsar by pulsar, with the same draws;
- :func:`add_common_correlated_noise_gp` draws the joint dense covariance
  at the true TOAs on the host in float64, from normals drawn at the
  pulsars' dtype (the JAX facade's float32 draw, or its float64 one under
  x64).

Every injector follows the pulsars' dtype (``Pulsar(dtype=...)``): float32,
or float64 for the JAX facade's x64 mode; an array of mixed dtypes raises.

The diagnostics are host numpy.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import spectrum as spectrum_lib
from .ops import fourier as fourier_ops
from .ops import gwb as gwb_ops
from .utils import rng as rng_utils

__all__ = [
    "get_correlation", "get_correlations", "bin_curve",
    "create_gw_antenna_pattern", "hd", "anisotropic", "monopole", "dipole",
    "curn", "optimal_statistic", "add_common_correlated_noise",
    "add_common_correlated_noise_gp", "add_roemer_delay",
]


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

def get_correlation(psr_a, psr_b, res_a, res_b):
    """Pair statistic ``<r_a . r_b>/n`` and angular separation."""
    angle = np.arccos(np.clip(np.dot(psr_a.pos, psr_b.pos), -1.0, 1.0))
    corr = np.dot(res_a, res_b) / len(res_a)
    return corr, angle


def get_correlations(psrs, res):
    """All-pair cross-correlations, separations and autocorrelations.

    ``res`` is a per-pulsar sequence of residual vectors; pairs need equal
    lengths (the statistic is only meaningful on a common grid).
    """
    npsr = len(psrs)
    corrs, angles, autocorrs = [], [], []
    for i in range(npsr):
        for j in range(i + 1):
            if len(res[i]) != len(res[j]):
                raise ValueError(
                    "get_correlations needs equal-length residual vectors "
                    f"per pair (pulsars {i} and {j} have {len(res[i])} vs "
                    f"{len(res[j])}); use parallel.montecarlo ensemble "
                    "statistics for ragged arrays")
            c, a = get_correlation(psrs[i], psrs[j], res[i], res[j])
            if i == j:
                autocorrs.append(c)
            else:
                corrs.append(c)
                angles.append(a)
    return np.array(corrs), np.array(angles), np.array(autocorrs)


def optimal_statistic(corr, pos, orf="hd", sigma2=None, counts=None,
                      h_map=None, null_amp2=None):
    """Noise-weighted optimal cross-correlation statistic per realization:

        A2_r = sum_ab rho_ab Gamma_ab / Var_ab  /  sum_ab Gamma_ab^2 / Var_ab

    with ``Var_ab = sigma2_a sigma2_b / counts_ab``, through the same
    weighting core as the engine's OS lane
    (:func:`.detect.operators.pair_weighting`).

    ``corr``: (R, P, P) pair-correlation matrices (``run(...,
    keep_corr=True)["corr"]``) or one (P, P) matrix; ``pos`` (P, 3) unit
    vectors; ``orf`` a template name (``h_map`` for ``'anisotropic'``);
    ``sigma2`` (P,) noise autocorrelations (default: the ensemble-mean
    diagonal of ``corr``); ``counts`` (P, P) valid-pair TOA counts
    (default 1, which leaves the analytic sigma off by ~sqrt(N_toa) and
    warns unless ``null_amp2`` is given); ``null_amp2`` an amp2 sample
    from a matched null ensemble, whose standard deviation then replaces
    the analytic sigma.

    Returns a dict with ``amp2`` (R,), ``sigma`` and ``snr`` (R,).
    """
    from .detect.operators import pair_weighting

    corr = np.asarray(corr)
    if corr.ndim == 2:
        corr = corr[None]
    npsr = corr.shape[1]
    orfs = np.asarray(gwb_ops.build_orf(orf, np.asarray(pos), h_map))
    if sigma2 is None:
        sigma2 = corr[:, np.arange(npsr), np.arange(npsr)].mean(0)
    # pairs with zero shared TOAs carry zero weight
    a, b, gam, inv_var, denom = pair_weighting(
        orfs, sigma2,
        np.ones((npsr, npsr)) if counts is None else counts)
    rho = corr[:, a, b]
    if denom <= 0.0:
        raise ValueError(
            f"ORF {orf!r} has no weighted cross-correlation signal (e.g. "
            f"'curn' is diagonal, or no pulsar pair shares TOAs) — the "
            f"optimal statistic is undefined for it")
    amp2 = (rho * (gam * inv_var)).sum(axis=1) / denom
    if null_amp2 is not None:
        null_amp2 = np.asarray(null_amp2, dtype=np.float64).ravel()
        if null_amp2.size < 2:
            raise ValueError("null_amp2 needs at least 2 null realizations "
                             "to estimate an empirical sigma")
        sigma_amp2 = float(np.std(null_amp2, ddof=1))
    else:
        if counts is None:
            warnings.warn(
                "optimal_statistic without counts: the analytic sigma/snr "
                "are off by ~sqrt(N_toa) and not comparable across TOA "
                "counts; pass counts=mask @ mask.T (EnsembleSimulator holds "
                "them) or calibrate empirically via null_amp2",
                stacklevel=2)
        sigma_amp2 = denom ** -0.5
    return {"amp2": amp2, "sigma": sigma_amp2, "snr": amp2 / sigma_amp2}


def bin_curve(corrs, angles, bins):
    """Angular-binned mean/std of pair correlations."""
    edges = np.linspace(0.0, np.pi, bins + 1)
    centers = edges[:-1] + 0.5 * (edges[1] - edges[0])
    mean, std = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (angles > lo) & (angles < hi)
        mean.append(np.mean(corrs[sel]) if sel.any() else np.nan)
        std.append(np.std(corrs[sel]) if sel.any() else np.nan)
    return np.array(mean), np.array(std), np.array(centers)


# ---------------------------------------------------------------------------
# ORFs: reference-parity wrappers over the host-f64 builders
# ---------------------------------------------------------------------------

def _positions(psrs):
    if isinstance(psrs, np.ndarray) and psrs.ndim == 2:
        return psrs
    return np.stack([psr.pos for psr in psrs])


def create_gw_antenna_pattern(pos, gwtheta, gwphi):
    """F+, Fx, cosMu of one pulsar against a grid of GW directions."""
    fplus, fcross, cosmu = gwb_ops.antenna_patterns(
        np.asarray(pos)[None, :], gwtheta, gwphi)
    return fplus[0], fcross[0], cosmu[0]


def hd(psrs):
    """Hellings-Downs ORF matrix."""
    return gwb_ops.hd_orf(_positions(psrs))


def anisotropic(psrs, h_map):
    """ORF from a HEALPix intensity map."""
    return gwb_ops.anisotropic_orf(_positions(psrs), np.asarray(h_map))


def monopole(psrs):
    return gwb_ops.monopole_orf(_positions(psrs))


def dipole(psrs):
    return gwb_ops.dipole_orf(_positions(psrs))


def curn(psrs):
    return gwb_ops.curn_orf(_positions(psrs))


# ---------------------------------------------------------------------------
# the GWB injectors
# ---------------------------------------------------------------------------

def _array_tspan(psrs):
    return (max(psr.toas.max() for psr in psrs)
            - min(psr.toas.min() for psr in psrs))


def _array_dtype(psrs) -> torch.dtype:
    """The one dtype of the array's pulsars (``TypeError`` when they
    differ: the common draw has one dtype)."""
    dtypes = {p._dtype for p in psrs}
    if len(dtypes) != 1:
        raise TypeError(f"a common signal needs one dtype across the array, "
                        f"got {sorted(str(d) for d in dtypes)}")
    return dtypes.pop()


def _resolve_common_psd(spectrum, f_psd, custom_psd, kwargs, dtype):
    """(host PSD, kwargs to record): a named spectrum evaluates on the CPU
    at the pulsars' ``dtype`` (the JAX facade's precision in its float32
    or x64 mode), a custom one is taken at float64."""
    if spectrum == "custom":
        if custom_psd is None or len(custom_psd) != len(f_psd):
            raise ValueError('"custom_psd" and "f_psd" must be given with '
                             'equal length')
        return np.asarray(custom_psd, dtype=np.float64), {}
    if spectrum not in spectrum_lib.SPECTRA:
        raise KeyError(f"unknown spectrum {spectrum!r}")
    return spectrum_lib.evaluate_host_at(spectrum, f_psd, dtype,
                                         **kwargs), kwargs


def _common_grid(psrs, components, f_psd):
    """(f_psd, df) of a common signal: ``(1..components)/Tspan_array``
    unless given."""
    if f_psd is None:
        f_psd = np.arange(1, components + 1) / _array_tspan(psrs)
    f_psd = np.asarray(f_psd, dtype=np.float64)
    return f_psd, np.diff(np.concatenate([[0.0], f_psd]))


def _old_realization(psrs, old, device, dtype):
    """(G, T) realizations at ``dtype`` of stored ``fourier`` entries
    ``old`` (one per pulsar), each on its own entry's f / idx / freqf
    tables: what was injected, whatever this call's scaling is."""
    from .fake_pta import _gp_realization

    tabs = [p._phase_scale(np.asarray(o["f"], dtype=np.float64), o["idx"],
                           o.get("freqf", 1400.0), None)
            for p, o in zip(psrs, old)]
    return _gp_realization(np.stack([t[0] for t in tabs]),
                           np.stack([t[1] for t in tabs]),
                           np.stack([np.asarray(o["fourier"]) for o in old]),
                           tabs[0][2], device, dtype)


def _gwb_project(psrs, coeffs, f_psd, idx, freqf, inv_sqrt_df, device):
    """(delta (G, T), stored coefficients (G, 2, ncomp)), at the dtype of
    ``coeffs``, of pulsars ``g`` whose columns of the correlated block are
    ``coeffs[..., g]``."""
    from .fake_pta import _dev

    dtype = coeffs.dtype
    tabs = [p._phase_scale(f_psd, idx, freqf, None) for p in psrs]
    cols = coeffs.to(device).permute(2, 0, 1)                # (G, 2, ncomp)
    basis = fourier_ops.basis_from_phase(
        _dev(np.stack([t[0] for t in tabs]), device, dtype),
        _dev(np.stack([t[1] for t in tabs]), device, dtype))
    delta = fourier_ops.inject_from_coeffs(
        basis, cols, _dev(tabs[0][2], device, dtype))
    return delta, cols * _dev(inv_sqrt_df, device, dtype)[None, None, :]


def _gwb_apply_batched(psrs, signal_name, f_psd, idx, freqf, coeffs,
                       inv_sqrt_df):
    """Whole-array GWB injection in one batch when the array is uniform
    (one TOA count, one device, no stored entry or every pulsar with one
    of one (f, idx, freqf, shape)): updates every pulsar's residuals and
    returns the per-pulsar stored coefficients, or None (the caller falls
    back to the per-pulsar path)."""
    from .fake_pta import _batchable_olds, _one_place, _stack_current

    place = _one_place(psrs)
    if place is None or len({len(p.toas) for p in psrs}) != 1:
        return None
    olds = _batchable_olds(psrs, signal_name)
    if olds is None:
        return None
    dev, dtype = place
    cur = _stack_current(psrs, dev, dtype)
    delta, four = _gwb_project(psrs, coeffs, f_psd, idx, freqf,
                               inv_sqrt_df, dev)
    if olds:
        delta = delta - _old_realization(psrs, olds, dev, dtype)
    new = cur + delta
    for g, p in enumerate(psrs):
        p.residuals = new[g]
    return list(four.cpu().numpy())


def add_common_correlated_noise(psrs, orf="hd", spectrum="powerlaw",
                                name="gw", idx=0, components=30, freqf=1400,
                                custom_psd=None, f_psd=None, h_map=None,
                                seed=None, **kwargs):
    """Inject a cross-pulsar-correlated common signal (the GWB path).

    One shared frequency grid over the array Tspan; per-pulsar
    ``signal_model`` entries under ``'<name>_common'`` (orf / spectrum /
    hmap / f / psd / fourier / nbin / idx / freqf); re-injection subtracts
    the previous realization (a joint-covariance entry is subtracted and
    replaced). The amplitudes are drawn with covariance ORF through one
    Cholesky and one product (:func:`.ops.gwb.draw_correlated_coeffs`, at
    the pulsars' dtype): with ``seed`` from ``key(seed)``, else from the
    next key of the package's ``"gwb"`` stream. Returns the ORF matrix.
    """
    signal_name = f"{name}_common" if name is not None else "common"
    psrs = list(psrs)
    dtype = _array_dtype(psrs)
    f_psd, df = _common_grid(psrs, components, f_psd)
    components = len(f_psd)

    psd_gwb, resolved = _resolve_common_psd(spectrum, f_psd, custom_psd,
                                            kwargs, dtype)
    if resolved:
        for psr in psrs:
            psr.update_noisedict(signal_name, resolved)

    # one Cholesky for the whole injection; (2, ncomp, npsr) correlated block
    orfs = gwb_ops.build_orf(orf, _positions(psrs), h_map)
    chol = gwb_ops.orf_cholesky(orfs)
    if seed is not None:
        key, folds = rng_utils.as_key(seed), rng_utils.NO_FOLDS
    else:
        key, folds = rng_utils.KeyStream(None, "gwb").next_spec()
    key = rng_utils.fold_key_in_kernel(key.cpu(), folds).to(psrs[0]._dev())
    coeffs = gwb_ops.draw_correlated_coeffs(key, chol, psd_gwb, dtype=dtype)
    inv_sqrt_df = 1.0 / np.sqrt(df)

    four_vals = _gwb_apply_batched(psrs, signal_name, f_psd, idx, freqf,
                                   coeffs, inv_sqrt_df)
    if four_vals is None:
        # ragged TOAs, several devices, mixed re-injection state or
        # joint-covariance entries: pulsar by pulsar, the same draws
        four_vals = []
        for n, psr in enumerate(psrs):
            old = psr.signal_model.get(signal_name)
            if old is not None and "fourier" not in old:
                # a joint-covariance entry stores the realization itself
                psr._accumulate(-psr._reconstruct_signal_dev([signal_name]))
                old = None
            dev = psr._dev()
            delta, four = _gwb_project([psr], coeffs[..., n:n + 1], f_psd,
                                       idx, freqf, inv_sqrt_df, dev)
            if old is not None:
                delta = delta - _old_realization([psr], [old], dev, dtype)
            psr.residuals = psr._res_current() + delta[0]
            four_vals.append(four[0])
        # read back after the loop: a copy per pulsar would wait for that
        # pulsar's work before the next one is enqueued
        four_vals = [f.cpu().numpy() for f in four_vals]

    for n, psr in enumerate(psrs):
        psr.signal_model[signal_name] = {
            "orf": orf,
            "spectrum": spectrum,
            "hmap": h_map,
            "f": f_psd,
            "psd": psd_gwb,
            "fourier": four_vals[n],
            "nbin": components,
            "idx": idx,
            "freqf": freqf,
        }
    return np.asarray(orfs)


def add_common_correlated_noise_gp(psrs, orf="hd", spectrum="powerlaw",
                                   name="gw", idx=0, components=30,
                                   freqf=1400, custom_psd=None, f_psd=None,
                                   h_map=None, seed=None, **kwargs):
    """Joint dense-covariance GWB draw at the true TOAs.

    Builds ``C[(a,t),(b,u)] = orf_ab sum_k psd_k df_k [cos cos + sin sin]``
    (chromatic-scaled) on the host in float64, Cholesky-samples the whole
    array in one shot from standard normals drawn at the pulsars' dtype
    (the JAX facade's draws, float32 or under x64 float64: ``key(seed)``,
    else the next key of the package's ``"gwb_gp"`` stream) and adds each
    pulsar's slice to its residuals. Exact but
    O((sum n_toa)^3): refused above 20000 TOAs in all. Records
    ``{'realization': ...}`` per pulsar so reconstruct / remove still work;
    a prior injection under the same name is subtracted first.
    """
    signal_name = f"{name}_common" if name is not None else "common"
    psrs = list(psrs)
    dtype = _array_dtype(psrs)
    f_psd, df = _common_grid(psrs, components, f_psd)
    psd_gwb, resolved = _resolve_common_psd(spectrum, f_psd, custom_psd,
                                            kwargs, dtype)
    if resolved:
        for psr in psrs:
            psr.update_noisedict(signal_name, resolved)

    orfs = np.asarray(gwb_ops.build_orf(orf, _positions(psrs), h_map))
    sizes = [len(psr.toas) for psr in psrs]
    total = sum(sizes)
    if total > 20000:
        raise ValueError(
            f"joint covariance would be {total}x{total}; use "
            "add_common_correlated_noise (factorized, exact) at this scale")

    # per-pulsar basis F_a sqrt(S df), chromatic-scaled:
    # C_ab = orf_ab B_a B_b^T
    weights = np.sqrt(psd_gwb * df)
    bases = []
    for psr in psrs:
        phase = 2.0 * np.pi * (np.outer(psr.toas, f_psd) % 1.0)
        chrom = ((freqf / np.asarray(psr.freqs)) ** idx)[:, None]
        bases.append(chrom * np.concatenate([np.cos(phase) * weights,
                                             np.sin(phase) * weights],
                                            axis=1))
    cov = np.empty((total, total))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for a in range(len(psrs)):
        for b in range(len(psrs)):
            cov[offsets[a]:offsets[a + 1], offsets[b]:offsets[b + 1]] = \
                orfs[a, b] * (bases[a] @ bases[b].T)

    key = rng_utils.as_key(seed) if seed is not None else \
        rng_utils.KeyStream(None, "gwb_gp").next()
    # rank 2*ncomp*npsr < N by construction: regularize relative to the
    # covariance's own scale before factorizing
    jitter = 1e-10 * np.mean(np.diag(cov))
    chol = np.linalg.cholesky(cov + jitter * np.eye(total))
    # at float32 the draw stays the two-argument call it has always been
    # (the float32 tests stub it with that signature)
    z = (rng_utils.normal(key.cpu(), (total,)) if dtype == torch.float32
         else rng_utils.normal(key.cpu(), (total,), dtype=dtype))
    z = z.numpy().astype(np.float64)
    draw = chol @ z

    for a, psr in enumerate(psrs):
        if signal_name in psr.signal_model:
            # a prior injection under this name (either kind) goes first
            psr._accumulate(-psr._reconstruct_signal_dev([signal_name]))
        realization = draw[offsets[a]:offsets[a + 1]]
        psr.signal_model[signal_name] = {
            "orf": orf, "spectrum": spectrum, "hmap": h_map, "f": f_psd,
            "psd": psd_gwb, "nbin": len(f_psd), "idx": idx, "freqf": freqf,
            "realization": realization,
        }
        psr._accumulate(realization)
    return orfs


# ---------------------------------------------------------------------------
# array-level Roemer delay
# ---------------------------------------------------------------------------

def add_roemer_delay(psrs, planet, d_mass=0.0, d_Om=0.0, d_omega=0.0,
                     d_inc=0.0, d_a=0.0, d_e=0.0, d_l0=0.0):
    """Accumulate a perturbed-ephemeris Roemer delay (host float64, the
    ephemeris' :meth:`~.ephemeris.Ephemeris.roemer_delay`) into every
    pulsar, at each pulsar's dtype; every pulsar needs an ``ephem``."""
    for psr in psrs:
        if getattr(psr, "ephem", None) is None:
            raise ValueError(f'"ephem" not found in pulsar {psr.name}')
    for psr in psrs:
        psr._accumulate(psr.ephem.roemer_delay(
            psr.toas, psr.pos, planet, d_mass, d_Om, d_omega, d_inc, d_a,
            d_e, d_l0))
