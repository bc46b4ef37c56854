"""Host-float64 precompute for the device optimal-statistic (OS) lane.

Port of :mod:`fakepta_tpu.detect.operators` (numpy only; its own copy, not
an import). The noise-weighted optimal statistic is, per realization ``r``
with pair-correlation matrix ``rho_ab = S_ab / counts_ab`` (``S`` the raw
pair sums the engine's correlation produces),

    amp2_r = sum_{a<b} rho_ab Gamma_ab / Var_ab  /  sum_{a<b} Gamma_ab^2 / Var_ab
    Var_ab = sigma2_a sigma2_b / counts_ab

the reference host ``optimal_statistic``, which shares :func:`pair_weighting`
in the JAX package. Substituting ``rho = S / counts`` makes the per-pair
counts cancel, so the whole statistic is ONE static (P, P) weight matrix
contracted against the raw pair sums,

    amp2_r = sum_ab S_ab W_ab,     W_ab = Gamma_ab / (sigma2_a sigma2_b) / (2 denom)

the same shape as the engine's angular-binning and auto weights. That is
what lets the OS ride the engine's statistic weight slots beside the
curves (``EnsembleSimulator.run(os=...)``), in the same contraction or
kernel launch, with no (R, P, P) tensor leaving the device.

Everything here is one-off host staging at float64 (ORF closed forms via
:func:`..ops.gwb.build_orf`, count matrices, weight normalizations); the
contraction runs on the device at the batch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..ops import gwb as gwb_ops

#: schema tag for detection-run artifacts (summary dicts, saved JSON-lines)
DETECT_SCHEMA = "fakepta_tpu.detect/1"

#: ORF templates the OS lane accepts. 'curn' is deliberately rejected at
#: operator build time — it is diagonal, so the cross-correlation statistic
#: is undefined for it (the host ``optimal_statistic`` raises identically).
KNOWN_ORFS = ("hd", "monopole", "dipole", "curn", "anisotropic")

#: null-ensemble quantiles recorded per run (per-mille precision needs more
#: realizations than a typical run carries; these four are the standard
#: detection thresholds)
NULL_QUANTILES = (0.5, 0.9, 0.95, 0.99)


@dataclasses.dataclass(frozen=True)
class OSSpec:
    """Configuration of the device OS lane (``EnsembleSimulator.run(os=...)``
    of :mod:`fakepta_tpu_torch.parallel.montecarlo`).

    ``orf`` names one or several ORF templates ('hd', 'monopole', 'dipole';
    'anisotropic' additionally needs ``h_map``); each gets its own packed
    lane. ``weighting`` is ``'noise'`` (per-pulsar white-noise variance from
    the batch + valid-pair TOA counts — the standard inverse-variance OS) or
    ``'none'`` (uniform weights: the plain ORF-matched filter). ``sigma2``
    optionally overrides the per-pulsar noise levels (a (P,) array, e.g. an
    ensemble-measured diagonal). ``null=True`` additionally runs a paired
    noise-only stream inside the same device program (keys derived per
    realization with the engine's 0xD7 domain tag) and packs its OS values as
    extra lanes — the on-device empirical null calibration: per-run null
    quantiles, empirical sigma, and per-realization detection p-values.
    """

    orf: Union[str, Sequence[str]] = "hd"
    weighting: str = "noise"
    null: bool = False
    sigma2: Optional[np.ndarray] = None
    h_map: Optional[np.ndarray] = None

    @property
    def orfs(self) -> Tuple[str, ...]:
        names = ((self.orf,) if isinstance(self.orf, str)
                 else tuple(self.orf))
        return names


def as_spec(os) -> OSSpec:
    """Coerce a run's ``os=`` argument (str | sequence | OSSpec) to OSSpec."""
    if isinstance(os, OSSpec):
        spec = os
    elif isinstance(os, str):
        spec = OSSpec(orf=os)
    elif isinstance(os, (list, tuple)):
        spec = OSSpec(orf=tuple(os))
    else:
        raise TypeError(f"os must be an ORF name, a sequence of ORF names or "
                        f"an OSSpec, got {type(os).__name__}")
    if spec.weighting not in ("noise", "none"):
        raise ValueError(f"OSSpec.weighting must be 'noise' or 'none', got "
                         f"{spec.weighting!r}")
    if not spec.orfs:
        raise ValueError("OSSpec needs at least one ORF template")
    for name in spec.orfs:
        if name not in KNOWN_ORFS:
            raise ValueError(f"unknown ORF template {name!r}; known: "
                             f"{KNOWN_ORFS}")
    return spec


def pulsar_noise_levels(sigma2, mask) -> np.ndarray:
    """(P,) mean white-noise variance over each pulsar's valid TOAs.

    The per-pulsar noise autocorrelation level entering ``Var_ab`` — computed
    from the batch's per-TOA variances at host f64 (padding TOAs excluded).
    """
    sigma2 = np.asarray(sigma2, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    n = np.maximum(mask.sum(axis=1), 1.0)
    return (sigma2 * mask).sum(axis=1) / n


def pair_weighting(orfs, sigma2, counts):
    """Strict-upper-triangle OS weighting pieces, shared with the host path.

    Returns ``(a, b, gam, inv_var, denom)``: pair indices, ORF template
    values, inverse pair variances ``counts_ab / (sigma2_a sigma2_b)`` and
    the normalization ``denom = sum gam^2 inv_var``. This is the single
    source of truth for the weighting: the device lane's
    :func:`build_operators` calls it (in the JAX package the host
    ``correlated_noises.optimal_statistic`` does too).
    """
    orfs = np.asarray(orfs, dtype=np.float64)
    npsr = orfs.shape[0]
    a, b = np.triu_indices(npsr, 1)
    gam = orfs[a, b]
    sigma2 = np.asarray(sigma2, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    inv_var = counts[a, b] / (sigma2[a] * sigma2[b])
    denom = float((gam ** 2 * inv_var).sum())
    return a, b, gam, inv_var, denom


@dataclasses.dataclass(frozen=True)
class OSOperator:
    """One ORF's precomputed OS contraction.

    ``weights`` is the (P, P) float64 matrix whose contraction against a
    realization's RAW pair-sum matrix yields ``amp2`` directly (counts and
    normalization folded in); ``sigma`` the analytic null standard deviation
    ``denom**-0.5`` of ``amp2`` under independent white noise.
    """

    orf: str
    weights: np.ndarray
    sigma: float
    denom: float

    def apply(self, corr_raw) -> np.ndarray:
        """Host reference contraction: (R,) amp2 from raw pair sums."""
        corr_raw = np.asarray(corr_raw, dtype=np.float64)
        if corr_raw.ndim == 2:
            corr_raw = corr_raw[None]
        return np.einsum("rpq,pq->r", corr_raw, self.weights)


def build_operators(spec: OSSpec, pos, mask, sigma2_toa,
                    pair_counts=None) -> Tuple[OSOperator, ...]:
    """Host-f64 OS operators for every ORF in ``spec``.

    ``pos`` (P, 3) unit vectors, ``mask`` (P, T) validity, ``sigma2_toa``
    (P, T) per-TOA white variances (only read under ``weighting='noise'``
    with no ``spec.sigma2`` override). ``pair_counts`` defaults to
    ``mask @ mask.T``.
    """
    pos = np.asarray(pos, dtype=np.float64)
    mask_f = np.asarray(mask, dtype=np.float64)
    counts = (mask_f @ mask_f.T if pair_counts is None
              else np.asarray(pair_counts, dtype=np.float64))
    npsr = pos.shape[0]
    if spec.weighting == "noise":
        if spec.sigma2 is not None:
            sigma2 = np.asarray(spec.sigma2, dtype=np.float64).reshape(npsr)
        else:
            sigma2 = pulsar_noise_levels(sigma2_toa, mask)
    else:
        sigma2 = np.ones(npsr)

    ops = []
    for name in spec.orfs:
        orfs = np.asarray(gwb_ops.build_orf(name, pos, spec.h_map))
        if spec.weighting == "noise":
            a, b, gam, inv_var, denom = pair_weighting(orfs, sigma2, counts)
            if denom <= 0.0:
                raise ValueError(
                    f"ORF {name!r} has no weighted cross-correlation signal "
                    f"(e.g. 'curn' is diagonal, or no pulsar pair shares "
                    f"TOAs) — the optimal statistic is undefined for it")
            # rho = S / counts makes counts cancel against inv_var: the raw
            # pair sums contract directly (module docstring)
            w_pair = gam / (sigma2[a] * sigma2[b]) / (2.0 * denom)
        else:
            a, b, gam, _, denom = pair_weighting(orfs, sigma2,
                                                 np.ones((npsr, npsr)))
            if denom <= 0.0:
                raise ValueError(
                    f"ORF {name!r} has no cross-correlation signal (e.g. "
                    f"'curn' is diagonal) — the matched filter is undefined "
                    f"for it")
            # unweighted statistic averages rho, so the raw sums divide by
            # their pair counts (clamped: a zero-count pair's S is exactly 0)
            w_pair = gam / np.maximum(counts[a, b], 1.0) / (2.0 * denom)
        weights = np.zeros((npsr, npsr))
        weights[a, b] = w_pair
        weights[b, a] = w_pair
        ops.append(OSOperator(orf=name, weights=weights,
                              sigma=denom ** -0.5, denom=denom))
    return tuple(ops)


def assemble(spec: OSSpec, ops: Sequence[OSOperator], os_vals,
             null_vals=None) -> dict:
    """Per-ORF detection statistics from the packed OS lanes.

    ``os_vals`` (R, K) device amp2 lanes in operator order; ``null_vals``
    the paired noise-only lanes when ``spec.null``. Returns the schema-
    versioned result dict attached as ``out["os"]``: per ORF ``amp2``,
    ``sigma`` (empirical when a null stream ran, else analytic), ``snr``,
    and under null calibration the ``null_amp2`` sample, its quantiles and
    per-realization p-values ``(1 + #{null >= amp2}) / (N + 1)``.
    """
    os_vals = np.asarray(os_vals, dtype=np.float64)
    stats = {}
    for k, op in enumerate(ops):
        amp2 = os_vals[:, k]
        entry = {"amp2": amp2, "sigma_analytic": op.sigma}
        if null_vals is not None:
            null = np.asarray(null_vals[:, k], dtype=np.float64)
            sigma = float(np.std(null, ddof=1)) if null.size >= 2 else op.sigma
            qs = np.quantile(null, NULL_QUANTILES)
            # one-sided empirical p-value with the standard +1 regularization
            # (a p of exactly 0 is never claimable from a finite null sample)
            rank = np.searchsorted(np.sort(null), amp2, side="left")
            pval = (1.0 + null.size - rank) / (null.size + 1.0)
            entry.update({
                "null_amp2": null,
                "sigma_empirical": sigma,
                "null_quantiles": {f"q{int(100 * q)}": float(v)
                                   for q, v in zip(NULL_QUANTILES, qs)},
                "p_value": pval,
            })
        else:
            sigma = op.sigma
        entry["sigma"] = sigma
        entry["snr"] = amp2 / sigma
        stats[op.orf] = entry
    return {
        "schema": DETECT_SCHEMA,
        "weighting": spec.weighting,
        "orfs": [op.orf for op in ops],
        "null": null_vals is not None,
        "stats": stats,
    }
