"""SampleSpec: the declarative configuration of the on-device sampler (port
of ``fakepta_tpu.sample.model``).

One spec = one posterior-characterization program: which
:class:`..infer.LikelihoodSpec` model to sample (the SAME
declarative models the grid lane evaluates — priors single-sourced through
the model's box bounds), how many chains and tempering rungs to run, and
the HMC kernel's step/trajectory/thinning parameters. The facade
(:class:`.run.SamplingRun`) owns the data side (residuals -> Woodbury
moments -> Laplace warm start).

This module also holds the host-side diagnostics finishers: the chain
segments accumulate sufficient statistics ON DEVICE (per-chain first/second
moments and lag-1 cross moments of the thinned cold-chain draws, per-rung
acceptance and swap counters) and drains them once per segment like any
chunk output; :func:`diagnostics` turns the final accumulators into
split-free R-hat, a lag-1 autocorrelation ESS estimate, and acceptance
rates with host float64 arithmetic only — no chain data round-trips inside
the loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..infer.model import LikelihoodSpec

#: schema tag for sampling-run artifacts (the JAX package's string, so
#: each package reads the other's artifacts)
SAMPLE_SCHEMA = "fakepta_tpu.sample/1"

#: PRNG domain tag for the sampler's step keys (cf. montecarlo's 0x51 noise
#: / 0x6B gwb / 0x9C hyper / 0xC6 cgw / 0xE1 white / 0xD7 null tags)
SAMPLE_TAG = 0xA5

#: subtag folded for the tempering-swap uniforms (momentum/accept draws use
#: per-(chain, temp) subtags 0/1, ..ops.mcmc.transition_draws)
SWAP_TAG = 0x53


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """Configuration of one batched-MCMC posterior run.

    ``n_chains`` independent chains (sharded over the ``'real'`` mesh axis;
    must divide by the axis size) times ``n_temps`` tempering rungs
    (local to each shard — swaps are on-device permutations along the rung
    axis, never a host decision). The HMC kernel runs in the
    Laplace-whitened unconstrained space, so ``step_size`` is in units of
    the posterior's own scale (~0.2-0.6 is the useful range) and
    ``eps_t = step_size / sqrt(beta_t)`` widens steps on hot rungs.
    ``warmup`` steps are discarded (and excluded from the on-device
    accumulators); every ``thin``-th post-step cold-chain draw is streamed
    out. ``max_temp`` sets the geometric ladder ``beta_t =
    max_temp^(-t/(T-1))``.
    """

    model: LikelihoodSpec
    n_chains: int = 32
    n_temps: int = 1
    max_temp: float = 8.0
    step_size: float = 0.3
    n_leapfrog: int = 8
    thin: int = 1
    swap_every: int = 5
    warmup: int = 256
    max_energy_error: float = 50.0


def as_spec(spec) -> SampleSpec:
    """Validate a run's ``spec`` argument (a SampleSpec or a bare model)."""
    if isinstance(spec, LikelihoodSpec):
        spec = SampleSpec(model=spec)
    if not isinstance(spec, SampleSpec):
        raise TypeError(f"spec must be a SampleSpec (or a LikelihoodSpec "
                        f"for the defaults), got {type(spec).__name__}")
    if spec.n_chains < 2:
        raise ValueError("SampleSpec.n_chains must be >= 2 (cross-chain "
                         "R-hat needs at least two chains)")
    if spec.n_temps < 1:
        raise ValueError("SampleSpec.n_temps must be >= 1")
    if spec.n_temps > 1 and not spec.max_temp > 1.0:
        raise ValueError("SampleSpec.max_temp must be > 1 when tempering")
    if not spec.step_size > 0:
        raise ValueError("SampleSpec.step_size must be positive")
    if spec.n_leapfrog < 1:
        raise ValueError("SampleSpec.n_leapfrog must be >= 1")
    if spec.thin < 1:
        raise ValueError("SampleSpec.thin must be >= 1")
    if spec.swap_every < 1:
        raise ValueError("SampleSpec.swap_every must be >= 1")
    if spec.warmup < 0:
        raise ValueError("SampleSpec.warmup must be >= 0")
    return spec


def diagnostics(accum: dict, n_chains: int, n_temps: int,
                steps_done: int) -> dict:
    """Host finishers over the drained on-device accumulators.

    ``accum`` holds numpy copies of the chain program's carry accumulators:
    ``n``/``npair`` (retained-draw and lag-pair counts), ``s1``/``s2``/
    ``s11`` (per-chain (K, D) moment sums over thinned post-warmup
    cold-chain draws), ``accept`` (T,) accepted HMC transitions per rung,
    ``swap``/``swap_att`` (T,) accepted/attempted rung swaps, and
    ``divergent``/``nonfinite`` counters. Returns R-hat per dimension
    (between/within variance over whole chains), a conservative lag-1
    autocorrelation ESS (``n * (1 - rho1)/(1 + rho1)`` per chain, summed),
    and rates.
    """
    out = {
        "divergences": float(accum["divergent"]),
        "nonfinite_lnl": float(accum["nonfinite"]),
    }
    att = float(n_chains) * max(steps_done, 1)
    accept = np.asarray(accum["accept"], dtype=np.float64)
    out["accept_rate"] = float(accept[0] / att)
    out["accept_rate_by_temp"] = (accept / att).tolist()
    swap_att = np.asarray(accum["swap_att"], dtype=np.float64)
    if n_temps > 1 and swap_att.sum() > 0:
        swaps = np.asarray(accum["swap"], dtype=np.float64)
        out["swap_rate"] = float(swaps.sum() / swap_att.sum())
    n = float(accum["n"])
    out["n_kept"] = n
    if n >= 4:
        s1 = np.asarray(accum["s1"], dtype=np.float64)
        s2 = np.asarray(accum["s2"], dtype=np.float64)
        s11 = np.asarray(accum["s11"], dtype=np.float64)
        npair = max(float(accum["npair"]), 1.0)
        mean_k = s1 / n                                       # (K, D)
        var_k = np.maximum((s2 - n * mean_k ** 2) / (n - 1), 1e-300)
        w = var_k.mean(axis=0)                                # within
        b = n * mean_k.var(axis=0, ddof=1)                    # between
        var_hat = (n - 1) / n * w + b / n
        rhat = np.sqrt(var_hat / w)
        out["rhat"] = rhat.tolist()
        out["rhat_max"] = float(rhat.max())
        # lag-1 autocorrelation of the thinned stream, per chain; clipped
        # to [0, 1) so the geometric-decay ESS estimate stays conservative
        rho1 = np.clip((s11 / npair - mean_k ** 2) / var_k, 0.0, 0.999)
        ess_k = n * (1.0 - rho1) / (1.0 + rho1)               # (K, D)
        ess = ess_k.sum(axis=0)                               # (D,)
        out["ess"] = ess.tolist()
        out["ess_min"] = float(ess.min())
    return out
