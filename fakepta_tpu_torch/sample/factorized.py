"""Per-frequency factorized free-spectrum sampling (port of
``fakepta_tpu.sample.factorized``).

**The algebra.** The joint likelihood depends on theta only through the
prior diagonal ``phi``: per pulsar, ``lnL = -1/2 [ d0 - dT^T Sigma^-1 dT +
lndet ]`` with ``Sigma = M + diag(1/phi)`` (:mod:`..ops.woodbury`). For a
``FreeParam(per_bin=True)`` free-spectrum component on the standard grid,
each bin's theta slot drives exactly two columns (its cos/sin pair). The
batch-pinned nuisance components have CONSTANT phi, so their Woodbury
marginalization folds into an effective noise ``Ntilde = N + B_nuis
Phi_nuis B_nuis^T`` once at staging (:func:`marginalize_nuisance_np`, a
block-Woodbury downdate per pulsar, host float64). On a REGULAR grid
``t_k = k/T`` the Fourier columns of distinct harmonics are orthogonal in
the ``Ntilde`` metric too, so the joint lnL SPLITS into a sum of
per-bin(-block) terms plus a theta-independent constant; each block's term
is the lnL of a tiny model of only its ``2w`` columns, from a slice of the
marginalized moments. On an irregular grid the off-block entries are small
but nonzero; :func:`factorized_oracle` measures the coupling and the lnL
additivity defect in float64.

**The system.** Each bin block becomes an ordinary :class:`.run.
SamplingRun` over a derived lane model (``ComponentSpec.bin_offset``
restricts the free component to its bins; the pinned components are
marginalized into the injected moments). :class:`FactorizedRun` drives the
lanes one after another on one mesh; per-lane seeds are a hash of ``(seed,
lane index)`` (:func:`lane_seed`), so a lane's draws are those of the lane
run alone. Recombination scatters lane draws into their parent theta
slots; the joint diagnostics are lane aggregates (R-hat max, ESS min).

The JAX module's ``run_factorized_sessions`` routes the lanes over its
serve fleet's sampling sessions and waits for that module (ROADMAP Queue 1
item 11b).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..infer import model as infer_model
from ..infer.model import LikelihoodSpec
from ..obs import metrics as obs_metrics
from ..obs.timing import now
from ..ops import woodbury
from ..tune import defaults as tune_defaults
from .model import SAMPLE_SCHEMA, SampleSpec, as_spec
from .run import (SamplingRun, f64_batch_views, stage_moments,
                  synthesize_residuals)


def lane_seed(seed: int, lane_index: int) -> int:
    """Deterministic per-lane RNG seed: a hash of ``(seed, lane index)``.

    Independent of lane count, lane width, and host — the contract that
    makes a lane's draws bit-identical whether it runs solo, coalesced in
    one :class:`FactorizedRun`, or routed to a fleet replica (and keeps
    lanes statistically independent of each other and of the data seed).
    """
    tag = f"fakepta.fs.lane/{int(seed)}/{int(lane_index)}".encode()
    return int.from_bytes(hashlib.sha256(tag).digest()[:4], "big")


def lane_spans(nbin: int, lane_bins=None) -> Tuple[Tuple[int, int], ...]:
    """Partition ``nbin`` parent bins into lane blocks ``(lo, hi)``.

    ``lane_bins`` is a block width (int; the last lane takes the
    remainder) or an explicit width sequence summing to ``nbin``. Default:
    :data:`..tune.defaults.FS_LANE_BINS`.
    """
    if lane_bins is None:
        lane_bins = tune_defaults.FS_LANE_BINS
    if isinstance(lane_bins, (int, np.integer)):
        w = int(lane_bins)
        if w < 1:
            raise ValueError(f"lane_bins must be >= 1, got {w}")
        widths = [min(w, nbin - lo) for lo in range(0, nbin, w)]
    else:
        widths = [int(w) for w in lane_bins]
        if any(w < 1 for w in widths) or sum(widths) != nbin:
            raise ValueError(
                f"lane_bins widths {widths} must be positive and sum to "
                f"the free component's nbin ({nbin})")
    spans, lo = [], 0
    for w in widths:
        spans.append((lo, lo + w))
        lo += w
    return tuple(spans)


@dataclasses.dataclass(frozen=True)
class FactorizedSpec:
    """A joint :class:`.model.SampleSpec` plus the lane granularity:
    everything :class:`FactorizedRun` needs to build one small sampler per
    bin block."""

    spec: SampleSpec
    lane_bins: Union[int, Tuple[int, ...], None] = None


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """One bin-block lane of a factorized model (see :func:`factor_plan`).

    ``theta_idx`` are the lane parameters' slots in the PARENT theta
    vector. ``free_cols`` are the lane's two [lo, hi) quadrature strips as
    PARENT column indices (the columns the lane owns); ``marg_cols`` the
    same strips as positions within the MARGINALIZED moment space (the
    free component's ``2*nbin`` columns in parent order —
    ``_restrict_np(marginalized_moments, marg_cols)`` is the lane's
    staged input); ``nuisance_cols`` the batch-pinned columns every lane
    shares, folded into the moments by :func:`marginalize_nuisance_np`.
    The lane ``model`` contains ONLY the restricted free component.
    """

    index: int
    lo: int
    hi: int
    model: LikelihoodSpec
    theta_idx: Tuple[int, ...]
    free_cols: Tuple[int, ...]
    marg_cols: Tuple[int, ...]
    nuisance_cols: Tuple[int, ...]


def factor_plan(compiled, lane_bins=None) -> Tuple[LanePlan, ...]:
    """Derive the per-bin-block lane decomposition of a compiled model.

    Requirements (raised on violation): exactly ONE component carries free
    hyperparameters; all of them are ``per_bin`` (the free-spectrum
    shape); the component is not ``'sys'`` and not itself offset. Every
    other component must be theta-independent (batch-pinned), so its
    Woodbury marginalization is a constant the lanes share.
    """
    spec = compiled.spec
    free_ci = [ci for ci, comp in enumerate(spec.components) if comp.free]
    if len(free_ci) != 1:
        raise ValueError(
            f"factorization needs exactly one free component; this model "
            f"has {len(free_ci)} (every other component must be pinned so "
            f"its marginalization is theta-independent)")
    ci = free_ci[0]
    comp = spec.components[ci]
    cc = compiled._comps[ci]
    if any(not fp.per_bin for fp in comp.free):
        raise ValueError(
            "factorization needs per_bin free parameters only (the "
            "free-spectrum shape); scalar or per_pulsar hyperparameters "
            "couple every bin through one theta slot")
    if comp.target == "sys":
        raise ValueError("'sys' components cannot be factorized "
                         "(per-band column maps)")
    if cc["bin_offset"]:
        raise ValueError("the free component is already a bin_offset "
                         "lane; factor the parent model instead")
    nbin = cc["nbin"]
    # parent basis column extents, one entry per concatenated block
    # ('sys' components emit one entry per band) — the public column map
    entries = compiled.column_slices()
    ei = sum(compiled._comps[j]["bands"] for j in range(ci))
    col_start = entries[ei][1]
    # every column outside the free component's [cos_1..cos_N,
    # sin_1..sin_N] block is a pinned (constant-phi) nuisance column
    nuis = tuple(c for c in range(compiled.ncols)
                 if not col_start <= c < col_start + 2 * nbin)
    spans = lane_spans(nbin, lane_bins)
    n_free = len(comp.free)
    plans = []
    for i, (lo, hi) in enumerate(spans):
        w = hi - lo
        lane_comp = dataclasses.replace(comp, nbin=w, bin_offset=lo)
        # the lane model is ONLY the restricted free component — the
        # pinned components are marginalized into the injected moments
        model = LikelihoodSpec(components=(lane_comp,))
        # per_bin params pack [p0 bins..., p1 bins, ...] in theta; each
        # lane takes its [lo, hi) slice of every per_bin parameter
        theta_idx = [p * nbin + b
                     for p in range(n_free) for b in range(lo, hi)]
        # the two [lo, hi) quadrature strips, as parent column indices
        # (free_cols) and as positions within the free block (marg_cols)
        strips = (list(range(lo, hi))
                  + list(range(nbin + lo, nbin + hi)))
        plans.append(LanePlan(index=i, lo=lo, hi=hi, model=model,
                              theta_idx=tuple(theta_idx),
                              free_cols=tuple(col_start + s
                                              for s in strips),
                              marg_cols=tuple(strips),
                              nuisance_cols=nuis))
    return tuple(plans)


def _restrict_np(moments, cols):
    """Host-side (numpy, f64-preserving) :func:`woodbury.restrict_moments`
    — the staging path must not round-trip through device f32."""
    cols = np.asarray(cols, dtype=np.int64)
    m, lndet, nv, d0, dt = (np.asarray(x) for x in moments)
    lane_cols = cols + np.zeros((1,), dtype=np.int64)  # defensive copy
    m_r = np.take(np.take(m, lane_cols, axis=-1), lane_cols, axis=-2)
    return (m_r, lndet, nv, d0, np.take(dt, lane_cols, axis=-1))


def marginalize_nuisance_np(moments, keep_cols, nuis_cols, phi_nuis):
    """Fold constant-phi columns into the noise: parent moments (against
    ``N``) -> moments against ``Ntilde = N + B_n Phi_n B_n^T`` over
    ``keep_cols`` (module docstring, "The algebra").

    Per pulsar, with ``A = diag(1/phi_n) + M_nn`` (the Schur kernel):

    - ``M~  = M_kk  - M_kn A^-1 M_nk``
    - ``dT~ = dT_k  - M_kn A^-1 dT_n``
    - ``d0~ = d0    - dT_n^T A^-1 dT_n``
    - ``lndetN~ = lndetN + sum(ln phi_n) + lndet A``

    so ``lnlike_from_moments(d0~, dT~, M~, lndetN~, n_valid, phi_k)`` IS
    the joint lnL (block-determinant/Schur identities) — the pinned
    components' cost moves from every leapfrog step to this one host-f64
    staging pass. Shapes: ``phi_nuis`` is ``(P, n_nuis)``; everything is
    numpy (f64-preserving by the same contract as :func:`_restrict_np`).
    """
    m, lndet, nv, d0, dt = (np.asarray(x, dtype=np.float64)
                            for x in moments)
    keep = np.asarray(keep_cols, dtype=np.int64)
    nuis = np.asarray(nuis_cols, dtype=np.int64)
    if nuis.size == 0:
        return _restrict_np((m, lndet, nv, d0, dt), keep)
    # same positive floor as the device kernels (woodbury._phi_floor):
    # a zero-variance padded column must contribute nothing, not a 1/0
    phi_n = np.maximum(np.asarray(phi_nuis, dtype=np.float64),
                       4.0 / np.finfo(np.float64).max)
    m_nn = m[:, nuis[:, None], nuis[None, :]].copy()
    m_kn = m[:, keep[:, None], nuis[None, :]]
    m_kk = m[:, keep[:, None], keep[None, :]]
    dt_n = dt[:, nuis]
    idx = np.arange(nuis.size)
    m_nn[:, idx, idx] += 1.0 / phi_n
    sol_dt = np.linalg.solve(m_nn, dt_n[..., None])[..., 0]
    sol_mk = np.linalg.solve(m_nn, np.swapaxes(m_kn, -1, -2))
    m_t = m_kk - m_kn @ sol_mk
    m_t = 0.5 * (m_t + np.swapaxes(m_t, -1, -2))
    dt_t = dt[:, keep] - np.einsum("pkn,pn->pk", m_kn, sol_dt)
    d0_t = d0 - np.einsum("pn,pn->p", dt_n, sol_dt)
    _sign, ln_a = np.linalg.slogdet(m_nn)
    lndet_t = lndet + np.sum(np.log(phi_n), axis=-1) + ln_a
    return (m_t, lndet_t, nv, d0_t, dt_t)


def nuisance_phi_np(compiled, batch, nuis_cols):
    """The pinned components' per-column prior variances, host f64.

    Theta-independent by :func:`factor_plan`'s contract (only the free
    component's columns move with theta), so any theta works: evaluated
    at the box midpoint."""
    nsb = f64_batch_views(batch)
    theta = torch.as_tensor(compiled.theta_from_unit(
        np.full(compiled.D, 0.5)))
    phi = compiled.phi(theta, nsb).numpy()
    return phi[:, np.asarray(nuis_cols, dtype=np.int64)]


def marginalize_for_lanes(compiled, batch, moments, plans):
    """One marginalization shared by every lane: parent moments -> the
    ``Ntilde``-metric moments over the free component's ``2*nbin`` columns
    (parent order). Each lane then takes its
    ``_restrict_np(result, plan.marg_cols)`` slice."""
    keep = sorted({c for lp in plans for c in lp.free_cols})
    nuis = plans[0].nuisance_cols
    phi_n = nuisance_phi_np(compiled, batch, nuis)
    return marginalize_nuisance_np(moments, keep, nuis, phi_n)


def marginalized_window_moments(compiled, batch, moments, lo: int,
                                hi: int):
    """``Ntilde`` moments restricted to one ``[lo, hi)`` bin window (the
    JAX package's fleet lanes stage through it).

    The marginalization keeps the free component's FULL ``2*nbin`` block
    (it is granularity-independent), then slices the window's quadrature
    strips, so a lane routed to any replica stages bit-identical moments
    to its slot in a local :class:`FactorizedRun` regardless of how that
    run partitioned the bins."""
    plans = factor_plan(compiled)
    marg = marginalize_for_lanes(compiled, batch, moments, plans)
    nbin = plans[-1].hi
    if not 0 <= lo < hi <= nbin:
        raise ValueError(f"window [{lo}, {hi}) outside the free "
                         f"component's {nbin} bins")
    strips = list(range(lo, hi)) + list(range(nbin + lo, nbin + hi))
    return _restrict_np(marg, strips)


def recombine_draws(spans, results, d_parent: int):
    """Deterministic recombination: scatter each lane's thinned draws into
    its parent theta slots. Truncates to the shortest lane's draw count
    (lanes at different segment roundings keep different totals)."""
    if not results:
        raise ValueError("no lane results to recombine")
    n_keep = min(int(r["theta"].shape[0]) for r in results)
    k = int(results[0]["theta"].shape[1])
    theta = np.zeros((n_keep, k, d_parent),
                     dtype=results[0]["theta"].dtype)
    for (idx, r) in zip(spans, results):
        theta[:, :, list(idx)] = r["theta"][:n_keep]
    return theta


class FactorizedRun:
    """The factorized free-spectrum driver: one small
    :class:`.run.SamplingRun` per bin block over shared data,
    deterministic recombination, exact aggregate diagnostics.

    ``mesh`` / ``device`` as for :class:`.run.SamplingRun` (the card by
    default, raising without a GPU unless ``device="cpu"``).

    ``spec`` is the JOINT :class:`.model.SampleSpec` (or a
    :class:`FactorizedSpec` carrying the lane granularity). Data is staged
    ONCE against the parent model (synthesized at ``truth`` when
    ``residuals`` is None — the same draw a joint run makes), the pinned
    components are marginalized once (:func:`marginalize_for_lanes`), and
    each lane is built with its restricted slice injected — lane
    construction costs a Laplace fit of width-w blocks, never a restage,
    and each lane's chain steps factor a ``2w``-sized Cholesky instead of
    the joint run's full-basis one.
    """

    def __init__(self, batch, spec, lane_bins=None, residuals=None,
                 truth=None, mesh=None, data_seed=0, device=None):
        if isinstance(spec, FactorizedSpec):
            lane_bins = spec.lane_bins if lane_bins is None else lane_bins
            spec = spec.spec
        self.spec = as_spec(spec)
        self.batch = batch
        self.parent = infer_model.build(self.spec.model, batch)
        if truth is None:
            truth = self.parent.theta_from_unit(
                np.full(self.parent.D, 0.5))
        self.truth = np.asarray(truth, dtype=np.float64)
        if residuals is None:
            residuals = synthesize_residuals(self.parent, batch,
                                             self.truth, data_seed)
        self.residuals = np.asarray(residuals, dtype=np.float64)
        self.moments = stage_moments(self.parent, batch, self.residuals)
        self.plan = factor_plan(self.parent, lane_bins)
        self.marg_moments = marginalize_for_lanes(self.parent, batch,
                                                  self.moments, self.plan)
        self.lanes = []
        for lp in self.plan:
            lane_spec = dataclasses.replace(self.spec, model=lp.model)
            lane = SamplingRun(
                batch, lane_spec,
                truth=self.truth[list(lp.theta_idx)], mesh=mesh,
                moments=_restrict_np(self.marg_moments, lp.marg_cols),
                device=device)
            self.lanes.append(lane)
        self.last_result = None

    @property
    def lane_count(self) -> int:
        return len(self.lanes)

    @property
    def retraces(self) -> int:
        return sum(lane.retraces for lane in self.lanes)

    def run(self, n_steps: int, seed=0, segment=None, **run_kwargs) -> dict:
        """Run every lane (one after another, on this mesh) and recombine.

        Per-lane seeds come from :func:`lane_seed`, so the recombined
        posterior is independent of lane execution order and identical to
        running each lane solo. Returns the joint-shaped result dict
        (``theta`` (S, K, D) in PARENT slots) plus ``fs_*`` metrics in
        ``summary`` and the per-lane results under ``lanes``.
        """
        t0 = now()
        lane_results, lane_wall = [], []
        for lp, lane in zip(self.plan, self.lanes):
            t_l = now()
            res = lane.run(n_steps, seed=lane_seed(seed, lp.index),
                           segment=segment, **run_kwargs)
            lane_wall.append(now() - t_l)
            lane_results.append(res)
            obs_metrics.count("sample.lane_runs")
        theta = recombine_draws([lp.theta_idx for lp in self.plan],
                                lane_results, self.parent.D)
        total_s = now() - t0
        n_dev = max(len(set(self.lanes[0].mesh.devices.flat)), 1)

        diag = {
            "rhat_max": max(r["diag"].get("rhat_max", float("nan"))
                            for r in lane_results),
            "ess_min": min(r["diag"].get("ess_min", 0.0)
                           for r in lane_results),
            "accept_rate": float(np.mean([r["diag"]["accept_rate"]
                                          for r in lane_results])),
            "divergences": int(sum(r["diag"]["divergences"]
                                   for r in lane_results)),
            "nonfinite_lnl": int(sum(r["diag"]["nonfinite_lnl"]
                                     for r in lane_results)),
        }
        critical_s = max(lane_wall)
        summary = {
            "rhat_max": round(diag["rhat_max"], 5),
            "ess_min": round(diag["ess_min"], 2),
            # sequential-honest local figure: every lane ran on THIS mesh
            "ess_per_s_per_chip": round(
                diag["ess_min"] / total_s / n_dev, 3),
            "accept_rate": round(diag["accept_rate"], 4),
            "divergences": diag["divergences"],
            "nonfinite_lnl": diag["nonfinite_lnl"],
            "fs_lane_count": len(self.lanes),
            # fleet figure-of-merit: lanes are independent, one per
            # replica chip — the critical path is the slowest lane
            "fs_ess_per_s_per_chip": round(
                diag["ess_min"] / critical_s / n_dev, 3),
            "fs_wall_s_total": round(total_s, 4),
            "fs_wall_s_critical": round(critical_s, 4),
        }
        mode_theta = np.zeros(self.parent.D)
        for lp, lane in zip(self.plan, self.lanes):
            mode_theta[list(lp.theta_idx)] = lane.mode_theta
        result = {
            "schema": SAMPLE_SCHEMA,
            "theta": theta,
            "param_names": list(self.parent.param_names),
            "bounds": np.asarray(self.parent.bounds),
            "truth": np.asarray(self.truth),
            "mode_theta": mode_theta,
            "diag": diag,
            "summary": summary,
            "lanes": lane_results,
        }
        self.last_result = result
        return result


def factorized_oracle(batch, model, lane_bins=None, residuals=None,
                      truth=None, data_seed=0, n_probe: int = 4,
                      probe_seed: int = 0) -> dict:
    """f64 dense proof that factorized == joint (or how far off it is).

    At ``n_probe`` theta points drawn uniformly in the box, evaluates the
    JOINT lnL from the parent moments and the SUM of per-lane lnLs from
    the marginalized, restricted moments (the exact inputs the lanes
    sample with). When the factorization is exact the difference is the
    same theta-independent constant at every probe, so
    ``additivity_max_err`` (``max_i |delta_i - delta_0|``) is roundoff;
    ``coupling`` is the normalized max cross-lane ``|M~_jk|`` of the
    marginalized moment matrix. Everything runs in host float64.
    """
    compiled = infer_model.build(model, batch)
    if truth is None:
        truth = compiled.theta_from_unit(np.full(compiled.D, 0.5))
    truth = np.asarray(truth, dtype=np.float64)
    if residuals is None:
        residuals = synthesize_residuals(compiled, batch, truth, data_seed)
    mom = stage_moments(compiled, batch, residuals)
    plans = factor_plan(compiled, lane_bins)
    marg = marginalize_for_lanes(compiled, batch, mom, plans)
    lanes = [(lp, infer_model.build(lp.model, batch),
              _restrict_np(marg, lp.marg_cols)) for lp in plans]

    rng = np.random.default_rng(probe_seed)
    lo, hi = compiled.bounds[:, 0], compiled.bounds[:, 1]
    probes = rng.uniform(lo, hi, size=(n_probe, compiled.D))
    nsb = f64_batch_views(batch)

    def lnl_of(cmp, moments, theta):
        m, lndet, nv, d0, dt = (torch.as_tensor(np.asarray(x))
                                for x in moments)
        phi = cmp.phi(torch.as_tensor(theta), nsb)
        return float(torch.sum(woodbury.lnlike_from_moments(
            d0, dt, m, lndet, nv, phi)))

    deltas = []
    joint_vals = []
    for th in probes:
        joint = lnl_of(compiled, mom, th)
        joint_vals.append(joint)
        lane_sum = sum(
            lnl_of(cmp, lmom, th[list(lp.theta_idx)])
            for lp, cmp, lmom in lanes)
        deltas.append(joint - lane_sum)
    deltas = np.asarray(deltas)
    defect = float(np.max(np.abs(deltas - deltas[0])))
    scale = float(np.max(np.abs(joint_vals)))
    blocks = [np.asarray(lp.marg_cols) for lp in plans]
    coupling = float(woodbury.block_coupling(torch.as_tensor(marg[0]),
                                             blocks))
    return {
        "additivity_max_err": defect,
        "additivity_rel_err": defect / max(scale, 1.0),
        "lnl_scale": scale,
        "coupling": coupling,
        "deltas": deltas,
        "lane_count": len(plans),
    }
