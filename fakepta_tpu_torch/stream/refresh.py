"""Continuous posterior refresh: re-sample on data arrival, warm-started
(port of ``fakepta_tpu.stream.refresh``).

Each refresh builds a fresh :class:`..sample.SamplingRun` over the
stream's accumulated data (``batch_view``/``residuals_view``: the frozen
grids, so the model is the SAME model the moments live on) and recycles
two things from the previous posterior instead of starting cold:

- ``warm_from``: the previous Laplace mode seeds the damped-Newton fit.
  With one epoch of new data the mode barely moves, so the fit converges
  in a handful of iterations (``laplace_iters`` is surfaced per refresh
  so the win is measurable).
- ``init_z``: the previous chains' final whitened positions, REMAPPED into
  the new run's whitened frame. Chains sample ``v = mode + z C^T`` (C
  upper-triangular, ``C C^T = (-H)^{-1}``); keeping the *physical*
  positions fixed across the frame change solves
  ``mode_old + z_old C_old^T = mode_new + z_new C_new^T`` for ``z_new``,
  a host-f64 solve.

Promotion is R-hat gated: the refreshed posterior replaces ``posterior``
only when ``rhat_max <= rhat_gate``; a non-converged refresh is kept out
(flight-recorded ``stream_refresh_reject``) while the warm state still
advances: the Laplace mode is a deterministic fit, valid regardless of
chain convergence.

Scheduling: :class:`RefreshPolicy` decides when a refresh is DUE, after
``every_appends`` appended blocks since the last refresh, or earlier when
the stream's rolling ``|SNR|`` moved by at least ``min_snr_gain``.
:meth:`PosteriorRefresher.maybe_refresh` applies the policy: not-due calls
are counted (``stream.refresh_skips``) and flight-recorded, never sampled.
Both gate decisions are published as live gauges of :mod:`..obs.telemetry`.

Per-frequency incremental refresh: :class:`FactorizedRefresher` is the
factorized counterpart for per-bin free-spectrum streams. Its bin-block
lanes (:func:`..sample.factor_plan`) are built ONCE against the stream's
frozen grids; each refresh slices the stream's CURRENT accumulated
Woodbury moments per lane (O(ncols^2), never an O(history) restage) and
re-samples ONLY the lanes whose data projection moved, so the refresh
cost is O(bins-touched), not O(nbin). Untouched lanes keep their previous
draws. Later refreshes inject freshly restricted moments into the lanes
(:meth:`..sample.SamplingRun.restage`).

The refreshers run their samplers on ``device`` (default ``"cuda"``,
raising without a GPU unless ``device="cpu"``) or ``mesh``; a stream
whose mesh spans processes lends its mesh when neither is given, so
every rank's refresh is one collective sampler run (every rank calls the
refresher alike, as it appends alike). The JAX
refreshers' ``compile_cache_dir`` (XLA's persistent compilation cache) has
no counterpart in the port, whose sampler compiles nothing at run time:
``None`` is accepted and anything else raises ``NotImplementedError`` (a
kept divergence since ROADMAP Queue 1 item 11b.4, listed in Queue 3; the
serve fleet shares the kernel build directory instead). ``fs_recompiles``
reads the lanes' ``retraces``, which are 0 in the port by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..device import DeviceLike
from ..infer import model as infer_model
from ..obs import flightrec, metrics, telemetry
from ..obs.timing import now
from ..sample import SampleSpec, SamplingRun, as_spec
from ..sample.factorized import (_restrict_np, factor_plan, lane_seed,
                                 marginalize_nuisance_np, nuisance_phi_np,
                                 recombine_draws)
from ..tune import defaults as knobs
from .state import STREAM_SCHEMA


def _no_compile_cache(compile_cache_dir) -> None:
    if compile_cache_dir is not None:
        raise NotImplementedError(
            "compile_cache_dir is XLA's persistent compilation cache, which "
            "the port does not have (its sampler compiles nothing at run "
            "time); pass None (a kept divergence since ROADMAP Queue 1 "
            "item 11b.4, listed in Queue 3)")


def _run_place(stream, mesh, device) -> dict:
    """The sampler placement keywords: ``mesh`` or ``device`` (default
    ``"cuda"``, or the stream's mesh when it spans processes), as
    :class:`..sample.SamplingRun` takes them."""
    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    lent = getattr(stream, "mesh", None)
    if mesh is None and device is None and lent is not None \
            and lent.multiprocess:
        mesh = lent
    return {"mesh": mesh} if mesh is not None else {"device": device}


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """When is a posterior refresh due? (defaults from ``tune/defaults.py``)

    - ``every_appends``: refresh after this many appended TOA blocks since
      the last refresh (the epoch-count trigger; always active).
    - ``min_snr_gain``: refresh as soon as the stream's rolling detection
      statistic moved this much in ``|SNR|`` since the last refresh
      (0 disables; streams without a ``watch`` statistic never trip it).
    """

    every_appends: int = knobs.REFRESH_EVERY_APPENDS
    min_snr_gain: float = knobs.REFRESH_MIN_SNR_GAIN


class PosteriorRefresher:
    """Warm-started, R-hat-gated posterior refresh loop over a stream.

    ``spec`` is a :class:`..sample.SampleSpec` (or None for the stream's
    model with SampleSpec defaults); its model must BE the stream's model:
    the posterior must describe the same process the stream accumulates
    moments for.
    """

    def __init__(self, stream, spec=None, *, rhat_gate: float = 1.05,
                 mesh=None, device: DeviceLike = None,
                 compile_cache_dir=None,
                 policy: Optional[RefreshPolicy] = None):
        _no_compile_cache(compile_cache_dir)
        self.stream = stream
        self.spec = (SampleSpec(model=stream.model) if spec is None
                     else as_spec(spec))
        if self.spec.model != stream.model:
            raise ValueError("PosteriorRefresher spec.model must be the "
                             "stream's model (same basis, same moments)")
        self.rhat_gate = float(rhat_gate)
        self._place = _run_place(stream, mesh, device)
        self.policy = policy or RefreshPolicy()
        self.posterior: Optional[dict] = None
        self.refreshes = 0
        self.promotions = 0
        self.skips = 0
        self._warm: Optional[dict] = None
        self._last_z: Optional[np.ndarray] = None
        # scheduling baselines: appends/SNR as of the last refresh (the
        # construction point counts as "refreshed": maybe_refresh measures
        # accumulation, not absolute stream age)
        self._mark_appends = int(getattr(stream, "appends", 0))
        self._mark_snr = self._current_snr()

    def _current_snr(self) -> Optional[float]:
        """The stream's rolling |SNR|, or None without a watch statistic."""
        snr = self.stream.stats().get("snr")
        return None if snr is None else abs(float(snr))

    @staticmethod
    def _remap_z(z_prev, prev, new) -> np.ndarray:
        """Whitened positions from the previous frame re-expressed in the
        new one, holding the physical positions fixed (module docstring)."""
        k, t, d = z_prev.shape
        v = (np.asarray(prev["mode_v"])[None, None, :]
             + np.asarray(z_prev, dtype=np.float64)
             @ np.asarray(prev["chol_cov"]).T)
        delta = (v - np.asarray(new["mode_v"])[None, None, :])
        z_new = np.linalg.solve(np.asarray(new["chol_cov"]).T,
                                delta.reshape(-1, d).T).T
        return z_new.reshape(k, t, d)

    def refresh(self, n_steps: int = 200, seed: int = 0, **run_kwargs
                ) -> dict:
        """One refresh cycle: Laplace re-fit (warm), chains (warm),
        R-hat-gated promotion. Returns the cycle's stats dict; the
        promoted posterior (when the gate passes) is ``self.posterior``.
        """
        t0 = now()
        warm = self._warm
        run = SamplingRun(self.stream.batch_view(), self.spec,
                          residuals=self.stream.residuals_view(),
                          warm_from=warm, **self._place)
        init_z = None
        if self._last_z is not None and warm is not None:
            init_z = self._remap_z(self._last_z, warm, run.laplace_state())
        result = run.run(int(n_steps), seed=seed, init_z=init_z,
                         **run_kwargs)
        rhat = float(result["summary"].get("rhat_max", float("nan")))
        promoted = bool(np.isfinite(rhat) and rhat <= self.rhat_gate)
        cycle = self.refreshes
        self.refreshes += 1
        if promoted:
            self.posterior = result
            self.promotions += 1
            metrics.count("stream.promotions")
        else:
            flightrec.note("stream_refresh_reject", refresh=cycle,
                           rhat_max=rhat, gate=self.rhat_gate)
        self._warm = run.laplace_state()
        self._last_z = run.last_z
        self._mark_appends = int(getattr(self.stream, "appends", 0))
        self._mark_snr = self._current_snr()
        metrics.count("stream.refreshes")
        return {
            "schema": STREAM_SCHEMA, "refresh": cycle,
            "rhat_max": rhat, "promoted": promoted,
            "warm_started": warm is not None,
            "chains_warm_started": init_z is not None,
            "laplace_iters": int(run.laplace_iters),
            "n_steps": int(n_steps),
            "n_toas": int(self.stream._n.sum()),
            "latency_ms": round((now() - t0) * 1e3, 3),
        }

    def maybe_refresh(self, n_steps: int = 200, seed: int = 0, **run_kwargs
                      ) -> dict:
        """Refresh only when the :class:`RefreshPolicy` says one is due.

        Due: delegates to :meth:`refresh` (the returned info dict gains a
        ``trigger`` key, ``"appends"`` or ``"snr"``). Not due: no chains
        run; the skip is counted (``stream.refresh_skips``) and
        flight-recorded, and a ``{"skipped": True, ...}`` dict reports how
        far each trigger has accumulated.
        """
        pol = self.policy
        since = int(getattr(self.stream, "appends", 0)) - self._mark_appends
        snr = self._current_snr()
        gain = (abs(snr - self._mark_snr)
                if snr is not None and self._mark_snr is not None
                else (snr if snr is not None else 0.0))
        due_appends = since >= int(pol.every_appends)
        due_snr = pol.min_snr_gain > 0 and gain >= pol.min_snr_gain
        if not (due_appends or due_snr):
            self.skips += 1
            metrics.count("stream.refresh_skips")
            # the telemetry plane watches the gate decisions: holds vs
            # opens show whether refresh work keeps pace with arrivals
            metrics.count("stream.refresh_gate_holds")
            telemetry.publish("stream.refresh_gate_holds", int(self.skips))
            flightrec.note("stream_refresh_skip", appends_since=since,
                           snr_gain=round(float(gain), 6))
            return {"schema": STREAM_SCHEMA, "skipped": True,
                    "appends_since": since, "snr_gain": float(gain)}
        metrics.count("stream.refresh_gate_opens")
        telemetry.publish("stream.refresh_gate_opens",
                          int(self.refreshes) + 1)
        info = self.refresh(n_steps, seed=seed, **run_kwargs)
        info["trigger"] = "appends" if due_appends else "snr"
        info["skipped"] = False
        return info


class FactorizedRefresher:
    """O(bins-touched) incremental posterior refresh for per-bin
    free-spectrum streams (module docstring).

    Requires the stream's model to be exactly factorizable by
    :func:`..sample.factor_plan` (one ``per_bin`` free component;
    batch-pinned nuisances ride along). Lanes are built on the FIRST
    refresh and reused: later refreshes only inject freshly restricted
    moments (:meth:`..sample.SamplingRun.restage`).

    ``touch_tol`` is the relative ``dT`` movement (Frobenius, over the
    lane's own quadrature columns) above which a lane's conditional
    posterior is considered moved; defaults to ``tune/defaults.py
    FS_TOUCH_TOL``. ``refresh(force_all=True)`` is the A/B baseline: every
    lane re-sampled, same code path.
    """

    def __init__(self, stream, spec=None, *, lane_bins=None,
                 rhat_gate: float = 1.05, touch_tol=None, mesh=None,
                 device: DeviceLike = None, compile_cache_dir=None):
        _no_compile_cache(compile_cache_dir)
        self.stream = stream
        self.spec = (SampleSpec(model=stream.model) if spec is None
                     else as_spec(spec))
        if self.spec.model != stream.model:
            raise ValueError("FactorizedRefresher spec.model must be the "
                             "stream's model (same basis, same moments)")
        self.rhat_gate = float(rhat_gate)
        self.touch_tol = float(knobs.FS_TOUCH_TOL if touch_tol is None
                               else touch_tol)
        self.lane_bins = lane_bins
        self._place = _run_place(stream, mesh, device)
        self.posterior: Optional[dict] = None
        self.refreshes = 0
        self.promotions = 0
        self._compiled = None
        self._plan = None
        self._lanes = None
        self._dt_mark: Optional[np.ndarray] = None
        self._lane_results: dict = {}
        self._lane_warm: dict = {}
        self._lane_z: dict = {}

    def _moments_np(self):
        return tuple(x.detach().cpu().numpy().astype(np.float64)
                     for x in self.stream.moments())

    def _build(self, mom):
        """First-refresh lane construction.

        The build-time batch AND the pinned nuisance ``phi`` are cached so
        the marginalization operator stays FIXED across refreshes: only
        the data moments move with appends, which keeps touch detection
        stable and the per-refresh fold a single host solve.
        """
        self._batch = self.stream.batch_view()
        self._compiled = infer_model.build(self.spec.model, self._batch)
        self._plan = factor_plan(self._compiled, self.lane_bins)
        self._keep = sorted({c for lp in self._plan
                             for c in lp.free_cols})
        self._nuis = self._plan[0].nuisance_cols
        self._phi_nuis = nuisance_phi_np(self._compiled, self._batch,
                                         self._nuis)
        marg = self._marg(mom)
        self._lanes = []
        for lp in self._plan:
            lane_spec = dataclasses.replace(self.spec, model=lp.model)
            self._lanes.append(SamplingRun(
                self._batch, lane_spec,
                moments=_restrict_np(marg, lp.marg_cols), **self._place))
        return marg

    def _marg(self, mom):
        """Fold the pinned nuisances into the moments (Ntilde metric),
        with the build-time cached nuisance ``phi``: the pinned prior is
        theta-independent, so the fold stays one pure host solve."""
        return marginalize_nuisance_np(mom, self._keep, self._nuis,
                                       self._phi_nuis)

    def _touched(self, dt_new) -> list:
        """Lane indices whose data projection moved since the last refresh:
        an appended block perturbs the PARENT ``dT`` only in the bins it
        excites, so excitation is read off the raw projections (the
        marginalized ``dT`` folds nuisance projections into every column
        and would flood-fill the touch set on irregular grids; the R-hat
        gate catches any misprediction)."""
        out = []
        for lp in self._plan:
            cols = list(lp.free_cols)
            base = float(np.linalg.norm(self._dt_mark[:, cols]))
            delta = float(np.linalg.norm(dt_new[:, cols]
                                         - self._dt_mark[:, cols]))
            if delta > self.touch_tol * (base + 1e-300):
                out.append(lp.index)
        return out

    @property
    def lane_count(self) -> int:
        return 0 if self._plan is None else len(self._plan)

    def refresh(self, n_steps: int = 200, seed: int = 0, *,
                force_all: bool = False, **run_kwargs) -> dict:
        """One incremental cycle: slice current moments, re-sample the
        touched lanes warm, recombine, R-hat-gated promotion.

        The first call (and any ``force_all=True`` call) refreshes every
        lane: that IS the full-refresh baseline, same code path. Returns
        the cycle stats (``fs_*`` keys); the promoted recombined posterior
        is ``self.posterior``.
        """
        t0 = now()
        cold = self._lanes is None
        mom = self._moments_np()
        marg = self._build(mom) if cold else self._marg(mom)
        dt_new = np.asarray(mom[4])
        if cold or force_all or self._dt_mark is None:
            touched = [lp.index for lp in self._plan]
        else:
            touched = self._touched(dt_new)
        bins = sum(self._plan[i].hi - self._plan[i].lo for i in touched)
        retr0 = sum(lane.retraces for lane in self._lanes)
        rhat_ran = []
        for i in touched:
            lp, lane = self._plan[i], self._lanes[i]
            warm = self._lane_warm.get(i)
            if not cold:
                lane.restage(moments=_restrict_np(marg, lp.marg_cols))
            init_z = None
            z_prev = self._lane_z.get(i)
            if z_prev is not None and warm is not None:
                init_z = PosteriorRefresher._remap_z(
                    z_prev, warm, lane.laplace_state())
            res = lane.run(int(n_steps), seed=lane_seed(seed, i),
                           init_z=init_z, **run_kwargs)
            self._lane_results[i] = res
            self._lane_warm[i] = lane.laplace_state()
            self._lane_z[i] = lane.last_z
            rhat_ran.append(float(res["summary"].get("rhat_max",
                                                     float("nan"))))
            metrics.count("stream.fs_lanes_refreshed")
        recompiles = sum(lane.retraces for lane in self._lanes) - retr0
        rhat_max = max(rhat_ran) if rhat_ran else float("nan")
        cycle = self.refreshes
        self.refreshes += 1
        promoted = bool(rhat_ran) and bool(np.isfinite(rhat_max)
                                           and rhat_max <= self.rhat_gate)
        if promoted:
            results = [self._lane_results[lp.index] for lp in self._plan]
            theta = recombine_draws([lp.theta_idx for lp in self._plan],
                                    results, self._compiled.D)
            mode_theta = np.zeros(self._compiled.D)
            for lp, lane in zip(self._plan, self._lanes):
                mode_theta[list(lp.theta_idx)] = lane.mode_theta
            self.posterior = {
                "schema": STREAM_SCHEMA,
                "theta": theta,
                "param_names": list(self._compiled.param_names),
                "bounds": np.asarray(self._compiled.bounds),
                "mode_theta": mode_theta,
                "summary": {
                    "rhat_max": round(max(
                        r["summary"]["rhat_max"] for r in results), 5),
                    "ess_min": round(min(
                        r["summary"]["ess_min"] for r in results), 2),
                    "fs_lane_count": len(self._plan),
                },
            }
            self.promotions += 1
            metrics.count("stream.promotions")
        elif rhat_ran:
            flightrec.note("stream_fs_refresh_reject", refresh=cycle,
                           rhat_max=rhat_max, gate=self.rhat_gate)
        self._dt_mark = dt_new.copy()
        metrics.count("stream.fs_refreshes")
        metrics.count("stream.fs_bins_touched", bins)
        telemetry.publish("stream.fs_bins_touched", int(bins))
        return {
            "schema": STREAM_SCHEMA, "refresh": cycle,
            "fs_lane_count": len(self._plan),
            "fs_lanes_touched": len(touched),
            "fs_bins_touched": int(bins),
            "fs_recompiles": int(recompiles),
            "rhat_max": rhat_max, "promoted": promoted,
            "warm_started": not cold and not force_all,
            "n_steps": int(n_steps),
            "fs_refresh_ms": round((now() - t0) * 1e3, 3),
        }
