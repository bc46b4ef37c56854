"""SLO-driven autoscaling for a serve fleet (port of
``fakepta_tpu.serve.autoscale``, line for line).

The fleet's SLO rollup measures demand (``fleet_qps`` against what one
replica sustains, ``fleet_p99_ms`` against the latency objective); the
autoscaler turns that into a **target replica count** and actuates it
through the fleet's ``join`` / ``retire``, with three flap-killers:

- **step-by-one**: each :meth:`Autoscaler.step` changes membership by at
  most one replica;
- **hysteresis**: scale UP when demand exceeds current capacity (or p99
  passes ``p99_high_ms``); scale DOWN only when demand sits below
  ``(1 - hysteresis)`` of the post-shrink capacity AND p99 is under
  ``p99_low_ms``: the up and down thresholds never meet;
- **cooldown**: ``cooldown_s`` between actuations.

The policy (:meth:`Autoscaler.target`) is a pure function of the SLO
dict; the actuator (:meth:`Autoscaler.step`) is driven explicitly, and
actuates a :class:`.fleet.ServeFleet` through ``join`` / ``retire``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..obs import flightrec, metrics
from ..obs.timing import now as _now
from ..tune import defaults as knobs


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs (defaults from ``tune/defaults.py``)."""

    min_replicas: int = 1
    max_replicas: int = 8
    target_qps_per_replica: float = knobs.AUTOSCALE_TARGET_QPS_PER_REPLICA
    hysteresis: float = knobs.AUTOSCALE_HYSTERESIS
    p99_high_ms: float = knobs.AUTOSCALE_P99_HIGH_MS
    p99_low_ms: float = knobs.AUTOSCALE_P99_LOW_MS
    cooldown_s: float = knobs.AUTOSCALE_COOLDOWN_S


class Autoscaler:
    """Policy + actuator over a fleet (``slo_summary``, ``join``,
    ``retire``, ``alive_replicas``, ``replicas``).

    ``spawn`` builds a fresh un-joined replica for a scale-up —
    ``spawn(index) -> replica`` — so the transport (LocalReplica,
    SocketReplica, a k8s pod) is the caller's choice, not the policy's.
    """

    def __init__(self, fleet, spawn: Callable[[int], object],
                 config: Optional[AutoscaleConfig] = None):
        self.fleet = fleet
        self.spawn = spawn
        self.config = config or AutoscaleConfig()
        self.scale_events = 0
        self._spawned = 0
        self._last_action_t: Optional[float] = None

    # -- the pure policy ---------------------------------------------------
    def target(self, slo: dict) -> int:
        """Desired replica count from one SLO rollup (pure; see module
        docstring for the hysteresis contract)."""
        cfg = self.config
        alive = max(int(slo.get("fleet_replicas_alive", 1)), 1)
        qps = float(slo.get("fleet_qps", 0.0))
        p99 = float(slo.get("fleet_p99_ms", 0.0))
        demand = qps / cfg.target_qps_per_replica    # replicas of load
        want = alive
        if p99 > cfg.p99_high_ms or demand > alive:
            want = alive + 1
        elif (p99 < cfg.p99_low_ms and alive > 1
                and demand < (alive - 1) * (1.0 - cfg.hysteresis)):
            want = alive - 1
        return max(cfg.min_replicas, min(cfg.max_replicas, want))

    # -- the actuator ------------------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        """One control-loop tick: read the SLOs, move membership at most
        one replica toward the target (honoring the cooldown). Returns
        the decision record (also flight-recorded)."""
        cfg = self.config
        now = _now() if now is None else float(now)
        slo = self.fleet.slo_summary()
        alive = max(int(slo.get("fleet_replicas_alive", 1)), 1)
        want = self.target(slo)
        decision = {"alive": alive, "want": want, "action": "hold"}
        if want == alive:
            return decision
        if (self._last_action_t is not None
                and now - self._last_action_t < cfg.cooldown_s):
            decision["action"] = "cooldown"
            return decision
        if want > alive:
            self._spawned += 1
            index = len(self.fleet.replicas) + self._spawned
            replica = self.spawn(index)
            joined = self.fleet.join(replica)
            decision.update(action="up", replica=replica.id,
                            warm_loads=joined.get("warm_loads", 0))
        else:
            # deterministic victim: the lexicographically last live
            # replica (scale-downs retire the newest `scale-N` join
            # first, never the seed replicas)
            victim = sorted(self.fleet.alive_replicas())[-1]
            self.fleet.retire(victim)
            decision.update(action="down", replica=victim)
        self._last_action_t = now
        self.scale_events += 1
        metrics.count("fleet.scale_events")
        flightrec.note("fleet_scale", **{k: v for k, v in decision.items()
                                         if isinstance(v, (int, str))})
        return decision
