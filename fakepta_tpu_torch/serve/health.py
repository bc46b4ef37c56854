"""Active health plane for a serve fleet: heartbeats and circuit breakers
(port of ``fakepta_tpu.serve.health``, line for line).

The plane probes every replica **out of band** and classifies it before
traffic does:

- **probe**: a no-op ``ping`` over the replica's connection (protocol kind
  ``ping``, ``serve/cli.py``) with a bounded deadline
  (``HEARTBEAT_DEADLINE_S``): nothing to build, nothing to queue behind
  the scheduler, so a missed probe means the process or its socket
  plumbing is stuck, not that it is merely busy;
- **states**: ``healthy`` -> (consecutive misses) -> ``suspect`` ->
  ``wedged`` -> (transport EOF / kill) -> ``dead``. Suspect and wedged
  replicas are **breakered**: :meth:`HealthMonitor.routable` returns
  False, while probing continues with exponential backoff
  (``BREAKER_BACKOFF_BASE_S`` doubling to ``BREAKER_BACKOFF_CAP_S``);
- **breaker close**: only after ``BREAKER_CLOSE_AFTER`` consecutive probe
  successes does a breakered replica take traffic again;
- **dead**: transport-level death is detected by the fleet's reader
  threads; the monitor records the terminal state;
- **scrape**: every ``scrape_every``-th successful probe also pulls the
  replica's telemetry snapshot into an aggregator, best-effort: a failed
  scrape is counted, never a heartbeat miss.

Chaos: every probe passes the ``fleet.heartbeat`` fault site with
``replica=<id>`` context (a ``hang`` matched to one replica is a wedge, a
``transient`` one flaky probe), and every scrape the ``telemetry.scrape``
site, after the probe's verdict is recorded.

The monitor is one daemon thread; it works on any object with a
``replicas`` map and the ``_lock`` guarding it (a
:class:`.fleet.ServeFleet`), holds no fleet lock while probing, and
shuts down with a bounded join.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from .. import faults as faults_mod
from ..obs import flightrec, metrics
from ..obs.timing import now as _now
from ..tune import defaults as knobs

#: the health states, in degradation order
STATES = ("healthy", "suspect", "wedged", "dead")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Heartbeat/breaker knobs (defaults from ``tune/defaults.py``; tests
    shrink the periods)."""

    period_s: float = knobs.HEARTBEAT_PERIOD_S
    probe_deadline_s: float = knobs.HEARTBEAT_DEADLINE_S
    suspect_after: int = knobs.HEARTBEAT_SUSPECT_AFTER
    wedged_after: int = knobs.HEARTBEAT_WEDGED_AFTER
    close_after: int = knobs.BREAKER_CLOSE_AFTER
    backoff_base_s: float = knobs.BREAKER_BACKOFF_BASE_S
    backoff_cap_s: float = knobs.BREAKER_BACKOFF_CAP_S
    #: telemetry scrape cadence: scrape every Nth successful probe of a
    #: replica (0 disables scraping); the scrape rides the heartbeat's
    #: connection, no new sockets
    scrape_every: int = knobs.TELEMETRY_SCRAPE_EVERY


class _ReplicaHealth:
    __slots__ = ("state", "misses", "ok_streak", "next_probe_t",
                 "backoff_s", "probes", "total_misses")

    def __init__(self):
        self.state = "healthy"
        self.misses = 0            # consecutive
        self.ok_streak = 0         # consecutive
        self.next_probe_t = 0.0    # monotonic; 0 -> probe immediately
        self.backoff_s = 0.0
        self.probes = 0
        self.total_misses = 0


class HealthMonitor:
    """The fleet's heartbeat thread (module docstring).

    ``fleet`` is duck-typed: it exposes ``replicas`` (id -> replica with
    ``alive``, ``ping(deadline_s)`` and optionally
    ``telemetry(deadline_s)``) and ``_lock`` guarding the map.
    """

    def __init__(self, fleet, config: Optional[HealthConfig] = None,
                 aggregator=None):
        self.fleet = fleet
        self.config = config or HealthConfig()
        #: fleet-level TelemetryAggregator fed by the heartbeat scrape
        #: (None = health plane only, no telemetry)
        self.aggregator = aggregator
        self._states: Dict[str, _ReplicaHealth] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.heartbeat_misses = 0
        self.breaker_opens = 0
        self.breaker_closes = 0
        self.probes = 0
        self.scrapes = 0
        self.scrape_errors = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            raise RuntimeError("health monitor already started")
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-health", daemon=True)
        self._thread.start()
        flightrec.note("health_start",
                       period_s=self.config.period_s,
                       deadline_s=self.config.probe_deadline_s)
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        """Bounded shutdown: a probe stuck in an injected hang may hold
        the thread for its ``hang_s``; the join is bounded and an expiry
        is flight-recorded, never a silent hang (the
        ``unbounded-thread-join`` invariant)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                flightrec.note("health_stop_join_timeout",
                               timeout_s=timeout_s)

    # -- routing hook ------------------------------------------------------
    def routable(self, rid: str) -> bool:
        """False while the replica's breaker is open (suspect/wedged) or
        it is dead; a replica the monitor has not probed yet is routable
        (innocent until a missed heartbeat)."""
        st = self._states.get(rid)
        return st is None or st.state == "healthy"

    def state(self, rid: str) -> str:
        st = self._states.get(rid)
        return st.state if st is not None else "healthy"

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {rid: st.state for rid, st in self._states.items()}

    def forget(self, rid: str) -> None:
        """Drop a retired replica's record (fleet.retire)."""
        with self._lock:
            self._states.pop(rid, None)

    def stats(self) -> dict:
        """The ``fleet_*`` health counters merged into
        :meth:`ServeFleet.slo_summary` (direction tables: misses and
        breaker opens regress upward)."""
        with self._lock:
            wedged = sum(1 for s in self._states.values()
                         if s.state == "wedged")
            breakered = sum(1 for s in self._states.values()
                            if s.state in ("suspect", "wedged"))
            return {
                "fleet_probes": self.probes,
                "fleet_heartbeat_misses": self.heartbeat_misses,
                "fleet_breaker_opens": self.breaker_opens,
                "fleet_breaker_closes": self.breaker_closes,
                "fleet_breakered": breakered,
                "fleet_wedged": wedged,
                "fleet_scrapes": self.scrapes,
                "fleet_scrape_errors": self.scrape_errors,
            }

    def reset_counters(self) -> None:
        """Loadgen warmup/measure boundary (states are NOT reset — a
        breakered replica stays breakered across the boundary)."""
        with self._lock:
            self.heartbeat_misses = 0
            self.breaker_opens = 0
            self.breaker_closes = 0
            self.probes = 0
            self.scrapes = 0
            self.scrape_errors = 0

    # -- the monitor thread ------------------------------------------------
    def _run(self) -> None:
        # the loop quantum bounds stop() latency without busy-waiting;
        # probes themselves are scheduled per replica on period/backoff
        quantum = min(max(self.config.period_s / 4.0, 0.005), 0.25)
        while not self._stop.is_set():
            now = _now()
            with self.fleet._lock:
                replicas = dict(self.fleet.replicas)
            for rid, replica in replicas.items():
                if self._stop.is_set():
                    break
                with self._lock:
                    st = self._states.setdefault(rid, _ReplicaHealth())
                if st.state == "dead":
                    continue
                if not getattr(replica, "alive", False):
                    self._transition(rid, st, "dead", why="transport dead")
                    continue
                if now < st.next_probe_t:
                    continue
                self._probe(rid, replica, st)
            self._stop.wait(quantum)

    def _probe(self, rid: str, replica, st: _ReplicaHealth) -> None:
        cfg = self.config
        t0 = _now()
        ok = True
        why = ""
        try:
            # chaos site: a matched `hang` sleeps HERE (in the monitor
            # thread) past the deadline -> a missed probe, exactly what a
            # wedged replica looks like; `transient` is one flaky probe
            faults_mod.check("fleet.heartbeat", replica=rid)
            replica.ping(cfg.probe_deadline_s)
        except faults_mod.TransientFault:
            ok, why = False, "injected transient probe failure"
        except BaseException as exc:  # noqa: BLE001 — a probe may fail
            # with anything the transport can raise (timeout, OSError,
            # ReplicaDead); every failure is a miss, never a crash of the
            # monitor thread
            ok, why = False, repr(exc)[:120]
        elapsed = _now() - t0
        if elapsed > cfg.probe_deadline_s:
            ok, why = False, (why or f"probe took {elapsed:.3f}s "
                                     f"> {cfg.probe_deadline_s}s deadline")
        now = _now()
        with self._lock:
            self.probes += 1
            st.probes += 1
        if ok:
            st.misses = 0
            st.ok_streak += 1
            if (st.state in ("suspect", "wedged")
                    and st.ok_streak >= cfg.close_after):
                st.backoff_s = 0.0
                self._transition(rid, st, "healthy",
                                 why=f"{st.ok_streak} consecutive probe "
                                     f"successes")
                with self._lock:
                    self.breaker_closes += 1
            # telemetry piggyback: the scrape reuses the probe's mux'd
            # connection on the probe's cadence — by construction there is
            # no telemetry socket, timer, or thread to add
            self._scrape(rid, replica, st)
            st.next_probe_t = now + (cfg.period_s if st.state == "healthy"
                                     else st.backoff_s or cfg.period_s)
            return
        # a miss
        st.ok_streak = 0
        st.misses += 1
        st.total_misses += 1
        with self._lock:
            self.heartbeat_misses += 1
        metrics.count("fleet.heartbeat_misses")
        if not getattr(replica, "alive", False):
            self._transition(rid, st, "dead", why=why)
            return
        if st.state == "healthy" and st.misses >= cfg.suspect_after:
            # breaker OPENS: drain new routes, probe with backoff
            st.backoff_s = cfg.backoff_base_s
            self._transition(rid, st, "suspect", why=why)
            with self._lock:
                self.breaker_opens += 1
            metrics.count("fleet.breaker_opens")
        elif st.state == "suspect" and st.misses >= cfg.wedged_after:
            self._transition(rid, st, "wedged", why=why)
        if st.state in ("suspect", "wedged"):
            st.next_probe_t = now + st.backoff_s
            st.backoff_s = min(st.backoff_s * 2.0 or cfg.backoff_base_s,
                               cfg.backoff_cap_s)
        else:
            st.next_probe_t = now + cfg.period_s
        return

    def _scrape(self, rid: str, replica, st: _ReplicaHealth) -> None:
        """Scrape one replica's telemetry snapshot into the aggregator.

        Best-effort by contract: a failed scrape is counted and
        flight-recorded but is NEVER a heartbeat miss — telemetry must not
        be able to breaker a healthy replica. Runs only after a probe
        SUCCESS, so it adds zero traffic to a struggling replica."""
        agg = self.aggregator
        cfg = self.config
        if agg is None or cfg.scrape_every <= 0:
            return
        if st.probes % cfg.scrape_every:
            return
        scrape = getattr(replica, "telemetry", None)
        if scrape is None:
            return
        try:
            # chaos site: a `transient`/`hang` here exercises exactly the
            # scrape path, distinct from the heartbeat's own site
            faults_mod.check("telemetry.scrape", replica=rid)
            snap = scrape(cfg.probe_deadline_s)
        except BaseException as exc:  # noqa: BLE001 — best-effort scrape
            with self._lock:
                self.scrape_errors += 1
            metrics.count("telemetry.scrape_errors")
            flightrec.note("telemetry_scrape_failed", replica=rid,
                           error=repr(exc)[:160])
            return
        if not snap:
            return
        agg.ingest(rid, snap, health={
            "state": st.state, "misses": st.misses,
            "breaker_open": st.state in ("suspect", "wedged")})
        with self._lock:
            self.scrapes += 1

    def _transition(self, rid: str, st: _ReplicaHealth, to: str,
                    why: str = "") -> None:
        if st.state == to:
            return
        flightrec.note("health_transition", replica=rid,
                       frm=st.state, to=to, misses=st.misses,
                       why=str(why)[:160])
        st.state = to
