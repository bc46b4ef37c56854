"""The port's fleet lifecycle pieces (``serve/router.py``,
``serve/health.py``, ``serve/autoscale.py``) against the JAX package's,
on the CPU. All host logic: no simulator, no socket.

- :class:`HashRing`: owners and preference orders equal to the JAX ring's
  over 1,000 spec hashes, through a join and a leave;
- :class:`HealthMonitor` on a fake fleet (the duck-typed replica map and
  lock of JAX ``tests/test_lifecycle.py``): probes stepped one at a time
  through the same scripted answers and fault plans step through the same
  states and counters as the JAX monitor's (the ``fleet.heartbeat`` and
  ``telemetry.scrape`` sites included); then the monitor's own thread
  takes a replica healthy -> suspect -> wedged -> healthy -> dead;
- :class:`Autoscaler`: ``target`` equal to the JAX policy's over a grid,
  and ``step`` on a fake fleet making the same decisions.
"""

import hashlib
import itertools
import threading
import time

import pytest

from fakepta_tpu import faults as jfaults
from fakepta_tpu.serve import autoscale as jautoscale
from fakepta_tpu.serve import health as jhealth
from fakepta_tpu.serve import router as jrouter
from fakepta_tpu.tune import defaults as jdefaults
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.serve import autoscale, health, router
from fakepta_tpu_torch.tune import defaults

HASHES = [hashlib.sha1(str(i).encode()).hexdigest()[:12]
          for i in range(1000)]
FAST = dict(period_s=0.05, probe_deadline_s=0.05, suspect_after=2,
            wedged_after=4, close_after=2, backoff_base_s=0.02,
            backoff_cap_s=0.1, scrape_every=1)

#: the serve and lifecycle knobs both packages define
SERVE_KNOBS = ("DEFAULT_BUCKETS", "BUCKET_RATIO", "DEFAULT_FLEET_BUCKETS",
               "HEARTBEAT_PERIOD_S", "HEARTBEAT_DEADLINE_S",
               "HEARTBEAT_SUSPECT_AFTER", "HEARTBEAT_WEDGED_AFTER",
               "BREAKER_CLOSE_AFTER", "BREAKER_BACKOFF_BASE_S",
               "BREAKER_BACKOFF_CAP_S", "AUTOSCALE_TARGET_QPS_PER_REPLICA",
               "AUTOSCALE_HYSTERESIS", "AUTOSCALE_P99_HIGH_MS",
               "AUTOSCALE_P99_LOW_MS", "AUTOSCALE_COOLDOWN_S",
               "TELEMETRY_SCRAPE_EVERY", "TELEMETRY_RING_SIZE",
               "TELEMETRY_WINDOW_S")


def test_every_shared_knob_equals_jax():
    """Every upper-case name both knob tables define has the JAX value
    (DEFAULT_PATH maps through {"xla": "einsum"})."""
    shared = {k for k in vars(defaults) if k.isupper()} & \
        {k for k in vars(jdefaults) if k.isupper()}
    assert set(SERVE_KNOBS) <= shared
    for name in sorted(shared):
        want = getattr(jdefaults, name)
        if name == "DEFAULT_PATH":
            want = {"xla": "einsum"}.get(want, want)
        assert getattr(defaults, name) == want, name


@pytest.mark.parametrize("vnodes", [1, 8, router.DEFAULT_VNODES])
def test_hash_ring_equals_jax_through_join_and_leave(vnodes):
    ids = ["r0", "r1", "r2"]
    ring = router.HashRing(ids, vnodes=vnodes)
    jring = jrouter.HashRing(ids, vnodes=vnodes)
    for step in ("start", "join", "leave"):
        if step == "join":
            ring.add("r3")
            jring.add("r3")
        elif step == "leave":
            ring.remove("r1")
            jring.remove("r1")
        assert ring.replica_ids == jring.replica_ids
        assert ring._points == jring._points
        assert [ring.owner(h) for h in HASHES] == \
            [jring.owner(h) for h in HASHES]
        assert [ring.preference(h) for h in HASHES] == \
            [jring.preference(h) for h in HASHES]
        assert ring.shard(HASHES) == jring.shard(HASHES)


def test_hash_ring_errors_equal_jax():
    for mod in (router, jrouter):
        with pytest.raises(ValueError, match="vnodes"):
            mod.HashRing([], vnodes=0)
        ring = mod.HashRing(["a"])
        with pytest.raises(ValueError, match="already on the ring"):
            ring.add("a")
        with pytest.raises(ValueError, match="not on the ring"):
            ring.remove("b")
        ring.remove("a")
        with pytest.raises(ValueError, match="no replicas"):
            ring.owner("x")


class _Replica:
    """A scripted replica: ``answers`` is the probe outcomes in order
    (True answers, False times out past the deadline)."""

    def __init__(self, answers, deadline_s=0.05):
        self.alive = True
        self.answers = list(answers)
        self.deadline_s = deadline_s
        self.scraped = 0

    def ping(self, deadline_s):
        if not (self.answers.pop(0) if self.answers else True):
            raise TimeoutError(f"no pong within {deadline_s}s")
        return True

    def telemetry(self, deadline_s):
        self.scraped += 1
        return {"seq": self.scraped, "epoch": "e", "t": float(self.scraped),
                "replica": "r", "slo": {"serve_requests": self.scraped}}


class _FakeFleet:
    def __init__(self, replicas):
        self.replicas = replicas
        self._lock = threading.Lock()


class _Aggregator:
    def __init__(self):
        self.seen = []

    def ingest(self, rid, snap, health=None):
        self.seen.append((rid, snap["seq"], dict(health)))


def _trace(mod, faults_mod, answers, plan_specs, kill_at=None):
    """Step one monitor's probes of replica r0 by hand; the (state,
    misses, ok_streak, backoff) after each and the monitor's stats."""
    rep = _Replica(answers)
    agg = _Aggregator()
    hm = mod.HealthMonitor(_FakeFleet({"r0": rep}),
                           mod.HealthConfig(**FAST), aggregator=agg)
    st = hm._states.setdefault("r0", mod._ReplicaHealth())
    plan = faults_mod.FaultPlan([faults_mod.FaultSpec(*s[:2], **s[2])
                                 for s in plan_specs])
    trace = []
    with faults_mod.inject(plan):
        for i in range(len(answers)):
            if i == kill_at:
                rep.alive = False
            hm._probe("r0", rep, st)
            trace.append((st.state, st.misses, st.ok_streak,
                          round(st.backoff_s, 6)))
    return trace, hm.stats(), agg.seen, plan.fired


SCRIPTS = {
    "wedge_and_recover": (
        [True, False, False, False, False, True, True, True], [], None),
    "flaky_then_breaker": (
        [True, True, False, True, False, False, True, True], [], None),
    "injected_heartbeat": (
        [True] * 8,
        [("fleet.heartbeat", "transient",
          dict(at=(1, 2, 3), match=(("replica", "r0"),)))], None),
    "injected_scrape": (
        [True] * 5, [("telemetry.scrape", "transient", dict(at=(0, 2)))],
        None),
    "death": ([True, False, False, True], [], 2),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_health_monitor_steps_like_jax(script):
    answers, specs, kill_at = SCRIPTS[script]
    got = _trace(health, faults, answers, specs, kill_at)
    want = _trace(jhealth, jfaults, answers, specs, kill_at)
    assert got == want
    states = [t[0] for t in got[0]]
    if script == "wedge_and_recover":
        assert states[2:] == ["suspect", "suspect", "wedged", "wedged",
                              "healthy", "healthy"]
        assert got[1]["fleet_breaker_opens"] == 1
        assert got[1]["fleet_breaker_closes"] == 1
    if script == "injected_scrape":
        # a failed scrape is counted, never a heartbeat miss
        assert got[1]["fleet_scrape_errors"] == 2
        assert got[1]["fleet_heartbeat_misses"] == 0
        assert got[1]["fleet_scrapes"] == 3
    if script == "death":
        assert states[-2:] == ["dead", "dead"]


def _wait_for(pred, timeout_s=20.0, step=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


class _Switch:
    """A replica whose pongs can be withheld (a wedge) and whose
    transport can be cut (death)."""

    def __init__(self):
        self.alive = True
        self.answer = threading.Event()
        self.answer.set()

    def ping(self, deadline_s):
        if not self.answer.is_set():
            time.sleep(deadline_s * 1.5)
            raise TimeoutError("no pong")
        return True


def test_health_monitor_thread_wedge_recover_die():
    """The monitor's own thread: pongs withheld -> suspect -> wedged
    (breakered, still alive); pongs back -> healthy after consecutive
    successes; transport cut -> dead. Generous waits, no fixed sleeps."""
    rep = _Switch()
    hm = health.HealthMonitor(_FakeFleet({"w0": rep}),
                              health.HealthConfig(**FAST)).start()
    try:
        assert _wait_for(lambda: hm.stats()["fleet_probes"] >= 2)
        assert hm.state("w0") == "healthy" and hm.routable("w0")
        rep.answer.clear()
        assert _wait_for(lambda: hm.state("w0") == "suspect")
        assert not hm.routable("w0")
        assert _wait_for(lambda: hm.state("w0") == "wedged")
        assert hm.stats()["fleet_breakered"] == 1
        rep.answer.set()
        assert _wait_for(lambda: hm.state("w0") == "healthy")
        assert hm.stats()["fleet_breaker_closes"] == 1
        rep.alive = False
        assert _wait_for(lambda: hm.state("w0") == "dead")
        assert not hm.routable("w0")
        assert hm.states() == {"w0": "dead"}
    finally:
        hm.stop(timeout_s=10.0)
    with pytest.raises(RuntimeError, match="already started"):
        hm.start()


GRID = list(itertools.product((1, 2, 4), (0.0, 5.0, 8.0, 15.0, 25.0, 1e6),
                              (0.0, 5.0, 50.0, 500.0)))


def test_autoscaler_target_equals_jax_over_a_grid():
    kw = dict(min_replicas=1, max_replicas=4, target_qps_per_replica=10.0,
              hysteresis=0.25, p99_high_ms=100.0, p99_low_ms=20.0)
    sc = autoscale.Autoscaler(None, None, autoscale.AutoscaleConfig(**kw))
    jsc = jautoscale.Autoscaler(None, None,
                                jautoscale.AutoscaleConfig(**kw))
    for alive, qps, p99 in GRID:
        slo = {"fleet_replicas_alive": alive, "fleet_qps": qps,
               "fleet_p99_ms": p99}
        assert sc.target(slo) == jsc.target(slo), slo
    assert autoscale.AutoscaleConfig() == autoscale.AutoscaleConfig(
        **{f: getattr(jautoscale.AutoscaleConfig(), f)
           for f in autoscale.AutoscaleConfig.__dataclass_fields__})


class _ScaleFleet:
    """The fleet surface Autoscaler.step drives."""

    def __init__(self, slos):
        self.slos = list(slos)
        self.replicas = {"r0": None, "r1": None}
        self.log = []

    def slo_summary(self):
        return dict(self.slos.pop(0), fleet_replicas_alive=len(
            self.replicas))

    def join(self, replica):
        self.replicas[replica.id] = replica
        self.log.append(("join", replica.id))
        return {"warm_loads": 2}

    def retire(self, rid):
        self.replicas.pop(rid)
        self.log.append(("retire", rid))

    def alive_replicas(self):
        return list(self.replicas)


class _New:
    def __init__(self, index):
        self.id = f"scale{index}"


def test_autoscaler_step_decides_like_jax():
    slos = [{"fleet_qps": 50.0, "fleet_p99_ms": 5.0}] * 2 + \
        [{"fleet_qps": 0.0, "fleet_p99_ms": 1.0}] * 3
    times = (0.0, 1.0, 100.0, 101.0, 200.0)
    logs = []
    for mod in (autoscale, jautoscale):
        flt = _ScaleFleet(slos)
        sc = mod.Autoscaler(flt, _New, mod.AutoscaleConfig(
            target_qps_per_replica=10.0, cooldown_s=30.0))
        decisions = [sc.step(now=t) for t in times]
        logs.append((decisions, flt.log, sc.scale_events))
    assert logs[0] == logs[1]
    assert [d["action"] for d in logs[0][0]] == \
        ["up", "cooldown", "down", "cooldown", "down"]
