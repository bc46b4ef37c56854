"""Deterministic fault injection: a seeded plan arming named engine sites
(port of ``fakepta_tpu.faults.plan``).

Chaos testing for the engine: a :class:`FaultPlan` arms **named sites**
threaded through the hot paths and fires scripted faults at exact,
reproducible hit indices. Every fired fault is mirrored into the crash
flight recorder (:mod:`..obs.flightrec`) and counted
(``faults.injected``), so a chaos run's report shows what was injected
where.

The plan is **deterministic by construction**: each site keeps a per-plan
hit counter, and a :class:`FaultSpec` names the hit indices (``at``) that
fire. Two runs under the same plan inject the same faults at the same
sites in the same order, which is what lets the chaos tests hold the
recovered run bit-identical to the unfaulted one.

Sites in the port:

========================  ====================================================
site                      where it is checked
========================  ====================================================
``mc.dispatch``           EnsembleSimulator.run, before each chunk dispatch
``mc.recycle``            EnsembleSimulator.run, the ring's buffer reuse
``pipeline.writer``       the per-chunk/segment drain (writer thread)
``ckpt.append``           EnsembleCheckpoint/SampleCheckpoint ``save``
``sample.segment``        SamplingRun.run, before each segment dispatch
========================  ====================================================

The JAX package's ``cache.load`` site wires XLA's persistent compilation
cache, which the port does not have (its kernels are built once per
checkout by :mod:`..ops._build`), so it has no counterpart. The
``serve.dispatch``, ``fleet.*``, ``ingest.append``, ``telemetry.scrape``
and ``gateway.*`` sites come with their modules (ROADMAP Queue 1 items 9
and 11b). ``match`` and the fleet context keys are kept so a plan reads
the same in both packages.

Fault kinds: ``transient`` / ``fatal`` raise (:class:`TransientFault` /
:class:`FatalFault`); ``degrade`` / ``precision`` raise the ladder triggers
(:class:`DegradeFault`, a hand-written kernel's launch failure stand-in,
and :class:`PrecisionFault`, a bf16 certification failure); ``kill``
raises :class:`KillFault` (a ``BaseException``: simulated process death,
never caught by recovery); ``hang`` sleeps ``hang_s`` at the site (a stuck
drain the watchdog must catch); ``poison`` / ``torn`` / ``donation``
return the kind string so the site applies the corruption itself (NaN the
dispatched output, tear the checkpoint write, fake a failed buffer reuse).

No plan installed means every site check is one global read and a ``None``
return: the harness costs nothing when it is off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence, Tuple

from ..obs import flightrec
from ..obs import metrics

#: fault kinds that raise at the site
_RAISING_KINDS = ("transient", "fatal", "degrade", "precision", "kill")
#: fault kinds returned to the site for in-place corruption
_ACTING_KINDS = ("poison", "torn", "donation", "hang")
KINDS = _RAISING_KINDS + _ACTING_KINDS


class FaultError(RuntimeError):
    """Base class of every injected (raising) fault."""


class TransientFault(FaultError):
    """A retryable failure (the injected stand-in for preemptions, evicted
    executables, transient RPC errors); recovery retries with backoff."""


class FatalFault(FaultError):
    """A non-retryable failure: recovery must fail loudly, never mask it."""


class DegradeFault(FaultError):
    """A hand-written kernel's launch failure stand-in (the JAX package's
    Pallas failure): recovery steps down the statistic-path ladder
    (mega -> fused); on the fused path it propagates."""


class PrecisionFault(FaultError):
    """A bf16 certification failure stand-in: recovery re-dispatches the
    chunk at f32."""


class KillFault(BaseException):
    """Simulated process death (SIGKILL analog) — derives from
    ``BaseException`` so no recovery path can swallow it; the kill-resume
    chaos tests raise it mid-checkpoint-write."""


class WatchdogTimeout(RuntimeError):
    """A per-chunk watchdog deadline expired: the oldest in-flight drain
    never completed. The engine dumps the flight recorder and aborts."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed site: fire ``kind`` at the site's hit indices ``at``.

    ``at`` is a tuple of 0-based per-site hit counters (the Nth time the
    engine reaches the site under this plan); ``times`` caps total fires
    (default: one per ``at`` entry). ``hang_s`` is the sleep of a ``hang``
    fault — size it against the watchdog deadline under test.

    ``match`` narrows the spec to site visits whose context carries the
    given (key, value) pairs — e.g. ``match=(("replica", "r1"),)`` wedges
    ONE replica's heartbeat probes while its siblings stay healthy. A
    matched spec keeps its own hit counter over *matching* visits only, so
    ``at`` stays deterministic no matter how the fleet interleaves probes.
    """

    site: str
    kind: str = "transient"
    at: Tuple[int, ...] = (0,)
    times: Optional[int] = None
    hang_s: float = 2.0
    match: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))
        object.__setattr__(self, "match",
                           tuple((str(k), str(v)) for k, v in self.match))


class FaultPlan:
    """A deterministic schedule of faults over named sites.

    >>> plan = FaultPlan([FaultSpec("mc.dispatch", "transient", at=(1,))])
    >>> with fakepta_tpu_torch.faults.inject(plan):
    ...     sim.run(...)        # chunk 1's dispatch fails once, is retried

    ``hits``/``fired`` record what actually happened (the chaos tests
    assert on them); both are plain host bookkeeping.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.hits: dict = {}          # site -> times the site was reached
        self.fired: list = []         # (site, kind, hit_index) in fire order
        self._remaining = {id(s): (len(s.at) if s.times is None else s.times)
                           for s in self.specs}
        # matched specs count their own matching visits (FaultSpec.match)
        self._match_hits = {id(s): 0 for s in self.specs if s.match}

    def sites(self) -> Tuple[str, ...]:
        return tuple(sorted({s.site for s in self.specs}))

    def hit(self, site: str, **ctx) -> Optional[str]:
        """One site visit: fire any armed spec whose ``at`` matches.

        Raising kinds raise; acting kinds return the kind string for the
        site to apply. Every fire is flight-recorded and counted.
        """
        idx = self.hits.get(site, 0)
        self.hits[site] = idx + 1
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.match:
                if any(str(ctx.get(k)) != v for k, v in spec.match):
                    continue
                spec_idx = self._match_hits[id(spec)]
                self._match_hits[id(spec)] = spec_idx + 1
            else:
                spec_idx = idx
            if spec_idx not in spec.at:
                continue
            if self._remaining[id(spec)] <= 0:
                continue
            self._remaining[id(spec)] -= 1
            self.fired.append((site, spec.kind, spec_idx))
            flightrec.note("fault_fired", site=site, kind=spec.kind,
                           hit=spec_idx,
                           **{k: v for k, v in ctx.items()
                              if isinstance(v, (int, float, str))})
            metrics.count("faults.injected")
            if spec.kind == "transient":
                raise TransientFault(f"injected transient fault at {site} "
                                     f"(hit {spec_idx})")
            if spec.kind == "fatal":
                raise FatalFault(f"injected fatal fault at {site} "
                                 f"(hit {spec_idx})")
            if spec.kind == "degrade":
                raise DegradeFault(f"injected kernel failure at {site} "
                                   f"(hit {spec_idx})")
            if spec.kind == "precision":
                raise PrecisionFault(f"injected bf16 certification failure "
                                     f"at {site} (hit {spec_idx})")
            if spec.kind == "kill":
                raise KillFault(f"injected process kill at {site} "
                                f"(hit {spec_idx})")
            if spec.kind == "hang":
                time.sleep(spec.hang_s)
                return "hang"
            return spec.kind          # poison / torn / donation
        return None


# process-wide active plan: a single slot, installed by inject(). Reads are
# unlocked (one global load on the hot path); tests install one plan at a
# time, and the writer/serve threads only ever read it.
_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    """The installed plan, if any."""
    return _ACTIVE


def check(site: str, **ctx) -> Optional[str]:
    """Site hook: fire any armed fault at ``site`` (see FaultPlan.hit).

    Returns ``None`` with no plan installed — a single global read, so the
    harness is free when idle.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.hit(site, **ctx)


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Install ``plan`` process-wide for the scope of the context."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already installed; nest-injecting "
                           "plans would make the hit counters ambiguous")
    flightrec.note("fault_plan_armed", sites=",".join(plan.sites()),
                   seed=plan.seed)
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None
