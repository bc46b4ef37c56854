"""Metrics core: counters, gauges, timing lists and a JSON-lines sink (port of
``fakepta_tpu.obs.metrics``).

A :class:`Collector` owns one run's metrics. Producers report through the
module-level helpers (``count``/``gauge``/``observe``/``record_span``/
``event``), which write to the *active* collector and do nothing when none
is installed, so instrumentation costs one truthiness check on the host
when it is off.

Event schema (one JSON object per line; ``SCHEMA`` versions it, and it is
the JAX package's string, so each package reads the other's artifacts):

    {"kind": "header",  "schema": ..., "meta": {...}}        # first line
    {"kind": "span",    "name": "draws"}
    {"kind": "counter", "name": "obs.chunks", "value": 2}
    {"kind": "gauge",   "name": ..., "value": ...}
    {"kind": "timing",  "name": ..., "values": [..]}
    {"kind": "event",   "name": ..., "value": ..., "attrs": {...}}
    {"kind": "summary", "metrics": {...}}                    # last line

The JAX package's ``subscribe_jax_monitoring`` (compile-time events of
XLA) has no counterpart: the port compiles no programs at run time; its
kernel builds are timed by :mod:`..ops._build`.
"""

from __future__ import annotations

import contextlib
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from . import flightrec

SCHEMA = "fakepta_tpu.obs/1"

#: the schema era of logs carrying the JAX package's telemetry-plane record
#: kinds; a strict superset of /1, so readers accept both
SCHEMA_V2 = "fakepta_tpu.obs/2"

ACCEPTED_SCHEMAS = (SCHEMA, SCHEMA_V2)


@dataclass
class Collector:
    """One run's worth of metrics: counters, gauges, timings, spans, events."""

    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    timings: Dict[str, List[float]] = field(default_factory=dict)
    spans: List[str] = field(default_factory=list)
    events: List[dict] = field(default_factory=list)

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        self.timings.setdefault(name, []).append(float(seconds))

    def record_span(self, name: str) -> None:
        if name not in self.spans:
            self.spans.append(name)

    def event(self, name: str, value: Any = None, **attrs) -> None:
        ev = {"name": name}
        if value is not None:
            ev["value"] = value
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)

    def timing_summary(self) -> Dict[str, dict]:
        return {name: {"n": len(ts), "total_s": sum(ts),
                       "mean_s": sum(ts) / len(ts)}
                for name, ts in self.timings.items() if ts}


# active-collector stack, thread-local so runs driven from different host
# threads do not interleave their metrics
_state = threading.local()


def active() -> Optional[Collector]:
    """The innermost installed collector, or None (instrumentation off)."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def collect(collector: Optional[Collector] = None) -> Iterator[Collector]:
    """Install ``collector`` as the active sink for the ``with`` body."""
    if collector is None:
        collector = Collector()
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(collector)
    try:
        yield collector
    finally:
        stack.pop()


def count(name: str, n: float = 1) -> None:
    c = active()
    if c is not None:
        c.count(name, n)


def gauge(name: str, value: float) -> None:
    c = active()
    if c is not None:
        c.gauge(name, value)


def observe(name: str, seconds: float) -> None:
    c = active()
    if c is not None:
        c.observe(name, seconds)


def record_span(name: str) -> None:
    c = active()
    if c is not None:
        c.record_span(name)


def event(name: str, value: Any = None, **attrs) -> None:
    """Record an event: always into the crash flight recorder's ring, and
    into the active collector when there is one."""
    flightrec.note(name, **({"value": value, **attrs} if value is not None
                            else attrs))
    c = active()
    if c is not None:
        c.event(name, value, **attrs)


class EventLog:
    """Append-only JSON-lines sink with the ``SCHEMA`` framing.

    ``append`` dicts, ``save`` to a ``.jsonl`` file (header first, summary
    last); ``EventLog.load`` reads any file this module, the report's
    ``save`` or the JAX package wrote. An unknown schema fails loudly.
    """

    def __init__(self, meta: Optional[dict] = None, schema: str = SCHEMA):
        if schema not in ACCEPTED_SCHEMAS:
            raise ValueError(f"unknown event-log schema {schema!r}; "
                             f"accepted: {ACCEPTED_SCHEMAS}")
        self.meta = dict(meta or {})
        self.schema = schema
        self.lines: List[dict] = []

    def append(self, kind: str, **fields) -> dict:
        ev = {"kind": kind, **fields}
        self.lines.append(ev)
        return ev

    def extend_from(self, collector: Collector) -> None:
        """Serialize a collector's state into schema lines."""
        for name in collector.spans:
            self.append("span", name=name)
        for name, value in sorted(collector.counters.items()):
            self.append("counter", name=name, value=value)
        for name, value in sorted(collector.gauges.items()):
            self.append("gauge", name=name, value=value)
        for name, values in sorted(collector.timings.items()):
            self.append("timing", name=name, values=list(values))
        for ev in collector.events:
            self.append("event", **ev)

    def to_jsonl(self, summary: Optional[dict] = None) -> str:
        out = [json.dumps({"kind": "header", "schema": self.schema,
                           "meta": self.meta})]
        out += [json.dumps(line) for line in self.lines]
        if summary is not None:
            out.append(json.dumps({"kind": "summary", "metrics": summary}))
        return "\n".join(out) + "\n"

    def save(self, path, summary: Optional[dict] = None) -> str:
        with open(path, "w") as fh:
            fh.write(self.to_jsonl(summary))
        return str(path)

    @classmethod
    def parse(cls, text: str) -> "EventLog":
        log = cls()
        for i, raw in enumerate(text.splitlines()):
            raw = raw.strip()
            if not raw:
                continue
            line = json.loads(raw)
            if i == 0:
                if line.get("kind") != "header":
                    raise ValueError("event log must start with a header line")
                if line.get("schema") not in ACCEPTED_SCHEMAS:
                    raise ValueError(
                        f"event-log schema {line.get('schema')!r} not in "
                        f"{ACCEPTED_SCHEMAS}: refusing to mix telemetry eras")
                log.meta = line.get("meta", {})
                log.schema = line["schema"]
                continue
            log.lines.append(line)
        return log

    @classmethod
    def load(cls, path) -> "EventLog":
        with open(path) as fh:
            return cls.parse(fh.read())

    def summary(self) -> Optional[dict]:
        for line in reversed(self.lines):
            if line.get("kind") == "summary":
                return line.get("metrics", {})
        return None
