"""Run identity and the crash flight recorder (port of
``fakepta_tpu.obs.flightrec``).

:func:`spec_hash` is the run identity the scenario registry rides on; it
equals the JAX package's hash for the same spec.

The flight recorder is an always-on bounded ring of recent events
(:data:`RING_SIZE`, oldest dropped first): :func:`note` costs one
``deque.append`` whether or not a collector is installed. When
:meth:`EnsembleSimulator.run` raises, it dumps the ring with the run's
identity and the chunk records completed so far to
``<checkpoint dir>/flightrec-<ts>-p<process>.json`` (beside the checkpoint
when the run has one, else under ``$FAKEPTA_TORCH_FLIGHTREC_DIR`` when that
is set). The dump is a ``fakepta_tpu.obs/1`` JSON-lines event log, readable
by either package's ``RunReport.load``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import List, Optional

# large enough to hold the tail of a long run (each chunk notes a handful
# of events), small enough that a dump stays a quick read
RING_SIZE = 256

# opt-in dump directory for runs without a checkpoint path
DUMP_DIR_ENV = "FAKEPTA_TORCH_FLIGHTREC_DIR"

_ring: "collections.deque" = collections.deque(maxlen=RING_SIZE)
# the dispatch thread and the writer thread may both unwind into a dump
_dump_lock = threading.Lock()


def spec_hash(meta: dict) -> str:
    """Stable short hash of a run's identity (meta minus volatile fields).

    Two runs of the same spec hash identically regardless of nreal/seed.
    """
    volatile = {"nreal", "seed", "extra_metrics"}
    stable = {k: v for k, v in sorted(meta.items()) if k not in volatile}
    blob = json.dumps(stable, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def note(name: str, **attrs) -> None:
    """Append one event ``(t_monotonic_s, name, attrs-or-None)`` to the
    ring; ``deque.append`` is atomic, so both threads record without a
    lock."""
    _ring.append((time.perf_counter(), name, attrs or None))


def snapshot() -> List[dict]:
    """The ring's contents, oldest first, as plain dicts."""
    out = []
    for t, name, attrs in list(_ring):
        ev = {"t_mono_s": round(t, 6), "name": name}
        if attrs:
            ev["attrs"] = attrs
        out.append(ev)
    return out


def clear() -> None:
    """Empty the ring."""
    _ring.clear()


def dump_dir(checkpoint=None) -> Optional[Path]:
    """Where a dump lands: the checkpoint's directory, else
    ``$FAKEPTA_TORCH_FLIGHTREC_DIR``, else None (no dump)."""
    if checkpoint is not None:
        return Path(checkpoint).resolve().parent
    env = os.environ.get(DUMP_DIR_ENV)
    return Path(env) if env else None


def dump(directory, meta: dict, chunks=None, error: str = "",
         process_index: int = 0) -> Optional[str]:
    """Write the flight-recorder artifact and return its path; None on any
    failure, so a dump never masks the exception being handled.

    The file is an event log: header (meta, spec hash, crash context), the
    chunk records completed so far, the ring's events and a summary line.
    """
    try:
        from .metrics import EventLog

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = directory / f"flightrec-{ts}-p{process_index:03d}.json"
        chunks = list(chunks or [])
        head_meta = dict(meta)
        head_meta.update({
            "flightrec": True,
            "spec_hash": spec_hash(meta),
            "crash_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "error": error[:2000],
        })
        log = EventLog(meta=head_meta)
        for c in chunks:
            log.append("chunk", **c)
        for ev in snapshot():
            log.append("event", **ev)
        summary = {"chunks_completed": len(chunks),
                   "events_recorded": len(_ring),
                   "nreal": int(meta.get("nreal", 0))}
        with _dump_lock:
            log.save(path, summary=summary)
        return str(path)
    except Exception:                                    # pragma: no cover
        return None
