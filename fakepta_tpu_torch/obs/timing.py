"""Stage spans and device-synced timing (port of ``fakepta_tpu.obs.timing``).

``span(name)`` names a stage: it records the name to the active
:mod:`.metrics` collector and, while ``torch.profiler`` traces, marks the
host timeline (``torch.profiler.record_function``), where the stage's
kernels appear under it. The engine enters spans once per chunk, outside
every kernel.

``Timer`` synchronizes the device of whatever tensor the timed block hands
to ``set_result``, so the recorded time covers its execution, not only the
enqueue; the time is recorded in a ``finally``, so a block that raises
still leaves its measurement.

The JAX package's ``trace`` (a profiler capture context) waits for the rest
of ``obs/`` (ROADMAP Queue 1 item 11); ``chip_smoke.py --phases profile``
traces with ``torch.profiler`` directly.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from . import metrics


def now() -> float:
    """The package's monotonic clock read, in seconds."""
    return time.perf_counter()


@contextlib.contextmanager
def span(name: str):
    """Record the stage ``name`` to the active collector and, under
    ``torch.profiler``, to the host timeline."""
    metrics.record_span(name)
    with torch.profiler.record_function(name):
        yield


def _sync(x) -> None:
    """Wait for the device work that produced ``x`` (tensors, or tuples /
    lists / dicts of them); a host tensor needs no wait."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


@dataclass
class Timer:
    """Accumulating wall-clock timer with device-sync semantics."""

    times: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        holder = {}

        def set_result(x):
            holder["out"] = x
            return x

        t0 = now()
        try:
            yield set_result
        finally:
            if "out" in holder:
                _sync(holder["out"])
            elapsed = now() - t0
            self.times.setdefault(name, []).append(elapsed)
            metrics.observe(f"timer.{name}", elapsed)

    def summary(self) -> Dict[str, dict]:
        return {name: {"n": len(ts), "total_s": sum(ts),
                       "mean_s": sum(ts) / len(ts)}
                for name, ts in self.times.items() if ts}
