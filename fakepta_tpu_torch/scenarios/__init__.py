"""IPTA-scale scenario registry + golden-run suite (port of
fakepta_tpu.scenarios).

- :mod:`.registry`: declarative, hashable :class:`Scenario` specs with
  named entries (``flagship_100``, ``ng15``, ``ipta_dr3``, ``ska_10k``),
  each materializing through the ordinary ``EnsembleSimulator`` /
  ``ArraySpec`` path, on the card unless the CPU is asked for.
- :mod:`.cadence`: telescope-cadence arrival processes (duty cycles,
  maintenance gaps, uneven multi-backend sampling) generating TOA epochs
  and timed ``AppendRequest`` schedules.
- :mod:`.golden`: the golden-run harness: every scenario emits a full
  bench-schema row (``scenario`` + ``scn_*`` keys) banded by ``obs gate``,
  plus the psr-sharded memory-scaling lane (cards only).

CLI: ``python -m fakepta_tpu_torch.scenarios list|describe|run``.
"""

from .registry import SCENARIOS, Scenario, get, names, register

__all__ = ["SCENARIOS", "Scenario", "get", "names", "register"]
