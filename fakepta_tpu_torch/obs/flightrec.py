"""Run identity (port of ``fakepta_tpu.obs.flightrec.spec_hash``).

Only :func:`spec_hash` is ported: the scenario registry's identity rides
on it, and it must equal the JAX package's hash for the same spec (serve,
tune and checkpoint artifacts group by it). The flight recorder's event
ring and crash dumps come with the run report.
"""

from __future__ import annotations

import hashlib
import json


def spec_hash(meta: dict) -> str:
    """Stable short hash of a run's identity (meta minus volatile fields).

    Two runs of the same spec hash identically regardless of nreal/seed.
    """
    volatile = {"nreal", "seed", "extra_metrics"}
    stable = {k: v for k, v in sorted(meta.items()) if k not in volatile}
    blob = json.dumps(stable, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]
