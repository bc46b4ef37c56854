"""fakepta_tpu_torch.tune: the platform-aware autotuner for the dispatch
surface (port of ``fakepta_tpu.tune``).

- :func:`fingerprint`: the platform identity every tuned knob is keyed on
  (the card's name and memory, device and process counts, torch and CUDA
  versions);
- :func:`search`: model-first pruning over the knob space (the analytic
  byte and residency models, :mod:`.model`) followed by short measured
  probes through ``run(tuned=...)``, wall-clock-budgeted;
- :class:`TuneStore` / :class:`TunedConfig`: the persisted result, a
  schema-versioned JSON file keyed fingerprint x spec family, consumed by
  ``EnsembleSimulator.run(tuned=True)`` and ``SamplingRun.run(tuned=True)``;
- ``python -m fakepta_tpu_torch.tune search|show|apply``: the CLI, writing
  ``fakepta_tpu.tune/1`` artifacts.
"""

from . import defaults  # noqa: F401
from .fingerprint import Fingerprint, family_hash, fingerprint  # noqa: F401
from .model import (Candidate, bucket_ladder,  # noqa: F401
                    candidate_frontier, default_candidate,
                    overshoot_factor)
from .search import (family_for_surface, resolve_buckets,  # noqa: F401
                     resolve_for_sim, resolve_platform_knob, search)
from .store import (TunedConfig, TuneStore,  # noqa: F401
                    default_store_path)

__all__ = [
    "Fingerprint", "fingerprint", "family_hash", "family_for_surface",
    "Candidate", "candidate_frontier", "default_candidate",
    "bucket_ladder", "overshoot_factor", "TunedConfig", "TuneStore",
    "default_store_path", "search", "resolve_for_sim",
    "resolve_platform_knob", "resolve_buckets", "defaults",
]
