"""fakepta_tpu_torch.detect: detection statistics as an engine lane.

Port of :mod:`fakepta_tpu.detect`. The per-realization optimal statistic
(amp2, SNR, sigma) is computed on the device from the raw pair sums, as
extra weight slots of the chunk's statistic contraction or kernel launch,
and packed beside the curves, so a detection study never fetches an
(R, P, P) correlation tensor and keeps every kernel path.

- :mod:`operators`: host-f64 precompute: ORF templates, valid-pair TOA
  counts, noise weighting from the batch's white variances.
- the device lane: ``EnsembleSimulator.run(os=...)`` (an ORF name, a
  sequence, or an :class:`OSSpec`), with the paired noise-only stream for
  on-device null calibration (``OSSpec(null=True)``).
- :class:`DetectionRun`: the host facade: one call runs a null-calibrated
  study and saves a schema-versioned summary artifact.
- :class:`StreamingOS` (:mod:`streaming`): the rolling per-append
  statistic over a stream's Woodbury moments (:mod:`..stream`).
- CLI: ``python -m fakepta_tpu_torch.detect run ...``.
"""

from .operators import (DETECT_SCHEMA, OSOperator, OSSpec, as_spec,
                        assemble, build_operators, pair_weighting,
                        pulsar_noise_levels)
from .run import DetectionRun
from .streaming import StreamingOS

__all__ = [
    "DETECT_SCHEMA", "DetectionRun", "OSOperator", "OSSpec", "StreamingOS",
    "as_spec", "assemble", "build_operators", "pair_weighting",
    "pulsar_noise_levels",
]
