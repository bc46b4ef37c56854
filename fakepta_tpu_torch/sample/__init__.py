"""Batched MCMC on the card as an engine lane (port of
``fakepta_tpu.sample``).

Gradient-informed HMC chains times parallel-tempering rungs over the
Woodbury PTA likelihood of :mod:`..infer`, warm-started and whitened by a
Laplace fit, chains sharded over the mesh's ``'real'`` entries and the
per-pulsar likelihood over its ``'psr'`` entries, swaps as on-device
permutations, R-hat / ESS / acceptance accumulated on the device and
drained through the pipeline's writer thread.

- :mod:`..ops.mcmc`: the batched transition kernels (leapfrog / HMC over a
  (chains, temps, D) tensor, replica-exchange permutations, the geometric
  beta ladder);
- :mod:`.model`: :class:`SampleSpec` and the host diagnostics finishers;
- :class:`SamplingRun`: data -> Woodbury moments -> Laplace warm start ->
  the segment loop, emitting a ``fakepta_tpu.sample/1`` artifact; CLI:
  ``python -m fakepta_tpu_torch.sample run``;
- :mod:`.factorized`: the per-frequency factorized free-spectrum driver
  (:class:`FactorizedRun`, :func:`factorized_oracle`). The JAX package's
  ``run_factorized_sessions`` routes lanes over its serve fleet and waits
  for that module (ROADMAP Queue 1 item 11b).
"""

from .factorized import (FactorizedRun, FactorizedSpec, LanePlan,
                         factor_plan, factorized_oracle, lane_seed,
                         lane_spans, marginalize_for_lanes,
                         marginalize_nuisance_np, marginalized_window_moments,
                         nuisance_phi_np, recombine_draws)
from .model import SAMPLE_SCHEMA, SampleSpec, as_spec, diagnostics
from .run import SampleCheckpoint, SamplingRun

__all__ = ["FactorizedRun", "FactorizedSpec", "LanePlan", "SAMPLE_SCHEMA",
           "SampleCheckpoint", "SampleSpec", "SamplingRun", "as_spec",
           "diagnostics", "factor_plan", "factorized_oracle", "lane_seed",
           "lane_spans", "marginalize_for_lanes", "marginalize_nuisance_np",
           "marginalized_window_moments", "nuisance_phi_np",
           "recombine_draws"]
