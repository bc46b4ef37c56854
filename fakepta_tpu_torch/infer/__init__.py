"""fakepta_tpu_torch.infer: the batched GP-marginalized likelihood as an
engine lane (port of fakepta_tpu.infer).

The GP-marginalized PTA log-likelihood (van Haasteren & Vallisneri's
Woodbury formulation, arXiv:1407.1838) is computed inside each chunk for a
K-point hyperparameter batch against every realization, with exact
gradient and Hessian lanes, and packed beside the curves and autos: no
residual fetch, no host round trip.

- :mod:`..ops.woodbury`: the linear-algebra layer (masked white and ECORR
  inner products, moment assembly, Cholesky-only factorizations).
- :mod:`model`: :class:`LikelihoodSpec`, a declarative model compiled
  against a batch on the registered spectra and the engine's bases.
- the device lane: ``EnsembleSimulator.run(lnlike=InferSpec(...))`` on
  every statistic path, psr mesh and toa cell; its gradient and Hessian
  lanes are forward-mode (``torch.func.jacfwd``) over the D parameters.
- :mod:`reconstruct`: the batched conditional-mean (Wiener) GP
  reconstruction.
- :class:`InferenceRun`, the host facade, and its CLI ``python -m
  fakepta_tpu_torch.infer run ...``; :mod:`schema`, the JSON wire form of
  an InferSpec (the JAX package's).
"""

from .model import (BATCH_SPECTRUM, INFER_SCHEMA, ComponentSpec,
                    CompiledLikelihood, FreeParam, InferSpec,
                    LikelihoodSpec, as_spec, assemble, box_from_unconstrained,
                    box_log_prior, box_to_unconstrained,
                    box_unconstrained_log_prior,
                    box_unconstrained_log_prior_grad, build, lanes_per_point,
                    theta_grid)
from .reconstruct import wiener_coefficients, wiener_reconstruct
from .run import InferenceRun
from .schema import (SPEC_SCHEMA, model_from_json, model_to_json,
                     spec_from_json, spec_to_json)

__all__ = [
    "BATCH_SPECTRUM", "INFER_SCHEMA", "SPEC_SCHEMA", "ComponentSpec",
    "CompiledLikelihood", "FreeParam", "InferSpec", "InferenceRun",
    "LikelihoodSpec", "as_spec", "assemble", "box_from_unconstrained",
    "box_log_prior", "box_to_unconstrained", "box_unconstrained_log_prior",
    "box_unconstrained_log_prior_grad", "build", "lanes_per_point",
    "model_from_json", "model_to_json", "spec_from_json", "spec_to_json",
    "theta_grid", "wiener_coefficients", "wiener_reconstruct",
]
