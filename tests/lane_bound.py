"""The float32 bound of the likelihood lanes (``run(lnlike=...)``), shared
by the port's lane tests on the CPU and on the card (no JAX import).

A float32 lnL is ``-1/2 (d0 - |L^-1 dT|^2 + ln det N + ln det B + ln det
Sigma + n ln 2 pi)``, each term a float32 sum, so each lane carries a few
float32 ULP of the sum of the terms' magnitudes, ``U = max_r sum_p d0_rp +
sum |ln sigma2| + max_k sum (|ln phi| + 2 |ln L_jj|)``, whatever the
implementation. Each lane rounds each term about once per theta point
(about one ULP of U), two independent lanes at most twice that, so
``LANE_ULPS = 4`` ULP of U (``eps32 * U``) for ``lnl``, for the theta
differences ``lnl - lnl[:, :1]`` (which cancel the theta-independent
terms, so they test ``quad`` and ``lnnorm`` alone) and, times ``2 ln 10``
(the largest ``|d ln phi / d theta|`` of the models tested), for ``grad``.
"""

import numpy as np
import torch

from fakepta_tpu_torch import infer as tinfer
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.ops import woodbury
from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
from fakepta_tpu_torch.utils import rng

EPS32 = float(np.finfo(np.float32).eps)
LANE_ULPS = 4
GRAD_PER_LNL = 2 * np.log(10.0)


def lane_unit(sim, spec, seed: int, chunk: int) -> float:
    """eps32 times U for ``sim``'s first chunk (``chunk`` realizations) at
    ``seed`` and the model and theta of ``spec``, in float64 on the CPU:
    one float32 ULP of the magnitudes the lane's float32 sums add."""
    keys = _chunk_keys(rng.key(seed, device=sim.device), 0, chunk)
    res = sim._residuals(keys).double().cpu()
    b64 = PulsarBatch.from_numpy(sim.batch.numpy(), device="cpu",
                                 dtype=torch.float64)
    w = woodbury._masked_weights(b64.sigma2, b64.mask)
    power = float((w * res ** 2).sum((-1, -2)).max())
    lndet_n = float(torch.where(b64.mask, b64.sigma2.log().abs(),
                                torch.zeros_like(b64.sigma2)).sum())
    compiled = tinfer.build(spec.model, b64)
    M = woodbury.finish_fixed(woodbury.fixed_parts(
        compiled.basis(b64), b64.sigma2, b64.mask))[0]
    norm = 0.0
    for t in np.atleast_2d(spec.theta):
        phi = compiled.phi(torch.as_tensor(t), b64)
        chol, _ = woodbury.lnlike_factors(M, phi)
        diag = torch.diagonal(chol, dim1=-2, dim2=-1)
        phi = torch.clamp(phi, min=woodbury._phi_floor(phi.dtype))
        norm = max(norm, float(phi.log().abs().sum()
                               + 2 * diag.log().abs().sum()))
    return EPS32 * (power + lndet_n + norm)


def assert_lanes(got, want, unit, keys=("lnl",), what=""):
    """``got`` lanes within LANE_ULPS * ``unit`` of ``want``'s (``grad``
    times 2 ln 10), their theta differences too."""
    bound = LANE_ULPS * unit
    for k in keys:
        scale = GRAD_PER_LNL if k == "grad" else 1.0
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=bound * scale, err_msg=f"{what} {k}")
    g, w = got["lnl"], want["lnl"]
    np.testing.assert_allclose(g - g[:, :1], w - w[:, :1], rtol=0,
                               atol=bound, err_msg=f"{what} theta diffs")
