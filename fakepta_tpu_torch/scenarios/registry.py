"""The flagship array (port of ``fakepta_tpu.scenarios.registry.flagship_batch``).

Only the flagship scenario is ported: 100 pulsars x 780 TOAs over 15 yr on a
uniform weekly cadence, white + red (30 bins) + DM (100 bins) noise. The
values below are the JAX registry's ``flagship_100`` entry (its ``Scenario``
defaults), materialized through the same uniform-cadence branch
(``PulsarBatch.synthetic``), so the batch is bit-identical to the JAX one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..batch import PulsarBatch
from ..device import DeviceLike


@dataclasses.dataclass(frozen=True)
class FlagshipSpec:
    """The ``flagship_100`` scenario fields the uniform branch reads."""

    npsr: int = 100
    ntoa: int = 780
    tspan_years: float = 15.0
    toaerr: float = 1e-7
    data_seed: int = 0
    n_red: int = 30
    n_dm: int = 100
    red_log10_A: float = -14.0
    red_gamma: float = 13.0 / 3.0
    dm_log10_A: float = -13.8
    dm_gamma: float = 3.0
    # the common signal: HD, power law at A = 2e-15, 30 bins
    gwb_log10_A: float = float(np.log10(2e-15))
    gwb_gamma: float = 13.0 / 3.0
    gwb_ncomp: int = 30


FLAGSHIP = FlagshipSpec()


def flagship_batch(dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> PulsarBatch:
    """The flagship batch on ``device`` (default ``"cuda"``)."""
    s = FLAGSHIP
    return PulsarBatch.synthetic(
        npsr=s.npsr, ntoa=s.ntoa, tspan_years=s.tspan_years,
        toaerr=s.toaerr, n_red=s.n_red, n_dm=s.n_dm,
        red_log10_A=s.red_log10_A, red_gamma=s.red_gamma,
        dm_log10_A=s.dm_log10_A, dm_gamma=s.dm_gamma,
        seed=s.data_seed, dtype=dtype, device=device)
