"""The streaming lane's A/B recipe: incremental append against full
restage (port of ``fakepta_tpu.stream.bench``).

One function stages a stream with bulk history, then measures a
single-epoch append against a full restage of the same accumulated store
on the SAME kernels (``restage`` reuses the append kernel at the store's
capacity rung, so the A/B is pure O(new-epoch) against O(history) work).
Timing rides the obs clock (:func:`..obs.timing.now`), every figure to a
device synchronize; the first append at each rung and the first restage
are warm-up, and the recorded figures are best-of-``repeats``.

Row metrics: ``append_latency_ms`` (lower-better), ``restage_ms`` (the
baseline side), ``append_speedup_x`` = restage/append (higher-better),
``stream_rebuckets`` (a shape fact) and ``stream_recompiles`` (JAX's
zero-expected canary, kept for parity: 0 by construction in the port,
whose kernel cache never rebuilds a key; :mod:`.state`).
:func:`config_blocks` makes the recipe's blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const
from ..batch import PulsarBatch
from ..device import DeviceLike
from ..obs.timing import now
from .state import StreamState, default_stream_model


def config_blocks(*, npsr: int, tspan_years: float, history: int,
                  epoch_width: int, epochs: int = 4, ecorr: bool = True,
                  seed: int = 0) -> list:
    """The A/B recipe's blocks, in append order: ``history`` TOAs a
    pulsar of bulk history in two halves (0-45% and 45-90% of the span,
    which exercises a mid-stream epoch extension), one warm-up epoch over
    90-97% of the span, then ``epochs - 1`` epochs over 97-100%, each
    ``epoch_width`` TOAs wide. Each block is the keyword arguments of
    :meth:`StreamState.append`: sorted absolute TOAs ``toas``, residuals
    ``residuals`` and, with ``ecorr``, ECORR amplitudes ``ecorr_amp``
    (host float64, the JAX recipe's draws in its order)."""
    rng = np.random.default_rng(seed + 1)
    tspan = tspan_years * const.yr
    half = history // 2
    spans = [(0.0, 0.45, half), (0.45, 0.9, history - half),
             (0.90, 0.97, epoch_width)]
    spans += [(0.97, 1.0, epoch_width)] * (epochs - 1)
    out = []
    for lo, hi, width in spans:
        blk = {"toas": np.sort(rng.uniform(lo * tspan, hi * tspan,
                                           (npsr, width)), axis=1)}
        if ecorr:
            blk["ecorr_amp"] = np.abs(rng.normal(3e-7, 1e-7,
                                                 (npsr, width)))
        blk["residuals"] = rng.normal(0.0, 1e-7, (npsr, width))
        out.append(blk)
    return out


def run_append_ab(*, npsr: int = 16, ntoa: int = 260,
                  tspan_years: float = 15.0, n_red: int = 10,
                  n_dm: int = 10, nbin: int = 10, history: int = 512,
                  epoch_width: int = 8, ecorr_dt=None, mesh=None,
                  device: DeviceLike = None, repeats: int = 3,
                  seed: int = 0) -> dict:
    """Stage ``history`` TOAs/pulsar of bulk history, then A/B one
    ``epoch_width``-TOA append against a full restage, on ``device``
    (default ``"cuda"``) or ``mesh``. Returns the bench row fragment
    (module docstring)."""
    template = PulsarBatch.synthetic(npsr=npsr, ntoa=ntoa,
                                     tspan_years=tspan_years, n_red=n_red,
                                     n_dm=n_dm, seed=seed,
                                     dtype=torch.float64, device="cpu")
    stream = StreamState(template, default_stream_model(nbin=nbin),
                         ecorr_dt=ecorr_dt, mesh=mesh, device=device)
    blocks = config_blocks(npsr=npsr, tspan_years=tspan_years,
                           history=history, epoch_width=epoch_width,
                           epochs=1 + repeats, ecorr=ecorr_dt is not None,
                           seed=seed)
    # the history and the warm-up epoch, which builds the steady-state
    # kernel at the final (block bucket, epoch capacity) pair
    for blk in blocks[:3]:
        stream.append(**blk)
    append_ms = min(stream.append(**blk)["latency_ms"] for blk in blocks[3:])

    stream.restage()                       # warm-up: the restage kernel
    restage_ms = float("inf")
    for _ in range(repeats):
        t0 = now()
        stream.restage()
        restage_ms = min(restage_ms, (now() - t0) * 1e3)
    restage_ms = round(restage_ms, 3)

    return {
        "append_latency_ms": append_ms,
        "restage_ms": restage_ms,
        "append_speedup_x": round(restage_ms / max(append_ms, 1e-9), 2),
        "stream_appends": int(stream.appends),
        "stream_toas": int(stream._n.sum()),
        "stream_rebuckets": int(stream.rebuckets),
        "stream_recompiles": int(stream.recompiles),
    }
