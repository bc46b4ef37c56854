"""The spec surface of the serving layer, in part (port of
``fakepta_tpu.serve.spec``).

A request names *what* to simulate (a spec), *how much* of it and *whose
stream* it is; the scheduler owns executables, buckets and batching. This
slice ports the declarative :class:`ArraySpec` (a synthetic array and GWB
parameters, hashed structurally; :func:`..tune.search` and the tuner CLI
take it) and the :class:`ServeError` family. The request dataclasses
(``SimRequest``, ``OSRequest``, ``InferRequest``, ``AppendRequest``,
``StreamRequest``), ``curn_grid_spec`` and ``resolve_spec_hash`` land with
the pool and the fleet (ROADMAP Queue 1 items 11b.3 and 11b.4).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..obs import flightrec
from ..tune import defaults as tune_defaults

#: default microbatch bucket ladder, single-sourced from
#: :mod:`..tune.defaults`: geometric with ratio 2
DEFAULT_BUCKETS: Tuple[int, ...] = tune_defaults.DEFAULT_BUCKETS


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class ServeBusy(ServeError):
    """Admission rejected: the pending-request queue is at its configured
    depth (the 429 of the serving layer: back off and retry).
    ``retry_after_s`` is the scheduler's backoff hint."""

    def __init__(self, msg: str = "", retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ServeTimeout(ServeError):
    """The request's deadline expired before its cohort dispatched."""


class ServeClosed(ServeError):
    """The pool is shut down and admits no new requests."""


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Declarative synthetic-array + ensemble spec a request names.

    The JSON-facing subset of what ``PulsarBatch.synthetic``,
    ``GWBConfig`` and ``EnsembleSimulator`` accept, field for field the
    JAX package's (so one spec hashes alike in both). ``gwb_orf=''``
    disables the common signal. ``data_seed`` seeds the array geometry,
    not the realization streams.
    """

    npsr: int = 20
    ntoa: int = 156
    tspan_years: float = 15.0
    toaerr: float = 1e-7
    n_red: int = 10
    n_dm: int = 10
    data_seed: int = 0
    gwb_log10_A: float = float(np.log10(2e-15))
    gwb_gamma: float = 13.0 / 3.0
    gwb_ncomp: int = 10
    gwb_orf: str = "hd"
    nbins: int = 15

    def spec_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = "ArraySpec"
        return d

    def spec_hash(self) -> str:
        """Stable identity of this spec (the flight recorder's run
        identity hash of :meth:`spec_dict`)."""
        return flightrec.spec_hash(self.spec_dict())

    def parts(self, device=None):
        """``(batch, gwb)``: the constructor ingredients this spec
        describes (shared by :meth:`build` and :func:`..tune.search`, so
        the two stage the identical array); the batch on ``device``
        (default ``"cuda"``)."""
        from .. import spectrum as spectrum_lib
        from ..batch import PulsarBatch
        from ..parallel.montecarlo import GWBConfig

        batch = PulsarBatch.synthetic(
            npsr=self.npsr, ntoa=self.ntoa, tspan_years=self.tspan_years,
            toaerr=self.toaerr, n_red=self.n_red, n_dm=self.n_dm,
            seed=self.data_seed, device=device)
        gwb = None
        if self.gwb_orf:
            f = np.arange(1, self.gwb_ncomp + 1) / float(batch.tspan_common)
            psd = spectrum_lib.powerlaw(
                f, log10_A=self.gwb_log10_A, gamma=self.gwb_gamma).numpy()
            gwb = GWBConfig(psd=psd, orf=self.gwb_orf)
        return batch, gwb

    def build(self, mesh=None, compile_cache_dir=None, device=None):
        """Construct the :class:`..parallel.montecarlo.EnsembleSimulator`
        this spec describes, on ``mesh`` or ``device`` (default
        ``"cuda"``). ``compile_cache_dir`` is XLA's persistent compilation
        cache in the JAX package; the port has none, so anything but None
        raises."""
        from ..parallel.montecarlo import EnsembleSimulator

        if compile_cache_dir is not None:
            raise NotImplementedError(
                "compile_cache_dir is XLA's persistent compilation cache, "
                "which the port does not have (its kernels build once per "
                "checkout, ops/_build.py); pass None")
        where = mesh.local_device if mesh is not None else device
        batch, gwb = self.parts(device=where)
        return EnsembleSimulator(batch, gwb=gwb, mesh=mesh, device=device,
                                 nbins=self.nbins)
