"""Request and spec surface of the serving layer (port of
``fakepta_tpu.serve.spec``).

A request names *what* to simulate (a spec), *how much* of it
(``n`` realizations) and *whose stream* it is (``seed``): nothing about
kernels, buckets or batching. The scheduler owns those: requests with the
same ``(spec_hash, lane token)`` coalesce into one padded chunk dispatch,
and each request's results come from its own RNG lane (``fold_in(key(seed),
i)``), so a response equals ``EnsembleSimulator.run(n, seed=seed)``
however it was batched.

Specs come in two forms: a declarative :class:`ArraySpec` (a synthetic
array and GWB parameters, hashed structurally, field for field the JAX
package's, so one spec hashes alike in both), or a name registered on the
pool with a prebuilt simulator. Both resolve to a stable ``spec_hash``
through :func:`..obs.flightrec.spec_hash`.

The stream-affine kinds (:class:`AppendRequest`, :class:`StreamRequest`)
are defined here, field for field the JAX package's; the pool serves
them through its :class:`.streams.StreamManager`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

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

        no_compile_cache(compile_cache_dir)
        where = mesh.local_device if mesh is not None else device
        batch, gwb = self.parts(device=where)
        return EnsembleSimulator(batch, gwb=gwb, mesh=mesh, device=device,
                                 nbins=self.nbins)


def no_compile_cache(compile_cache_dir) -> None:
    """``compile_cache_dir`` is XLA's persistent compilation cache in the
    JAX package; the port's counterpart is the kernel build directory
    every process of a checkout shares, so only ``None`` is accepted."""
    if compile_cache_dir is not None:
        raise NotImplementedError(
            "compile_cache_dir is XLA's persistent compilation cache, which "
            "the port does not have: its kernels build once per checkout "
            "into the build directory every process shares (ops/_build.py, "
            "FAKEPTA_TORCH_BUILD_DIR); pass None")


SpecLike = Union[str, ArraySpec]


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One user's simulation request: ``n`` realizations of ``spec`` drawn
    from the request's own RNG lane (``seed``). ``deadline_s`` is relative
    to submission; an expired request is cancelled *before* dispatch with
    :class:`ServeTimeout` (dispatched work always completes). ``trace_id``
    is the request's trace identity, carried through coalescing and
    dispatch (None: untraced)."""

    spec: SpecLike
    n: int
    seed: int = 0
    deadline_s: Optional[float] = None
    trace_id: Optional[str] = None

    kind = "sim"

    def lane_token(self):
        """Hashable lane identity: requests coalesce only when their
        (spec, lane token) match (one packed-extras layout per cohort)."""
        return ("sim",)

    def run_kwargs(self) -> dict:
        """The ``EnsembleSimulator.run`` / ``warm_start`` lane kwargs."""
        return {}


@dataclasses.dataclass(frozen=True)
class OSRequest(SimRequest):
    """A detection request: the optimal-statistic lane rides the cohort's
    chunk; per-request ``amp2`` / ``snr`` (and, with ``null=True``, the
    request's own paired-null calibration) come from the request's slice
    alone, so results are cohort-independent."""

    orf: Union[str, Sequence[str]] = "hd"
    weighting: str = "noise"
    null: bool = False

    kind = "os"

    def os_spec(self):
        from ..detect import operators as detect_ops
        orf = self.orf if isinstance(self.orf, str) else tuple(self.orf)
        return detect_ops.as_spec(detect_ops.OSSpec(
            orf=orf, weighting=self.weighting, null=bool(self.null)))

    def lane_token(self):
        spec = self.os_spec()
        return ("os", spec.orfs, spec.weighting, bool(spec.null))

    def run_kwargs(self) -> dict:
        return {"os": self.os_spec()}


@dataclasses.dataclass(frozen=True)
class InferRequest(SimRequest):
    """A likelihood request: the GP-marginalized Woodbury lnL lane
    (:mod:`..infer`) at the request's theta grid for each of its
    realizations. ``lnlike`` is an :class:`..infer.InferSpec`; requests
    sharing (spec, model, mode, theta) coalesce."""

    lnlike: object = None

    kind = "infer"

    def lane_token(self):
        if self.lnlike is None:
            raise ValueError("InferRequest needs an InferSpec (lnlike=...)")
        theta = np.asarray(self.lnlike.theta)
        return ("infer", self.lnlike.model, self.lnlike.mode,
                theta.shape, theta.tobytes())

    def run_kwargs(self) -> dict:
        return {"lnlike": self.lnlike}


@dataclasses.dataclass(frozen=True)
class AppendRequest:
    """Streaming ingestion: append a TOA block to the named stream. The
    first touch of a ``stream`` name carries a ``spec`` (the stream's
    frozen-grid template); ``ecorr_dt`` / ``watch`` / ``checkpoint`` are
    open-time options. ``toas`` / ``residuals`` are (P, B) absolute
    seconds / seconds; ``counts`` marks the valid prefix per pulsar.
    Stream-affine: a fleet routes it by stream name; the pool's
    :class:`.streams.StreamManager` executes it."""

    stream: str = ""
    toas: object = None
    residuals: object = None
    spec: Optional[SpecLike] = None
    sigma2: object = None
    freqs: object = None
    ecorr_amp: object = None
    counts: object = None
    ecorr_dt: Optional[float] = None
    watch: Optional[str] = None
    checkpoint: Optional[str] = None
    deadline_s: Optional[float] = None
    trace_id: Optional[str] = None

    kind = "append"
    stream_affine = True

    def affinity_key(self) -> str:
        """The fleet routing identity: the stream NAME."""
        return f"stream:{self.stream}"


@dataclasses.dataclass(frozen=True)
class StreamRequest:
    """Read the named stream's rolling state (``StreamState.stats()``);
    affine like :class:`AppendRequest`."""

    stream: str = ""
    deadline_s: Optional[float] = None
    trace_id: Optional[str] = None

    kind = "stream"
    stream_affine = True

    def affinity_key(self) -> str:
        return f"stream:{self.stream}"


def curn_grid_spec(k: int = 4, log10_A=(-15.2, -14.2), gamma=(3.0, 6.0),
                   nbin: int = 10):
    """A small CURN (log10_A, gamma) grid InferSpec: the JSON-expressible
    likelihood request (the protocol's ``"grid"`` form)."""
    from ..infer import (ComponentSpec, FreeParam, InferSpec, LikelihoodSpec,
                         theta_grid)

    model = LikelihoodSpec(components=(
        ComponentSpec(target="red", spectrum="batch"),
        ComponentSpec(target="dm", spectrum="batch"),
        ComponentSpec(target="curn", nbin=nbin, free=(
            FreeParam("log10_A", tuple(log10_A)),
            FreeParam("gamma", tuple(gamma)))),
    ))
    return InferSpec(model=model, theta=theta_grid(model, k))


def resolve_spec_hash(spec: SpecLike, named: dict) -> str:
    """spec -> stable hash; named registrations resolve through ``named``."""
    if isinstance(spec, str):
        if spec not in named:
            raise ServeError(f"unknown registered spec {spec!r}; "
                             f"known: {sorted(named)}")
        return named[spec]
    if isinstance(spec, ArraySpec):
        return spec.spec_hash()
    raise TypeError(f"request spec must be a registered name or an "
                    f"ArraySpec, got {type(spec).__name__}")
