"""StreamManager: the pool-side executor for stream-affine requests (port
of ``fakepta_tpu.serve.streams``).

Stream requests never enter the microbatch scheduler: there is nothing to
coalesce (an append mutates ONE stream's accumulated moments, in order)
and nothing to bucket at the cohort level (the stream buckets its own
append blocks on the :mod:`..tune.defaults` ladder).
:meth:`ServePool.submit` intercepts ``stream_affine`` requests before
admission and hands them here; execution is synchronous on the submitter's
thread under a per-stream lock, so appends to one stream serialize (the
additive-update order IS the stream's history) while distinct streams
proceed concurrently.

Sessions are opened lazily by the first :class:`~.spec.AppendRequest`
naming a stream: its ``spec``'s synthetic array becomes the frozen-grid
template, and ``ecorr_dt`` / ``watch`` / ``checkpoint`` are open-time
options (a later request repeating them is flight-recorded and ignored:
the grid contract forbids reconfiguring a live stream). With a
``checkpoint`` path the open REPLAYS any consistent on-disk blocks, which
is how a fleet failover resumes a stream on a sibling replica.

The streams run on the pool's device (``device``) or on ``mesh``; the
template's grids are staged from the host (``spec.parts(device="cpu")``).
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from .. import faults
from ..device import DeviceLike
from ..obs import flightrec, metrics
from ..obs.timing import now
from ..tune import defaults as tune_defaults
from .spec import ArraySpec, ServeError

#: payload schema tag for stream responses (versioned apart from the
#: on-disk STREAM_SCHEMA: the wire payload is a serve-layer contract)
STREAM_PAYLOAD_SCHEMA = "fakepta_tpu.serve-stream/1"


class _StreamSlot:
    """One registered stream: its per-stream lock plus the CURRENT state.

    ``state`` is only read or replaced while holding ``lock``: that is the
    migration-cutover fence. An appender that was waiting on the lock
    while :meth:`StreamManager.cutover` swapped the state lands its block
    on the NEW template, never on the retired one (zero dropped
    appends)."""

    __slots__ = ("lock", "state")

    def __init__(self, state):
        self.lock = threading.Lock()
        self.state = state


class StreamManager:
    """Named :class:`..stream.StreamState` sessions for one pool, on
    ``mesh`` or ``device`` (default ``"cuda"``)."""

    def __init__(self, mesh=None, device: DeviceLike = None):
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.mesh = mesh
        self.device = device
        self._lock = threading.Lock()
        self._streams: dict = {}      # name -> _StreamSlot
        # per-stream append-latency rings (telemetry plane), bounded like
        # every other telemetry buffer, read by summary()
        self._append_ms: dict = collections.defaultdict(
            lambda: collections.deque(
                maxlen=tune_defaults.TELEMETRY_RING_SIZE))

    def _place(self) -> dict:
        return ({"mesh": self.mesh} if self.mesh is not None
                else {"device": self.device})

    def _session(self, req) -> "_StreamSlot":
        """The :class:`_StreamSlot` for ``req.stream``, opening it when
        the request carries a spec.

        Two-phase open: the registry lock is held only for the dict
        lookups. :class:`StreamState` construction (device allocation,
        checkpoint REPLAY, seconds of work) happens with no manager lock
        held, so appends to every other stream keep flowing while one
        stream opens. A racing open of the same name keeps the first
        registered state and discards the loser (replay is read-only)."""
        name = str(req.stream)
        if not name:
            raise ServeError("stream requests need a non-empty stream name")
        with self._lock:
            entry = self._streams.get(name)
        if entry is not None:
            if getattr(req, "spec", None) is not None:
                flightrec.note("serve_stream_reopen_ignored", stream=name)
            return entry
        spec = getattr(req, "spec", None)
        if spec is None:
            raise ServeError(
                f"stream {name!r} is not open; the first append must "
                f"carry a spec (its array is the frozen-grid template)")
        if not isinstance(spec, ArraySpec):
            raise ServeError("stream templates must be declarative "
                             "ArraySpecs (named simulator registrations "
                             "have no batch to pin a grid from)")
        from .. import stream as stream_pkg

        template, _gwb = spec.parts(device="cpu")
        state = stream_pkg.StreamState(template, ecorr_dt=req.ecorr_dt,
                                       watch=req.watch,
                                       checkpoint=req.checkpoint,
                                       **self._place())
        entry = _StreamSlot(state)
        with self._lock:
            raced = self._streams.get(name)
            if raced is not None:
                entry = None
            else:
                self._streams[name] = entry
        if entry is None:
            flightrec.note("serve_stream_open_race", stream=name)
            return raced
        flightrec.note("serve_stream_open", stream=name, npsr=state.npsr,
                       replayed=int(state.appends),
                       rolled_back=int(state.rolled_back))
        return entry

    def handle(self, req) -> dict:
        """Execute one stream-affine request; returns the wire payload."""
        slot = self._session(req)
        name = str(req.stream)
        if req.kind == "append":
            if req.toas is None or req.residuals is None:
                raise ServeError("append needs toas and residuals")
            t0 = now()
            with slot.lock:
                # the state is re-read UNDER the lock: a cutover that
                # swapped the slot while this append queued lands it on
                # the new state
                info = slot.state.append(req.toas, req.residuals,
                                         sigma2=req.sigma2,
                                         freqs=req.freqs,
                                         ecorr_amp=req.ecorr_amp,
                                         counts=req.counts)
            dt = now() - t0
            metrics.observe("serve.append_latency_s", dt)
            with self._lock:
                self._append_ms[name].append(dt * 1e3)
            return dict(info, kind="append", stream=name,
                        payload_schema=STREAM_PAYLOAD_SCHEMA)
        if req.kind == "stream":
            with slot.lock:
                stats = slot.state.stats()
            return dict(stats, kind="stream", stream=name,
                        payload_schema=STREAM_PAYLOAD_SCHEMA)
        raise ServeError(f"unknown stream request kind {req.kind!r}")

    # ------------------------------------------------------------------
    # migration cutover
    # ------------------------------------------------------------------
    def cutover(self, name: str, spec, *, checkpoint=None,
                rtol=None) -> dict:
        """Re-stage one stream onto a wider frozen-grid template behind a
        checkpoint fence and swap atomically: zero dropped appends.

        1. the NEW :class:`..stream.StreamState` is built outside any lock;
        2. the per-stream lock is taken: the **fence**. Appends that
           already hold it finish on the old state; later ones queue;
        3. the old state's raw store (absolute TOAs) replays onto the new
           template as one bulk append;
        4. the swap is refused unless the TOA count is conserved AND the
           append/restage oracle holds on the new state (its accumulated
           moments match a fresh restage within ``rtol``); on refusal the
           old state stays installed, untouched;
        5. the slot's state swaps; queued appends land on the new
           template. ``gateway.cutover`` fault-site checks fire before the
           restage and before the swap.
        """
        name = str(name)
        with self._lock:
            slot = self._streams.get(name)
        if slot is None:
            raise ServeError(f"stream {name!r} is not open; nothing to "
                             f"cut over")
        if not isinstance(spec, ArraySpec):
            raise ServeError("cutover templates must be declarative "
                             "ArraySpecs")
        if rtol is None:
            rtol = tune_defaults.GATEWAY_CUTOVER_RTOL
        from .. import stream as stream_pkg

        t0 = now()
        template, _gwb = spec.parts(device="cpu")
        peek = slot.state          # open-time options carry over
        fresh = stream_pkg.StreamState(template, ecorr_dt=peek.ecorr_dt,
                                       watch=peek._watch_orf,
                                       checkpoint=checkpoint,
                                       **self._place())
        with slot.lock:            # -- the fence: appends queue here
            old = slot.state
            faults.check("gateway.cutover", stream=name, stage="restage")
            raw = old.raw_data()
            n_before = int(raw["counts"].sum())
            if n_before:
                kwargs = dict(sigma2=raw["sigma2"], freqs=raw["freqs"],
                              counts=raw["counts"])
                if old.ecorr_dt is not None:
                    kwargs["ecorr_amp"] = raw["ecorr"]
                fresh.append(raw["t"], raw["r"], **kwargs)
            n_after = int(fresh._n.sum())
            if n_after != n_before:
                flightrec.note("gateway_cutover_abort", stream=name,
                               reason="toa_conservation",
                               before=n_before, after=n_after)
                raise ServeError(
                    f"cutover of {name!r} aborted: restage carried "
                    f"{n_after} TOAs, expected {n_before}; old state "
                    f"stays installed")
            got = [_host(x) for x in fresh.moments()]
            want = [_host(x) for x in fresh.restage_moments()]
            for g, w in zip(got, want):
                if not np.allclose(g, w, rtol=rtol, atol=1e-12):
                    flightrec.note("gateway_cutover_abort", stream=name,
                                   reason="oracle",
                                   max_rel=float(np.max(np.abs(g - w))))
                    raise ServeError(
                        f"cutover of {name!r} aborted: append/restage "
                        f"oracle failed on the new template; old state "
                        f"stays installed")
            faults.check("gateway.cutover", stream=name, stage="swap")
            slot.state = fresh     # -- the atomic swap
        info = {"stream": name, "toas": n_after,
                "appends_replayed": int(old.appends),
                "old_tspan_s": float(old.tspan),
                "new_tspan_s": float(fresh.tspan),
                "new_capacity": int(fresh._cap),
                "cutover_ms": round((now() - t0) * 1e3, 3)}
        flightrec.note("gateway_cutover", **info)
        return info

    def stream_names(self):
        with self._lock:
            return sorted(self._streams)

    def summary(self) -> dict:
        """Per-stream telemetry: append totals and windowed latencies (the
        ``streams`` source of the pool's TelemetryPublisher and of the
        ``stats`` protocol reply)."""
        with self._lock:
            entries = list(self._streams.items())
            lat = {name: list(ring)
                   for name, ring in self._append_ms.items()}
        out = {}
        for name, slot in entries:
            state = slot.state
            ms = lat.get(name, [])
            row = {"appends": int(state.appends),
                   "toas": int(state._n.sum()),
                   "rebuckets": int(state.rebuckets)}
            if ms:
                row["append_mean_ms"] = round(sum(ms) / len(ms), 4)
                row["append_last_ms"] = round(ms[-1], 4)
            out[name] = row
        return out

    def close(self) -> None:
        with self._lock:
            self._streams.clear()


def _host(x) -> np.ndarray:
    """A moment array (torch tensor on any device, or numpy) on the
    host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
