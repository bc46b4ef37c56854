"""The Gateway: multi-tenant front door over a ServeFleet (port of
``fakepta_tpu.gateway.core``).

One request's path through the tier:

1. **authenticate**: bearer token -> :class:`.tenants.Tenant`
   (constant-time compare; ``gateway.auth_failures`` otherwise);
2. **admit**: weighted fair-share check over in-flight slots; a tenant
   past its share (or a full gateway) gets :class:`.tenants.GatewayBusy`
   with a *per-tenant* ``retry_after_s`` so one hot tenant's backlog never
   inflates another's retry hints (the ``gateway.admit`` fault site fires
   before any state moves);
3. **result store**: content-addressed lookup keyed
   ``spec_hash x lane token x (seed, n) x engine fingerprint``
   (:mod:`.store`); a hit is served with zero device-seconds and the
   producing run's ``service_s`` credited to ``device_s_saved``;
4. **single-flight**: identical concurrent requests coalesce onto one
   fleet dispatch and fan the same response out (sound because the serve
   layer's RNG-lane contract makes the response bit-identical to every
   requester's solo run at its bucket); the table is LRU-bounded: at
   capacity new keys *bypass* coalescing (``gateway.coalesce_bypass``)
   rather than grow it;
5. **dispatch**: everything else forwards to ``fleet.submit`` unchanged
   (trace ids ride the request object, so flight-recorder flows stay
   continuous through the gateway hop); a fleet-level
   :class:`..serve.ServeBusy` is re-raised as a per-tenant 429.

Completion callbacks resolve futures OUTSIDE the admission lock:
``Gateway._lock`` is first in the lock order and is never held across a
fleet, store, or future call. Stream-affine and named-spec requests are
forwarded without caching or coalescing: appends mutate state and names
are resolved by the owning pool, so neither is content-addressable here.

Kept divergences from the JAX gateway:

- the default fingerprint is that of the devices the fleet's replicas
  serve on (:func:`fleet_fingerprint`; a CPU fleet's is ``'cpu'``), where
  the JAX gateway fingerprints every visible device;
- a dispatch that ``fleet.submit`` refuses with any error, not only
  :class:`..serve.ServeBusy`, aborts its single-flight entry, so the
  followers attached to it fail with the leader instead of waiting on a
  flight that was never dispatched.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Optional, Sequence, Union

import numpy as np

from .. import faults
from ..obs import flightrec, metrics
from ..obs.timing import now
from ..serve.scheduler import ServeResult
from ..serve.spec import ArraySpec, ServeBusy
from ..tune import defaults as tune_defaults
from ..tune.fingerprint import Fingerprint, fingerprint
from .store import ResultStore, request_key
from .tenants import GatewayBusy, Tenant, TenantTable


def _device_entries(target) -> list:
    """The device entries ``target`` serves on: a pool's mesh entries, a
    LocalReplica's pool's, a fleet's replicas' (a socket replica's device
    names); empty when it names none."""
    from ..tune.search import mesh_entries

    mesh = getattr(target, "mesh", None)
    if mesh is not None:
        return mesh_entries(mesh)
    pool = getattr(target, "pool", None)
    if pool is not None:
        return _device_entries(pool)
    entries: list = []
    for rep in list(getattr(target, "replicas", {}).values()):
        entries += (_device_entries(rep) if hasattr(rep, "pool")
                    else list(rep.device_ids()))
    return entries


def fleet_fingerprint(fleet) -> Fingerprint:
    """The fingerprint of the devices ``fleet`` (a ServeFleet, a
    LocalReplica or a ServePool) serves on, as a simulator resolves
    against the fingerprint of its own mesh: a CPU fleet's is ``'cpu'``.
    A target that names no device is keyed by the visible cards, or by
    the CPU when there are none."""
    import torch

    entries = _device_entries(fleet)
    if entries:
        return fingerprint(entries)
    return fingerprint(None if torch.cuda.is_available() else ["cpu"])


class _Flight:
    """One in-flight single-flight entry: the leader's outer future plus
    every coalesced follower's."""

    __slots__ = ("key", "leader", "followers", "dispatched")

    def __init__(self, key: str):
        self.key = key
        self.leader: Future = Future()
        self.followers: list = []     # (Future, tenant_id, t_admit)
        self.dispatched = False


class Gateway:
    """Tenant-aware caching/coalescing tier in front of a ServeFleet."""

    def __init__(self, fleet, tenants: Union[TenantTable, Sequence[Tenant]],
                 store: Optional[ResultStore] = None,
                 fp: Optional[Fingerprint] = None,
                 max_inflight: int = tune_defaults.GATEWAY_MAX_INFLIGHT,
                 singleflight_cap: int =
                 tune_defaults.GATEWAY_SINGLEFLIGHT_CAP):
        self.fleet = fleet
        self.tenants = (tenants if isinstance(tenants, TenantTable)
                        else TenantTable(tenants,
                                         max_inflight=max_inflight))
        self.store = store if store is not None else ResultStore()
        self.fp = fp if fp is not None else fleet_fingerprint(fleet)
        self.singleflight_cap = int(singleflight_cap)
        self._lock = threading.Lock()
        self._flights: dict = {}       # key -> _Flight (bounded by
        #                              # singleflight_cap at admission)
        self._inflight = 0
        self._requests = 0
        self._hits = 0
        self._coalesced = 0
        self._throttles = 0
        self._bypassed = 0
        self._dispatched = 0
        self._device_s_saved = 0.0
        self._cutovers = 0
        self._closed = False

    # -- keys --------------------------------------------------------------
    def _request_key(self, req) -> Optional[str]:
        """Content address for a cacheable request, else None (stream
        kinds mutate state; named specs resolve pool-side)."""
        if getattr(req, "stream_affine", False):
            return None
        spec = getattr(req, "spec", None)
        if not isinstance(spec, ArraySpec):
            return None
        return request_key(spec.spec_hash(), req.lane_token(),
                           req.seed, req.n, self.fp)

    # -- admission ---------------------------------------------------------
    def submit(self, req, token: Optional[str] = None) -> Future:
        """Admit one tenant request; returns a Future of ServeResult (or,
        for stream kinds, the stream payload dict). Raises
        :class:`GatewayAuthError` / :class:`GatewayBusy` at the gate."""
        tenant = self.tenants.authenticate(token)
        tid = tenant.tenant_id
        faults.check("gateway.admit", tenant=tid)
        st = self.tenants.states[tid]
        t0 = now()
        throttle_hint = None
        with self._lock:
            if self._closed:
                raise ServeBusy("gateway is closed", retry_after_s=1.0)
            st.requests += 1
            self._requests += 1
            if st.t_first is None:
                st.t_first = t0
            if (self._inflight >= self.tenants.max_inflight
                    or st.inflight >= self.tenants.share(tid)):
                st.throttles += 1
                self._throttles += 1
                throttle_hint = self.tenants.retry_hint(st)
            else:
                st.inflight += 1
                self._inflight += 1
        metrics.count("gateway.requests")
        if throttle_hint is not None:
            metrics.count("gateway.throttles")
            flightrec.note("gateway_throttle", tenant=tid,
                           retry_after_s=round(throttle_hint, 4),
                           trace=getattr(req, "trace_id", None))
            raise GatewayBusy(
                f"tenant {tid!r} is over its fair share "
                f"({self.tenants.share(tid)} slots); retry in "
                f"~{throttle_hint:.3f}s",
                retry_after_s=throttle_hint, tenant=tid)
        try:
            return self._serve_admitted(req, tid, st, t0)
        except BaseException:
            self._release(tid, t0, completed=False)
            raise

    def _serve_admitted(self, req, tid: str, st, t0: float) -> Future:
        key = self._request_key(req)
        if key is not None:
            got = self.store.get(key, self.fp, key.split("/")[1])
            if got is not None:
                meta, arrays = got
                res = self._result_from_payload(meta, arrays,
                                                latency_s=now() - t0)
                with self._lock:
                    st.hits += 1
                    self._hits += 1
                    saved = float(meta.get("service_s", 0.0))
                    st.device_s_saved += saved
                    self._device_s_saved += saved
                metrics.count("gateway.hits")
                flightrec.note("gateway_cache_hit", key=key, tenant=tid,
                               trace=getattr(req, "trace_id", None))
                self._release(tid, t0, completed=True)
                fut: Future = Future()
                fut.set_result(res)
                return fut
            with self._lock:
                fl = self._flights.get(key)
                if fl is not None:
                    follower: Future = Future()
                    fl.followers.append((follower, tid, t0))
                    st.coalesced += 1
                    self._coalesced += 1
                    attach = True
                elif len(self._flights) >= self.singleflight_cap:
                    # table at its LRU bound: dispatch directly instead of
                    # growing it (a bounded table is the day-one contract)
                    self._bypassed += 1
                    key = None
                    attach = False
                else:
                    fl = _Flight(key)
                    self._flights[key] = fl
                    attach = False
            if attach:
                metrics.count("gateway.coalesced")
                flightrec.note("gateway_coalesced", key=key, tenant=tid,
                               trace=getattr(req, "trace_id", None))
                return follower
            if key is None:
                metrics.count("gateway.coalesce_bypass")
        return self._dispatch(req, tid, t0, key)

    def _dispatch(self, req, tid: str, t0: float,
                  key: Optional[str]) -> Future:
        fl = None
        if key is not None:
            with self._lock:
                fl = self._flights.get(key)
        try:
            inner = self.fleet.submit(req)
        except ServeBusy as exc:
            # fleet-level backpressure surfaces as THIS tenant's 429
            if fl is not None:
                self._abort_flight(fl, exc)
            with self._lock:
                st = self.tenants.states[tid]
                st.throttles += 1
                self._throttles += 1
            metrics.count("gateway.throttles")
            raise GatewayBusy(
                f"fleet busy for tenant {tid!r}: {exc}",
                retry_after_s=float(getattr(exc, "retry_after_s", 0.1)),
                tenant=tid) from exc
        except BaseException as exc:
            # any other refusal (a closed fleet, no live replica) fails
            # the flight too: a follower attached to it would otherwise
            # wait on a leader that was never dispatched
            if fl is not None:
                self._abort_flight(fl, exc)
            raise
        with self._lock:
            self._dispatched += 1
        if fl is None:
            inner.add_done_callback(
                lambda f: self._on_plain_done(f, tid, t0))
            return inner
        fl.dispatched = True
        inner.add_done_callback(
            lambda f: self._on_flight_done(f, fl, req, tid, t0))
        return fl.leader

    # -- completion (futures resolve OUTSIDE the lock) ---------------------
    def _release(self, tid: str, t0: float, completed: bool) -> None:
        t1 = now()
        with self._lock:
            st = self.tenants.states[tid]
            st.inflight = max(0, st.inflight - 1)
            self._inflight = max(0, self._inflight - 1)
            if completed:
                st.completed += 1
                st.latencies_ms.append((t1 - t0) * 1e3)
                st.t_last = t1

    def _on_plain_done(self, inner: Future, tid: str, t0: float) -> None:
        self._release(tid, t0, completed=inner.exception() is None)

    def _abort_flight(self, fl: _Flight, exc: BaseException) -> None:
        with self._lock:
            self._flights.pop(fl.key, None)
            followers = list(fl.followers)
        for fut, f_tid, f_t0 in followers:
            self._release(f_tid, f_t0, completed=False)
            if not fut.done():
                fut.set_exception(exc)
        if not fl.leader.done():
            fl.leader.set_exception(exc)

    def _on_flight_done(self, inner: Future, fl: _Flight, req,
                        tid: str, t0: float) -> None:
        exc = inner.exception()
        with self._lock:
            self._flights.pop(fl.key, None)
            followers = list(fl.followers)
        if exc is not None:
            self._release(tid, t0, completed=False)
            for fut, f_tid, f_t0 in followers:
                self._release(f_tid, f_t0, completed=False)
                if not fut.done():
                    fut.set_exception(exc)
            if not fl.leader.done():
                fl.leader.set_exception(exc)
            return
        res = inner.result()
        arrays = self._payload_arrays(res)
        if arrays is not None:
            meta = {"spec_hash": fl.key.split("/")[1], "fp": self.fp.hash,
                    "platform": self.fp.platform,
                    "lane": repr(tuple(req.lane_token())),
                    "seed": int(req.seed), "n": int(req.n),
                    "service_s": float(res.service_s),
                    "bucket": int(res.bucket)}
            try:
                self.store.put(fl.key, meta, arrays)
            except Exception as exc:   # noqa: BLE001 (recorded: caching
                # is best-effort; a store failure must degrade to "this
                # response is not cached", never strand the followers
                # waiting on this callback to fan the result out)
                flightrec.note("gateway_store_put_failed", key=fl.key,
                               error=repr(exc)[:160])
        self._release(tid, t0, completed=True)
        for fut, f_tid, f_t0 in followers:
            self._release(f_tid, f_t0, completed=True)
            if not fut.done():
                fut.set_result(res)
        if not fl.leader.done():
            fl.leader.set_result(res)

    # -- payload <-> ServeResult ------------------------------------------
    @staticmethod
    def _payload_arrays(res: ServeResult) -> Optional[dict]:
        """Flatten a ServeResult into npz-able arrays, or None when a lane
        payload is not representable (then the response is simply not
        cached: correctness never depends on cacheability)."""
        try:
            arrays = {"curves": np.asarray(res.curves),
                      "autos": np.asarray(res.autos),
                      "bin_centers": np.asarray(res.bin_centers)}
            for prefix, d in (("os", res.os), ("lnlike", res.lnlike)):
                if not d:
                    continue
                for k, v in d.items():
                    a = np.asarray(v)
                    if a.dtype == object:
                        return None
                    arrays[f"{prefix}__{k}"] = a
        except (TypeError, ValueError):
            return None
        return arrays

    @staticmethod
    def _result_from_payload(meta: dict, arrays: dict,
                             latency_s: float) -> ServeResult:
        os_d: dict = {}
        ln_d: dict = {}
        plain: dict = {}
        for k, v in arrays.items():
            if k.startswith("os__"):
                os_d[k[len("os__"):]] = v
            elif k.startswith("lnlike__"):
                ln_d[k[len("lnlike__"):]] = v
            else:
                plain[k] = v
        return ServeResult(
            curves=plain["curves"], autos=plain["autos"],
            bin_centers=plain["bin_centers"],
            os=os_d or None, lnlike=ln_d or None,
            queued_s=0.0, service_s=0.0, latency_s=float(latency_s),
            cohort_requests=1, bucket=int(meta.get("bucket", 0)),
            pad_waste_frac=0.0, replica="gateway-cache", failovers=0)

    # -- sync + stats surface ---------------------------------------------
    def serve(self, req, token: Optional[str] = None,
              timeout: Optional[float] = None):
        return self.submit(req, token).result(timeout)

    def cutover(self, name: str, spec, checkpoint=None) -> dict:
        """Frozen-grid migration as a gateway-managed operation (see
        :func:`.cutover.cutover_stream`)."""
        from .cutover import cutover_stream

        info = cutover_stream(self.fleet, name, spec,
                              checkpoint=checkpoint)
        with self._lock:
            self._cutovers += 1
        return info

    def gateway_summary(self) -> dict:
        with self._lock:
            completed = sum(s.completed
                            for s in self.tenants.states.values())
            return {
                "requests": int(self._requests),
                "dispatched": int(self._dispatched),
                "hits": int(self._hits),
                "coalesced": int(self._coalesced),
                "throttles": int(self._throttles),
                "coalesce_bypass": int(self._bypassed),
                "cache_rejects": int(self.store.rejects),
                "store_entries": len(self.store),
                "flights_open": len(self._flights),
                "inflight": int(self._inflight),
                "completed": int(completed),
                "hit_rate": round(self._hits / self._requests, 4)
                            if self._requests else 0.0,
                "device_s_saved": round(self._device_s_saved, 6),
                "cutovers": int(self._cutovers),
            }

    def tenant_summary(self) -> dict:
        with self._lock:
            return self.tenants.summary()

    def slo_summary(self) -> dict:
        out = dict(self.fleet.slo_summary())
        for k, v in self.gateway_summary().items():
            out[f"gateway_{k}"] = v
        return out

    def telemetry_rollup(self) -> dict:
        # ServeFleet and ServePool both expose telemetry_rollup; a
        # duck-typed target without one still gets the gateway sections.
        base = getattr(self.fleet, "telemetry_rollup", None)
        rollup = dict(base()) if base is not None else {}
        rollup["tenants"] = self.tenant_summary()
        rollup["gateway"] = self.gateway_summary()
        return rollup

    def metrics_text(self) -> str:
        from ..obs import promfmt

        return promfmt.render(self.telemetry_rollup())

    def reset_stats(self) -> None:
        with self._lock:
            self._requests = self._hits = self._coalesced = 0
            self._throttles = self._bypassed = self._dispatched = 0
            self._cutovers = 0
            self._device_s_saved = 0.0
            for st in self.tenants.states.values():
                st.requests = st.throttles = st.hits = 0
                st.coalesced = st.completed = 0
                st.device_s_saved = 0.0
                st.latencies_ms.clear()
                st.t_first = st.t_last = None
        self.fleet.reset_stats()

    def close(self, close_fleet: bool = True) -> None:
        with self._lock:
            self._closed = True
            flights = list(self._flights.values())
            self._flights.clear()
        for fl in flights:
            for fut, _tid, _t0 in fl.followers:
                if not fut.done():
                    fut.cancel()
        if close_fleet:
            self.fleet.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
