"""Tenants: auth tokens, weighted fair-share admission, per-tenant 429s
(port of ``fakepta_tpu.gateway.tenants``, line for line).

The gateway's isolation contract is *strict weighted shares over in-flight
slots*: tenant ``t`` may hold at most ``max(1, floor(cap * w_t / sum(w)))``
of the gateway's :data:`..tune.defaults.GATEWAY_MAX_INFLIGHT` slots at
once. A hot tenant that saturates its share gets a :class:`GatewayBusy` (a
:class:`..serve.ServeBusy` subclass, so polite clients need no new
handling) whose ``retry_after_s`` is computed from *that tenant's own*
recent completion latencies: one hot tenant can neither occupy another
tenant's slots nor inflate another tenant's retry hints.

Auth is deliberately boring: opaque bearer tokens compared with
:func:`hmac.compare_digest` (constant-time: a gateway that leaks token
prefixes through timing is a worse bug than any it prevents). Unknown
tokens raise :class:`GatewayAuthError` and count ``gateway.auth_failures``.
"""

from __future__ import annotations

import collections
import dataclasses
import hmac
from typing import Dict, Optional, Sequence

from ..obs import metrics
from ..serve.spec import ServeBusy, ServeError
from ..tune import defaults as tune_defaults


class GatewayAuthError(ServeError):
    """Unknown or missing tenant token."""


class GatewayBusy(ServeBusy):
    """Per-tenant 429: carries the tenant id beside the retry hint."""

    def __init__(self, msg: str, retry_after_s: float = 0.1,
                 tenant: str = ""):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.tenant = tenant


@dataclasses.dataclass
class Tenant:
    """One tenant's identity + quota configuration."""

    tenant_id: str
    token: str
    weight: float = float(tune_defaults.GATEWAY_DEFAULT_WEIGHT)


class _TenantState:
    """Mutable per-tenant accounting (guarded by the TenantTable's owner,
    the Gateway, under its admission lock)."""

    __slots__ = ("tenant", "inflight", "requests", "throttles", "hits",
                 "coalesced", "completed", "device_s_saved", "latencies_ms",
                 "t_first", "t_last")

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
        self.inflight = 0
        self.requests = 0
        self.throttles = 0
        self.hits = 0
        self.coalesced = 0
        self.completed = 0
        self.device_s_saved = 0.0
        self.latencies_ms = collections.deque(
            maxlen=tune_defaults.GATEWAY_LATENCY_RING)
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None


class TenantTable:
    """Token -> tenant resolution plus fair-share arithmetic.

    The table is immutable after construction (tenancy changes are a
    gateway restart), so reads need no lock: only the per-tenant *state*
    mutates, and that is owned by the Gateway's admission lock.
    """

    def __init__(self, tenants: Sequence[Tenant],
                 max_inflight: int = tune_defaults.GATEWAY_MAX_INFLIGHT):
        if not tenants:
            raise ValueError("a gateway needs at least one tenant")
        ids = [t.tenant_id for t in tenants]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant ids: {ids}")
        self.max_inflight = int(max_inflight)
        self._by_token: Dict[str, Tenant] = {t.token: t for t in tenants}
        if len(self._by_token) != len(tenants):
            raise ValueError("tenant tokens must be unique")
        self.states: Dict[str, _TenantState] = {
            t.tenant_id: _TenantState(t) for t in tenants}
        total = sum(max(0.0, float(t.weight)) for t in tenants)
        if total <= 0:
            raise ValueError("tenant weights must sum positive")
        self._share: Dict[str, int] = {
            t.tenant_id: max(1, int(self.max_inflight
                                    * max(0.0, float(t.weight)) / total))
            for t in tenants}

    def authenticate(self, token: Optional[str]) -> Tenant:
        """Resolve a bearer token; constant-time compare per entry."""
        if token:
            for known, tenant in self._by_token.items():
                if hmac.compare_digest(known, token):
                    return tenant
        metrics.count("gateway.auth_failures")
        raise GatewayAuthError("unknown tenant token")

    def share(self, tenant_id: str) -> int:
        """The tenant's in-flight slot allocation (its weighted share of
        the gateway total, floored at one slot)."""
        return self._share[tenant_id]

    def retry_hint(self, state: _TenantState) -> float:
        """Per-tenant retry_after_s: scale the tenant's own median recent
        latency by its queue pressure; floored/capped by the knobs so a
        cold tenant re-probes quickly and a backed-up one backs off."""
        lat = sorted(state.latencies_ms)
        share = self._share[state.tenant.tenant_id]
        if lat:
            p50_s = lat[len(lat) // 2] / 1e3
            hint = p50_s * max(1.0, state.inflight / max(1, share))
        else:
            hint = tune_defaults.GATEWAY_RETRY_MIN_S
        return float(min(tune_defaults.GATEWAY_RETRY_CAP_S,
                         max(tune_defaults.GATEWAY_RETRY_MIN_S, hint)))

    def summary(self) -> dict:
        """Per-tenant observability rows (the ``tenants`` table of stats
        replies, the telemetry rollup, promfmt and ``obs top``)."""
        out = {}
        for tid, st in sorted(self.states.items()):
            window_s = ((st.t_last - st.t_first)
                        if st.t_first is not None and st.t_last is not None
                        and st.t_last > st.t_first else 0.0)
            row = {
                "requests": int(st.requests),
                "throttles": int(st.throttles),
                "hits": int(st.hits),
                "coalesced": int(st.coalesced),
                "completed": int(st.completed),
                "inflight": int(st.inflight),
                "weight": float(st.tenant.weight),
                "share_slots": int(self._share[tid]),
                "queue_share": round(st.inflight
                                     / max(1, self.max_inflight), 4),
                "hit_rate": round(st.hits / st.requests, 4)
                            if st.requests else 0.0,
                "device_s_saved": round(st.device_s_saved, 6),
                "qps": round(st.completed / window_s, 3)
                       if window_s > 0 else 0.0,
            }
            lat = sorted(st.latencies_ms)
            if lat:
                row["p50_ms"] = round(lat[len(lat) // 2], 3)
                row["p99_ms"] = round(
                    lat[min(len(lat) - 1, int(0.99 * len(lat)))], 3)
            out[tid] = row
        return out
