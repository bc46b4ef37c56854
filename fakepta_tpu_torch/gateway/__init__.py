"""fakepta_tpu_torch.gateway: multi-tenant gateway + content-addressed
results (port of ``fakepta_tpu.gateway``).

The tier that turns the serve fleet into a *service*: per-tenant
auth/quota/fair-share admission with per-tenant 429 retry hints,
single-flight coalescing of identical concurrent requests (sound under the
serve layer's bit-identical-per-RNG-lane contract), a content-addressed
result store keyed by ``spec_hash x lane token x (seed, n) x engine
fingerprint`` with the tune store's atomic-write/CRC/schema-bump
lifecycle, and the frozen-grid migration cutover as a gateway-managed
operation. The fleet behind it serves on the card unless its replicas are
given ``device="cpu"``; the gateway keys its store by the fingerprint of
the devices the replicas serve on.

Embeddable surface::

    from fakepta_tpu_torch.gateway import Gateway, Tenant
    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         ServeFleet, SimRequest)

    fleet = ServeFleet([LocalReplica("r0")])       # the card
    gw = Gateway(fleet, [Tenant("acme", token="tok-acme", weight=2)])
    res = gw.serve(SimRequest(spec=ArraySpec(npsr=20), n=32, seed=7),
                   token="tok-acme")     # repeat = cache hit, 0 device-s
"""

from .core import Gateway
from .cutover import cutover_stream
from .store import ResultStore, default_gateway_dir, request_key
from .tenants import GatewayAuthError, GatewayBusy, Tenant, TenantTable

__all__ = [
    "Gateway", "GatewayAuthError", "GatewayBusy", "ResultStore", "Tenant",
    "TenantTable", "cutover_stream", "default_gateway_dir", "request_key",
]
