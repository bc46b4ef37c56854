"""Gateway-orchestrated frozen-grid migration cutover (port of
``fakepta_tpu.gateway.cutover``).

A stream is pinned to the frozen-grid template it opened with; when its
data outgrows the pinned Tspan the answer is a *managed re-stage onto a
wider template*, not a reconfiguration. The fence + swap mechanics live
with the stream registry (:meth:`..serve.streams.StreamManager.cutover`);
this module is the gateway's control half: find the replica that owns the
stream, drive the operation, and account for it (``gateway.cutovers`` /
``gateway.cutover_aborts``, flight-recorder bracketing).

Only in-process replicas (:class:`..serve.LocalReplica`, or a bare
:class:`..serve.ServePool`) can host a gateway-driven cutover; a socket
replica reaches the same code through the ``cutover`` protocol kind of its
own serve CLI.
"""

from __future__ import annotations

from ..obs import flightrec, metrics
from ..obs.timing import now
from ..serve.spec import ServeError


def _owning_pool(target, name: str):
    """The ServePool that owns stream ``name`` under ``target`` (a pool,
    a LocalReplica, or a ServeFleet of them)."""
    if hasattr(target, "cutover_stream"):
        return target                     # a pool (or pool-compatible)
    pool = getattr(target, "pool", None)  # a LocalReplica
    if pool is not None:
        return pool
    replicas = getattr(target, "replicas", None)
    if replicas:
        remote = 0
        for rep in list(replicas.values()):
            pool = getattr(rep, "pool", None)
            if pool is None:
                remote += 1
                continue
            if name in pool.stream_summary():
                return pool
        if remote:
            raise ServeError(
                f"stream {name!r} is not on any in-process replica; "
                f"drive the cutover through the owning socket replica's "
                f"'cutover' protocol kind instead")
    raise ServeError(f"no pool under {type(target).__name__} owns stream "
                     f"{name!r}")


def cutover_stream(target, name: str, spec, checkpoint=None) -> dict:
    """Run one migration cutover as a managed operation; returns the
    cutover info row (TOA conservation + oracle already enforced by the
    manager: an abort leaves the old state installed and raises)."""
    t0 = now()
    flightrec.note("gateway_cutover_begin", stream=str(name))
    pool = _owning_pool(target, str(name))
    try:
        info = pool.cutover_stream(str(name), spec, checkpoint=checkpoint)
    except BaseException as exc:
        metrics.count("gateway.cutover_aborts")
        flightrec.note("gateway_cutover_failed", stream=str(name),
                       error=repr(exc)[:160])
        raise
    metrics.count("gateway.cutovers")
    info = dict(info, managed_ms=round((now() - t0) * 1e3, 3))
    return info
