"""Deterministic fault injection and engine recovery (port of
``fakepta_tpu.faults``).

Two halves:

- the **chaos harness** (:mod:`.plan`): a seeded :class:`FaultPlan` arms
  named sites threaded through the engine and the sampler (chunk dispatch
  and ring reuse, the pipeline writer, checkpoint appends, sampler
  segments, stream appends, the serve dispatcher, the health monitor's
  heartbeats and telemetry scrapes, the gateway's admission and stream
  cutover) and fires scripted faults (transient
  errors, NaN poisoning, torn checkpoint writes, hung drains, simulated
  kills) at deterministic hit indices, each mirrored into the crash
  flight recorder;
- the **recovery policy** (:mod:`.recovery`): bounded exponential-backoff
  retry that re-dispatches the same RNG lanes (bit-identical), the
  degradation ladders (``mega -> fused`` on a kernel launch failure, the
  fused path's own kernel failure fatal; ``bf16 -> f32`` on a
  certification failure; ring reuse off on a failed reuse), and the
  per-chunk watchdog deadline that dumps the flight recorder and aborts
  hung drains.

The contract the chaos tests hold: every injected fault either
**recovers** (outputs bit-identical to the unfaulted run, or within the
path's tolerance when a degradation changed the path) or **fails loudly**
with a flight-recorder dump. Silent corruption is never an outcome.

The JAX package's ``cache.load`` site has no counterpart: it wires XLA's
persistent compilation cache, and the port has none (its kernels are
built once per checkout, :mod:`..ops._build`).
"""

from .plan import (FaultError, FaultPlan, FaultSpec, DegradeFault,
                   FatalFault, KillFault, PrecisionFault, TransientFault,
                   WatchdogTimeout, active, check, inject)
from .recovery import (DISABLED, PATH_LADDER, RecoveryPolicy, as_policy,
                       classify, classify_replica, is_oom, sleep)

__all__ = [
    "DISABLED", "DegradeFault", "FatalFault", "FaultError", "FaultPlan",
    "FaultSpec", "KillFault", "PATH_LADDER", "PrecisionFault",
    "RecoveryPolicy", "TransientFault", "WatchdogTimeout", "active",
    "as_policy", "check", "classify", "classify_replica", "inject",
    "is_oom", "sleep",
]
