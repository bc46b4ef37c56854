"""Recovery policy: bounded retry, degradation ladders, failure triage (port
of ``fakepta_tpu.faults.recovery``).

One policy object (:class:`RecoveryPolicy`) governs every recovery site in
the engine and the sampler:

- **retry**: transient dispatch/drain failures are retried up to
  ``max_retries`` times with exponential backoff (``backoff_s`` doubling by
  ``backoff_mult`` up to ``max_backoff_s``). A retried chunk or segment
  re-dispatches the *same* RNG lanes at the same offsets (per-realization
  keys fold absolute indices), so it is bit-identical to the unfaulted run.
  A CUDA out-of-memory error is of this class: the retry first returns the
  caching allocator's free blocks to the card (``torch.cuda.empty_cache``).
- **degradation ladders**: a hand-written kernel's launch failure on the
  mega path steps the statistic path down :data:`PATH_LADDER`
  (``mega -> fused``, both rungs hand-written kernels) at the same
  precision; on the fused path it is fatal, since the only rung below is
  the plain einsum path, and a run never falls back from a kernel to its
  plain version; a bf16 certification failure re-dispatches at f32;
  a failed buffer reuse stops the run loop's ring reuse for the rest of the
  run. Each step is counted (``faults.degradations``), flight-recorded, put
  on the timeline and written into the report's ``meta``: a degradation is
  never quiet, and its chunks are held to the path's tolerance, not to
  bit-identity.
- **watchdog**: ``watchdog_s`` arms a per-chunk deadline on the oldest
  in-flight drain; expiry dumps the flight recorder and aborts the run with
  :class:`~.plan.WatchdogTimeout` (pipelined runs only: the serial loop
  drains inline on the dispatch thread).

:func:`classify` is the failure triage every site shares. Its labels are
the JAX package's (``'transient'``, ``'pallas'``, ``'precision'``,
``'fatal'``), so reports and flight-recorder dumps read alike in both
packages; in the port ``'pallas'`` names the hand-written CUDA kernels'
class. Injected fault types map directly; real exceptions match
conservative message patterns, the JAX package's and torch's own.
Anything unrecognized is ``'fatal'``, and so are two classes a re-dispatch
cannot outlive: a sticky CUDA error (an illegal address or a device-side
assert poisons the process's CUDA context) and a kernel *build* failure
(nvcc missing or refusing a source), which fails at the kernel's first use.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .plan import (DegradeFault, FatalFault, KillFault, PrecisionFault,
                   TransientFault)

#: statistic-path degradation ladder: on a hand-written kernel's launch
#: failure the run steps down one rung and re-dispatches. The JAX package's
#: ladder is mega -> fused -> xla; the port stops at fused, because its
#: einsum path (the JAX xla path) is the kernels' plain version, and a
#: fallback from a kernel to it would hide the kernel's failure: a kernel
#: failure on the fused path propagates. The fused rung keeps the
#: simulator's pallas_mxu_binning (#1, or #2 when that is False), as the
#: JAX fused path does.
PATH_LADDER = {"mega": "fused"}

# conservative message fingerprints of retryable runtime failures (RPC /
# allocator transients a re-dispatch can outlive), the JAX package's list;
# matched case-insensitive. torch's out-of-memory error is matched by
# is_oom, by type or by its "CUDA out of memory" message
_TRANSIENT_PATTERNS = ("resource_exhausted", "resource exhausted",
                       "unavailable", "deadline_exceeded", "deadline "
                       "exceeded", "aborted", "connection reset",
                       "socket closed", "preempt")
# fingerprints of a serve-fleet replica dying under a request (the JAX
# package's list; the fleet's failover class)
_REPLICA_DEATH_PATTERNS = ("connection refused", "connection reset",
                           "broken pipe", "pipe closed", "socket closed",
                           "bad file descriptor", "eof",
                           "died mid-flight", "is dead", "pool is closed",
                           "pool closed")
_REPLICA_DEATH_TYPES = ("ReplicaDead", "ServeClosed", "ConnectionError",
                        "ConnectionResetError", "ConnectionRefusedError",
                        "BrokenPipeError", "EOFError")
# a failing hand-written kernel: the JAX package's Pallas/Mosaic words and
# the port's own launch error (ops/_build.py: "<kernel> failed to launch:
# CUDA error <code> (<message>)")
_KERNEL_PATTERNS = ("pallas", "mosaic", "failed to launch: cuda error")
# CUDA errors that leave the context unusable: no re-dispatch in this
# process can succeed, so they are fatal before any kernel or transient
# match (cudaErrorIllegalAddress, cudaErrorAssert, cudaErrorLaunchFailure,
# cudaErrorIllegalInstruction, cudaErrorMisalignedAddress, ...)
_STICKY_CUDA_PATTERNS = ("illegal memory access", "illegal address",
                         "device-side assert", "unspecified launch failure",
                         "illegal instruction", "misaligned address",
                         "invalid program counter", "hardware stack error",
                         "cudaerrorillegaladdress", "cudaerrorassert",
                         "cudaerrorlaunchfailure")
# a kernel that could not be built: fatal at its first use (ops/_build.py)
_BUILD_PATTERNS = ("kernel build failed", "nvcc not found")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for the engine-wide recovery ladder (module docstring)."""

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    degrade_paths: bool = True        # mega -> fused
    degrade_precision: bool = True    # bf16 -> f32
    degrade_pipeline: bool = True     # ring reuse off on a failed reuse
    watchdog_s: Optional[float] = None

    def next_backoff(self, delay: float) -> float:
        return min(delay * self.backoff_mult, self.max_backoff_s)


#: recovery disabled: no retries, no ladders, no watchdog; every failure
#: propagates (run(recovery=False))
DISABLED = RecoveryPolicy(max_retries=0, backoff_s=0.0,
                          degrade_paths=False, degrade_precision=False,
                          degrade_pipeline=False, watchdog_s=None)


def as_policy(recovery) -> RecoveryPolicy:
    """Normalize the ``run(recovery=...)`` argument: ``None`` -> defaults,
    ``False`` -> :data:`DISABLED`, a policy -> itself."""
    if recovery is None:
        return RecoveryPolicy()
    if recovery is False:
        return DISABLED
    if isinstance(recovery, RecoveryPolicy):
        return recovery
    raise TypeError(f"recovery must be None, False or a RecoveryPolicy, "
                    f"got {type(recovery).__name__}")


def is_oom(exc: BaseException) -> bool:
    """True for the caching allocator's out-of-memory error."""
    return isinstance(exc, torch.OutOfMemoryError) or \
        "cuda out of memory" in str(exc).lower()


def classify(exc: BaseException) -> str:
    """Triage one failure: 'transient' | 'pallas' | 'precision' | 'fatal'
    ('pallas': the hand-written kernels' class, module docstring)."""
    if isinstance(exc, TransientFault):
        return "transient"
    if isinstance(exc, DegradeFault):
        return "pallas"
    if isinstance(exc, PrecisionFault):
        return "precision"
    if isinstance(exc, (FatalFault, KillFault)):
        return "fatal"
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(p in msg for p in _STICKY_CUDA_PATTERNS + _BUILD_PATTERNS):
        return "fatal"
    if is_oom(exc):
        return "transient"
    if any(p in msg for p in _KERNEL_PATTERNS):
        return "pallas"
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return "transient"
    return "fatal"


def classify_replica(exc: BaseException) -> str:
    """Fleet-tier failure triage: ``'replica_death'`` when the replica
    serving the request is gone (a :class:`KillFault` counts: at a fleet
    site it is the simulated process kill), else :func:`classify`'s
    verdict. Walks the cause chain, at most eight links."""
    seen = 0
    cur: Optional[BaseException] = exc
    while cur is not None and seen < 8:
        if isinstance(cur, KillFault):
            return "replica_death"
        if any(t.__name__ in _REPLICA_DEATH_TYPES
               for t in type(cur).__mro__):
            return "replica_death"
        msg = f"{type(cur).__name__}: {cur}".lower()
        if any(p in msg for p in _REPLICA_DEATH_PATTERNS):
            return "replica_death"
        cur = cur.__cause__
        seen += 1
    return classify(exc)


def sleep(seconds: float) -> None:
    """Backoff sleep (bounded by the policy's ``max_backoff_s``)."""
    if seconds > 0:
        time.sleep(seconds)
