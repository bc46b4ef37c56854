"""Device-memory watermark and packed-buffer accounting (port of
``fakepta_tpu.obs.memwatch``).

Two views of device memory, both feeding ``RunReport.memory``:

- :class:`HbmSampler`: the allocator watermark of every CUDA device of the
  run's mesh, max-aggregated over devices. The JAX package samples
  ``device.memory_stats()`` from a background thread because an XLA
  allocator reports only its current use; PyTorch's caching allocator
  keeps the peak itself (``torch.cuda.reset_peak_memory_stats`` at
  ``start``, ``torch.cuda.max_memory_allocated`` at ``stop``), so no thread
  is needed and nothing between two samples is missed. ``stop`` publishes
  the peak as the live ``obs.peak_hbm_bytes`` gauge of
  :mod:`.telemetry`. A mesh of host devices reports nothing.
- :class:`PackedLedger`: the run loop's packed device outputs. The loop
  hands each chunk's packed tensor to :meth:`PackedLedger.track` as the
  step returns it; the ledger keeps weak references only, so a tensor
  counts as live for as long as anything in the run still holds it (the
  ring of chunks in flight, a queued drain, or a leak). Each chunk's
  drain drops the run's reference when it ends. On the pipelined
  path at most ``depth`` of them may be live at a dispatch, and
  :meth:`PackedLedger.check` raises if more were.
"""

from __future__ import annotations

import weakref
from typing import Dict

import torch

from . import telemetry

# allocator keys kept, max-aggregated over the mesh's devices (the JAX
# package's names, so the reports compare)
STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def _cuda_devices(devices):
    seen = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            if d not in seen:
                seen.append(d)
    return seen


def local_device_stats(devices) -> Dict[str, int]:
    """Max-over-devices allocator stats of the CUDA devices in ``devices``
    (empty for host devices)."""
    out: Dict[str, int] = {}
    for d in _cuda_devices(devices):
        stats = {"bytes_in_use": torch.cuda.memory_allocated(d),
                 "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
                 "bytes_limit": torch.cuda.get_device_properties(
                     d).total_memory}
        for k in STAT_KEYS:
            out[k] = max(out.get(k, 0), int(stats[k]))
    return out


class HbmSampler:
    """The run's allocator watermark over its CUDA devices.

    ``start()`` resets each device's peak counter (returns False, and does
    nothing, on a mesh of host devices); ``stop()`` returns the
    max-aggregated stats (``hbm_samples`` counts the devices read).
    """

    def __init__(self, devices):
        self.devices = _cuda_devices(devices)

    def start(self) -> bool:
        for d in self.devices:
            torch.cuda.reset_peak_memory_stats(d)
        return bool(self.devices)

    def stop(self) -> Dict[str, int]:
        out = local_device_stats(self.devices)
        if out:
            out["hbm_samples"] = len(self.devices)
            # the live watermark for the telemetry plane (the hbm_watermark
            # alert rule reads it)
            telemetry.publish("obs.peak_hbm_bytes",
                              int(out.get("peak_bytes_in_use", 0)))
        return out


class PackedLedger:
    """Live packed-buffer accounting for one ``run()``'s chunk loop.

    :meth:`track` counts the tracked tensors still alive, the new one
    included, at each dispatch, and keeps the peak. The count reads
    Python's own reference counts, not the loop's bookkeeping: a chunk
    whose tensor is still referenced after its drain (a ring that grows, a
    list that keeps every chunk) shows up in it. On the pipelined path
    :meth:`check` raises when the peak passed ``ring_size``; the serial
    loop keeps its chunks' outputs to the end and claims no bound.
    """

    def __init__(self, buffer_bytes: int, ring_size: int, pipelined: bool):
        self.buffer_bytes = int(buffer_bytes)
        self.ring_size = int(ring_size)
        self.pipelined = bool(pipelined)
        self._refs: list = []
        self.live_peak = 0
        self.degraded = False
        self.reuse_misses = 0

    def track(self, packed: torch.Tensor) -> int:
        """Record a chunk's packed tensor; returns the tracked tensors
        alive now, ``packed`` included."""
        self._refs = [r for r in self._refs if r() is not None]
        self._refs.append(weakref.ref(packed))
        self.live_peak = max(self.live_peak, len(self._refs))
        return len(self._refs)

    def disable(self) -> None:
        """Recovery turned the ring's buffer reuse off mid-run: the
        depth-bound claim is withdrawn for this run (:meth:`check` passes)
        and the report's memory says so (``packed_ring_degraded``); the
        engine counts and flight-records the degradation."""
        self.degraded = True
        self.pipelined = False

    def miss(self) -> None:
        """A ring reuse failed with recovery off: :meth:`check` raises."""
        self.reuse_misses += 1

    def check(self) -> None:
        """Assert the depth bound on the live packed tensors, and that the
        ring's buffer reuse never failed."""
        if self.pipelined and self.reuse_misses:
            raise RuntimeError(
                f"{self.reuse_misses} ring buffer reuse(s) failed with the "
                f"recovery policy's degrade_pipeline off")
        if self.pipelined and self.live_peak > self.ring_size:
            raise RuntimeError(
                f"pipeline depth bound violated: {self.live_peak} packed "
                f"buffers live at one dispatch (bound {self.ring_size}); "
                f"this is an engine bug")

    def memory_fields(self) -> Dict[str, int]:
        """The ledger's contribution to ``RunReport.memory``."""
        out = {"packed_buffer_bytes": self.buffer_bytes,
               "packed_buffers_live_peak": self.live_peak}
        if self.pipelined:
            out["packed_depth_bound_bytes"] = (self.ring_size
                                               * self.buffer_bytes)
        if self.degraded:
            out["packed_ring_degraded"] = 1
        return out
