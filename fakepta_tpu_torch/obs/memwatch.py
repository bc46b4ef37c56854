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

:func:`library_workspace_bytes` is the port's counterpart of the JAX
engine's ``static_reservation_bytes``: the fixed device bytes a run's
allocator peak holds outside its own tensors. On the card they are the
cuBLAS and cuBLASLt workspaces that torch takes from the caching
allocator for each (thread, stream) at its first product and keeps for
the life of the process (32 MiB and 1 MiB on an H100 under torch 2.11),
so the peak counts them whatever the run's size. It is per card, to pair
with that card's peak; :class:`WorkspaceTerm` keeps it between reads, so
a run takes an allocator snapshot only when the term may have grown.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Optional

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


def device_stats(devices) -> Dict[int, Dict[str, int]]:
    """Allocator stats of each CUDA device in ``devices``, by card index
    (empty for host devices): one ``torch.cuda.memory_stats`` read each,
    with the cumulative count of the allocator's device allocations
    (``device_allocs``: ``cudaMalloc`` calls) beside :data:`STAT_KEYS`."""
    out: Dict[int, Dict[str, int]] = {}
    for d in _cuda_devices(devices):
        st = torch.cuda.memory_stats(d)
        out[d.index] = {
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                d).total_memory),
            "device_allocs": int(st.get("num_device_alloc", 0))}
    return out


def local_device_stats(devices) -> Dict[str, int]:
    """Max-over-devices allocator stats of the CUDA devices in ``devices``
    (empty for host devices)."""
    out: Dict[str, int] = {}
    for stats in device_stats(devices).values():
        for k in STAT_KEYS:
            out[k] = max(out.get(k, 0), stats[k])
    return out


# one probe per process and card: the workspace sizes are a property of the
# process's torch build, its environment and the card, not of a run
_SIZES: Dict[torch.device, Optional[frozenset]] = {}
_SIZES_LOCK = threading.Lock()


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _probe_sizes(dev: torch.device) -> Optional[frozenset]:
    """One cuBLAS product and one cuBLASLt product (``addmm`` with a bias)
    on a stream created for the probe (``cudaStreamCreate``, not one of
    torch's pooled streams, so no handle has a workspace for it yet); the
    blocks still allocated on that stream's segments once the operands and
    results are freed are the workspaces torch took for it. Other threads
    allocate on their own streams' segments, so they do not enter. None
    when the stream cannot be made."""
    handle = ctypes.c_void_p()
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        cudart = torch.cuda.cudart()
        err = cudart.cudaStreamCreate(ctypes.addressof(handle))
        if err != cudart.cudaError.success:
            return None
        probe = torch.cuda.ExternalStream(handle.value, device=dev)
        with torch.cuda.stream(probe):
            a = torch.ones((8, 8), device=dev)
            bias = torch.ones((8,), device=dev)
            out = [a @ a, torch.addmm(bias, a, a)]
            probe.synchronize()
            del a, bias, out
    return frozenset(
        blk["size"] for seg in torch.cuda.memory_snapshot()
        if seg["device"] == dev.index and seg["stream"] == handle.value
        for blk in seg["blocks"] if blk["state"] == "active_allocated")


def workspace_sizes(device) -> Optional[frozenset]:
    """The block sizes of the library workspaces torch takes for a (thread,
    stream) on ``device`` at its first cuBLAS and cuBLASLt product (32 MiB
    and 1 MiB on an H100 under torch 2.11; empty under a zero workspace
    configuration), measured once per process and card by
    :func:`_probe_sizes`, or None when it could not be. The probe's stream
    and its workspaces stay for the life of the process (torch frees no
    workspace): one idle set, which :func:`library_workspace_bytes`
    counts."""
    dev = _card(device)
    with _SIZES_LOCK:
        if dev not in _SIZES:
            _SIZES[dev] = _probe_sizes(dev)
        return _SIZES[dev]


def device_tensor_ptrs(obj, out=None) -> set:
    """The data pointers of the CUDA tensors reachable from ``obj`` through
    dataclass fields, tuples, lists and dict values (a simulator's state)."""
    out = set() if out is None else out
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.data_ptr())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            device_tensor_ptrs(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            device_tensor_ptrs(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            device_tensor_ptrs(x, out)
    return out


def workspace_block_bytes(segments, sizes: dict,
                          exclude=()) -> Dict[int, int]:
    """Bytes, by card index, of the live blocks of an allocator snapshot's
    ``segments`` (``torch.cuda.memory_snapshot()``) whose size is one of
    ``sizes[card index]``, less any block holding a pointer of
    ``exclude``; every card of ``sizes`` has an entry."""
    total = {i: 0 for i in sizes}
    for seg in segments:
        want = sizes.get(seg["device"])
        if not want:
            continue
        for blk in seg["blocks"]:
            lo, size = blk["address"], blk["size"]
            if blk["state"] == "active_allocated" and size in want and \
                    not any(lo <= p < lo + size for p in exclude):
                total[seg["device"]] += size
    return total


def library_workspace_bytes(devices, exclude=()) -> Dict[int, Optional[int]]:
    """The cuBLAS and cuBLASLt workspaces present on each CUDA device of
    ``devices``, by card index (empty for host devices): the caching
    allocator's live blocks whose size is a workspace size measured on
    that card (:func:`workspace_sizes`; None for a card where it could not
    be), less any block holding a pointer of ``exclude`` (the caller's own
    tensors). torch keeps one set per (thread, stream) that ran a product,
    for the life of the process, so a process that ran products on
    several threads holds several; every one of them is in that card's
    allocator peak."""
    cards = _cuda_devices(devices)
    sizes = {d.index: workspace_sizes(d) for d in cards}
    known = {i: s for i, s in sizes.items() if s is not None}
    got = (workspace_block_bytes(torch.cuda.memory_snapshot(), known,
                                 exclude) if known else {})
    return {i: got.get(i) for i in sizes}


class WorkspaceTerm:
    """:func:`library_workspace_bytes` of a set of cards, kept between
    reads.

    A workspace set appears only when a (thread, stream) runs its first
    product, so :meth:`read` takes a new allocator snapshot only when the
    calling thread, its current streams or the cards' count of device
    allocations (``device_allocs``) changed since the last one, and
    otherwise returns the last value. A set that another thread took from
    a block the allocator already held shows at the next snapshot; until
    then the term reads low, which makes a bound on ``peak / (model +
    term)`` stricter, never looser.
    """

    def __init__(self, devices):
        self.cards = _cuda_devices(devices)
        self._key = None
        self._value: Dict[int, Optional[int]] = {}

    def measure(self) -> None:
        """Measure the cards' workspace sizes now (:func:`workspace_sizes`;
        a no-op once they are known): a caller that resets an allocator
        peak calls this first, so the probe's set is inside that peak."""
        for d in self.cards:
            workspace_sizes(d)

    def read(self, exclude: Callable[[], set],
             device_allocs: Optional[Dict[int, int]] = None,
             ) -> Dict[int, Optional[int]]:
        """The term by card index; ``exclude()`` gives the caller's own
        tensors' pointers, and ``device_allocs`` (by card index) the
        allocation counts where the caller has just read them."""
        if not self.cards:
            return {}
        if device_allocs is None:
            device_allocs = {i: s["device_allocs"]
                             for i, s in device_stats(self.cards).items()}
        key = (threading.get_ident(),
               tuple(torch.cuda.current_stream(d).cuda_stream
                     for d in self.cards),
               tuple(device_allocs[d.index] for d in self.cards))
        if key != self._key:
            self._value = library_workspace_bytes(self.cards, exclude())
            self._key = key
        return dict(self._value)


class HbmSampler:
    """The run's allocator watermark over its CUDA devices.

    ``start()`` resets each device's peak counter (returns False, and does
    nothing, on a mesh of host devices); ``stop()`` returns the
    max-aggregated stats (``hbm_samples`` counts the devices read) and
    keeps each card's (``per_device``, :func:`device_stats`) and the index
    of the card whose peak is the reported one (``peak_device``).
    """

    def __init__(self, devices):
        self.devices = _cuda_devices(devices)
        self.per_device: Dict[int, Dict[str, int]] = {}
        self.peak_device: Optional[int] = None

    def start(self) -> bool:
        for d in self.devices:
            torch.cuda.reset_peak_memory_stats(d)
        return bool(self.devices)

    def stop(self) -> Dict[str, int]:
        out = local_device_stats(self.devices)
        self.per_device = per = device_stats(self.devices)
        self.peak_device = (max(per, key=lambda i: per[i]["peak_bytes_in_use"])
                            if per else None)
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
