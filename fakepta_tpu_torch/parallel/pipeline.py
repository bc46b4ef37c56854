"""Bounded-depth chunk pipeline: the run loop's host side (port of
``fakepta_tpu.parallel.pipeline``).

What :meth:`EnsembleSimulator.run` pipelines through:

- a **single background writer thread** draining a FIFO of per-chunk
  drain thunks (wait for the chunk's device-to-host copy, append the
  checkpoint chunk, call the progress callback) in the serial loop's exact
  order, so the checkpoint semantics do not change;
- an **inline writer** with the same interface for the serial loop
  (``run(pipeline_depth=0)``);
- the **device-to-host copy**: :func:`start_d2h` enqueues a
  ``non_blocking`` copy of a chunk's packed statistics into a pinned host
  buffer on a dedicated copy stream, after an event recorded behind the
  step's last kernel, and records a ``torch.cuda.Event`` behind the copy;
  :func:`materialize_copy` waits on that event before numpy reads the
  buffer. The kernels keep running on the device's current stream; only
  the copy moves off it.

Exceptions raised by a drain (a checkpoint write failing, a progress
callback aborting the run) reach the ``run()`` caller as in the serial
loop: the writer records the first one, cancels the queued drains and
re-raises it at the next ``submit``/``close``. The depth bound and the
ring of reused buffers live in the run loop.

Not ported, because they manage XLA state the port does not have: the JAX
package's ``configure_compile_cache`` (XLA's persistent compilation cache;
the port's kernels are built once per checkout and cached on disk by
:mod:`..ops._build`) and ``donation_unsafe`` (a guard for XLA buffer
donation; the port frees each packed device tensor once its copy has
landed, and the caching allocator reuses the memory). Not ported yet: the
JAX ``run_drain_with_retry`` and the writers' retry options, which retry
the drains that the JAX ``faults/`` module classifies as transient; they
come back with that module (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..obs.timing import now as _now

_STOP = object()


class InlineWriter:
    """Drains run synchronously at submit time: the serial loop."""

    pipelined = False

    def submit(self, drain: Callable[[], None],
               cancel: Callable[[], None] = lambda: None) -> float:
        drain()
        return 0.0

    def close(self) -> None:
        pass

    def abort(self) -> None:
        pass


class ThreadWriter:
    """One background thread draining per-chunk thunks in FIFO order.

    The queue is unbounded; the run loop's ring bounds the chunks in
    flight (chunk ``i`` waits for chunk ``i - depth``'s drain before its
    dispatch). The first exception a drain raises is kept, the remaining
    queued drains are cancelled (their ``cancel`` callbacks still run, so
    the loop cannot deadlock on them), and the exception re-raises at the
    next ``submit``/``close``.
    """

    pipelined = True

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        # the writer sets _exc, the dispatch thread reads and clears it
        self._exc_lock = threading.Lock()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, name="fakepta-torch-chunk-writer",
            daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            drain, cancel = item
            with self._exc_lock:
                failed = self._exc is not None
            if not failed:
                try:
                    drain()
                except BaseException as exc:   # noqa: BLE001 — re-raised
                    with self._exc_lock:       # in the dispatch thread
                        self._exc = exc
                    cancel()
            else:
                cancel()

    def submit(self, drain: Callable[[], None],
               cancel: Callable[[], None] = lambda: None) -> float:
        """Enqueue a drain; returns the seconds blocked (the put only).

        Raises the writer's pending exception instead of enqueueing, so
        the loop stops at most one chunk after a failure.
        """
        self._raise_pending()
        t0 = _now()
        self._q.put((drain, cancel))
        return _now() - t0

    def _raise_pending(self) -> None:
        with self._exc_lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            try:
                raise exc
            finally:
                # the traceback holds this frame: a local naming the
                # exception would be a cycle keeping the failed run's
                # device tensors alive until the next gc pass
                del exc

    def close(self) -> None:
        """Flush the queue, join the thread, re-raise a drain's
        exception."""
        self._q.put(_STOP)
        self._thread.join()
        self._raise_pending()

    def abort(self) -> None:
        """Stop the thread without re-raising (error-path cleanup)."""
        self._q.put(_STOP)
        self._thread.join(timeout=60.0)
        with self._exc_lock:
            self._exc = None


def make_writer(pipelined: bool):
    """The writer the run loop drains through: threaded iff pipelined."""
    return ThreadWriter() if pipelined else InlineWriter()


def host_buffer(like: torch.Tensor) -> torch.Tensor:
    """A host tensor shaped like ``like``, page-locked when ``like`` lives
    on a CUDA device (a non-blocking copy needs pinned memory)."""
    return torch.empty(like.shape, dtype=like.dtype, device="cpu",
                       pin_memory=like.is_cuda)


def start_d2h(packed: torch.Tensor, host: torch.Tensor,
              after: Optional["torch.cuda.Event"] = None,
              stream: Optional["torch.cuda.Stream"] = None
              ) -> Optional["torch.cuda.Event"]:
    """Start copying ``packed`` into the host buffer ``host``.

    On a CUDA device the copy is enqueued on ``stream`` behind the event
    ``after`` (recorded after the step's last kernel on the compute
    stream), ``non_blocking`` into the pinned buffer, and an event recorded
    behind it is returned: the buffer holds the chunk only once that event
    has completed. ``packed.record_stream(stream)`` keeps the caching
    allocator from handing ``packed``'s memory to later work before the
    copy has read it. On the CPU the copy is synchronous and None is
    returned.
    """
    if not packed.is_cuda:
        host.copy_(packed)
        return None
    stream.wait_event(after)
    with torch.cuda.stream(stream):
        host.copy_(packed, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    packed.record_stream(stream)
    return copied


def materialize_copy(host: torch.Tensor,
                     copied: Optional["torch.cuda.Event"]) -> np.ndarray:
    """The chunk in ``host`` as a numpy array of its own: waits for the
    copy's event first (reading earlier would see the previous chunk), and
    copies, because the ring reuses ``host`` for a later chunk."""
    if copied is not None:
        copied.synchronize()
    return host.numpy().copy()
