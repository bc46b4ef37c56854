"""Warm pool: LRU-bounded spec_hash -> ready-to-dispatch simulator entries
(port of ``fakepta_tpu.serve.pool``).

The pool keeps a **live simulator** per spec: its staged array, bases and
statistic weights stay on the card between requests, and each (lane
configuration, bucket) pair it will dispatch is warmed once through
:meth:`..parallel.montecarlo.EnsembleSimulator.warm_start` with
``lane_keys=True``: the kernel libraries built and loaded, one step run at
exactly the dispatch's shape (priming cuBLAS, the kernel modules' first
launch and the caching allocator), then :meth:`chunk_cost`'s analytic cost.

Kept divergence from the JAX pool: the port has no persistent compilation
cache (its kernels build once per checkout, :mod:`..ops._build`), so the
pool takes no cache directory and :meth:`PoolEntry.ensure_warm` always
calls ``warm_start``; the JAX pool calls it only when XLA's on-disk cache
is on (without it its AOT executable could not reach the dispatch path).

Entries are LRU-evicted past ``max_entries`` (a spec's device footprint
dies with its simulator); simulators registered by name through
:meth:`WarmPool.register` are pinned: the embeddable multi-tenant case
owns their lifecycle.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

from ..obs import flightrec
from ..obs.timing import now
from .spec import ArraySpec, ServeError


class PoolEntry:
    """One warm spec: the simulator plus its prewarmed-bucket bookkeeping."""

    def __init__(self, spec_hash: str, sim, pinned: bool = False):
        self.spec_hash = spec_hash
        self.sim = sim
        self.pinned = pinned
        # (lane_token, bucket) pairs already warmed: the contract is zero
        # kernel builds for any pair in this set
        self.warmed = set()
        self.warm_s = 0.0            # total seconds spent prewarming
        # lane_token -> host-f64 OS operators (the demux re-assembles each
        # request's detection statistics; built once per spec and lane)
        self.os_ops = {}

    def ensure_warm(self, bucket: int, lane_token, run_kwargs: dict) -> float:
        """Warm one (lane configuration, bucket) pair; idempotent. Returns
        the seconds spent (0.0 when already warm)."""
        key = (lane_token, int(bucket))
        if key in self.warmed:
            return 0.0
        t0 = now()
        self.sim.warm_start(bucket, lane_keys=True, **run_kwargs)
        self.sim.chunk_cost(bucket, **run_kwargs)   # memoized for the bucket
        self.warmed.add(key)
        spent = now() - t0
        self.warm_s += spent
        return spent


class WarmPool:
    """LRU-bounded ``spec_hash -> PoolEntry`` map (see module docstring)."""

    def __init__(self, mesh, max_entries: int = 4):
        self.mesh = mesh
        self.max_entries = int(max_entries)
        self._entries: "collections.OrderedDict[str, PoolEntry]" = \
            collections.OrderedDict()
        self._named: dict = {}               # name -> spec_hash
        self.builds = 0
        self.evictions = 0

    # -- registration (the embeddable multi-tenant surface) ---------------
    def register(self, name: str, sim) -> str:
        """Pin a prebuilt simulator under ``name``; returns its spec hash."""
        spec_hash = flightrec.spec_hash({"kind": "registered", "name": name})
        self._named[name] = spec_hash
        self._entries[spec_hash] = PoolEntry(spec_hash, sim, pinned=True)
        self._entries.move_to_end(spec_hash)
        return spec_hash

    @property
    def named(self) -> dict:
        return self._named

    # -- lookup ------------------------------------------------------------
    def get(self, spec_hash: str, spec) -> PoolEntry:
        """The entry for ``spec_hash``, building it from ``spec`` on a miss
        on the pool's mesh (LRU-evicting unpinned entries past
        ``max_entries``)."""
        entry = self._entries.get(spec_hash)
        if entry is not None:
            self._entries.move_to_end(spec_hash)
            return entry
        if not isinstance(spec, ArraySpec):
            raise ServeError(
                f"spec {spec!r} is not resident (registered sims are pinned "
                f"at register time; only ArraySpec specs build on demand)")
        sim = spec.build(mesh=self.mesh)
        entry = PoolEntry(spec_hash, sim)
        self._entries[spec_hash] = entry
        self.builds += 1
        while len(self._entries) > self.max_entries:
            victim = next((k for k, e in self._entries.items()
                           if not e.pinned and k != spec_hash), None)
            if victim is None:
                break
            del self._entries[victim]
            self.evictions += 1
        return entry

    def evict(self, spec_hash: str) -> bool:
        """Evict one entry's derived state (the poisoned-output recovery
        hook).

        Unpinned (ArraySpec-built) entries are dropped wholesale: the next
        :meth:`get` rebuilds the simulator from the spec,
        deterministically. Pinned (registered) entries own their
        simulator's lifecycle, so only its derived memos are cleared
        (:meth:`..parallel.montecarlo.EnsembleSimulator.clear_executables`)
        and the prewarmed-bucket bookkeeping reset. Returns True when
        something was evicted.
        """
        entry = self._entries.get(spec_hash)
        if entry is None:
            return False
        if entry.pinned:
            entry.sim.clear_executables()
            entry.warmed.clear()
            entry.os_ops.clear()
        else:
            del self._entries[spec_hash]
        self.evictions += 1
        flightrec.note("pool_evict", spec=spec_hash,
                       pinned=bool(entry.pinned))
        return True

    def prewarm(self, entry: PoolEntry, buckets: Tuple[int, ...],
                lane_token=("sim",), run_kwargs: Optional[dict] = None
                ) -> float:
        """Warm a bucket ladder for one lane configuration; returns
        seconds."""
        spent = 0.0
        for b in buckets:
            spent += entry.ensure_warm(b, lane_token, run_kwargs or {})
        return spent

    def __len__(self) -> int:
        return len(self._entries)
