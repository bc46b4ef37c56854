"""Consistent-hash request routing for the serve fleet (port of
``fakepta_tpu.serve.router``, line for line).

A fleet scales its warm capacity with the replica count only if the same
spec keeps landing on the same replica, so the router consistent-hashes
``spec_hash`` onto a ring of virtual nodes:

- each replica owns ``vnodes`` points on a 64-bit ring (SHA-1 of
  ``"replica_id#k"``: stable across processes, runs and the two packages,
  so a spec lands on the same owner in both);
- a spec routes to the first replica point clockwise of
  ``SHA-1(spec_hash)``: the spec's **owner**;
- :meth:`HashRing.preference` lists the owner first and then the distinct
  successors around the ring: the spillover and failover order;
- adding or removing a replica only remaps the arcs adjacent to its
  points: ~1/N of the spec space moves on a join or leave.

Pure host-side data structure: no torch, no sockets, no threads.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Sequence, Tuple

#: virtual nodes per replica: enough that per-replica load imbalance and
#: the join/leave remap fraction both concentrate near 1/N (stddev ~
#: 1/sqrt(vnodes)) while a full ring rebuild stays microseconds
DEFAULT_VNODES = 64


def _point(label: str) -> int:
    """Stable 64-bit ring coordinate of a label (no seed, no salt: two
    processes building the same ring agree bit-for-bit)."""
    return int.from_bytes(hashlib.sha1(label.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring of replica ids (see module docstring).

    >>> ring = HashRing(["r0", "r1", "r2"])
    >>> ring.owner("a1b2c3")                    # stable owner
    >>> ring.preference("a1b2c3")               # owner + failover order
    """

    def __init__(self, replica_ids: Sequence[str],
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []
        self._keys: List[int] = []
        self._ids: List[str] = []
        for rid in replica_ids:
            self.add(rid)

    # -- membership --------------------------------------------------------
    def add(self, replica_id: str) -> None:
        """Join one replica (idempotence is an error: duplicate ids would
        silently double the replica's arc share)."""
        rid = str(replica_id)
        if rid in self._ids:
            raise ValueError(f"replica {rid!r} is already on the ring")
        self._ids.append(rid)
        for k in range(self.vnodes):
            self._points.append((_point(f"{rid}#{k}"), rid))
        self._rebuild()

    def remove(self, replica_id: str) -> None:
        """Leave: only the departing replica's arcs remap (~1/N of specs)."""
        rid = str(replica_id)
        if rid not in self._ids:
            raise ValueError(f"replica {rid!r} is not on the ring")
        self._ids.remove(rid)
        self._points = [(p, r) for p, r in self._points if r != rid]
        self._rebuild()

    def _rebuild(self) -> None:
        self._points.sort()
        self._keys = [p for p, _ in self._points]

    @property
    def replica_ids(self) -> Tuple[str, ...]:
        return tuple(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    # -- routing -----------------------------------------------------------
    def _walk(self, spec_hash: str):
        """Ring points clockwise of the spec's coordinate, wrapped."""
        if not self._points:
            raise ValueError("the ring has no replicas")
        start = bisect.bisect_right(self._keys, _point(str(spec_hash)))
        n = len(self._points)
        for i in range(n):
            yield self._points[(start + i) % n][1]

    def owner(self, spec_hash: str) -> str:
        """The replica owning ``spec_hash`` (its warm-pool home)."""
        return next(self._walk(spec_hash))

    def preference(self, spec_hash: str) -> List[str]:
        """Every replica, owner first then distinct ring successors — the
        spillover order when the owner is saturated and the failover order
        when it dies (deterministic per spec, so degraded traffic converges
        on one sibling's warm pool)."""
        order: List[str] = []
        seen: Dict[str, bool] = {}
        for rid in self._walk(spec_hash):
            if rid not in seen:
                seen[rid] = True
                order.append(rid)
                if len(order) == len(self._ids):
                    break
        return order

    def shard(self, spec_hashes: Sequence[str]) -> Dict[str, List[str]]:
        """Owner -> owned spec hashes (introspection + the tests' remap
        accounting)."""
        out: Dict[str, List[str]] = {rid: [] for rid in self._ids}
        for h in spec_hashes:
            out[self.owner(h)].append(h)
        return out
