"""Device mesh, one process or several (port of fakepta_tpu.parallel.mesh).

A :class:`Mesh` is a ``(real, psr, toa)`` grid of entries, the counterpart
of the JAX package's ``jax.sharding.Mesh``: the ``'real'`` axis splits a
chunk's realizations into contiguous blocks, the ``'psr'`` axis splits the
pulsars, and the ``'toa'`` axis splits the TOA slots (time sharding).
Every entry is a ``torch.device`` owned by one process (its *rank*).

One process: entries may name one device several times.
``make_mesh(["cpu"] * 8, psr_shards=8)`` plays the role of the JAX tests'
eight virtual host devices, and ``make_mesh(["cuda:0"] * 4,
psr_shards=4)`` runs a 4-way pulsar-sharded program on one card: the
shards then execute one after another, so such a run measures the sharded
code path, not multi-GPU scaling.

Several processes: :func:`initialize_multihost` joins a
``torch.distributed`` process group (one rank per card, or per group of
cards) and returns the global mesh, its entries in rank-major order, as
``jax.devices()`` spans every process after ``jax.distributed``. Every
rank builds the same meshes in the same order (one program, many
processes) and runs only the entries it owns. :func:`global_devices` lists
every rank's entries as :class:`MeshDevice`; reorder that list to choose
which axis crosses ranks.

The collectives keep one fixed order, so reruns are bit-identical and a
multi-process mesh gives the one-process mesh's bits: :func:`all_gather`
concatenates the shards' blocks in shard order on each shard's device, and
:func:`psum` adds the partials in shard order on one device. Across ranks
(:class:`Comm`) each block is broadcast from its owner and then
concatenated or added in shard order on every member, never through
``all_reduce``, whose NCCL ring order is not shard order.

The backend follows the layout, chosen before the group starts: ``nccl``
when every rank owns its own card(s), ``gloo`` for CPU entries and when
ranks share a card (NCCL refuses two ranks on one GPU).

Host decisions (a probe's budget stop, an append's bucket rungs, a
failure on one rank) travel on the group's CPU transport: a gloo group
over the mesh's ranks (the mesh's own group under gloo, a second group
beside NCCL's). :meth:`Mesh.agreement` wraps a step every rank takes
together and ends it with one exchange there, so a failure inside it on
one rank raises on every rank at once instead of leaving the others in
the next collective until the timeout.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

REAL_AXIS = "real"
PSR_AXIS = "psr"
TOA_AXIS = "toa"
AXES = (REAL_AXIS, PSR_AXIS, TOA_AXIS)

#: seconds a cross-rank collective (and the group's start) may wait
DEFAULT_TIMEOUT_S = 300.0

# what initialize_multihost exchanged: every rank's entries, the backend
# and the collective deadline (the process group itself is torch's global)
_LAYOUT: Dict[str, object] = {}


class MeshDevice(NamedTuple):
    """A mesh entry of a multi-process program: the owning rank and the
    device as that rank names it."""

    rank: int
    device: torch.device


def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank; 0 when no process group is up."""
    if not _group_up():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    """The number of ranks; 1 when no process group is up."""
    if not _group_up():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def backend() -> Optional[str]:
    """The process group's backend (``"nccl"`` or ``"gloo"``), or None."""
    if not _group_up():
        return None
    import torch.distributed as dist
    return str(dist.get_backend())


def _normalize(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _describe(dev: torch.device) -> dict:
    """A local device as the rank exchange carries it: its name and, for a
    card, an identity that two ranks sharing the card both report."""
    card = None
    if dev.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
        card = (str(uuid) if uuid is not None
                else f"{socket.gethostname()}:{dev.index}")
    return {"device": str(dev), "card": card}


def pick_backend(layout: Sequence[Sequence[dict]],
                 requested: Optional[str] = None) -> str:
    """The backend for a layout (``layout[rank]`` lists that rank's devices
    as :func:`_describe` gives them): ``nccl`` when every entry is a card
    and no card is named by two ranks, else ``gloo``. ``requested`` names
    one; ``"nccl"`` on CPU entries or on a shared card raises."""
    owners: Dict[str, set] = {}
    cpu = False
    for rank, devs in enumerate(layout):
        for d in devs:
            if d["card"] is None:
                cpu = True
            else:
                owners.setdefault(d["card"], set()).add(rank)
    shared = sorted(c for c, ranks in owners.items() if len(ranks) > 1)
    auto = "gloo" if cpu or shared else "nccl"
    if requested is None:
        return auto
    if requested not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{requested!r}")
    if requested == "nccl" and cpu:
        raise ValueError("backend='nccl' needs every rank on a card; this "
                         "layout has CPU entries (use gloo)")
    if requested == "nccl" and shared:
        raise ValueError(f"backend='nccl' refuses two ranks on one card "
                         f"({len(shared)} card(s) shared); use gloo or one "
                         f"rank per card")
    return requested


def _store(address: str, rank: int, world: int, timeout: datetime.timedelta):
    """The rendezvous store: ``file://<path>`` (a FileStore, for ranks on
    one file system) or ``[tcp://]host:port`` (a TCPStore served by rank
    0)."""
    import torch.distributed as dist
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world)
    host, sep, port = address.removeprefix("tcp://").rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"coordinator_address must be 'host:port', "
                         f"'tcp://host:port' or 'file://path', got "
                         f"{address!r}")
    return dist.TCPStore(host or "localhost", int(port), world, rank == 0,
                         timeout=timeout)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         local_devices: Optional[Sequence[DeviceLike]] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> "Mesh":
    """Join a ``torch.distributed`` process group and return the global
    mesh (:func:`make_mesh` over :func:`global_devices`).

    With no arguments it reads what ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), the
    counterpart of JAX discovering a pod from its environment; others pass
    ``coordinator_address`` (``host:port``, ``tcp://host:port`` or
    ``file://path``), ``num_processes`` and ``process_id``.
    ``local_devices`` are this rank's entries (default: ``cuda:LOCAL_RANK``;
    without a GPU it raises unless CPU devices are listed). The ranks
    exchange their entries through the rendezvous store first, so the
    backend is picked from the layout (:func:`pick_backend`) before the
    group starts; an NCCL failure raises and is never retried on gloo.
    ``timeout_s`` bounds the start and every cross-rank collective.
    """
    import torch.distributed as dist
    if _group_up():
        raise RuntimeError("a torch.distributed process group is already up; "
                           "call shutdown_multihost() first")
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator_address and no MASTER_ADDR / "
                             "MASTER_PORT in the environment (run under "
                             "torchrun or pass one)")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} is outside "
                         f"[0, {num_processes})")
    if local_devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "local_devices=['cpu'] to run on the CPU")
        local_rank = int(env.get("LOCAL_RANK",
                                 process_id % torch.cuda.device_count()))
        local_devices = [f"cuda:{local_rank}"]
    devs = [_normalize(d) for d in local_devices]
    if not devs:
        raise ValueError("a rank needs at least one local device")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    store = _store(coordinator_address, process_id, num_processes, timeout)
    store.set(f"fakepta_torch/devices/{process_id}",
              json.dumps([_describe(d) for d in devs]))
    layout = [json.loads(store.get(f"fakepta_torch/devices/{r}"))
              for r in range(num_processes)]
    chosen = pick_backend(layout, backend)
    if chosen == "nccl":
        torch.cuda.set_device(devs[0])
    dist.init_process_group(chosen, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _LAYOUT.clear()
    _LAYOUT.update(
        entries=[MeshDevice(r, torch.device(d["device"]))
                 for r, rank_devs in enumerate(layout) for d in rank_devs],
        backend=chosen, timeout_s=float(timeout_s))
    return make_mesh(None)


def shutdown_multihost() -> None:
    """Leave the process group :func:`initialize_multihost` started."""
    import torch.distributed as dist
    if _group_up():
        dist.destroy_process_group()
    _LAYOUT.clear()


def global_devices() -> List[MeshDevice]:
    """Every rank's entries in rank-major order (after
    :func:`initialize_multihost`); without a group, this process's visible
    cards as rank 0's."""
    if _group_up() and _LAYOUT:
        return list(_LAYOUT["entries"])
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; list CPU devices, e.g. "
            "make_mesh(['cpu'] * 8, psr_shards=2), to run on the CPU")
    return [MeshDevice(0, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def _collective_timeout_s() -> float:
    return float(_LAYOUT.get("timeout_s", DEFAULT_TIMEOUT_S))


class RankFailure(RuntimeError):
    """Raised on the other ranks when a step every rank of a multi-process
    mesh takes together (:meth:`Mesh.agreement`) failed on one rank; that
    rank raises its own exception."""


class Agreement:
    """A step every rank of a mesh takes together, ended by one exchange
    on the host transport (:meth:`Mesh.exchange_objects`).

    ``value`` is what this rank proposes (set it inside the block; any
    picklable object); after the block ``values`` holds every rank's, in
    the mesh's rank order, and ``lead_value`` the lead rank's (the owner
    of entry (0, 0, 0), whose decisions every rank takes). When the block
    raised on any rank, the exchange still happens: the failed rank
    re-raises its own exception and every other rank raises
    :class:`RankFailure` naming it. One process: no exchange, ``values``
    is ``[value]``.
    """

    def __init__(self, mesh: "Mesh", what: str):
        self.mesh, self.what = mesh, what
        self.value = None
        self.values: list = []

    def __enter__(self) -> "Agreement":
        return self

    def __exit__(self, typ, exc, tb) -> bool:
        error = None if exc is None else f"{typ.__name__}: {exc}"[:500]
        self.values = [self.value]
        got = self.mesh.exchange_objects((error, self.value))
        self.values = [v for _, v in got]
        failed = [(r, e) for r, (e, _) in zip(self.mesh.members, got)
                  if e is not None]
        if failed and exc is None:
            rank, err = failed[0]
            raise RankFailure(f"{self.what} failed on rank {rank}: {err}")
        return False            # this rank's own exception propagates

    @property
    def lead_value(self):
        return self.values[self.mesh.members.index(self.mesh.lead)]


class Comm:
    """The collectives of a set of mesh entries, in shard order.

    ``ranks[i]`` owns entry i. Lists passed in hold a tensor for each entry
    this rank owns and anything (None) for the others; results hold a
    tensor for owned entries and None for the others. A rank owning none of
    the entries takes no part and gets Nones. When one rank owns every
    entry the ops are the one-process :func:`all_gather` / :func:`psum`.
    """

    def __init__(self, ranks: Sequence[int], me: int, group=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.ranks = [int(r) for r in ranks]
        self.me = int(me)
        self.local = len(set(self.ranks)) == 1
        self.member = self.me in self.ranks
        self.group = group
        self.timeout = datetime.timedelta(seconds=float(timeout_s))

    def _owned(self, xs) -> list:
        return [x for x, r in zip(xs, self.ranks) if r == self.me]

    def _transport_device(self, like: torch.device) -> torch.device:
        # NCCL moves tensors on the rank's current card; gloo takes CPU
        # and CUDA tensors alike for broadcast
        if backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return like

    def _broadcast(self, x: Optional[torch.Tensor], src: int,
                   like: torch.Tensor) -> torch.Tensor:
        """``x`` (given on rank ``src``) on every member, at ``like``'s
        device. The bytes travel as uint8, whatever the dtype (bf16 and
        bool too)."""
        import torch.distributed as dist
        dev = self._transport_device(like.device)
        if x is None:
            buf = torch.empty(like.numel() * like.element_size(),
                              dtype=torch.uint8, device=dev)
        else:
            buf = x.detach().to(dev).contiguous().reshape(-1).view(
                torch.uint8)
        work = dist.broadcast(buf, src=src, group=self.group,
                              async_op=True)
        if backend() == "nccl":
            work.wait()         # stream-ordered; the group's timeout holds
        else:
            work.wait(self.timeout)
        return buf.view(like.dtype).reshape(like.shape).to(like.device)

    def _fill(self, xs) -> list:
        """Every entry's tensor on this member: its own, and each other
        entry's broadcast from its owner, in entry order."""
        like = self._owned(xs)[0]
        return [self._broadcast(x if r == self.me else None, r, like)
                for x, r in zip(xs, self.ranks)]

    def all_gather(self, blocks, dim: int = 1) -> list:
        """:func:`all_gather` over the entries' blocks."""
        if not self.member:
            return [None] * len(self.ranks)
        if self.local:
            return all_gather(blocks, dim)
        full = self._fill(blocks)
        done: Dict[torch.device, torch.Tensor] = {}
        out = []
        for b, r in zip(blocks, self.ranks):
            if r != self.me:
                out.append(None)
                continue
            if b.device not in done:
                done[b.device] = torch.cat([f.to(b.device) for f in full],
                                           dim=dim)
            out.append(done[b.device])
        return out

    def psum(self, parts, device: Optional[torch.device] = None
             ) -> Optional[torch.Tensor]:
        """:func:`psum` of the entries' partials on every member, on
        ``device`` (default: this rank's first partial's device)."""
        if not self.member:
            return None
        if self.local:
            return psum(parts, device)
        dev = self._owned(parts)[0].device if device is None else device
        return psum(self._fill(parts), dev)


class Mesh:
    """A ``(real, psr, toa)`` grid of entries.

    ``devices`` is the numpy object array of ``torch.device`` entries and
    ``ranks`` the array of their owning ranks (all this process's on a
    one-process mesh); ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh`` does. On a multi-process mesh the constructor
    creates a process group for every set of ranks its collectives join,
    so every rank must build it (same entries, same order).
    """

    def __init__(self, devices: np.ndarray,
                 ranks: Optional[np.ndarray] = None):
        if devices.ndim != 3:
            raise ValueError(f"a mesh grid is 3-D (real, psr, toa), got "
                             f"shape {devices.shape}")
        self.devices = devices
        self.rank = process_index()
        self.ranks = (np.full(devices.shape, self.rank, dtype=np.int64)
                      if ranks is None else
                      np.asarray(ranks, dtype=np.int64).reshape(
                          devices.shape))
        if not (self.ranks == self.rank).any():
            raise ValueError(f"rank {self.rank} owns no entry of this mesh")
        self.multiprocess = len(set(self.ranks.flat)) > 1
        #: the mesh's ranks in order, and the lead (entry (0, 0, 0)'s)
        self.members = sorted({int(r) for r in self.ranks.flat})
        self.lead = int(self.ranks[0, 0, 0])
        self._groups: Dict[tuple, object] = {}
        self._host_group = None
        if self.multiprocess:
            self._make_groups()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def owns(self, index) -> bool:
        return int(self.ranks[index]) == self.rank

    @property
    def local_devices(self) -> List[torch.device]:
        """This rank's entries' devices, in entry order."""
        return [d for d, r in zip(self.devices.flat, self.ranks.flat)
                if r == self.rank]

    @property
    def local_device(self) -> torch.device:
        """This rank's first entry's device (where its whole-array state
        and a real row's results live)."""
        return self.local_devices[0]

    def _entry_sets(self):
        """Every entry set a collective runs over: each real row, each
        row's psr shards of one toa window, each psr shard's toa cells."""
        n_real, n_psr, n_toa = self.devices.shape
        for r in range(n_real):
            yield [(r, s, t) for s in range(n_psr) for t in range(n_toa)]
            for t in range(n_toa):
                yield [(r, s, t) for s in range(n_psr)]
            for s in range(n_psr):
                yield [(r, s, t) for t in range(n_toa)]
        yield list(np.ndindex(self.devices.shape))

    def _make_groups(self) -> None:
        import torch.distributed as dist
        world = tuple(range(process_count()))
        needed = sorted({tuple(sorted({int(self.ranks[i]) for i in ent}))
                         for ent in self._entry_sets()})
        for members in needed:
            if len(members) < 2:
                continue
            # every rank calls new_group for every set, in one order
            self._groups[members] = (None if members == world
                                     else dist.new_group(list(members)))
        mine = tuple(self.members)
        if backend() == "gloo":
            self._host_group = self._groups[mine]
            return
        # beside NCCL, one gloo group per rank set carries host decisions;
        # every rank builds the same meshes in one order, so the cache
        # misses alike on every rank
        host = _LAYOUT.setdefault("host_groups", {})
        if mine not in host:
            # fakepta: allow[collective-divergence] one backend, one cache
            host[mine] = dist.new_group(
                list(mine), backend="gloo", timeout=datetime.timedelta(
                    seconds=_collective_timeout_s()))
        self._host_group = host[mine]

    def comm(self, entries: Sequence[tuple]) -> Comm:
        """The collectives over ``entries`` ((real, psr, toa) indices, in
        shard order)."""
        ranks = [int(self.ranks[i]) for i in entries]
        members = tuple(sorted(set(ranks)))
        return Comm(ranks, self.rank, self._groups.get(members),
                    _collective_timeout_s())

    def _mesh_comm(self) -> Comm:
        """The collectives over every entry of the mesh."""
        return Comm(list(self.ranks.flat), self.rank,
                    self._groups.get(tuple(self.members)),
                    _collective_timeout_s())

    def exchange_objects(self, value) -> list:
        """Every rank's ``value`` (picklable), in :attr:`members` order, on
        every rank of the mesh, over the host transport; ``[value]`` on a
        one-process mesh."""
        if not self.multiprocess:
            return [value]
        import torch.distributed as dist
        out = [None] * len(self.members)
        dist.all_gather_object(out, value, group=self._host_group)
        return out

    def agreement(self, what: str) -> Agreement:
        """A step every rank takes together (:class:`Agreement`)."""
        return Agreement(self, what)

    def broadcast_tensors(self, xs: Optional[Sequence[torch.Tensor]],
                          src: int, likes: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """Rank ``src``'s tensors ``xs`` on every rank of the mesh, in one
        broadcast of their bytes, at ``likes``' shapes, dtypes and devices
        (``xs`` is read on ``src`` only). One process: ``xs`` moved to the
        likes' devices."""
        if not self.multiprocess:
            return [x.to(like.device) for x, like in zip(xs, likes)]
        sizes = [like.numel() * like.element_size() for like in likes]
        like_buf = torch.empty(sum(sizes), dtype=torch.uint8,
                               device=likes[0].device)
        packed = None
        if src == self.rank:
            packed = torch.cat([
                x.detach().contiguous().reshape(-1).view(torch.uint8).to(
                    like_buf.device) for x in xs])
        buf = self._mesh_comm()._broadcast(packed, src, like_buf)
        out, off = [], 0
        for like, n in zip(likes, sizes):
            # a copy of the slice starts its own storage, so any dtype's
            # alignment holds
            out.append(buf[off:off + n].clone().view(like.dtype).reshape(
                like.shape).to(like.device))
            off += n
        return out

    def gather_real(self, blocks: Sequence[Optional[torch.Tensor]],
                    shape: Sequence[int], dtype: torch.dtype,
                    device: Optional[torch.device] = None) -> torch.Tensor:
        """The real rows' blocks concatenated along dim 0 in row order, on
        every rank. ``blocks[r]`` is row r's block where this rank owns the
        row's first entry (its lead) and may be None elsewhere; each block
        has ``shape`` and ``dtype``."""
        device = self.local_device if device is None else device
        if not self.multiprocess:
            return torch.cat([b.to(device) for b in blocks])
        leads = [int(self.ranks[r, 0, 0]) for r in range(len(blocks))]
        comm = self._mesh_comm()
        like = torch.empty(tuple(shape), dtype=dtype, device=device)
        return torch.cat([
            comm._broadcast(b if lead == self.rank else None, lead, like)
            for b, lead in zip(blocks, leads)])

    def __repr__(self) -> str:
        names = [str(d) if not self.multiprocess else f"p{r}:{d}"
                 for d, r in zip(self.devices.flat, self.ranks.flat)]
        return f"Mesh(shape={self.shape}, devices={names})"


def make_mesh(devices: Optional[Sequence] = None,
              psr_shards: int = 1, toa_shards: int = 1) -> Mesh:
    """Build the (real, psr, toa) mesh over the given entries.

    An entry is a device (owned by this process) or a :class:`MeshDevice`
    (owned by its rank). ``devices=None`` means :func:`global_devices`:
    every rank's cards after :func:`initialize_multihost`, else every
    visible CUDA device; it raises without a GPU, and the CPU is used only
    when the caller lists CPU devices (the tests pass ``["cpu"] * 8``).
    ``psr_shards * toa_shards`` must divide the entry count; the remaining
    factor goes to the realization axis. Entries fill the grid in order,
    real-major, then psr, then toa.
    """
    if devices is None:
        devices = global_devices()
    me = process_index()
    entries = [d if isinstance(d, MeshDevice) else MeshDevice(me, d)
               for d in devices]
    entries = [MeshDevice(e.rank, _normalize(e.device) if e.rank == me
                          else torch.device(e.device)) for e in entries]
    if not entries:
        raise ValueError("a mesh needs at least one device")
    if psr_shards < 1 or toa_shards < 1:
        raise ValueError(f"shard counts must be >= 1, got psr_shards="
                         f"{psr_shards}, toa_shards={toa_shards}")
    model = psr_shards * toa_shards
    if len(entries) % model != 0:
        raise ValueError(f"psr_shards*toa_shards={model} must divide "
                         f"{len(entries)} devices")
    shape = (len(entries) // model, psr_shards, toa_shards)
    grid = np.empty(len(entries), dtype=object)
    grid[:] = [e.device for e in entries]
    ranks = np.array([e.rank for e in entries], dtype=np.int64)
    return Mesh(grid.reshape(shape), ranks.reshape(shape))


def to_host(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The global value of a 'real'-sharded array on every rank, as numpy.

    One process: a plain copy. Several: ``x`` holds this rank's real
    blocks, the rows whose first entry it owns, concatenated in row order
    (an empty block where it leads none); the blocks are gathered across
    ranks in shard order. Without ``mesh`` each rank's ``x`` is one block
    of ``mesh = the world in rank order``.
    """
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if mesh is None:
        if process_count() == 1:
            return x.detach().cpu().numpy()
        mesh = make_mesh([MeshDevice(r, x.device if r == process_index()
                                     else torch.device("cpu"))
                          for r in range(process_count())])
    if not mesh.multiprocess:
        return x.detach().cpu().numpy()
    n_real = mesh.shape[REAL_AXIS]
    led = [r for r in range(n_real) if mesh.owns((r, 0, 0))]
    if x.shape[0] % max(len(led), 1) != 0:
        raise ValueError(f"{x.shape[0]} rows do not split into this rank's "
                         f"{len(led)} real blocks")
    rows = x.shape[0] // max(len(led), 1) if led else 0
    blocks: List[Optional[torch.Tensor]] = [None] * n_real
    for i, r in enumerate(led):
        blocks[r] = x[i * rows:(i + 1) * rows]
    # every rank learns the block shape from rank 0's lead row
    import torch.distributed as dist
    meta = [None]
    if mesh.rank == int(mesh.ranks[0, 0, 0]):
        meta = [tuple(blocks[0].shape)]
    # a rank whose rows do not split raised above; its peers then fail at
    # the group's timeout (timeout_s) instead of hanging
    # fakepta: allow[collective-divergence] a rank-local raise; peers time out
    dist.broadcast_object_list(meta, src=int(mesh.ranks[0, 0, 0]))
    # fakepta: allow[collective-divergence] a rank-local raise; peers time out
    return mesh.gather_real(blocks, meta[0], x.dtype,
                            device=x.device).cpu().numpy()


def all_gather(blocks: Sequence[torch.Tensor], dim: int = 1
               ) -> List[torch.Tensor]:
    """The shards' blocks concatenated along ``dim`` in shard order, one
    result per shard on that shard's device. Shards on one device share
    one concatenation (read-only)."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for block in blocks:
        dev = block.device
        if dev not in done:
            done[dev] = torch.cat([b.to(dev) for b in blocks], dim=dim)
        out.append(done[dev])
    return out


def psum(parts: Sequence[torch.Tensor],
         device: Optional[torch.device] = None) -> torch.Tensor:
    """Sum of the shards' partials, added in shard order on ``device``
    (default: the first partial's device)."""
    dev = parts[0].device if device is None else device
    total = parts[0].to(dev)
    for part in parts[1:]:
        total = total + part.to(dev)
    return total
