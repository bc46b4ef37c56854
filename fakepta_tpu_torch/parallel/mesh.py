"""Device mesh of one process (port of fakepta_tpu.parallel.mesh).

A :class:`Mesh` is a ``(real, psr, toa)`` grid of ``torch.device`` entries
driven from one process, the counterpart of the JAX package's
single-controller ``jax.sharding.Mesh``: the ``'real'`` axis splits a
chunk's realizations into contiguous blocks, the ``'psr'`` axis splits the
pulsars, and the ``'toa'`` axis is reserved for time sharding.

Entries may name one device several times. ``make_mesh(["cpu"] * 8,
psr_shards=8)`` plays the role of the JAX tests' eight virtual host devices,
and ``make_mesh(["cuda:0"] * 4, psr_shards=4)`` runs a 4-way pulsar-sharded
program on one card: the shards then execute one after another, so such a
run measures the sharded code path, not multi-GPU scaling.

The two collectives are plain tensor copies and sums with a fixed order:
:func:`all_gather` concatenates the shards' blocks in shard order on each
shard's device, and :func:`psum` adds the partials in shard order on one
device. No float atomics and no timing-dependent order, so reruns are
bit-identical.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

REAL_AXIS = "real"
PSR_AXIS = "psr"
TOA_AXIS = "toa"
AXES = (REAL_AXIS, PSR_AXIS, TOA_AXIS)


def _normalize(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(real, psr, toa)`` grid of torch devices.

    ``devices`` is the numpy object array of ``torch.device`` entries;
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does.
    """

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 3:
            raise ValueError(f"a mesh grid is 3-D (real, psr, toa), got "
                             f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices.flat]
        return f"Mesh(shape={self.shape}, devices={names})"


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None,
              psr_shards: int = 1, toa_shards: int = 1) -> Mesh:
    """Build the (real, psr, toa) mesh over the given devices.

    ``devices=None`` means every visible CUDA device, and raises without a
    GPU: the CPU is used only when the caller lists CPU devices (the tests
    pass ``["cpu"] * 8``). ``psr_shards * toa_shards`` must divide the
    device count; the remaining factor goes to the realization axis.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; list CPU devices, e.g. "
                "make_mesh(['cpu'] * 8, psr_shards=2), to run on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_normalize(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if psr_shards < 1 or toa_shards < 1:
        raise ValueError(f"shard counts must be >= 1, got psr_shards="
                         f"{psr_shards}, toa_shards={toa_shards}")
    model = psr_shards * toa_shards
    if len(devices) % model != 0:
        raise ValueError(f"psr_shards*toa_shards={model} must divide "
                         f"{len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(len(devices) // model, psr_shards, toa_shards))


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
