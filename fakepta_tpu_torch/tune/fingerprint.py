"""Platform fingerprint: the identity every tuned knob is keyed on (port
of ``fakepta_tpu.tune.fingerprint``).

A tuned configuration is meaningless without the platform it was measured
on, so the fingerprint captures what changes the optimum: the platform and
device kind, the device and process counts, per-device memory, and the
torch and CUDA versions (whose kernels and allocator can move the optimum
as surely as hardware can). The JAX package's ``jax_version`` /
``jaxlib_version`` fields are ``torch_version`` / ``cuda_version`` here,
so an entry one package wrote never applies in the other.

``n_devices`` counts distinct ``(rank, device)`` pairs, as ``run()``'s
``meta["n_devices"]`` does: a mesh of ``["cpu"] * 8`` (eight shards on one
device) and one of ``["cuda:0"] * 4`` each fingerprint one device. The
mesh layout is a tuned knob, not an identity field.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """What the tuner knows about the platform it measured on."""

    platform: str          # 'gpu' | 'cpu'
    device_kind: str       # torch.cuda.get_device_name, or 'cpu'
    n_devices: int         # distinct (rank, device) pairs
    n_processes: int       # ranks (parallel.mesh.process_count())
    hbm_bytes: int         # per-device memory; 0 on the CPU
    torch_version: str
    cuda_version: str      # torch.version.cuda, '' on a CPU-only build

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def hash(self) -> str:
        """Stable short identity (the store key ingredient)."""
        blob = json.dumps(self.as_dict(), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


def fingerprint(devices: Optional[Sequence] = None) -> Fingerprint:
    """Fingerprint the devices a run uses: mesh entries (devices, device
    names or :class:`..parallel.mesh.MeshDevice`), by default
    :func:`..parallel.mesh.global_devices` (every rank's cards; it raises
    without a GPU, so pass CPU devices to fingerprint the CPU)."""
    from ..parallel.mesh import (MeshDevice, global_devices, process_count,
                                 process_index)

    entries = list(global_devices() if devices is None else devices)
    if not entries:
        raise ValueError("fingerprint needs at least one device")
    me = process_index()
    pairs = [(e.rank, torch.device(e.device)) if isinstance(e, MeshDevice)
             else (me, torch.device(e)) for e in entries]
    pairs = [(r, torch.device("cuda", torch.cuda.current_device())
              if d.type == "cuda" and d.index is None and r == me else d)
             for r, d in pairs]
    own = [d for r, d in pairs if r == me] or [pairs[0][1]]
    d0 = own[0]
    on_card = d0.type == "cuda"
    return Fingerprint(
        platform="gpu" if on_card else "cpu",
        device_kind=torch.cuda.get_device_name(d0) if on_card else "cpu",
        n_devices=len(set(pairs)),
        n_processes=int(process_count()),
        hbm_bytes=(int(torch.cuda.get_device_properties(d0).total_memory)
                   if on_card else 0),
        torch_version=str(torch.__version__),
        cuda_version=str(torch.version.cuda or ""))


def family_hash(**fields) -> str:
    """Stable short hash of a spec *family*: the problem-shaped identity
    (pulsar/TOA/bin counts, coefficient width, dtype) a TunedConfig applies
    to, without the knobs themselves (chunk, depth, path, precision, mesh
    split are what the tuner chooses) or the volatile fields (nreal, seed).
    Byte for byte the JAX package's, so one batch gives one family in
    both packages."""
    blob = json.dumps(dict(sorted(fields.items())), sort_keys=True,
                      default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]
