"""Persistence (port of ``fakepta_tpu.utils.io``): crash-safe files, the
ENTERPRISE-layout pulsar-list pickles and config JSONs of the facade
(``save_array``, ``load_array``, ``load_noisedict``,
``load_custom_models``), and resumable ensemble checkpoints.

The checkpoint layout is the JAX package's, file for file and key for
key: a manifest at ``<path>`` (npz: ``seed``, ``nreal``, ``chunk``,
``done``, ``n_extra``, ``sums``) and one ``<path>.c<k>.npz`` per completed
chunk (``curves``, ``autos``, optional ``corr`` and ``extra``). A
checkpoint either package wrote resumes in the other: per-realization keys
are ``fold_in(key(seed), absolute index)`` in both.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import zipfile
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs import flightrec


def write_atomic(path, data: bytes) -> int:
    """Crash-safe file write: tmp + fsync + rename + directory fsync.

    The rename is atomic on POSIX, so a reader never sees a half-written
    file under the final name; the two fsyncs (the data before the rename,
    the directory entry after) close the window where the rename survives
    a power loss but the data does not. Returns the CRC32 of ``data``, the
    checksum the checkpoint manifest records so that a resume detects the
    torn writes fsync cannot prevent on failing storage.
    """
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    dirfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return zlib.crc32(data)


def npz_bytes(**arrays) -> bytes:
    """Serialize arrays to npz bytes (for :func:`write_atomic`)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def save_array(psrs, path) -> Path:
    """Pickle a pulsar list in the ENTERPRISE-compatible layout (host
    float64 residuals, no key streams or device tensors)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(list(psrs), fh)
    return path


def load_array(path, device: DeviceLike = None) -> list:
    """Load a pulsar-list pickle (the facade's or ENTERPRISE objects).

    Unpickling runs code from the file: load only pickles this program
    wrote. The facade's pulsars come back with their host residuals
    authoritative and ``device`` (the package rule: ``None`` is ``"cuda"``,
    which raises without a GPU) as the device of their next injection.
    """
    from ..fake_pta import Pulsar

    dev = resolve_device(device)
    with open(path, "rb") as fh:
        psrs = pickle.load(fh)
    for p in psrs:
        if isinstance(p, Pulsar):
            p._device = dev
    return psrs


def load_noisedict(path) -> dict:
    """Flat ``{parameter_name: float}`` JSON in ENTERPRISE naming."""
    nd = json.loads(Path(path).read_text())
    bad = {k: v for k, v in nd.items() if not isinstance(v, (int, float))}
    if bad:
        raise ValueError(f"noisedict values must be numbers; offending keys: "
                         f"{sorted(bad)[:5]}")
    return nd


def load_custom_models(path) -> dict:
    """``{psrname: {'RN': n|None, 'DM': n|None, 'Sv': n|None}}`` JSON."""
    models = json.loads(Path(path).read_text())
    for name, entry in models.items():
        missing = {"RN", "DM", "Sv"} - set(entry)
        if missing:
            raise ValueError(f"custom_models[{name!r}] missing "
                             f"{sorted(missing)}")
    return models


class EnsembleCheckpoint:
    """Chunk-granular checkpoint/resume for :meth:`EnsembleSimulator.run`.

    Append-only: each completed chunk is written once to its own
    ``.c<k>.npz`` file and a small manifest records how far the run got,
    so the I/O per chunk is O(chunk). Because each realization's keys
    derive from ``fold_in(key(seed), absolute index)``, a resumed run
    continues the identical stream and equals the unbroken run bit for bit
    on the same device and path.

    Every file lands through :func:`write_atomic`; the manifest records a
    CRC32 per chunk file and :meth:`load` verifies them: a torn or corrupt
    chunk file rolls the checkpoint back to the last good chunk (bad files
    dropped, manifest rewritten, the rollback noted in the flight
    recorder), and the resumed run recomputes the dropped chunks.

    :meth:`save` is the ``ckpt.append`` site of the chaos harness
    (:mod:`..faults`): its ``"torn"`` action truncates the chunk file just
    written (after the manifest names it) and raises
    :class:`..faults.KillFault`, the torn write fsync cannot prevent on
    failing storage followed by process death.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._sums: dict = {}      # chunk index -> CRC32 (manifest-backed)

    def _chunk_path(self, k: int) -> Path:
        return self.path.with_name(self.path.name + f".c{k:06d}.npz")

    def _write_manifest(self, seed, nreal: int, chunk: int, done: int,
                        n_extra: int) -> None:
        n_chunks = done // chunk
        manifest = dict(seed=np.int64(seed), nreal=np.int64(nreal),
                        chunk=np.int64(chunk), done=np.int64(done),
                        n_extra=np.int64(n_extra),
                        sums=np.asarray([self._sums.get(k, 0)
                                         for k in range(n_chunks)],
                                        dtype=np.int64))
        write_atomic(self.path, npz_bytes(**manifest))

    def _rollback(self, seed, nreal: int, chunk: int, good: int,
                  total: int, n_extra: int) -> None:
        """Drop chunks ``good..total-1`` and rewrite the manifest."""
        for k in range(good, total):
            self._chunk_path(k).unlink(missing_ok=True)
            self._sums.pop(k, None)
        flightrec.note("ckpt_rollback", path=str(self.path), good=good,
                       dropped=total - good)
        if good == 0:
            self.delete()
        else:
            self._write_manifest(seed, nreal, chunk, good * chunk, n_extra)

    def load(self, seed, nreal: int, chunk: int, keep_corr: bool = True,
             n_extra: int = 0) -> Optional[dict]:
        """The saved state if it matches this run's configuration.

        Raises ``ValueError`` when the checkpoint was written by another
        (seed, nreal, chunk) or another extra-lane count, or has lost its
        chunk files. ``keep_corr=False`` skips reading the per-chunk
        correlation tensors. A chunk file whose bytes miss the manifest's
        CRC32 rolls the checkpoint back to the chunk before it
        (``state["rolled_back"]`` counts the dropped chunks); an unreadable
        manifest is noted and treated as no checkpoint.
        """
        if not self.path.exists():
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                manifest = {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile) as exc:
            flightrec.note("ckpt_manifest_corrupt", path=str(self.path),
                           error=repr(exc)[:200])
            self.delete()
            return None
        if (int(manifest["seed"]) != int(seed)
                or int(manifest["nreal"]) != nreal
                or int(manifest["chunk"]) != chunk):
            raise ValueError(
                f"checkpoint {self.path} was written by a different run "
                f"(seed/nreal/chunk = {int(manifest['seed'])}/"
                f"{int(manifest['nreal'])}/{int(manifest['chunk'])}, requested "
                f"{seed}/{nreal}/{chunk}); delete it or use a different path")
        saved_extra = int(manifest.get("n_extra", 0))
        if saved_extra != int(n_extra):
            raise ValueError(
                f"checkpoint {self.path} carries {saved_extra} extra "
                f"statistic lane(s) but this run expects {n_extra} (a "
                f"different os= configuration); delete it or use a "
                f"different path")
        done = int(manifest["done"])
        if done and not self._chunk_path(0).exists():
            raise ValueError(
                f"checkpoint {self.path} has no chunk files (written by an "
                f"older single-file format, or the .c*.npz files were removed); "
                f"delete it and restart the run")
        sums = manifest.get("sums")
        total = done // chunk
        parts = []
        good = total
        self._sums = {}
        for k in range(total):
            try:
                data = self._chunk_path(k).read_bytes()
                crc = zlib.crc32(data)
                if sums is not None and k < len(sums) and crc != int(sums[k]):
                    raise ValueError(
                        f"chunk {k} checksum mismatch (torn write)")
                with np.load(io.BytesIO(data), allow_pickle=False) as z:
                    keys = [key for key in z.files
                            if keep_corr or key != "corr"]
                    parts.append({key: z[key] for key in keys})
                self._sums[k] = crc
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile) as exc:
                flightrec.note("ckpt_chunk_corrupt", chunk=k,
                               error=repr(exc)[:200])
                good = k
                parts = parts[:good]
                break
        if good < total:
            self._rollback(seed, nreal, chunk, good, total, saved_extra)
            done = good * chunk
            if good == 0:
                return None
        state = {
            "done": done,
            "rolled_back": total - good,
            "curves": np.concatenate([p["curves"] for p in parts]),
            "autos": np.concatenate([p["autos"] for p in parts]),
        }
        if parts and all("corr" in p for p in parts):
            state["corr"] = np.concatenate([p["corr"] for p in parts])
        if parts and all("extra" in p for p in parts):
            state["extra"] = np.concatenate([p["extra"] for p in parts])
        return state

    def save(self, seed, nreal: int, chunk: int, done: int, curves, autos,
             corr=None, extra=None):
        """Record one completed chunk (its arrays only). The chunk file
        and then the manifest, which carries the chunk CRCs, are both
        written atomically; a crash between the two leaves an unreferenced
        chunk file that the next save overwrites."""
        from .. import faults
        self.path.parent.mkdir(parents=True, exist_ok=True)
        act = faults.check("ckpt.append", done=int(done))
        payload = dict(curves=curves, autos=autos)
        if corr is not None:
            payload["corr"] = corr
        if extra is not None:
            payload["extra"] = extra
        k = done // chunk - 1
        cpath = self._chunk_path(k)
        self._sums[k] = write_atomic(cpath, npz_bytes(**payload))
        self._write_manifest(seed, nreal, chunk, done,
                             0 if extra is None else np.shape(extra)[1])
        if act == "torn":
            # chaos harness: the torn write (storage dropping the pages
            # after the rename became durable) and the process dying with
            # it; a resume must see the bad CRC and roll back
            data = cpath.read_bytes()
            cpath.write_bytes(data[:max(len(data) // 2, 1)])
            raise faults.KillFault(
                f"injected torn checkpoint write at chunk {k}")

    def delete(self):
        for p in self.path.parent.glob(self.path.name + ".c*.npz"):
            p.unlink(missing_ok=True)
        self.path.unlink(missing_ok=True)
        self._sums = {}
