"""Content-addressed result store: served responses keyed by what produced
them (port of ``fakepta_tpu.gateway.store``).

A served :class:`..serve.ServeResult` is a pure function of ``(spec_hash,
RNG-lane token, seed, n)`` on a given engine build: the serve layer's
bit-identical-per-lane contract is what makes the response
*content-addressable* at all. The store keys every entry by exactly that
tuple plus the platform/engine :class:`..tune.fingerprint.Fingerprint`, so
a repeat request is a cache hit served with zero device-seconds, and a
response produced by a different engine build can never be served as if
it were current. The port's fingerprint carries ``torch_version`` /
``cuda_version`` where the JAX one carries its jax versions, so an entry
the JAX package wrote into the same directory is a loud miss here, never
a hit (and the reverse).

Lifecycle mirrors :mod:`..tune.store`:

- **fingerprint mismatch**: an entry produced on another platform /
  device count / torch version is a loud miss-and-recompute,
  flight-recorded (``gateway_fingerprint_mismatch``) and counted
  ``gateway.cache_rejects``;
- **schema-version bump**: entries written by another store version are
  ignored, never reinterpreted (``gateway_entry_schema_mismatch``);
- **corrupt / torn payload**: a CRC mismatch between the index and the
  payload file raises a :class:`RuntimeWarning`, drops the entry, and
  recomputes (``gateway_store_corrupt_entry``); index-file corruption
  empties the store the same way the tune store does.

Payload files are one ``.npz`` per entry written through
:func:`..utils.io.write_atomic` (tmp + fsync + rename), with the returned
CRC32 recorded in the JSON index; the index itself is rewritten
atomically on every put. The in-memory decoded-payload cache and the
on-disk entry table are both explicitly bounded
(:data:`..tune.defaults.GATEWAY_RESULT_CACHE_CAP` /
:data:`..tune.defaults.GATEWAY_STORE_CAP`).
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import os
import threading
import warnings
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..obs import flightrec, metrics as obs_metrics
from ..tune import defaults as tune_defaults
from ..tune.fingerprint import Fingerprint


def request_key(spec_hash: str, lane_token, seed: int, n: int,
                fp: Fingerprint) -> str:
    """The content address of one served response:
    ``<fp-hash>/<spec-hash>/<lane-hash>/<seed>x<n>``."""
    lane = hashlib.sha1(repr(tuple(lane_token)).encode()).hexdigest()[:12]
    return f"{fp.hash}/{spec_hash}/{lane}/{int(seed)}x{int(n)}"


def default_gateway_dir() -> Optional[Path]:
    """``$FAKEPTA_TPU_GATEWAY_DIR`` wins; else a ``gateway/`` directory
    beside the tune store (:func:`..tune.store.default_store_path`:
    responses and the knobs that produced them amortize together); None
    when neither resolves."""
    env = os.environ.get(tune_defaults.GATEWAY_DIR_ENV)
    if env:
        return Path(env)
    from ..tune.store import default_store_path

    tune_path = default_store_path()
    return tune_path.parent / "gateway" if tune_path is not None else None


class ResultStore:
    """Bounded content-addressed store of served response payloads."""

    def __init__(self, path=None,
                 cache_cap: int = tune_defaults.GATEWAY_RESULT_CACHE_CAP,
                 store_cap: int = tune_defaults.GATEWAY_STORE_CAP):
        self.dir: Optional[Path] = (Path(path) if path is not None
                                    else default_gateway_dir())
        self.cache_cap = int(cache_cap)
        self.store_cap = int(store_cap)
        self._lock = threading.Lock()
        # serializes index-file writes: write_atomic stages through one
        # fixed tmp name per path, so two concurrent put()s racing their
        # os.replace would unlink each other's staged bytes. Taken BEFORE
        # _lock (the flusher re-snapshots under _lock so the last writer
        # always lands the newest index).
        self._io_lock = threading.Lock()
        self._entries: Optional[dict] = None   # key -> meta (index order =
        #                                      # insertion order = eviction)
        # decoded-payload LRU: key -> (meta, arrays); bounded at cache_cap
        self._mem: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.rejects = 0
        self.puts = 0

    # -- index -------------------------------------------------------------
    def _index_path(self) -> Optional[Path]:
        if self.dir is None:
            return None
        return self.dir / tune_defaults.GATEWAY_INDEX_FILENAME

    def _load_index(self) -> dict:
        """Raw ``key -> meta``; empty (loudly) on corruption or a schema
        bump: the tune-store contract, verbatim."""
        path = self._index_path()
        if path is None or not path.exists():
            return {}
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
            if not isinstance(data, dict) or "entries" not in data:
                raise ValueError("gateway index has no 'entries' table")
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            warnings.warn(
                f"corrupt gateway result index {path}: {exc!r}; ignoring "
                f"it and recomputing (the next put rewrites it atomically)",
                RuntimeWarning, stacklevel=2)
            flightrec.note("gateway_store_corrupt", path=str(path),
                           error=repr(exc)[:160])
            return {}
        if data.get("schema") != tune_defaults.GATEWAY_STORE_SCHEMA or \
                int(data.get("version", -1)) != \
                tune_defaults.GATEWAY_STORE_VERSION:
            warnings.warn(
                f"gateway result index {path} has schema "
                f"{data.get('schema')!r} v{data.get('version')!r} != "
                f"{tune_defaults.GATEWAY_STORE_SCHEMA!r} "
                f"v{tune_defaults.GATEWAY_STORE_VERSION}; ignoring it",
                RuntimeWarning, stacklevel=2)
            flightrec.note("gateway_store_schema_mismatch", path=str(path),
                           schema=str(data.get("schema")),
                           version=data.get("version"))
            return {}
        entries = data.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def _entries_locked(self) -> dict:
        if self._entries is None:
            self._entries = self._load_index()
        return self._entries

    def _write_index(self, entries: dict) -> None:
        path = self._index_path()
        if path is None:
            return
        from ..utils.io import write_atomic

        payload = {"schema": tune_defaults.GATEWAY_STORE_SCHEMA,
                   "version": tune_defaults.GATEWAY_STORE_VERSION,
                   "entries": entries}
        path.parent.mkdir(parents=True, exist_ok=True)
        write_atomic(path,
                     (json.dumps(payload, indent=1, sort_keys=True) + "\n")
                     .encode())

    def _flush_index(self) -> None:
        """Persist the index under the IO lock, re-snapshotting so the
        last writer always lands a state at least as new as its own
        insert: concurrent put()s can't clobber each other's entries or
        race write_atomic's staged tmp file."""
        with self._io_lock:
            with self._lock:
                snapshot = dict(self._entries_locked())
            self._write_index(snapshot)

    def _payload_path(self, key: str) -> Optional[Path]:
        if self.dir is None:
            return None
        h = hashlib.sha1(key.encode()).hexdigest()[:20]
        return self.dir / f"{h}.npz"

    # -- read --------------------------------------------------------------
    def _reject(self, note: str, **ctx) -> None:
        with self._lock:
            self.rejects += 1
        obs_metrics.count("gateway.cache_rejects")
        flightrec.note(note, **ctx)

    def get(self, key: str, fp: Fingerprint,
            spec_hash: str) -> Optional[Tuple[dict, dict]]:
        """``(meta, arrays)`` for a valid entry, else None.

        Every miss path that *could* have been a hit is loud: a
        fingerprint or schema mismatch and a torn payload are
        flight-recorded and counted ``gateway.cache_rejects``: a stale or
        corrupt response is never served.
        """
        with self._lock:
            cached = self._mem.get(key)
            if cached is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                return cached
            meta = self._entries_locked().get(key)
        if meta is None:
            # same spec/lane under another fingerprint: the diagnosable
            # near-miss (new platform / torch bump, or the JAX package's
            # entry), mirrored from the tune store's lookup
            tail = key.split("/", 1)[1] if "/" in key else key
            with self._lock:
                near = next((other for other in self._entries_locked()
                             if other.endswith(tail) and other != key),
                            None)
            if near is not None:
                self._reject("gateway_fingerprint_mismatch", want=fp.hash,
                             have=near.split("/", 1)[0],
                             spec_hash=spec_hash)
            return None
        if int(meta.get("version", -1)) != \
                tune_defaults.GATEWAY_STORE_VERSION or \
                meta.get("schema") != tune_defaults.GATEWAY_STORE_SCHEMA:
            self._reject("gateway_entry_schema_mismatch", key=key,
                         have=str(meta.get("schema")),
                         version=meta.get("version"))
            return None
        if meta.get("fp") != fp.hash:
            self._reject("gateway_fingerprint_mismatch", key=key,
                         want=fp.hash, have=str(meta.get("fp")))
            return None
        if meta.get("spec_hash") != spec_hash:
            self._reject("gateway_entry_spec_mismatch", key=key,
                         want=spec_hash, have=str(meta.get("spec_hash")))
            return None
        path = self._payload_path(key)
        try:
            blob = path.read_bytes()
        except OSError as exc:
            self._drop(key)
            self._reject("gateway_store_missing_payload", key=key,
                         error=repr(exc)[:160])
            return None
        if zlib.crc32(blob) != int(meta.get("crc", -1)):
            warnings.warn(
                f"torn gateway result payload {path} (CRC mismatch); "
                f"dropping the entry and recomputing",
                RuntimeWarning, stacklevel=2)
            self._drop(key)
            self._reject("gateway_store_corrupt_entry", key=key,
                         path=str(path))
            return None
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as npz:
                arrays = {k: np.asarray(npz[k]) for k in npz.files}
        except (OSError, ValueError) as exc:
            self._drop(key)
            self._reject("gateway_store_corrupt_entry", key=key,
                         error=repr(exc)[:160])
            return None
        entry = (dict(meta), arrays)
        with self._lock:
            self._mem[key] = entry
            self._mem.move_to_end(key)
            while len(self._mem) > self.cache_cap:
                self._mem.popitem(last=False)
            self.hits += 1
        return entry

    def _drop(self, key: str) -> None:
        """Forget one entry (bad payload); index rewritten on next put."""
        with self._lock:
            self._entries_locked().pop(key, None)
            self._mem.pop(key, None)

    # -- write -------------------------------------------------------------
    def put(self, key: str, meta: dict, arrays: dict) -> Optional[str]:
        """Insert one entry: atomic payload write, CRC recorded in the
        index, oldest entries evicted past the store cap. Returns the
        payload path, or None when no store dir is configured."""
        path = self._payload_path(key)
        if path is None:
            flightrec.note("gateway_store_unconfigured", key=key)
            return None
        from ..utils.io import npz_bytes, write_atomic

        blob = npz_bytes(**arrays)
        path.parent.mkdir(parents=True, exist_ok=True)
        crc = write_atomic(path, blob)
        full = dict(meta, crc=int(crc),
                    schema=tune_defaults.GATEWAY_STORE_SCHEMA,
                    version=tune_defaults.GATEWAY_STORE_VERSION)
        evicted = []
        with self._lock:
            entries = self._entries_locked()
            entries.pop(key, None)
            entries[key] = full
            self._mem[key] = (dict(full), dict(arrays))
            self._mem.move_to_end(key)
            while len(self._mem) > self.cache_cap:
                self._mem.popitem(last=False)
            while len(entries) > self.store_cap:
                old_key = next(iter(entries))
                entries.pop(old_key)
                self._mem.pop(old_key, None)
                evicted.append(old_key)
            self.puts += 1
        for old_key in evicted:
            obs_metrics.count("gateway.store_evictions")
            old_path = self._payload_path(old_key)
            try:
                old_path.unlink()
            except OSError:
                pass              # index no longer references it: harmless
        self._flush_index()
        obs_metrics.count("gateway.store_puts")
        flightrec.note("gateway_store_put", key=key, path=str(path))
        return str(path)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries_locked())
