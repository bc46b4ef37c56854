"""Persisted TunedConfig store (port of ``fakepta_tpu.tune.store``).

One small schema-versioned JSON file holds every tuned knob set, keyed by
``<fingerprint-hash>/<family-hash>`` (platform identity x spec family,
:mod:`.fingerprint`). A warm start then skips the search: the engine's
``run(tuned=True)``, the sampler and the CLI resolve knobs with one file
read. The schema tag, version and layout are the JAX package's, so one
file may hold both packages' entries: an entry the JAX package wrote
never applies here (its fingerprint has other fields, so another hash),
and a :meth:`TuneStore.put` keeps it in the file.

Robustness contract (the same cases as the JAX package's):

- **fingerprint mismatch**: an entry written on another platform (or
  device count, or torch version) never applies; the miss is
  flight-recorded (``tune_fingerprint_mismatch``);
- **schema-version bump**: entries (or a whole file) of another tuner
  version are ignored, never reinterpreted;
- **corrupt / torn file**: a loud :class:`RuntimeWarning` and a
  flight-recorder note, then an empty store; the next search re-tunes and
  rewrites the file through :func:`..utils.io.write_atomic`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

from ..obs import flightrec
from . import defaults
from .fingerprint import Fingerprint


@dataclasses.dataclass
class TunedConfig:
    """One platform x family's chosen dispatch knobs plus provenance."""

    fingerprint: dict              # Fingerprint.as_dict() at search time
    family: str                    # spec-family hash (fingerprint.family_hash)
    knobs: dict                    # chunk / pipeline_depth / path / precision
    #                              # / psr_shards / buckets
    metrics: dict = dataclasses.field(default_factory=dict)
    schema_version: int = defaults.STORE_VERSION
    created: str = ""              # ISO-8601 stamp (provenance only)

    @property
    def fp_hash(self) -> str:
        blob = json.dumps(self.fingerprint, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def key(self) -> str:
        return f"{self.fp_hash}/{self.family}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "TunedConfig":
        return cls(fingerprint=dict(data["fingerprint"]),
                   family=str(data["family"]),
                   knobs=dict(data["knobs"]),
                   metrics=dict(data.get("metrics", {})),
                   schema_version=int(data.get("schema_version", -1)),
                   created=str(data.get("created", "")))


def default_store_path() -> Optional[Path]:
    """The store location: ``$FAKEPTA_TPU_TUNE_DIR/tuned.json`` wins, else
    ``~/.cache/fakepta_tpu_torch/tuned.json`` (the port has no compile
    cache for the file to sit beside); None when no home resolves."""
    env = os.environ.get(defaults.TUNE_DIR_ENV)
    if env:
        return Path(env) / defaults.STORE_FILENAME
    try:
        home = Path.home()
    except (OSError, RuntimeError):
        return None       # no resolvable home (sandboxed): un-persisted
    return home / ".cache" / "fakepta_tpu_torch" / defaults.STORE_FILENAME


class TuneStore:
    """Load/lookup/put over the schema-versioned store file."""

    def __init__(self, path=None):
        self.path: Optional[Path] = (Path(path) if path is not None
                                     else default_store_path())

    # -- read --------------------------------------------------------------
    def load_entries(self) -> Dict[str, dict]:
        """Raw ``key -> entry`` dict; empty (with the loud warning) on any
        corruption, missing file, or schema mismatch."""
        if self.path is None or not self.path.exists():
            return {}
        try:
            data = json.loads(self.path.read_text(encoding="utf-8"))
            if not isinstance(data, dict) or "entries" not in data:
                raise ValueError("store file has no 'entries' table")
        except (OSError, ValueError) as exc:
            # corrupt/torn store: loud, then retune
            warnings.warn(
                f"corrupt tune store {self.path}: {exc!r}; ignoring it and "
                f"re-tuning (the next search rewrites it atomically)",
                RuntimeWarning, stacklevel=2)
            flightrec.note("tune_store_corrupt", path=str(self.path),
                           error=repr(exc)[:160])
            return {}
        if data.get("schema") != defaults.STORE_SCHEMA or \
                int(data.get("version", -1)) != defaults.STORE_VERSION:
            warnings.warn(
                f"tune store {self.path} has schema "
                f"{data.get('schema')!r} v{data.get('version')!r} != "
                f"{defaults.STORE_SCHEMA!r} v{defaults.STORE_VERSION}; "
                f"ignoring it and re-tuning", RuntimeWarning, stacklevel=2)
            flightrec.note("tune_store_schema_mismatch", path=str(self.path),
                           schema=str(data.get("schema")),
                           version=data.get("version"))
            return {}
        entries = data.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def lookup(self, fp: Fingerprint, family: str) -> Optional[TunedConfig]:
        """The TunedConfig for this platform x family, or None. A
        same-family entry under another fingerprint (another platform or
        package, a resized mesh, an upgraded torch) is ignored, never
        applied, with a flight-recorder note."""
        entries = self.load_entries()
        key = f"{fp.hash}/{family}"
        raw = entries.get(key)
        if raw is not None:
            cfg = TunedConfig.from_json(raw)
            if cfg.schema_version != defaults.STORE_VERSION:
                flightrec.note("tune_entry_schema_mismatch", key=key,
                               have=cfg.schema_version,
                               want=defaults.STORE_VERSION)
                return None
            return cfg
        for other_key in entries:
            if other_key.endswith(f"/{family}"):
                flightrec.note("tune_fingerprint_mismatch", family=family,
                               want=fp.hash,
                               have=other_key.split("/", 1)[0])
                break
        return None

    # -- write -------------------------------------------------------------
    def put(self, cfg: TunedConfig) -> Optional[str]:
        """Insert/replace one entry (every other entry stays); atomic
        read-modify-write. Returns the store path, or None (recorded) when
        no store is configured."""
        if self.path is None:
            flightrec.note("tune_store_unconfigured", family=cfg.family)
            return None
        from ..utils.io import write_atomic

        if not cfg.created:
            cfg.created = time.strftime("%Y-%m-%dT%H:%M:%S")
        entries = self.load_entries()
        entries[cfg.key()] = cfg.to_json()
        payload = {"schema": defaults.STORE_SCHEMA,
                   "version": defaults.STORE_VERSION,
                   "entries": entries}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        write_atomic(self.path,
                     (json.dumps(payload, indent=1, sort_keys=True) + "\n")
                     .encode())
        flightrec.note("tune_store_put", key=cfg.key(),
                       path=str(self.path))
        return str(self.path)

    def newest_for(self, fp: Fingerprint) -> Optional[TunedConfig]:
        """The most recently created valid entry for this fingerprint (any
        family): the per-platform knob resolver (the sampler's pipeline
        depth and the serve bucket ladder are platform-shaped)."""
        best: Optional[TunedConfig] = None
        for key, raw in self.load_entries().items():
            if not key.startswith(f"{fp.hash}/"):
                continue
            try:
                cfg = TunedConfig.from_json(raw)
            except (KeyError, TypeError, ValueError):
                flightrec.note("tune_entry_unparseable", key=key)
                continue
            if cfg.schema_version != defaults.STORE_VERSION:
                continue
            if best is None or cfg.created > best.created:
                best = cfg
        return best
