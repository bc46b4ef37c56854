"""Search orchestration: fingerprint -> model frontier -> probes -> store
(port of ``fakepta_tpu.tune.search``).

:func:`search` is the whole tuner: fingerprint the devices
(:mod:`.fingerprint`), prune the knob space with the analytic models
(:mod:`.model`), measure the surviving frontier with short probes
(:mod:`.probe`) under a wall-clock budget, persist the winner
(:mod:`.store`), and emit an obs-readable artifact. A warm store returns
in one file read with zero probes.

Across ranks (a mesh that spans processes) every rank calls
:func:`search` with the same arguments, as every rank calls ``run()``:
the frontier comes from the global fingerprint, every probe is a
collective ``run()`` of the same candidate in the same order, and the
lead rank (the owner of the probe mesh's first entry) makes every
timing decision (the warm-store hit, the predictive budget stop, the
winner) and sends it on the group's host transport before the next
probe (:meth:`..parallel.mesh.Mesh.agreement`), so no rank's own clock
can split the ranks. The lead alone writes the store entry and the
artifact; every rank returns the lead's :class:`.store.TunedConfig`. A
probe's ``tune.probe`` chaos site (:mod:`..faults`) fires inside that
exchange, so a fault on one rank raises on every rank before the probe
runs.

The ``resolve_*`` helpers are the consumption surface:
``EnsembleSimulator.run(tuned=True)`` resolves per spec family, and
``SamplingRun.run(tuned=True)`` resolves the platform-shaped pipeline
depth from the newest entry for the fingerprint. A simulator resolves
against the fingerprint of its own mesh's devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..obs import flightrec
from ..obs.timing import now
from . import defaults
from .fingerprint import Fingerprint, family_hash, fingerprint
from .model import (Candidate, bucket_ladder, candidate_frontier,
                    default_candidate, overshoot_factor)
from .probe import run_probe
from .store import TunedConfig, TuneStore


def _as_store(store) -> TuneStore:
    return store if isinstance(store, TuneStore) else TuneStore(store)


def mesh_entries(mesh) -> list:
    """A mesh's entries as :class:`..parallel.mesh.MeshDevice` pairs (what
    :func:`.fingerprint.fingerprint` takes)."""
    from ..parallel.mesh import MeshDevice

    return [MeshDevice(int(r), d) for d, r in zip(mesh.devices.flat,
                                                   mesh.ranks.flat)]


def _shared_lookup(tstore: TuneStore, mesh, fp: Fingerprint,
                   family: str) -> Optional[TunedConfig]:
    """The store entry for ``fp`` x ``family`` as the lead rank of
    ``mesh`` reads it, on every rank (one process: a plain lookup), so
    ranks whose store files differ still take one decision."""
    with mesh.agreement("tune store lookup") as agreed:
        if mesh.rank == mesh.lead:
            hit = tstore.lookup(fp, family)
            agreed.value = None if hit is None else hit.to_json()
    got = agreed.lead_value
    return None if got is None else TunedConfig.from_json(got)


def family_for_surface(surf: dict) -> str:
    """The spec-family hash of an engine dispatch surface
    (:meth:`..parallel.montecarlo.EnsembleSimulator.dispatch_surface`)."""
    return family_hash(npsr=surf["npsr"], max_toa=surf["max_toa"],
                       nbins=surf["nbins"], k_coef=surf["k_coef"],
                       dtype=surf["dtype"])


def search(batch=None, *, gwb=None, include=None, nbins: int = 15,
           spec=None, mesh_devices: Optional[Sequence] = None,
           nreal_hint: int = 4096, budget_s: Optional[float] = None,
           probe_chunks: int = defaults.PROBE_CHUNKS,
           probe_timeout_s: float = defaults.PROBE_TIMEOUT_S,
           max_candidates: int = 12, store=None, force: bool = False,
           seed: int = 2024, artifact=None) -> Tuple[TunedConfig, dict]:
    """Tune the dispatch knobs for one ensemble spec on these devices.

    Pass either ``batch`` (with ``gwb`` / ``include`` / ``nbins``, the
    :class:`..parallel.montecarlo.EnsembleSimulator` constructor surface)
    or a :class:`..serve.ArraySpec` as ``spec``. ``mesh_devices``: the
    mesh entries the probes run on (default
    :func:`..parallel.mesh.global_devices`, every visible card; pass
    ``["cpu"] * 8`` for eight shards on the CPU). Its entry count is the
    frontier's device count (the shards); the fingerprint counts the
    physical devices. Returns ``(TunedConfig, info)``, ``info`` carrying
    ``probes`` / ``probe_s`` / ``warm`` / the per-candidate records. With
    a warm store (same fingerprint x family, not ``force``) the search
    performs zero probes. On a mesh that spans processes every rank
    calls it alike and gets the same result (module docstring); ``info``
    then holds this rank's own probe records and times.
    """
    from .. import faults
    from ..parallel.mesh import global_devices, make_mesh
    from ..parallel.montecarlo import EnsembleSimulator

    t0 = now()
    if spec is not None:
        if batch is not None:
            raise ValueError("pass batch=... or spec=..., not both")
        batch, gwb = spec.parts(device="cpu")
        nbins = spec.nbins
    if batch is None:
        raise ValueError("search needs a PulsarBatch (batch=...) or a "
                         "serve ArraySpec (spec=...)")
    devices = list(mesh_devices if mesh_devices is not None
                   else global_devices())
    fp = fingerprint(devices)
    budget_s = defaults.PROBE_BUDGET_S if budget_s is None else budget_s
    tstore = _as_store(store)

    sims: dict = {}

    def sim_for(psr_shards: int):
        if psr_shards not in sims:
            kw = {} if include is None else {"include": include}
            sims[psr_shards] = EnsembleSimulator(
                batch, gwb=gwb, nbins=nbins,
                stat_path=defaults.DEFAULT_PATH,
                mesh=make_mesh(devices, psr_shards=psr_shards), **kw)
        return sims[psr_shards]

    # ONE family source: the base simulator's dispatch surface (the method
    # run(tuned=True) resolves through)
    base_sim = sim_for(1)
    mesh = base_sim.mesh
    lead = mesh.rank == mesh.lead
    surf = base_sim.dispatch_surface()
    family = family_for_surface(surf)
    if not force:
        hit = _shared_lookup(tstore, mesh, fp, family)
        if hit is not None:
            flightrec.note("tune_warm_hit", family=family, fp=fp.hash)
            info = {"probes": 0, "probe_s": 0.0, "warm": True,
                    "records": []}
            if artifact and lead:
                _write_artifact(artifact, fp, family, [], hit, info)
            return hit, info

    frontier = candidate_frontier(
        fp, surf["npsr"], surf["max_toa"], surf["k_coef"],
        nreal_hint=nreal_hint, n_devices=len(devices),
        dtype_bytes=surf["dtype_bytes"], max_candidates=max_candidates)

    records: List[Tuple[Candidate, dict]] = []
    attempted = 0
    last_probe_s = 0.0
    for i, cand in enumerate(frontier):
        # predictive budget stop: if the last probe's cost would push this
        # one past the budget, stop now (the hand-set default candidate,
        # frontier[0], is always probed); the lead's clock decides
        with mesh.agreement(f"tune probe {i}") as agreed:
            faults.check("tune.probe", idx=i)
            agreed.value = i > 0 and now() - t0 + last_probe_s > budget_s
        if agreed.lead_value:
            flightrec.note("tune_budget_exhausted", probed=attempted,
                           frontier=len(frontier))
            break
        attempted += 1
        rec = run_probe(sim_for(cand.psr_shards), cand, seed=seed,
                        probe_chunks=probe_chunks,
                        timeout_s=probe_timeout_s, nreal_cap=nreal_hint)
        if rec is not None:
            last_probe_s = rec["probe_s"]
            records.append((cand, rec))
    # the lead's records choose the winner and write the store; every
    # rank returns what it chose
    with mesh.agreement("tune choice") as agreed:
        if lead:
            cfg = _choose(records, attempted, fp, family, surf, nreal_hint,
                          len(devices), t0)
            store_path = tstore.put(cfg)
            agreed.value = (cfg.to_json(), store_path)
    got, store_path = agreed.lead_value
    cfg = TunedConfig.from_json(got)
    info = {"probes": attempted, "probe_s": now() - t0, "warm": False,
            "records": [dict(r, knobs=c.knobs()) for c, r in records],
            "store_path": store_path}
    if artifact and lead:
        _write_artifact(artifact, fp, family, records, cfg, info)
    return cfg, info


def _choose(records, attempted: int, fp: Fingerprint, family: str,
            surf: dict, nreal_hint: int, n_devices: int,
            t0: float) -> TunedConfig:
    """The winner of the probe ``records`` as a :class:`TunedConfig`."""
    if not records:
        raise RuntimeError(
            f"tune search probed {attempted} candidate(s) and none "
            f"completed; refusing to persist a guess (see the flight "
            f"recorder's tune_probe_failed / tune_probe_degraded notes)")

    default = default_candidate(nreal_hint, n_devices)

    # selection is on DELIVERED throughput at the workload scale: a chunk
    # that does not divide nreal_hint computes a truncated tail
    def delivered(cand: Candidate, rec: dict) -> float:
        return (rec["real_per_s_per_chip"]
                / overshoot_factor(cand.chunk, nreal_hint))

    best_cand, best_rec = max(records, key=lambda cr: delivered(*cr))
    default_rec = next((r for c, r in records if c == default), None)
    probe_s = now() - t0

    knobs = best_cand.knobs()
    knobs["buckets"] = list(bucket_ladder(
        fp, surf["npsr"], surf["max_toa"], surf["k_coef"],
        n_real_shards=n_devices, dtype_bytes=surf["dtype_bytes"]))
    metrics = {
        "real_per_s_per_chip": round(delivered(best_cand, best_rec), 3),
        "probes": attempted,
        "probe_s": round(probe_s, 3),
        "peak_hbm_bytes": best_rec["peak_hbm_bytes"],
    }
    if default_rec is not None:
        hand = delivered(default, default_rec)
        metrics["hand_set_real_per_s_per_chip"] = round(hand, 3)
        if hand > 0:
            metrics["speedup_x"] = round(
                delivered(best_cand, best_rec) / hand, 3)
    return TunedConfig(fingerprint=fp.as_dict(), family=family,
                       knobs=knobs, metrics=metrics)


def _write_artifact(path, fp: Fingerprint, family: str, records,
                    cfg: TunedConfig, info: dict) -> str:
    """The ``fakepta_tpu.tune/1`` artifact: an EventLog whose meta carries
    the chosen knobs and whose extra_metrics feed ``python -m
    fakepta_tpu_torch.obs summarize|compare``."""
    from ..obs.metrics import EventLog

    summary = {
        "tuned": 1,
        "tune_probe_s": round(float(info["probe_s"]), 3),
        "tune_probes": int(info["probes"]),
    }
    if cfg.metrics.get("speedup_x") is not None:
        summary["tuned_speedup_x"] = cfg.metrics["speedup_x"]
    if cfg.metrics.get("real_per_s_per_chip") is not None:
        summary["tuned_real_per_s_per_chip"] = \
            cfg.metrics["real_per_s_per_chip"]
    log = EventLog(meta={
        "kind": "tune", "tune_schema": defaults.STORE_SCHEMA,
        "platform": fp.platform, "fingerprint": fp.as_dict(),
        "family": family, "knobs": dict(cfg.knobs),
        "extra_metrics": summary,
    })
    for cand, rec in records:
        log.append("probe", knobs=cand.knobs(),
                   real_per_s_per_chip=round(
                       rec["real_per_s_per_chip"], 3),
                   probe_s=round(rec["probe_s"], 3),
                   retraces=rec["retraces"],
                   peak_hbm_bytes=rec["peak_hbm_bytes"])
    return log.save(path, summary=summary)


# ---------------------------------------------------------------------------
# consumption surface (engine / sampler / CLI)
# ---------------------------------------------------------------------------

def resolve_for_sim(sim, store=None) -> Optional[TunedConfig]:
    """The TunedConfig matching one simulator's platform (its mesh's
    devices) x family, or None: ``run(tuned=True)``'s store hook, one file
    read and zero probes (on a mesh that spans processes, the lead rank's
    read, sent to every rank, so every rank runs the same knobs)."""
    fp = fingerprint(mesh_entries(sim.mesh))
    family = family_for_surface(sim.dispatch_surface())
    return _shared_lookup(_as_store(store), sim.mesh, fp, family)


def resolve_platform_knob(name: str, store=None, default=None,
                          devices: Optional[Sequence] = None):
    """The platform-shaped knob ``name`` from the newest store entry for
    the fingerprint of ``devices`` (default: every visible card), any
    family: the pipeline depth and the serve bucket ladder are properties
    of the host/device tier, not of one spec."""
    cfg = _as_store(store).newest_for(fingerprint(devices))
    if cfg is None:
        return default
    value = cfg.knobs.get(name)
    return default if value is None else value


def resolve_buckets(store=None, devices: Optional[Sequence] = None
                    ) -> Optional[Tuple[int, ...]]:
    """Tuned serve bucket ladder for this platform, or None."""
    ladder = resolve_platform_knob("buckets", store=store, devices=devices)
    if not ladder:
        return None
    return tuple(int(b) for b in ladder)
