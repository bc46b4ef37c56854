"""Search orchestration: fingerprint -> model frontier -> probes -> store
(port of ``fakepta_tpu.tune.search``).

:func:`search` is the whole tuner: fingerprint the devices
(:mod:`.fingerprint`), prune the knob space with the analytic models
(:mod:`.model`), measure the surviving frontier with short probes
(:mod:`.probe`) under a wall-clock budget, persist the winner
(:mod:`.store`), and emit an obs-readable artifact. A warm store returns
in one file read with zero probes.

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
    performs zero probes. A multi-process mesh raises
    ``NotImplementedError``; ``run(tuned=...)`` works on every mesh.
    """
    from ..parallel.mesh import (MeshDevice, global_devices, make_mesh,
                                 process_index)
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
    me = process_index()
    if any(isinstance(d, MeshDevice) and d.rank != me for d in devices):
        raise NotImplementedError(
            "tune.search() probes on one process; a multi-process mesh is "
            "not tuned yet (ROADMAP Queue 1 item 11b.1); run(tuned=...) "
            "takes a TunedConfig on every mesh")
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
    surf = base_sim.dispatch_surface()
    family = family_for_surface(surf)
    if not force:
        hit = tstore.lookup(fp, family)
        if hit is not None:
            flightrec.note("tune_warm_hit", family=family, fp=fp.hash)
            info = {"probes": 0, "probe_s": 0.0, "warm": True,
                    "records": []}
            if artifact:
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
        # frontier[0], is always probed)
        if i > 0 and now() - t0 + last_probe_s > budget_s:
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
    if not records:
        raise RuntimeError(
            f"tune search probed {attempted} candidate(s) and none "
            f"completed; refusing to persist a guess (see the flight "
            f"recorder's tune_probe_failed / tune_probe_degraded notes)")

    default = default_candidate(nreal_hint, len(devices))

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
        n_real_shards=len(devices), dtype_bytes=surf["dtype_bytes"]))
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
    cfg = TunedConfig(fingerprint=fp.as_dict(), family=family,
                      knobs=knobs, metrics=metrics)
    store_path = tstore.put(cfg)
    info = {"probes": attempted, "probe_s": probe_s, "warm": False,
            "records": [dict(r, knobs=c.knobs()) for c, r in records],
            "store_path": store_path}
    if artifact:
        _write_artifact(artifact, fp, family, records, cfg, info)
    return cfg, info


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
    read and zero probes."""
    fp = fingerprint(mesh_entries(sim.mesh))
    family = family_for_surface(sim.dispatch_surface())
    return _as_store(store).lookup(fp, family)


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
