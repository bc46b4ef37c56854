"""Golden-run harness: one bench-schema row per registered scenario (port of
fakepta_tpu.scenarios.golden).

``golden_run(name)`` drives a scenario through the production lanes:
ensemble simulation (steady real/s/chip, ``peak_hbm_bytes``, recovery
counters), the batched-MCMC sampler (ESS/s/chip), the serving scheduler
(SLO latencies, bit-verified answers) and the telescope-cadence streaming
tail (append latencies, the append-equals-restage oracle, the
zero-recompile contract). It returns ONE flat JSON row with the JAX
package's keys: the standard metric keys plus the scenario headline keys
(``scenario``, ``scn_real_per_s_per_chip``, ``scn_ess_per_s_per_chip``,
``scn_peak_hbm_bytes``, ``scn_append_p99_ms``). ``obs gate`` bands it
only against same-scenario, same-platform history.

``memory_lane()`` is the scaling check: sweep n_psr at a fixed chunk under
``psr`` sharding and hold the CUDA allocator's peak to the engine's
analytic ``chunk_bytes_model`` plus its fixed term (the library workspaces
present on the card, the engine's ``static_reservation_bytes``) within
:data:`MEM_BOUND_FACTOR` up to the ``ska_10k`` endpoint. The port keeps no
host-side watermark (the JAX engine's CPU stand-in is its static
reservation plus the packed ledger), so the lane runs on cards only and
raises on a host mesh: a ratio of 0 would pass the bound without
measuring anything.

Devices: every entry point runs on the card unless the caller asks for the
CPU. ``golden_run`` meshes ``["cuda"]`` by default (``device=`` or
``mesh=`` otherwise); ``reduced=None`` runs each scenario's
:meth:`Scenario.reduced` rendition on a host mesh and the full spec on a
card, and the stream lane runs on the golden run's own device. Nothing
falls back to the CPU: a failed lane or oracle raises.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import resource
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..obs.timing import now
from . import cadence as cadence_mod
from . import registry

#: Declared memory-lane bound: the per-device allocator peak must stay
#: within this factor of the engine's analytic per-device
#: ``model_bytes_per_chunk`` plus its fixed ``static_reservation_bytes`` at
#: every sweep point. The slack covers what the chunk model excludes (the
#: resident batch arrays, basis and phi staging, the statistic weights).
MEM_BOUND_FACTOR = 3.0

#: Oracle tolerance for the cadence stream lane: the float64 append
#: accumulation against a full restage of the same store (summation-order
#: differences only).
ORACLE_RTOL = 1e-7


def _mesh_for(mesh, device: DeviceLike):
    from ..parallel.mesh import make_mesh

    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    if mesh is None:
        mesh = make_mesh(["cuda" if device is None else device])
    return mesh


def _platform(mesh) -> str:
    """The fingerprint platform of the mesh's own devices: ``'gpu'`` on
    the card, ``'cpu'`` on a host mesh."""
    from ..tune import fingerprint
    return fingerprint(mesh.local_devices).platform


def _percentile(vals: Sequence[float], q: float) -> float:
    # fakepta: allow[dtype-policy] host latency percentiles
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q)) \
        if len(vals) else 0.0


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def cadence_stream_lane(scn, *, mesh=None, device: DeviceLike = None,
                        history_frac: float = 0.85,
                        max_blocks: Optional[int] = 12,
                        nbin: int = 8, seed: int = 0) -> dict:
    """Drive a stream with the scenario's telescope-cadence append tail.

    Bulk history (everything before ``history_frac``) stages first; the
    cadence tail then replays as uneven observing-window blocks. The
    stream runs on ``mesh`` or ``device`` (default ``"cuda"``); its
    float64 template stays on the host (grids only). Checked here:

    - **append = restage**: the accumulated moments match a full
      recompute from the raw store (:data:`ORACLE_RTOL`);
    - **zero recompiles**: ``recompiles == 0``, as the JAX lane checks it
      (the port counts builds at its kernel cache, so it is 0 by
      construction).

    Returns the bench-row fragment (``append_latency_ms``,
    ``scn_append_p99_ms``, ``stream_*`` shape facts, ``oracle_ok``).
    """
    from ..stream.state import StreamState, default_stream_model

    # fakepta: allow[dtype-policy] the stream's f64 template stays on the host
    template = scn.batch_parts(dtype=torch.float64, device="cpu")[0]
    ecorr_dt = (scn.ecorr_dt_days * cadence_mod.DAY_S
                if scn.ecorr else None)
    stream = StreamState(template, default_stream_model(nbin=nbin),
                         ecorr_dt=ecorr_dt, mesh=mesh, device=device)

    rng = np.random.default_rng((seed, 0xA99))
    hist = cadence_mod.history_block(scn, history_frac)
    stream.append(hist.toas, rng.normal(0.0, scn.toaerr, hist.toas.shape),
                  freqs=hist.freqs, counts=hist.counts)

    blocks = cadence_mod.append_schedule(scn, history_frac,
                                         max_blocks=max_blocks)
    latencies = []
    for blk in blocks:
        res = rng.normal(0.0, scn.toaerr, blk.toas.shape)
        stats = stream.append(blk.toas, res, freqs=blk.freqs,
                              counts=blk.counts)
        latencies.append(stats["latency_ms"])

    got = [_host(x) for x in stream.moments()]
    want = [_host(x) for x in stream.restage_moments()]
    oracle_ok = True
    for g, w in zip(got, want):
        scale = np.max(np.abs(w)) or 1.0
        if not np.allclose(g, w, rtol=ORACLE_RTOL,
                           atol=ORACLE_RTOL * scale):
            oracle_ok = False
    return {
        "append_latency_ms": round(_percentile(latencies, 50), 3),
        "scn_append_p99_ms": round(_percentile(latencies, 99), 3),
        "stream_appends": int(stream.appends),
        "stream_toas": int(np.sum(stream._n)),
        "stream_rebuckets": int(stream.rebuckets),
        "stream_recompiles": int(stream.recompiles),
        "stream_compiles": int(stream.compiles),
        "oracle_ok": bool(oracle_ok),
    }


def golden_run(name: str, *, mesh=None, device: DeviceLike = None,
               reduced: Optional[bool] = None,
               nreal: int = 64, chunk: int = 32,
               sample_steps: int = 96, sample_warmup: int = 48,
               sample_chains: int = 8, serve_requests: int = 32,
               max_append_blocks: Optional[int] = 12,
               skip: Sequence[str] = (), seed: int = 1,
               report_path=None) -> dict:
    """Run one scenario through every lane; return the bench-schema row.

    ``skip`` drops lanes by name (``"sample"``, ``"serve"``,
    ``"stream"``); the ensemble lane always runs (it is the scenario).
    The lanes run on ``mesh``, else on ``device`` (default ``"cuda"``).
    ``reduced=None`` reduces on a host mesh only. ``report_path`` also
    saves the ensemble lane's RunReport .jsonl, the artifact ``obs
    summarize|compare|trace`` read.
    """
    mesh = _mesh_for(mesh, device)
    scn_full = registry.get(name)
    platform = _platform(mesh)
    if reduced is None:
        reduced = platform == "cpu"
    scn = scn_full.reduced() if reduced else scn_full
    n_devices = int(np.prod(list(mesh.shape.values())))

    # --- ensemble lane (always): the scenario through the ordinary
    # EnsembleSimulator path, its default statistic path
    sim = scn.build(mesh=mesh)
    warm = sim.run(chunk, seed=99, chunk=chunk)
    out = sim.run(nreal, seed=seed, chunk=chunk)
    if out["curves"].shape[0] != nreal or \
            not np.all(np.isfinite(out["curves"])):
        raise RuntimeError(f"scenario {name}: wrong-shaped or non-finite "
                           f"ensemble output")
    rep = out["report"]
    rep_sum = rep.summary()
    steady = round(rep.steady_real_per_s_per_chip(), 2)
    row = {
        "metric": f"scenario golden run ({name})",
        "value": steady,
        "unit": "realizations/s/chip",
        "platform": platform,
        "scenario": name,
        "spec_hash": scn_full.spec_hash(),
        "compile_s": round(warm["report"].compile_s, 3),
        "steady_real_per_s_per_chip": steady,
        "scn_real_per_s_per_chip": steady,
        "retraces": rep.retraces,
        "pipeline_depth": rep_sum.get("pipeline_depth", 0),
        "pipeline_stall_s": rep_sum.get("pipeline_stall_s", 0.0),
        "ckpt_wait_s": rep_sum.get("ckpt_wait_s", 0.0),
    }
    if rep_sum.get("model_bytes_per_chunk"):
        row["model_bytes_per_chunk"] = rep_sum["model_bytes_per_chunk"]
    if rep_sum.get("peak_hbm_bytes"):
        row["peak_hbm_bytes"] = rep_sum["peak_hbm_bytes"]
        row["scn_peak_hbm_bytes"] = rep_sum["peak_hbm_bytes"]
    for key, counter in (("faults_retries", "faults.retries"),
                         ("faults_degradations", "faults.degradations"),
                         ("faults_rollbacks", "faults.rollbacks")):
        row[key] = int(rep.counters.get(counter, 0))
    if report_path is not None:
        rep.meta.setdefault("scenario", name)
        rep.meta.setdefault("platform", platform)
        rep.save(report_path)

    # --- sampler lane: the CURN free-spectrum posterior on the
    # scenario's array
    if "sample" not in skip:
        from ..infer import ComponentSpec, FreeParam, LikelihoodSpec
        from ..sample import SampleSpec, SamplingRun
        s_model = LikelihoodSpec(components=(
            ComponentSpec(target="red", spectrum="batch"),
            ComponentSpec(target="dm", spectrum="batch"),
            ComponentSpec(target="curn", nbin=min(6, scn.gwb_ncomp or 6),
                          spectrum="free_spectrum", free=(
                              FreeParam("log10_rho", (-9.0, -5.0),
                                        per_bin=True),)),
        ))
        s_spec = SampleSpec(model=s_model, n_chains=sample_chains,
                            n_temps=2, step_size=0.35, n_leapfrog=10,
                            thin=2, warmup=sample_warmup)
        s_out = SamplingRun(sim.batch, s_spec, mesh=mesh, data_seed=7).run(
            sample_steps, seed=7, segment=min(sample_steps, 64))
        for key in ("ess_per_s_per_chip", "rhat_max", "accept_rate"):
            if key in s_out["summary"]:
                row[key] = s_out["summary"][key]
        row["scn_ess_per_s_per_chip"] = row.get("ess_per_s_per_chip", 0.0)

    # --- serving lane: the scenario's nearest ArraySpec family through
    # the warm pool and the coalescing scheduler (SLO latencies; a
    # verified answer equals its request served alone bit for bit)
    if "serve" not in skip:
        from ..serve import ServeConfig, run_loadgen
        buckets = tuple(b for b in (max(1, n_devices), 16, 128)
                        if b % n_devices == 0) or (n_devices,)
        serve_row = run_loadgen(
            spec=scn.serve_spec(), mesh=mesh, n_requests=serve_requests,
            sizes=(1, 2, 4), kind="sim", baseline=False, verify=1,
            seed=5, config=ServeConfig(buckets=buckets))
        for key in ("serve_qps_per_chip", "serve_p50_ms", "serve_p99_ms",
                    "coalesce_factor", "pad_waste_frac", "serve_retraces",
                    "serve_steady_compiles"):
            if key in serve_row:
                row[key] = serve_row[key]

    # --- streaming lane: the scenario's own cadence tail as append
    # traffic, on the golden run's own device
    if "stream" not in skip:
        stream_row = cadence_stream_lane(scn, device=mesh.local_device,
                                         max_blocks=max_append_blocks)
        if not stream_row.pop("oracle_ok"):
            raise RuntimeError(f"scenario {name}: append/restage oracle "
                               f"diverged beyond rtol={ORACLE_RTOL}")
        if stream_row["stream_recompiles"]:
            raise RuntimeError(
                f"scenario {name}: {stream_row['stream_recompiles']} "
                f"unexpected stream recompile(s) under the cadence tail "
                f"(the bucket ladder stopped covering the traffic)")
        row.update(stream_row)

    return row


def sweep_plan(npsr: int, n_devices: int,
               psr_shards: Optional[int] = None,
               sweep: Optional[Sequence[int]] = None
               ) -> Tuple[int, Tuple[int, ...]]:
    """``(psr_shards, sweep)`` of the memory lane, the JAX lane's rule:
    the most psr shards in (8, 4, 2, 1) that divide ``n_devices``, and
    by default the sweep ``{s, 2 s, 4 s, npsr}`` of the multiples of the
    shard count ``s`` up to the scenario's ``npsr``."""
    if psr_shards is None:
        psr_shards = max(d for d in (8, 4, 2, 1) if n_devices % d == 0)
    if sweep is None:
        sweep = sorted({n for n in (psr_shards, 2 * psr_shards,
                                    4 * psr_shards, npsr)
                        if n <= npsr and n % psr_shards == 0})
    return int(psr_shards), tuple(int(n) for n in sweep)


def _cards(devices) -> list:
    """The distinct devices of ``devices`` (default every visible card);
    raises on a host device."""
    from ..device import resolve_device
    from ..parallel.mesh import global_devices

    if devices is None:
        resolve_device(None)       # no card: the port's usual message
        devices = [e.device for e in global_devices()]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type != "cuda":
            raise ValueError(
                f"memory_lane holds the CUDA allocator's peak to the chunk "
                f"model; a host device ({dev}) has no such watermark (the "
                f"port keeps no static reservation), so its ratio would "
                f"read 0 and pass the bound without measuring anything: "
                f"run the lane on the card")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev not in out:
            out.append(dev)
    return out


def _host_ram_bytes() -> int:
    """This machine's physical memory."""
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def _host_peak_bytes() -> int:
    """This process's resident-set peak so far (``ru_maxrss``)."""
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def lane_point(report, npsr: int, chunk: int,
               bound_factor: float = MEM_BOUND_FACTOR) -> dict:
    """One memory-lane point from a run's report: the raw allocator peak,
    the chunk model, the fixed library workspaces inside the peak, and
    ``ratio = peak / (model + static)``, ``ok`` when it is above 0 and at
    most ``bound_factor``."""
    summary = report.summary()
    peak = float(summary.get("peak_hbm_bytes") or 0.0)
    model = float(summary.get("model_bytes_per_chunk") or 0.0)
    static = float(report.memory.get("static_reservation_bytes") or 0.0)
    ratio = peak / (model + static) if model else float("inf")
    return {"npsr": int(npsr), "chunk": int(chunk),
            "peak_hbm_bytes": peak, "model_bytes_per_chunk": model,
            "static_reservation_bytes": static,
            "ratio": round(ratio, 3),
            "ok": bool(model and 0.0 < ratio <= bound_factor)}


def memory_lane(name: str = "ska_10k", *, chunk: int = 32,
                sweep: Optional[Sequence[int]] = None,
                psr_shards: Optional[int] = None,
                ntoa_cap: Optional[int] = None,
                bound_factor: float = MEM_BOUND_FACTOR,
                seed: int = 5, devices=None) -> dict:
    """Allocator peak against n_psr at a fixed chunk under ``psr``
    sharding, on the cards ``devices`` (default every visible card; a host
    device raises).

    Each sweep point rebuilds the scenario at that population size (same
    cadence, same noise menu), runs one chunk through the engine's default
    path and compares the run's allocator peak (``peak_hbm_bytes``, the
    max over the mesh's cards) with the engine's analytic per-device
    ``model_bytes_per_chunk`` plus the fixed library workspaces the run
    reports on that peak's card (``static_reservation_bytes``: cuBLAS's
    and cuBLASLt's, one set per (thread, stream) that ran a product in the
    process, which the peak counts whatever the run's size; the JAX lane's
    stat-less watermark is its static reservation plus the model's extra
    bytes). A run that could not measure the term reports none, and the
    lane then raises. The contract: ``ratio = peak / (model + static) <= bound_factor`` and
    ``ratio > 0`` at every point through the scenario's endpoint; each
    point keeps the raw peak and the fixed term beside the ratio. Each
    point also carries the bytes allocated on the cards once the simulator
    is built (``resident_bytes``: the peak less them is the run's working
    set), its build seconds and the process's host peak so far; the lane
    carries the machine's RAM. ``psr_shards`` and the sweep
    follow :func:`sweep_plan` with the distinct cards as the device
    count.
    """
    from ..parallel.mesh import make_mesh

    base = registry.get(name)
    cards = _cards(devices)
    if ntoa_cap is not None and base.cadence != "uniform":
        base = dataclasses.replace(
            base, cadence_thin=max(base.cadence_thin, math.ceil(
                base.ntoa / ntoa_cap)))
    psr_shards, sweep = sweep_plan(base.npsr, len(cards), psr_shards, sweep)
    mesh = make_mesh(cards, psr_shards=psr_shards)
    platform = _platform(mesh)
    points = []
    for n in sweep:
        scn_n = dataclasses.replace(base, npsr=int(n))
        t0 = now()
        sim = scn_n.build(mesh=mesh)
        build_s = now() - t0
        resident = max(torch.cuda.memory_allocated(d) for d in cards)
        out = sim.run(chunk, seed=seed, chunk=chunk)
        if "static_reservation_bytes" not in out["report"].memory:
            raise RuntimeError(
                f"the {n}-pulsar run reported no fixed term (the library "
                f"workspace sizes could not be measured on {cards}): its "
                f"peak cannot be held to the model")
        points.append(lane_point(out["report"], n, chunk, bound_factor))
        points[-1].update({
            "resident_bytes": float(resident),
            "build_s": round(build_s, 3),
            "host_peak_bytes": _host_peak_bytes(),
        })
        del sim, out
        gc.collect()
        torch.cuda.empty_cache()
    return {
        "scenario": name, "platform": platform,
        "psr_shards": int(psr_shards), "chunk": int(chunk),
        "bound_factor": float(bound_factor),
        "host_ram_bytes": _host_ram_bytes(),
        "points": points,
        "ok": bool(points) and all(p["ok"] for p in points),
    }


def save_row(row: dict, path) -> None:
    """One bench-schema JSON line: the artifact ``python -m
    fakepta_tpu_torch.obs gate`` loads."""
    with open(path, "w") as fh:
        fh.write(json.dumps(row) + "\n")
