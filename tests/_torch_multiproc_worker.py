"""Worker of tests/test_torch_multiproc.py (not a pytest module).

Usage: python _torch_multiproc_worker.py <outdir> <rank> <nranks>

Joins a gloo process group through a FileStore in ``outdir`` (no TCP port,
so parallel test workers cannot collide), with four CPU entries per rank,
prints ``MULTIPROC_INIT_OK`` on stderr once the group is up, runs every
case on its multi-process mesh, and prints one JSON line: per case this
rank's outputs and, on rank 0, the outputs of the one-process mesh of the
same global shape run in this same process (same torch thread count).

The engine configuration is tests/_multihost_worker.py's (the JAX package's
two-process test), so the test's JAX oracle and these ranks cannot drift
apart; the sampler's is tests/test_torch_sample.py's and the stream's
tests/test_stream.py's, restated here because those modules import JAX.
"""

import json
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

# one source for the workers and the test's oracles
NRANKS = 2
LOCAL = 4                         # CPU entries per rank
OS_ORFS = ("hd", "monopole", "dipole")
THETA_SHAPE = (2, 2)
SAMPLE_BATCH = dict(npsr=4, ntoa=48, tspan_years=15.0, toaerr=1e-7,
                    n_red=3, n_dm=3, red_log10_A=-14.5, dm_log10_A=-14.5,
                    seed=0)
SAMPLE_SPEC = dict(n_chains=8, n_temps=2, warmup=8, thin=2, n_leapfrog=3)
SAMPLE_RUN = dict(seed=3, segment=8)
SAMPLE_STEPS = 16
SAMPLE_TRUTH = (-13.2, 13 / 3)
#: the sampler's toa cases; the chains do not depend on the mesh, so one
#: one-process run (real 2 x psr 2 x toa 2) is both cases' reference
SAMPLE_TOA = ("toa_cross", "toa_only")

#: the stream: tests/test_stream.py's template, model and ragged blocks
STREAM_TEMPLATE = dict(npsr=4, ntoa=48, tspan_years=3.0, n_red=4, n_dm=4,
                       n_chrom=2, seed=3)
STREAM_NBIN = 4
STREAM_ECORR_DT = 2.0e6
STREAM_COUNTS = ((6, 5, 6, 6), (5, 5, 4, 5), (4, 3, 4, 4))
STREAM_WIDTHS = (6, 5, 4)
#: the stream layouts: layout -> its one-process mesh's (psr, toa)
STREAM_CASES = {"psr": (2, 1), "cross": (2, 2)}
#: the detection sequence: dT scaled by these, threshold 4x the last snr
OS_SCALES = (1.0, 3.0, 1.0, 3.0, 3.0, 1.0, 3.0)
REFRESH_SPEC = dict(n_chains=2, warmup=4, step_size=0.3, n_leapfrog=4)
REFRESH_RUN = dict(n_steps=8, segment=4)
FS_NBIN = 2

#: the search: a small frontier, one probe chunk
SEARCH = dict(nreal_hint=64, budget_s=120.0, max_candidates=3,
              probe_chunks=1)

#: case -> (layout, (psr_shards, toa_shards), engine kwargs, run kwargs).
#: ``cross``: entry (r, s, t) on rank (s + t) % 2, so the psr gather of
#: every toa window, each psr shard's toa psum and the heads' psum all
#: cross ranks; ``rank_major``: initialize_multihost's own mesh (each rank
#: one whole real row, nothing crosses inside a row); ``psr``: one entry
#: per rank on a real 1 x psr 2 mesh; ``real``: real 2 x psr 1. An engine
#: argument ``dtype="float64"`` runs the case on the float64 batch (the
#: kernel paths' float64 kernels across ranks)
CASES = {
    "einsum_cross": ("cross", (2, 2), dict(stat_path="einsum"),
                     dict(keep_corr=True)),
    "einsum_rank_major": ("rank_major", (2, 2), dict(stat_path="einsum"),
                          {}),
    "fused_psr_f32": ("psr", (2, 1), dict(stat_path="fused"),
                      dict(precision="f32")),
    "fused_psr_bf16": ("psr", (2, 1), dict(stat_path="fused"),
                       dict(precision="bf16")),
    "vpu_psr_f32": ("psr", (2, 1), dict(stat_path="fused",
                                        pallas_mxu_binning=False),
                    dict(precision="f32")),
    "mega_psr_f32": ("psr", (2, 1), dict(stat_path="mega"),
                     dict(precision="f32")),
    "mega_psr_bf16": ("psr", (2, 1), dict(stat_path="mega"),
                      dict(precision="bf16")),
    "fused_real": ("real", (1, 1), dict(stat_path="fused"),
                   dict(precision="f32")),
    "os_psr": ("psr", (2, 1), dict(stat_path="fused"),
               dict(precision="f32", os="os")),
    "lnl_cross": ("cross", (2, 2), dict(stat_path="einsum"),
                  dict(lnlike="grad")),
    "fused_psr_f64": ("psr", (2, 1), dict(stat_path="fused",
                                          dtype="float64"),
                      dict(precision="f32")),
    "mega_psr_f64": ("psr", (2, 1), dict(stat_path="mega", dtype="float64"),
                     dict(precision="f32")),
}


def lnl_model(pkg, nbin: int = 4):
    """The likelihood lane's model (``pkg`` is either package's infer)."""
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C("red", spectrum="batch"), C("dm", spectrum="batch"),
        C("curn", nbin=nbin, free=(F("log10_A", (-13.8, -12.6)),
                                   F("gamma", (2.0, 6.0))))))


def sample_model(pkg):
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C(target="red", spectrum="batch"),
        C(target="dm", spectrum="batch"),
        C(target="curn", nbin=3, free=(
            F("log10_A", (-14.0, -12.4)), F("gamma", (2.0, 6.0))))))


def stream_blocks(seed: int = 5) -> list:
    """tests/test_stream.py's chronological blocks of absolute-second
    TOAs with ragged counts (its ``_blocks``)."""
    from fakepta_tpu_torch.constants import yr
    npsr, t_hi = STREAM_TEMPLATE["npsr"], 0.95
    rng = np.random.default_rng(seed)
    t_all = np.sort(rng.uniform(0.0, t_hi * STREAM_TEMPLATE["tspan_years"]
                                * yr, (npsr, sum(STREAM_WIDTHS))), axis=1)
    blocks, lo = [], 0
    for w, c in zip(STREAM_WIDTHS, STREAM_COUNTS):
        blocks.append({
            "t": t_all[:, lo:lo + w],
            "r": rng.normal(0.0, 1e-7, (npsr, w)),
            "s2": (1e-7 + rng.uniform(0.0, 5e-8, (npsr, w))) ** 2,
            "ec": np.abs(rng.normal(3e-7, 1e-7, (npsr, w))),
            "counts": np.asarray(c, dtype=np.int64),
        })
        lo += w
    return blocks


def fs_model(pkg, nbin: int = FS_NBIN):
    """A free-spectrum stream model (the factorized refresher's)."""
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C(target="red", spectrum="batch"), C(target="dm", spectrum="batch"),
        C(target="curn", nbin=nbin, spectrum="free_spectrum",
          free=(F("log10_rho", (-9.0, -5.0), per_bin=True),))))


def batch_digest(batch) -> str:
    """sha256 over every field of a PulsarBatch (equal digests: equal
    bits)."""
    import hashlib
    h = hashlib.sha256()
    for name, arr in sorted(batch.numpy().items()):
        arr = np.ascontiguousarray(np.asarray(arr))
        h.update(f"{name}:{arr.dtype}:{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def f64_batch(batch):
    """The float64 cases' batch: the float32 batch's leaves at float64 (the
    test builds the JAX package's from the same leaves)."""
    import torch

    from fakepta_tpu_torch.batch import PulsarBatch
    return PulsarBatch.from_numpy(batch.numpy(), device="cpu",
                                  dtype=torch.float64)


def _lists(x):
    return np.asarray(x, dtype=np.float64).tolist()


def _result(out) -> dict:
    got = {"curves": _lists(out["curves"]), "autos": _lists(out["autos"]),
           "dtype": str(out["curves"].dtype)}
    if "corr" in out:
        got["corr"] = _lists(out["corr"])
    if "os" in out:
        got["os"] = {orf: {k: _lists(v[k]) for k in ("amp2", "null_amp2")}
                     for orf, v in out["os"]["stats"].items()}
    if "lnlike" in out:
        got["lnlike"] = {k: _lists(out["lnlike"][k])
                         for k in ("lnl", "grad")}
    got["meta"] = {k: out["report"].meta[k] for k in (
        "process_index", "process_count", "backend", "mesh_shape",
        "pipeline_depth")}
    return got


def stream_cases(result: dict, outdir, rank: int, layouts: dict) -> None:
    """The stream on multi-process meshes: each layout's moments, lnL, OS
    and detections (rank 0 beside the one-process mesh's), checkpoint
    files per rank, a resume from a shared directory, an append fault on
    rank 1 alone, and both refreshers on the psr layout's stream."""
    import torch

    from fakepta_tpu_torch import faults, infer
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.detect import StreamingOS
    from fakepta_tpu_torch.obs import metrics
    from fakepta_tpu_torch.parallel import mesh as mesh_lib
    from fakepta_tpu_torch.sample import SampleSpec
    from fakepta_tpu_torch.stream import (FactorizedRefresher,
                                          PosteriorRefresher, StreamState,
                                          default_stream_model)

    tpl = PulsarBatch.synthetic(**STREAM_TEMPLATE, dtype=torch.float64,
                                device="cpu")
    blocks = stream_blocks()

    def stream_on(mesh, model=None, watch="hd", **kw):
        return StreamState(tpl, model or default_stream_model(
            nbin=STREAM_NBIN), ecorr_dt=STREAM_ECORR_DT, watch=watch,
            mesh=mesh, **kw)

    def append(st, b):
        return st.append(b["t"], b["r"], sigma2=b["s2"], ecorr_amp=b["ec"],
                         counts=b["counts"])

    def moments(st):
        return [_lists(x) for x in st.moments()]

    def streamed(st):
        infos = [append(st, b) for b in blocks]
        mom = st.moments()
        watcher = StreamingOS(st._compiled, st._nsb, tpl.pos.numpy(),
                              theta_ref=st.theta_ref,
                              threshold_sigma=4.0 * infos[-1]["snr"])
        with metrics.collect() as col:
            for k in OS_SCALES:
                watcher.update(mom[:4] + (mom[4] * k,))
        return {"moments": moments(st), "lnl": st.lnlike(st.theta_ref),
                "restaged": [_lists(x) for x in st.restage_moments()],
                "os": [{k: i[k] for k in ("amp2", "snr")} for i in infos],
                "detections": col.counters.get("stream.detections", 0),
                "os_sequence_snr": watcher.last["snr"],
                "append_ms": [i["latency_ms"] for i in infos]}

    def refreshed(st, mesh=None):
        spec = SampleSpec(model=st.model, **REFRESH_SPEC)
        pr = PosteriorRefresher(st, spec, rhat_gate=1e9, mesh=mesh)
        cyc = pr.refresh(REFRESH_RUN["n_steps"], seed=1,
                         segment=REFRESH_RUN["segment"])
        fst = stream_on(mesh or st.mesh, model=fs_model(infer), watch=None)
        for b in blocks:
            append(fst, b)
        fr = FactorizedRefresher(fst, SampleSpec(model=fst.model,
                                                 **REFRESH_SPEC),
                                 lane_bins=1, rhat_gate=1e9, mesh=mesh)
        fcyc = fr.refresh(REFRESH_RUN["n_steps"], seed=1,
                          segment=REFRESH_RUN["segment"])
        return {"theta": _lists(pr.posterior["theta"]),
                "promoted": bool(cyc["promoted"]),
                "fs_theta": _lists(fr.posterior["theta"]),
                "fs_lanes": int(fcyc["fs_lane_count"])}

    result["stream"], result["stream_ref"] = {}, {}
    for name, (psr, toa) in STREAM_CASES.items():
        mesh = layouts[name](None)
        st = stream_on(mesh)
        result["stream"][name] = streamed(st)
        one = None
        if rank == 0:
            one = mesh_lib.make_mesh(["cpu"] * mesh.devices.size,
                                     psr_shards=psr, toa_shards=toa)
            result["stream_ref"][name] = streamed(stream_on(one))
        if name == "psr":
            result["refresh"] = refreshed(st)
            if rank == 0:
                ref = stream_on(one)
                for b in blocks:
                    append(ref, b)
                result["refresh_ref"] = refreshed(ref, mesh=one)

    # checkpoints: the lead alone writes (each rank's own directory); a
    # stream cut after two appends resumes from a shared directory
    psr_mesh = layouts["psr"](None)
    own = outdir / f"sck{rank}"
    own.mkdir()
    st = stream_on(psr_mesh, checkpoint=own / "s.ckpt")
    for b in blocks:
        append(st, b)
    result["stream_ckpt_files"] = sorted(p.name for p in own.iterdir())
    shared = outdir / "sck_shared"
    first = stream_on(psr_mesh, checkpoint=shared / "s.ckpt")
    for b in blocks[:2]:
        append(first, b)
    resumed = stream_on(psr_mesh, checkpoint=shared / "s.ckpt")
    replayed = resumed.appends
    append(resumed, blocks[2])
    result["stream_resume"] = {"replayed": replayed,
                               "moments": moments(resumed)}

    # a transient fault at rank 1's second append: every rank raises
    # before any state moves, and the retried block lands as if nothing
    # had failed
    st = stream_on(psr_mesh)
    append(st, blocks[0])
    plan = faults.FaultPlan([faults.FaultSpec("ingest.append", "transient",
                                              at=(0,))])
    t0 = time.perf_counter()
    try:
        if rank == 1:
            with faults.inject(plan):
                append(st, blocks[1])
        else:
            append(st, blocks[1])
        fault = {"raised": None}
    except Exception as exc:  # noqa: BLE001 — the case's outcome
        fault = {"raised": type(exc).__name__, "error": repr(exc)[:300],
                 "after_s": time.perf_counter() - t0}
    for b in blocks[1:]:
        append(st, b)
    fault["moments"] = moments(st)
    result["stream_fault"] = fault


def search_cases(result: dict, outdir, rank: int, batch, psd) -> None:
    """tune.search over both ranks' entries: the TunedConfig, the probed
    knobs, the store's files, a warm second search, and a fault at rank
    1's first probe."""
    from fakepta_tpu_torch import faults, tune
    from fakepta_tpu_torch.parallel import mesh as mesh_lib
    from fakepta_tpu_torch.parallel.montecarlo import GWBConfig

    store = outdir / "tune"

    def search(**kw):
        return tune.search(batch, gwb=GWBConfig(psd=psd, orf="hd"),
                           mesh_devices=mesh_lib.global_devices(),
                           store=store / "tuned.json", **SEARCH, **kw)

    cfg, info = search(artifact=outdir / f"tune_art{rank}.jsonl")
    warm_cfg, warm = search()
    result["search"] = {
        "cfg": cfg.to_json(), "probes": info["probes"],
        "probed": [r["knobs"] for r in info["records"]],
        "store_path": info["store_path"],
        "store_files": sorted(p.name for p in store.iterdir()),
        "artifact": (outdir / f"tune_art{rank}.jsonl").exists(),
        "warm": {"cfg": warm_cfg.to_json(), "probes": warm["probes"],
                 "warm": warm["warm"]},
        "fingerprint": tune.fingerprint(mesh_lib.global_devices()).as_dict()}
    plan = faults.FaultPlan([faults.FaultSpec("tune.probe", "fatal",
                                              at=(0,))])
    t0 = time.perf_counter()
    try:
        if rank == 1:
            with faults.inject(plan):
                search(force=True)
        else:
            search(force=True)
        fault = {"raised": None}
    except Exception as exc:  # noqa: BLE001 — the case's outcome
        fault = {"raised": type(exc).__name__, "error": repr(exc)[:300],
                 "after_s": time.perf_counter() - t0}
    result["search_fault"] = fault


def main():
    import torch

    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE))
    import _multihost_worker as cfg
    from fakepta_tpu_torch import faults, infer
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.parallel import mesh as mesh_lib
    from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                       GWBConfig)
    from fakepta_tpu_torch.sample import SampleSpec, SamplingRun

    outdir, rank, nranks = (pathlib.Path(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]))
    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(f"file://{outdir / 'store'}", nranks,
                                  rank, local_devices=["cpu"] * LOCAL,
                                  timeout_s=60.0)
    assert mesh_lib.process_count() == nranks
    assert mesh_lib.backend() == "gloo"
    # the skip classifier's sentinel: a failure after this line fails
    print("MULTIPROC_INIT_OK", file=sys.stderr, flush=True)

    entries = mesh_lib.global_devices()
    rank_major = mesh_lib.make_mesh(entries, psr_shards=2, toa_shards=2)
    cpu = entries[0].device
    layouts = {
        "rank_major": lambda shape: rank_major,
        "cross": lambda shape: mesh_lib.make_mesh(
            [mesh_lib.MeshDevice((s + t) % 2, cpu)
             for r in range(2) for s in range(2) for t in range(2)],
            psr_shards=2, toa_shards=2),
        "psr": lambda shape: mesh_lib.make_mesh(
            [mesh_lib.MeshDevice(r, cpu) for r in range(nranks)],
            psr_shards=2),
        "real": lambda shape: mesh_lib.make_mesh(
            [mesh_lib.MeshDevice(r, cpu) for r in range(nranks)]),
    }

    batch = PulsarBatch.synthetic(**cfg.SIM, device="cpu")
    f = np.arange(1, cfg.GWB["ncomp"] + 1) / float(batch.tspan_common)
    psd = spectrum_lib.powerlaw(f, log10_A=cfg.GWB["log10_A"],
                                gamma=cfg.GWB["gamma"]).numpy()
    theta = infer.theta_grid(lnl_model(infer), THETA_SHAPE)

    batch64 = f64_batch(batch)

    def sim_on(mesh, kw):
        kw = dict(kw)
        b = batch64 if kw.pop("dtype", None) == "float64" else batch
        return EnsembleSimulator(b, gwb=GWBConfig(psd=psd, orf="hd"),
                                 mesh=mesh, **kw)

    def run_kw(kw):
        kw = dict(kw)
        if kw.get("os"):
            kw["os"] = OSSpec(orf=OS_ORFS, null=True)
        if kw.get("lnlike"):
            kw["lnlike"] = infer.InferSpec(model=lnl_model(infer),
                                           theta=theta, mode=kw["lnlike"])
        return kw

    run = dict(nreal=cfg.RUN["nreal"], seed=cfg.RUN["seed"],
               chunk=cfg.RUN["chunk"])
    result = {"rank": rank, "cases": {}, "ref": {},
              "rank_major_ranks": rank_major.ranks.tolist(),
              "batch_digest": batch_digest(batch)}
    for name, (layout, (psr, toa), kw, rkw) in CASES.items():
        mesh = layouts[layout](None)
        extra = {"eventlog": str(outdir / "shards")} \
            if name == "einsum_cross" else {}
        out = sim_on(mesh, kw).run(**run, **run_kw(rkw), **extra)
        result["cases"][name] = _result(out)
        if rank == 0:
            one = mesh_lib.make_mesh(["cpu"] * mesh.devices.size,
                                     psr_shards=psr, toa_shards=toa)
            result["ref"][name] = _result(
                sim_on(one, kw).run(**run, **run_kw(rkw)))

    # to_host: each rank's block (rank r's rows hold r) gathered in shard
    # order, over the world in rank order and over a mesh's real rows,
    # whose leads are the owners of their first entries
    block = torch.full((2, 3), float(rank))
    result["to_host"] = {
        "world": mesh_lib.to_host(block).tolist(),
        "real": mesh_lib.to_host(block, layouts["real"](None)).tolist(),
        "psr": mesh_lib.to_host(block if rank == 0 else block[:0],
                                layouts["psr"](None)).tolist()}

    # checkpoints: rank 0 alone writes (each rank's own directory here,
    # listed after every chunk); then a run cut after its first chunk
    # resumes from a shared directory to the uninterrupted result
    psr_mesh = layouts["psr"](None)
    sim = sim_on(psr_mesh, dict(stat_path="fused"))
    mine = outdir / f"ck{rank}"
    mine.mkdir()
    seen = []
    sim.run(**run, checkpoint=mine / "mc",
            progress=lambda d, n: seen.append(sorted(
                p.name for p in mine.iterdir())))
    result["ckpt_files_mid_run"] = seen
    result["ckpt_files_after"] = sorted(p.name for p in mine.iterdir())

    class Cut(RuntimeError):
        pass

    def cut(done, total):
        if done >= cfg.RUN["chunk"]:
            raise Cut("cut after the first chunk")

    shared = outdir / "shared"
    shared.mkdir(exist_ok=True)
    try:
        sim.run(**run, checkpoint=shared / "mc", progress=cut)
        raise AssertionError("the cut run did not stop")
    except Cut:
        pass
    import torch.distributed as dist
    dist.barrier()      # rank 0's append is on disk before anyone resumes
    result["ckpt_shared_after_cut"] = sorted(
        p.name for p in shared.iterdir() if p.name.startswith("mc"))
    resumed = sim.run(**run, checkpoint=shared / "mc")
    result["resumed"] = _result(resumed)
    result["uninterrupted"] = _result(sim.run(**run))

    # the sampler: chains over 'real' across ranks, pulsar rows over 'psr'
    sb = PulsarBatch.synthetic(**SAMPLE_BATCH, dtype=torch.float64,
                               device="cpu")
    result["sample"], result["sample_ref"] = {}, {}
    for name, layout, psr in (("real2", "real", 1), ("psr2", "psr", 2)):
        def study(mesh):
            return SamplingRun(sb, SampleSpec(model=sample_model(infer),
                                              **SAMPLE_SPEC),
                               mesh=mesh, data_seed=1,
                               truth=np.array(SAMPLE_TRUTH))

        ev = {"eventlog": str(outdir / "sample_shards")} \
            if name == "psr2" else {}
        out = study(layouts[layout](None)).run(SAMPLE_STEPS, **SAMPLE_RUN,
                                               **ev)
        result["sample"][name] = {
            "theta": _lists(out["theta"]),
            "diag": {k: out["diag"][k] for k in (
                "accept_rate_by_temp", "swap_rate", "divergences",
                "nonfinite_lnl", "n_kept")},
            "meta": {k: out["report"].meta[k] for k in (
                "process_index", "process_count", "pipeline_depth")}}
        if rank == 0:
            ref = study(mesh_lib.make_mesh(["cpu"] * 2, psr_shards=psr)
                        ).run(SAMPLE_STEPS, **SAMPLE_RUN)
            result["sample_ref"][name] = {"theta": _lists(ref["theta"])}

    # the sampler's toa axis across ranks: psr 2 x toa 2 on the cross
    # layout, and real 1 x toa 2 with rank 1 owning only the toa 1 entry
    # (it computes no cell and receives every row)
    toa_layouts = {"toa_cross": layouts["cross"](None),
                   "toa_only": mesh_lib.make_mesh(
                       [mesh_lib.MeshDevice(r, cpu) for r in range(nranks)],
                       toa_shards=2)}

    def sampler(mesh):
        return SamplingRun(sb, SampleSpec(model=sample_model(infer),
                                          **SAMPLE_SPEC),
                           mesh=mesh, data_seed=1,
                           truth=np.array(SAMPLE_TRUTH))

    for name in SAMPLE_TOA:
        out = sampler(toa_layouts[name]).run(SAMPLE_STEPS, **SAMPLE_RUN)
        result["sample"][name] = {
            "theta": _lists(out["theta"]),
            "diag": {k: out["diag"][k] for k in (
                "accept_rate_by_temp", "swap_rate", "divergences",
                "nonfinite_lnl", "n_kept")},
            "meta": {k: out["report"].meta[k] for k in (
                "process_index", "process_count", "pipeline_depth")}}
    if rank == 0:
        ref = sampler(mesh_lib.make_mesh(["cpu"] * 8, psr_shards=2,
                                         toa_shards=2)).run(SAMPLE_STEPS,
                                                            **SAMPLE_RUN)
        result["sample_ref"]["toa_cross"] = {"theta": _lists(ref["theta"])}

    stream_cases(result, outdir, rank, layouts)
    search_cases(result, outdir, rank, batch, psd)

    # recovery, last: a transient fault on rank 1 alone cannot be retried
    # there (rank 0 would wait in the psr gather), so rank 1 raises and
    # rank 0's collective fails once rank 1 is gone, inside the timeout
    plan = faults.FaultPlan([faults.FaultSpec("mc.dispatch", "transient",
                                              at=(1,))])
    t0 = time.perf_counter()
    try:
        if rank == 1:
            with faults.inject(plan):
                sim.run(**run)
        else:
            sim.run(**run)
        result["recovery"] = {"raised": None}
    except Exception as exc:  # noqa: BLE001 — the case's outcome
        result["recovery"] = {"raised": type(exc).__name__,
                              "error": repr(exc)[:300],
                              "after_s": time.perf_counter() - t0}
    print(json.dumps(result), flush=True)
    # no shutdown: rank 1 leaves with rank 0 still inside a collective,
    # which fails when this process's connections close


if __name__ == "__main__":
    main()
