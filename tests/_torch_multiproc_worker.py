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
apart; the sampler's is tests/test_torch_sample.py's, restated here
because that module imports JAX.
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

#: case -> (layout, (psr_shards, toa_shards), engine kwargs, run kwargs).
#: ``cross``: entry (r, s, t) on rank (s + t) % 2, so the psr gather of
#: every toa window, each psr shard's toa psum and the heads' psum all
#: cross ranks; ``rank_major``: initialize_multihost's own mesh (each rank
#: one whole real row, nothing crosses inside a row); ``psr``: one entry
#: per rank on a real 1 x psr 2 mesh; ``real``: real 2 x psr 1
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


def _lists(x):
    return np.asarray(x, dtype=np.float64).tolist()


def _result(out) -> dict:
    got = {"curves": _lists(out["curves"]), "autos": _lists(out["autos"])}
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

    def sim_on(mesh, kw):
        return EnsembleSimulator(batch, gwb=GWBConfig(psd=psd, orf="hd"),
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

    # the stream keeps its host store in one process: a multi-process
    # mesh is refused
    from fakepta_tpu_torch.stream import StreamState, default_stream_model
    try:
        StreamState(PulsarBatch.synthetic(**SAMPLE_BATCH, device="cpu",
                                          dtype=torch.float64),
                    default_stream_model(nbin=3),
                    mesh=layouts["psr"](None))
        result["stream_refused"] = None
    except ValueError as exc:
        result["stream_refused"] = str(exc)

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
