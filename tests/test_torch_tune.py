"""The port's tuner (``fakepta_tpu_torch.tune``), the engine and sampler
hooks it drives and serve's ArraySpec, against the JAX package's, on the
CPU.

Sizes are tests/test_tune.py's: 6 pulsars x 48 TOAs, 3+3+3 basis bins,
``nreal_hint=64``, ``max_candidates=4`` and one module-scoped search whose
store every other test reads. Held against ``fakepta_tpu`` on the same
inputs: the dispatch surface and family hash (equal), the CPU frontier
under the path map ``{"xla": "einsum"}`` (equal, entry for entry), the
default candidate, overshoot factor and bucket ladder (equal), the store
lifecycle (the JAX cases, and a JAX-written store file), and a tuned run
(within the engine's f32 tolerance, tests/test_montecarlo.py:338-354:
1e-5 of the curve scale, autos 1e-5 relative). Where the port differs by
design (the mega residual in the Hopper model, the probe's failure rules,
the fingerprint's torch fields) the test says so.
"""

import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu import tune as jtune
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.ops.megakernel import chunk_bytes_model as jax_bytes_model
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu.tune import model as jmodel
from fakepta_tpu.tune import store as jstore
from fakepta_tpu_torch import faults, tune
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs import flightrec
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.ops import binned_corr as binned_corr_ops
from fakepta_tpu_torch.ops import megakernel as megakernel_ops
from fakepta_tpu_torch.ops.megakernel import chunk_bytes_model
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from fakepta_tpu_torch.tune import defaults
from fakepta_tpu_torch.tune import model as tmodel
from fakepta_tpu_torch.tune.probe import run_probe
from fakepta_tpu_torch.tune.store import TunedConfig, TuneStore

NPSR, NTOA, NCOMP = 6, 48, 3
KW = dict(npsr=NPSR, ntoa=NTOA, tspan_years=8.0, toaerr=1e-7, n_red=NCOMP,
          n_dm=NCOMP, seed=0)
CPU8 = ["cpu"] * 8
PATH_MAP = {"xla": "einsum"}
TOL = 1e-5


def _psd(tspan):
    f = np.arange(1, NCOMP + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-14.6, gamma=13 / 3))


def _sim(tb, devices=CPU8, **kw):
    return EnsembleSimulator(
        tb, gwb=GWBConfig(psd=_psd(float(tb.tspan_common)), orf="hd"),
        mesh=make_mesh(devices, **kw.pop("mesh_kw", {})), **kw)


def _cand(c):
    """A JAX candidate as the port's tuple (path names mapped)."""
    return (c.chunk, c.pipeline_depth, PATH_MAP.get(c.path, c.path),
            c.precision, c.psr_shards)


def _tuple(c):
    return (c.chunk, c.pipeline_depth, c.path, c.precision, c.psr_shards)


def _fps(n_devices=8, hbm_bytes=0):
    """A CPU fingerprint in each package (the fields the models read are
    the same; the version fields are each package's)."""
    common = dict(platform="cpu", device_kind="cpu", n_devices=n_devices,
                  n_processes=1, hbm_bytes=hbm_bytes)
    return (tune.Fingerprint(torch_version="t", cuda_version="", **common),
            jtune.Fingerprint(jax_version="j", jaxlib_version="j", **common))


@pytest.fixture(scope="module")
def batches():
    return JaxBatch.synthetic(**KW), PulsarBatch.synthetic(**KW,
                                                           device="cpu")


@pytest.fixture(scope="module")
def jax_sims(batches):
    """The JAX engine on the same batch: one device (the surface, the cost
    capture) and the conftest's eight (the tuned run)."""
    jb = batches[0]
    gwb = JaxGWB(psd=_psd(float(jb.tspan_common)), orf="hd")
    return {"one": JaxSim(jb, gwb=gwb, mesh=jax_mesh(jax.devices()[:1])),
            "psr2": JaxSim(jb, gwb=gwb,
                           mesh=jax_mesh(jax.devices(), psr_shards=2)),
            "eight": JaxSim(jb, gwb=gwb, mesh=jax_mesh(jax.devices()))}


@pytest.fixture(scope="module")
def searched(batches, tmp_path_factory):
    """ONE real search over the tiny space on eight CPU shards; its store
    warms every other test."""
    store = tmp_path_factory.mktemp("tune") / "tuned.json"
    tb = batches[1]
    cfg, info = tune.search(
        tb, gwb=GWBConfig(psd=_psd(float(tb.tspan_common)), orf="hd"),
        mesh_devices=CPU8, nreal_hint=64, budget_s=60.0, max_candidates=4,
        probe_chunks=2, store=store,
        artifact=store.parent / "tune_art.jsonl")
    return {"store": store, "cfg": cfg, "info": info,
            "artifact": store.parent / "tune_art.jsonl"}


@pytest.fixture(scope="module")
def jax_tuned(jax_sims, searched):
    """The JAX engine's run(tuned=...) at the searched knobs (the port's
    einsum named "xla")."""
    knobs = dict(searched["cfg"].knobs)
    knobs["path"] = {"einsum": "xla"}[knobs["path"]]
    return jax_sims["eight"].run(64, seed=3, tuned=knobs)


# -- fingerprint / surface / family -----------------------------------------

def test_fingerprint_fields_and_family_hash_equal_jax():
    fp = tune.fingerprint(CPU8)
    assert (fp.platform, fp.device_kind, fp.hbm_bytes) == ("cpu", "cpu", 0)
    assert fp.n_devices == 1            # eight shards on one device
    assert fp.n_processes == 1
    assert fp.torch_version == torch.__version__
    assert fp.cuda_version == (torch.version.cuda or "")
    assert fp.hash == tune.fingerprint(["cpu"]).hash
    assert set(fp.as_dict()) == {
        "platform", "device_kind", "n_devices", "n_processes", "hbm_bytes",
        "torch_version", "cuda_version"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            tune.fingerprint()          # global_devices: the card or raise
    fields = dict(npsr=6, max_toa=48, nbins=15, k_coef=18, dtype="float32")
    assert tune.family_hash(**fields) == jtune.family_hash(**fields)
    assert tune.family_hash(**fields) == tune.family_hash(
        **dict(reversed(list(fields.items()))))


@pytest.mark.parametrize("shards", [1, 2])
def test_dispatch_surface_and_family_equal_jax(batches, jax_sims, shards):
    sim = _sim(batches[1], mesh_kw={"psr_shards": shards})
    jsim = jax_sims["one" if shards == 1 else "psr2"]
    assert sim.dispatch_surface() == jsim.dispatch_surface()
    assert sim.dispatch_surface()["k_coef"] == 2 * 3 * NCOMP
    assert tune.family_for_surface(sim.dispatch_surface()) == \
        jtune.family_for_surface(jsim.dispatch_surface())


# -- model-first frontier -----------------------------------------------------

@pytest.mark.parametrize("npsr,ntoa,k,nreal_hint,n_devices,hbm", [
    (NPSR, NTOA, 18, 64, 8, 0),
    (NPSR, NTOA, 18, 64, 1, 0),
    (100, 780, 320, 100_000, 8, 0),
    (100, 780, 320, 2000, 1, 0),
    (100, 780, 320, 4096, 8, 1 << 20),     # a tiny budget
])
def test_cpu_frontier_equals_jax(npsr, ntoa, k, nreal_hint, n_devices, hbm):
    fp, jfp = _fps(n_devices, hbm)
    got = tune.candidate_frontier(fp, npsr, ntoa, k, nreal_hint=nreal_hint,
                                  n_devices=n_devices, max_candidates=16)
    want = jtune.candidate_frontier(jfp, npsr, ntoa, k,
                                    nreal_hint=nreal_hint,
                                    n_devices=n_devices, max_candidates=16)
    assert [_tuple(c) for c in got] == [_cand(c) for c in want]
    assert {c.path for c in got} == {"einsum"}
    if hbm:
        # the bound leaves only the hand-set candidate: one shard cannot
        # hold the smallest chunk, so psr splits are tried, but each adds
        # the gathered copy and fits even less (in both packages)
        assert [_tuple(c) for c in got] == [
            _tuple(tune.default_candidate(nreal_hint, n_devices))]


@pytest.mark.parametrize("nreal_hint,n_devices", [(64, 8), (2000, 1),
                                                  (100, 3), (1, 8)])
def test_pure_functions_equal_jax(nreal_hint, n_devices):
    assert _tuple(tune.default_candidate(nreal_hint, n_devices)) == \
        _cand(jtune.default_candidate(nreal_hint, n_devices))
    for chunk in (1, 7, 64, 1024):
        assert tune.overshoot_factor(chunk, nreal_hint) == \
            jtune.overshoot_factor(chunk, nreal_hint)
    for hbm in (0, 1 << 20, 80 << 30):
        fp, jfp = _fps(n_devices, hbm)
        assert tune.bucket_ladder(fp, 100, 780, 320,
                                  n_real_shards=n_devices) == \
            jtune.bucket_ladder(jfp, 100, 780, 320,
                                n_real_shards=n_devices)


def test_gpu_frontier_offers_every_path_and_prices_the_mega_residual():
    fp = dataclasses.replace(_fps(1)[0], platform="gpu",
                             device_kind="NVIDIA H100 80GB HBM3",
                             hbm_bytes=80 << 30)
    cands = tune.candidate_frontier(fp, 100, 780, 320, nreal_hint=4096,
                                    n_devices=1, max_candidates=8)
    assert cands[0] == tune.default_candidate(4096, 1)
    assert _tuple(cands[0]) == (1024, 2, "einsum", None, 1)
    assert {(c.path, c.precision) for c in cands[1:]} >= {
        (p, q) for p in ("mega", "fused", "einsum") for q in (None, "bf16")}
    budget = tmodel.bytes_budget_per_device(fp)
    for c in cands:
        assert tmodel.resident_bytes_per_device(
            c.chunk, 100, 780, 320, 1, c.psr_shards, c.path) <= budget
    # the Hopper model: mega writes and reads its f32 residual
    mega = next(c for c in cands if c.path == "mega" and c.precision is None)
    R = mega.chunk
    assert tmodel.traffic_bytes_per_real(mega, 100, 780, 320) * R == \
        chunk_bytes_model(R, 100, 780, 320, mode="mega") + R * 100 * 780 * 4
    sharded = tmodel.Candidate(R, 0, "mega", "bf16", 4)
    assert tmodel.traffic_bytes_per_real(sharded, 100, 780, 320) * R == \
        chunk_bytes_model(R, 100, 780, 320, mode="mega_bf16",
                          psr_shards=4) + R * (25 + 100) * 780 * 4
    # mega's residency counts the residual, as fused's does (JAX's omits it)
    args = (R, 100, 780, 320, 1)
    assert tmodel.resident_bytes_per_device(*args, 1, "mega") == \
        tmodel.resident_bytes_per_device(*args, 1, "fused") > \
        jmodel.resident_bytes_per_device(*args, 1, "mega")
    # ... so a tight budget caps mega's chunks where it caps fused's
    tight = dataclasses.replace(fp, hbm_bytes=1 << 30)
    top = {p: max(c.chunk for c in tune.candidate_frontier(
        tight, 100, 780, 320, nreal_hint=1 << 16, n_devices=1,
        max_candidates=200) if c.path == p) for p in ("mega", "fused")}
    assert top["mega"] == top["fused"]
    # the JAX package's model itself is left as it is
    assert chunk_bytes_model(R, 100, 780, 320, mode="mega") == \
        jax_bytes_model(R, 100, 780, 320, mode="mega")


# -- store lifecycle -----------------------------------------------------------

def test_store_fingerprint_mismatch_ignored_with_note(searched, tmp_path):
    fp, cfg = tune.fingerprint(CPU8), searched["cfg"]
    foreign = dataclasses.replace(fp, platform="gpu",
                                  device_kind="NVIDIA H100 80GB HBM3")
    alien = TuneStore(tmp_path / "tuned.json")
    alien.put(TunedConfig(fingerprint=foreign.as_dict(), family=cfg.family,
                          knobs=dict(cfg.knobs)))
    flightrec.clear()
    assert alien.lookup(fp, cfg.family) is None
    assert "tune_fingerprint_mismatch" in \
        [e["name"] for e in flightrec.snapshot()]
    assert TuneStore(searched["store"]).lookup(fp, cfg.family) is not None


def test_store_schema_version_bump_ignored(searched, tmp_path):
    fp, cfg = tune.fingerprint(CPU8), searched["cfg"]
    bumped = TuneStore(tmp_path / "tuned.json")
    entry = TunedConfig(fingerprint=fp.as_dict(), family=cfg.family,
                        knobs=dict(cfg.knobs))
    bumped.put(entry)
    raw = json.loads(bumped.path.read_text())
    raw["entries"][entry.key()]["schema_version"] = \
        defaults.STORE_VERSION + 1
    bumped.path.write_text(json.dumps(raw))
    flightrec.clear()
    assert bumped.lookup(fp, cfg.family) is None
    assert "tune_entry_schema_mismatch" in \
        [e["name"] for e in flightrec.snapshot()]
    raw["version"] = defaults.STORE_VERSION + 1
    bumped.path.write_text(json.dumps(raw))
    with pytest.warns(RuntimeWarning, match="schema"):
        assert bumped.load_entries() == {}


def test_store_corrupt_file_warns_then_retunes(searched, tmp_path):
    fp, cfg = tune.fingerprint(CPU8), searched["cfg"]
    store = TuneStore(tmp_path / "tuned.json")
    store.path.write_text('{"schema": "fakepta_tpu.tune/1", "ent')  # torn
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert store.lookup(fp, cfg.family) is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        store.put(TunedConfig(fingerprint=fp.as_dict(), family=cfg.family,
                              knobs=dict(cfg.knobs)))
    got = store.lookup(fp, cfg.family)
    assert got is not None and got.knobs == cfg.knobs
    assert not store.path.with_name(store.path.name + ".tmp").exists()


def test_jax_written_store_is_read_and_kept(searched, tmp_path):
    """One file, both packages: the JAX entry of the same family never
    applies here (its fingerprint hashes apart), and a port put keeps it,
    still applying in the JAX package."""
    cfg = searched["cfg"]
    path = tmp_path / "tuned.json"
    jfp = jtune.fingerprint()
    jentry = jstore.TunedConfig(fingerprint=jfp.as_dict(), family=cfg.family,
                                knobs={"chunk": 8, "path": "xla"})
    jstore.TuneStore(path).put(jentry)
    assert (defaults.STORE_SCHEMA, defaults.STORE_VERSION) == (
        jtune.defaults.STORE_SCHEMA, jtune.defaults.STORE_VERSION)
    store, fp = TuneStore(path), tune.fingerprint(CPU8)
    assert list(store.load_entries()) == [jentry.key()]
    flightrec.clear()
    assert store.lookup(fp, cfg.family) is None
    assert "tune_fingerprint_mismatch" in \
        [e["name"] for e in flightrec.snapshot()]
    store.put(TunedConfig(fingerprint=fp.as_dict(), family=cfg.family,
                          knobs=dict(cfg.knobs)))
    assert set(store.load_entries()) == {jentry.key(),
                                         f"{fp.hash}/{cfg.family}"}
    assert store.lookup(fp, cfg.family).knobs == cfg.knobs
    assert jstore.TuneStore(path).lookup(jfp, cfg.family).knobs == \
        jentry.knobs


def test_default_store_path(monkeypatch, tmp_path):
    monkeypatch.setenv(defaults.TUNE_DIR_ENV, str(tmp_path))
    assert tune.default_store_path() == tmp_path / "tuned.json"
    monkeypatch.delenv(defaults.TUNE_DIR_ENV)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tune.default_store_path() == \
        tmp_path / ".cache" / "fakepta_tpu_torch" / "tuned.json"


# -- search -------------------------------------------------------------------

def test_search_tuned_never_loses_to_hand_set_and_persists(searched):
    cfg, info = searched["cfg"], searched["info"]
    assert not info["warm"] and info["probes"] >= 2
    assert cfg.metrics["real_per_s_per_chip"] >= \
        cfg.metrics["hand_set_real_per_s_per_chip"]
    assert cfg.metrics.get("speedup_x", 1.0) >= 1.0
    data = json.loads(searched["store"].read_text())
    assert (data["schema"], data["version"]) == (defaults.STORE_SCHEMA,
                                                 defaults.STORE_VERSION)
    assert cfg.key() in data["entries"]
    assert cfg.knobs["buckets"] and cfg.knobs["path"] == "einsum"
    assert cfg.knobs["chunk"] % 8 == 0      # a multiple of the 8 shards
    # every probe measured the candidate it names
    assert all(r["knobs"]["path"] == "einsum" for r in info["records"])


def test_warm_store_zero_probes_and_artifact(batches, searched, capsys):
    tb = batches[1]
    cfg2, info2 = tune.search(
        tb, gwb=GWBConfig(psd=_psd(float(tb.tspan_common)), orf="hd"),
        mesh_devices=CPU8, nreal_hint=64, budget_s=60.0, max_candidates=4,
        store=searched["store"])
    assert info2["warm"] and info2["probes"] == 0
    assert info2["probe_s"] < 5.0
    assert cfg2.knobs == searched["cfg"].knobs
    rep = RunReport.load(searched["artifact"])
    assert rep.meta["tune_schema"] == defaults.STORE_SCHEMA
    assert rep.summary()["tuned"] == 1
    assert rep.summary()["tune_probes"] == searched["info"]["probes"]
    from fakepta_tpu_torch.obs.cli import main as obs_main
    assert obs_main(["summarize", str(searched["artifact"])]) == 0
    assert "tune_probe_s" in capsys.readouterr().out


# -- consumption: run(tuned=...) ---------------------------------------------

def test_run_tuned_true_applies_store_and_matches_explicit_and_jax(
        batches, searched, jax_tuned, monkeypatch):
    monkeypatch.setenv(defaults.TUNE_DIR_ENV, str(searched["store"].parent))
    knobs = searched["cfg"].knobs
    sim = _sim(batches[1])                    # the constructor's "fused"
    out = sim.run(64, seed=3, tuned=True)
    applied = out["report"].meta["tuned"]["knobs"]
    assert applied["chunk"] == knobs["chunk"]
    assert applied["path"] == out["statistic_path"] == "einsum"
    assert out["report"].summary()["tuned"] == 1
    # the same knobs given explicitly, bit for bit
    explicit = _sim(batches[1], stat_path=knobs["path"]).run(
        64, seed=3, chunk=knobs["chunk"],
        pipeline_depth=knobs["pipeline_depth"],
        precision=knobs["precision"])
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(out[k], explicit[k])
    # the JAX engine's tuned run at the engine's f32 tolerance
    scale = np.abs(jax_tuned["curves"]).max()
    np.testing.assert_allclose(out["curves"], jax_tuned["curves"],
                               atol=TOL * scale)
    np.testing.assert_allclose(out["autos"], jax_tuned["autos"], rtol=TOL)
    # explicit caller knobs always win
    out3 = sim.run(64, seed=3, chunk=16, tuned=True)
    assert "chunk" not in out3["report"].meta["tuned"]["knobs"]
    assert out3["report"].meta["chunk"] == 16


def test_tuned_knob_edge_cases(batches):
    tb = batches[1]
    sim = _sim(tb, devices=["cpu"])
    out = sim.run(16, seed=1, tuned={"path": "xla"})
    assert out["statistic_path"] == "einsum"
    assert out["report"].meta["tuned"]["knobs"] == {"path": "einsum"}
    np.testing.assert_array_equal(
        out["curves"], _sim(tb, devices=["cpu"], stat_path="einsum").run(
            16, seed=1)["curves"])
    # a kernel path on a toa-sharded mesh is ignored, loudly
    toa = _sim(tb, devices=["cpu"] * 2, stat_path="einsum",
               mesh_kw={"toa_shards": 2})
    flightrec.clear()
    out = toa.run(16, seed=1, tuned={"path": "fused", "chunk": 8})
    assert out["statistic_path"] == "einsum"
    assert out["report"].meta["tuned"]["knobs"] == {"chunk": 8}
    notes = {e["name"]: e for e in flightrec.snapshot()}
    assert notes["tune_path_illegal"]["attrs"]["path"] == "fused"
    # a psr split other than the mesh's is noted, not applied
    flightrec.clear()
    out = sim.run(16, seed=1, tuned=TunedConfig(
        fingerprint={}, family="", knobs={"psr_shards": 2}))
    assert out["report"].meta["tuned"]["knobs"] == {}
    mismatch = [e for e in flightrec.snapshot()
                if e["name"] == "tune_mesh_mismatch"]
    assert mismatch and mismatch[0]["attrs"]["want"] == 2


# -- warm_start / clear_executables / chunk_cost ------------------------------

def test_warm_start_and_clear_executables_keep_runs_bit_identical(batches):
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         InferSpec, LikelihoodSpec,
                                         theta_grid)
    model = LikelihoodSpec(components=(
        ComponentSpec("red", spectrum="batch"),
        ComponentSpec("dm", spectrum="batch"),
        ComponentSpec("curn", nbin=3, free=(
            FreeParam("log10_A", (-15.0, -13.0)),
            FreeParam("gamma", (2.0, 6.0))))))
    lnl = InferSpec(model=model, theta=theta_grid(model, 2))
    tb = batches[1]
    cold = _sim(tb, devices=["cpu"] * 2).run(32, seed=5, chunk=16,
                                             lnlike=lnl)
    sim = _sim(tb, devices=["cpu"] * 2)
    for kw in ({}, {"lane_keys": True}, {"lnlike": lnl},
               {"os": "hd", "precision": "bf16"}):
        assert sim.warm_start(16, **kw) >= 0.0
    assert sim._lnl_compiled
    warm = sim.run(32, seed=5, chunk=16, lnlike=lnl)
    assert sim.chunk_cost(16)
    sim.clear_executables()
    assert not sim._lnl_compiled and not sim._chunk_costs
    again = sim.run(32, seed=5, chunk=16, lnlike=lnl)
    for out in (warm, again):
        for k in ("curves", "autos"):
            np.testing.assert_array_equal(out[k], cold[k])
        np.testing.assert_array_equal(out["lnlike"]["lnl"],
                                      cold["lnlike"]["lnl"])


def test_chunk_cost_keys_and_bytes(batches, jax_sims):
    sim = _sim(batches[1], devices=["cpu"])
    want = jax_sims["one"].chunk_cost(16)
    for kw in ({}, {"keep_corr": True}, {"precision": "bf16"},
               {"os": ("hd", "monopole")}):
        got = sim.chunk_cost(16, **kw)
        assert set(got) <= set(want) | {"static_reservation_bytes"}
        assert set(got) == {"bytes_per_chunk", "flops_per_chunk"}
        path = "einsum" if kw.get("keep_corr") else sim.stat_path
        assert got["bytes_per_chunk"] == sim.model_bytes_per_chunk(
            16, path, kw.get("precision"))
        assert got["flops_per_chunk"] > 0
    # the OS lane's slots and its null stream add FLOPs; the memo answers
    base = sim.chunk_cost(16)["flops_per_chunk"]
    assert sim.chunk_cost(16, os="hd")["flops_per_chunk"] > base
    from fakepta_tpu_torch.detect import OSSpec
    assert sim.chunk_cost(16, os=OSSpec(orf="hd", null=True))[
        "flops_per_chunk"] > sim.chunk_cost(16, os="hd")["flops_per_chunk"]
    # {} and precision='bf16' share a key (fused's default is bf16)
    assert len(sim._chunk_costs) == 5


# -- probes --------------------------------------------------------------------

def test_degraded_probe_is_scored_failed(batches, monkeypatch):
    """A probe runs with the recovery ladders off, so a mega launch failure
    (the injected ``degrade`` fault) raises out of it; a probe run that
    still comes back off its candidate's path is scored failed."""
    sim = _sim(batches[1], devices=["cpu"])
    cand = tmodel.Candidate(16, 0, "mega", None, 1)

    def plan():
        return faults.FaultPlan([faults.FaultSpec("mc.dispatch", "degrade",
                                                  at=(1,))])

    first = plan()
    with faults.inject(first), pytest.raises(faults.DegradeFault):
        run_probe(sim, cand, probe_chunks=2)
    assert first.fired == [("mc.dispatch", "degrade", 1)]
    # the guard: the same fault under a ladder that steps mega -> fused
    real_run = sim.run
    monkeypatch.setattr(sim, "run", lambda *a, **kw: real_run(
        *a, **{**kw, "recovery": faults.RecoveryPolicy(backoff_s=0.0)}))
    second = plan()
    flightrec.clear()
    with faults.inject(second):
        assert run_probe(sim, cand, probe_chunks=2) is None
    assert second.fired == [("mc.dispatch", "degrade", 1)]
    notes = [e for e in flightrec.snapshot()
             if e["name"] == "tune_probe_degraded"]
    assert notes and "degraded_path=fused" in notes[0]["attrs"]["why"]
    # the same probe unfaulted measures the candidate it names
    monkeypatch.undo()
    rec = run_probe(sim, cand, probe_chunks=2)
    assert rec is not None and rec["knobs"]["path"] == "mega"


def test_probe_scores_oom_failed_and_propagates_the_rest(batches,
                                                         monkeypatch):
    sim = _sim(batches[1], devices=["cpu"])
    cand = tmodel.Candidate(16, 0, "einsum", None, 1)

    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (stub)")

    monkeypatch.setattr(sim, "step", oom)
    flightrec.clear()
    assert run_probe(sim, cand) is None
    assert "tune_probe_failed" in [e["name"] for e in flightrec.snapshot()]

    def fatal(*a, **kw):
        raise faults.FatalFault("stub")

    monkeypatch.setattr(sim, "step", fatal)
    with pytest.raises(faults.FatalFault):
        run_probe(sim, cand)


@pytest.mark.parametrize("path", ["fused", "mega"])
def test_a_broken_kernel_raises_out_of_search(batches, monkeypatch,
                                              tmp_path, path):
    """A fused or mega probe whose kernel fails to launch propagates: the
    tuner never tunes around a broken kernel (the JAX probe would score it
    failed and move on, and the recovery ladder would step mega down to
    fused)."""
    import sys
    search_mod = sys.modules["fakepta_tpu_torch.tune.search"]

    def frontier(fp, *a, **kw):
        return [tune.default_candidate(64, 8),
                tmodel.Candidate(16, 0, path, None, 1)]

    def broken(*a, **kw):
        raise RuntimeError(f"{path} kernel failed to launch: CUDA error 98 "
                           f"(invalid device function)")

    monkeypatch.setattr(search_mod, "candidate_frontier", frontier)
    if path == "fused":
        monkeypatch.setattr(binned_corr_ops, "binned_correlation", broken)
    else:
        monkeypatch.setattr(megakernel_ops, "chunk_stats", broken)
    tb = batches[1]
    flightrec.clear()
    with pytest.raises(RuntimeError, match="failed to launch"):
        tune.search(tb, mesh_devices=CPU8, nreal_hint=64,
                    store=tmp_path / "tuned.json")
    assert not (tmp_path / "tuned.json").exists()
    assert "degrade" not in [e["name"] for e in flightrec.snapshot()]


# -- the sampler ---------------------------------------------------------------

def test_sampler_tuned_depth_and_warm_start(monkeypatch, tmp_path):
    from fakepta_tpu_torch.infer import ComponentSpec, FreeParam
    from fakepta_tpu_torch.infer import LikelihoodSpec
    from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
    tb = PulsarBatch.synthetic(npsr=4, ntoa=48, tspan_years=15.0,
                               n_red=3, n_dm=3, red_log10_A=-14.5,
                               dm_log10_A=-14.5, seed=0,
                               dtype=torch.float64, device="cpu")
    model = LikelihoodSpec(components=(
        ComponentSpec(target="red", spectrum="batch"),
        ComponentSpec(target="dm", spectrum="batch"),
        ComponentSpec(target="curn", nbin=3, free=(
            FreeParam("log10_A", (-14.0, -12.4)),
            FreeParam("gamma", (2.0, 6.0))))))
    spec = SampleSpec(model=model, n_chains=4, n_temps=2, warmup=4, thin=2,
                      n_leapfrog=2)
    monkeypatch.setenv(defaults.TUNE_DIR_ENV, str(tmp_path))
    fp = tune.fingerprint(["cpu"])
    TuneStore().put(TunedConfig(fingerprint=fp.as_dict(), family="older",
                                knobs={"pipeline_depth": 3},
                                created="2000-01-01T00:00:00"))
    TuneStore().put(TunedConfig(fingerprint=fp.as_dict(), family="newer",
                                knobs={"pipeline_depth": 0}))
    study = SamplingRun(tb, spec, data_seed=1, device="cpu")
    run = dict(seed=3, segment=4)
    tuned = study.run(8, tuned=True, **run)
    assert tuned["report"].meta["tuned"] == {"knobs": {"pipeline_depth": 0}}
    assert tuned["report"].meta["pipeline_depth"] == 0
    explicit = study.run(8, pipeline_depth=0, **run)
    assert "tuned" not in explicit["report"].meta
    np.testing.assert_array_equal(tuned["theta"], explicit["theta"])
    # an explicit depth wins over the store's
    assert "tuned" not in study.run(8, pipeline_depth=2, tuned=True,
                                    **run)["report"].meta
    assert study.warm_start(8, segment=4) >= 0.0
    np.testing.assert_array_equal(study.run(8, pipeline_depth=0,
                                            **run)["theta"],
                                  explicit["theta"])


# -- serve's ArraySpec and the CLI ----------------------------------------------

def test_array_spec_equals_jax():
    from fakepta_tpu.serve.spec import ArraySpec as JSpec
    from fakepta_tpu_torch.serve import (DEFAULT_BUCKETS, ArraySpec,
                                         ServeBusy, ServeError)
    spec = ArraySpec(npsr=6, ntoa=48, n_red=3, n_dm=3, gwb_ncomp=3)
    jspec_ = JSpec(npsr=6, ntoa=48, n_red=3, n_dm=3, gwb_ncomp=3)
    assert spec.spec_dict() == jspec_.spec_dict()
    assert spec.spec_hash() == jspec_.spec_hash()
    assert DEFAULT_BUCKETS == defaults.DEFAULT_BUCKETS
    assert issubclass(ServeBusy, ServeError)
    batch, gwb = spec.parts(device="cpu")
    jbatch, jgwb = jspec_.parts()
    np.testing.assert_array_equal(batch.numpy()["t_own"],
                                  np.asarray(jbatch.t_own))
    np.testing.assert_allclose(gwb.psd, jgwb.psd, rtol=1e-6)
    sim = spec.build(device="cpu")
    assert sim.dispatch_surface() == JaxSim(
        jbatch, gwb=jgwb, mesh=jax_mesh(jax.devices()[:1]),
        nbins=spec.nbins).dispatch_surface()
    with pytest.raises(NotImplementedError, match="compile_cache_dir"):
        spec.build(device="cpu", compile_cache_dir="/nonexistent")


def test_cli_search_show_apply_roundtrip(tmp_path, capsys):
    from fakepta_tpu_torch.tune.cli import main

    store = tmp_path / "store" / "tuned.json"
    artifact = tmp_path / "tune_art.jsonl"
    spec_args = ["--npsr", "6", "--ntoa", "48", "--n-red", "3",
                 "--n-dm", "3", "--gwb-ncomp", "3", "--device", "cpu"]
    assert main(["show", "--store", str(store)]) == 1          # empty
    assert main(["apply", *spec_args, "--store", str(store)]) == 1
    capsys.readouterr()
    assert main(["search", *spec_args, "--nreal-hint", "64",
                 "--max-candidates", "3", "--store", str(store),
                 "--out", str(artifact)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tuned"] == 1 and line["tune_probes"] >= 1
    assert line["knobs"]["chunk"] >= 1
    rep = RunReport.load(artifact)
    assert rep.summary()["tuned"] == 1 and rep.summary()["tune_probe_s"] > 0
    assert main(["show", "--store", str(store)]) == 0
    assert line["family"] in capsys.readouterr().out
    assert main(["apply", *spec_args, "--store", str(store)]) == 0
    assert json.loads(capsys.readouterr().out.strip())["knobs"] == \
        line["knobs"]
    assert main(["search", *spec_args, "--nreal-hint", "64",
                 "--max-candidates", "3", "--store", str(store)]) == 0
    warm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert warm["warm"] is True and warm["tune_probes"] == 0
    if not torch.cuda.is_available():
        # the card by default: without one, a configuration error
        assert main(["search", "--npsr", "6", "--store", str(store)]) == 2
        assert "cpu" in capsys.readouterr().err
