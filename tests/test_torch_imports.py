"""The PyTorch port stands alone: no JAX, no fakepta_tpu, no silent CPU."""

import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "fakepta_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "fakepta_tpu")
IMPORT_RE = re.compile(
    r"^\s*(?:from|import)\s+(jax|jaxlib|fakepta_tpu)(?![\w])", re.M)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.utils.masks", "fakepta_tpu_torch.ops.white",
    "fakepta_tpu_torch.ops.healpix", "fakepta_tpu_torch.obs.flightrec",
    "fakepta_tpu_torch.scenarios.cadence",
    "fakepta_tpu_torch.scenarios.registry"])
def test_scenario_modules_are_checked(module):
    """The scenario layer's modules, each a copy of a numpy-only module of
    the JAX package, are among the modules the checks below import and
    read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.utils.io", "fakepta_tpu_torch.obs.metrics",
    "fakepta_tpu_torch.obs.timing", "fakepta_tpu_torch.obs.flightrec",
    "fakepta_tpu_torch.obs.memwatch", "fakepta_tpu_torch.obs.report",
    "fakepta_tpu_torch.parallel.pipeline"])
def test_run_loop_modules_are_checked(module):
    """The run loop's modules (checkpoint, observability core, pipeline),
    each a port of a JAX package module, are among the modules the checks
    below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.ops.kepler", "fakepta_tpu_torch.ephemeris",
    "fakepta_tpu_torch.models", "fakepta_tpu_torch.models.roemer",
    "fakepta_tpu_torch.models.cgw"])
def test_signal_modules_are_checked(module):
    """The CGW and BayesEphem modules (the ephemeris a copy of a numpy-only
    module of the JAX package) are among the modules the checks below
    import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.detect", "fakepta_tpu_torch.detect.operators",
    "fakepta_tpu_torch.detect.run", "fakepta_tpu_torch.detect.cli",
    "fakepta_tpu_torch.detect.__main__"])
def test_detect_modules_are_checked(module):
    """The detection lane's modules (the operators a copy of a numpy-only
    module of the JAX package) are among the modules the checks below
    import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.fake_pta", "fakepta_tpu_torch.ops.fourier",
    "fakepta_tpu_torch.ops.woodbury", "fakepta_tpu_torch.ops.white",
    "fakepta_tpu_torch.utils.rng", "fakepta_tpu_torch.utils.io",
    "fakepta_tpu_torch.batch"])
def test_facade_modules_are_checked(module):
    """The reference-compatible facade and the modules it added to (each a
    port of a JAX package module) are among the modules the checks below
    import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.correlated_noises", "fakepta_tpu_torch.ops.gwb",
    "fakepta_tpu_torch.ops.woodbury", "fakepta_tpu_torch.infer",
    "fakepta_tpu_torch.infer.model", "fakepta_tpu_torch.infer.schema",
    "fakepta_tpu_torch.infer.reconstruct", "fakepta_tpu_torch.infer.run",
    "fakepta_tpu_torch.infer.cli", "fakepta_tpu_torch.infer.__main__"])
def test_correlated_and_infer_modules_are_checked(module):
    """The correlated signals and the likelihood lane's modules (each a
    port of a JAX package module) are among the modules the checks below
    import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.faults", "fakepta_tpu_torch.faults.plan",
    "fakepta_tpu_torch.faults.recovery", "fakepta_tpu_torch.tune",
    "fakepta_tpu_torch.tune.defaults", "fakepta_tpu_torch.ops.mcmc",
    "fakepta_tpu_torch.sample", "fakepta_tpu_torch.sample.model",
    "fakepta_tpu_torch.sample.run", "fakepta_tpu_torch.sample.factorized",
    "fakepta_tpu_torch.sample.cli", "fakepta_tpu_torch.sample.__main__"])
def test_faults_and_sample_modules_are_checked(module):
    """The recovery policy, the knob table and the sampler's modules (the
    plan and the knob table copies of pure-Python modules of the JAX
    package) are among the modules the checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.stream", "fakepta_tpu_torch.stream.state",
    "fakepta_tpu_torch.stream.refresh", "fakepta_tpu_torch.stream.bench",
    "fakepta_tpu_torch.detect.streaming", "fakepta_tpu_torch.obs.telemetry"])
def test_stream_modules_are_checked(module):
    """The streaming lane's modules and the telemetry plane (a copy of a
    pure-Python module of the JAX package) are among the modules the
    checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.parallel.mesh", "fakepta_tpu_torch.obs.trace",
    "fakepta_tpu_torch.obs.cli", "fakepta_tpu_torch.obs.__main__"])
def test_multihost_and_trace_modules_are_checked(module):
    """The multi-process mesh and the trace exporter and its CLI (ports of
    JAX package modules) are among the modules the checks below import and
    read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.tune", "fakepta_tpu_torch.tune.fingerprint",
    "fakepta_tpu_torch.tune.model", "fakepta_tpu_torch.tune.store",
    "fakepta_tpu_torch.tune.probe", "fakepta_tpu_torch.tune.search",
    "fakepta_tpu_torch.tune.cli", "fakepta_tpu_torch.tune.__main__",
    "fakepta_tpu_torch.serve", "fakepta_tpu_torch.serve.spec"])
def test_tune_and_serve_spec_modules_are_checked(module):
    """The tuner's modules and serve's spec surface (ports of JAX package
    modules) are among the modules the checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.obs.gate", "fakepta_tpu_torch.obs.promfmt",
    "fakepta_tpu_torch.obs.topview", "fakepta_tpu_torch.serve.pool",
    "fakepta_tpu_torch.serve.scheduler", "fakepta_tpu_torch.serve.router",
    "fakepta_tpu_torch.serve.health", "fakepta_tpu_torch.serve.autoscale",
    "fakepta_tpu_torch.serve.loadgen", "fakepta_tpu_torch.serve.cli",
    "fakepta_tpu_torch.serve.__main__"])
def test_serve_and_gate_modules_are_checked(module):
    """The serving layer's first half and the rest of obs/ (ports of JAX
    package modules; the router, promfmt and topview line for line) are
    among the modules the checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.serve.fleet", "fakepta_tpu_torch.serve.streams",
    "fakepta_tpu_torch.serve.loadgen", "fakepta_tpu_torch.serve.cli",
    "fakepta_tpu_torch.sample.factorized"])
def test_fleet_modules_are_checked(module):
    """The serve fleet, the served streams, the fleet load generators and
    the factorized sessions (ports of JAX package modules) are among the
    modules the checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.gateway", "fakepta_tpu_torch.gateway.core",
    "fakepta_tpu_torch.gateway.store", "fakepta_tpu_torch.gateway.tenants",
    "fakepta_tpu_torch.gateway.cutover", "fakepta_tpu_torch.serve.loadgen",
    "fakepta_tpu_torch.scenarios.registry",
    "fakepta_tpu_torch.scenarios.cadence"])
def test_gateway_modules_are_checked(module):
    """The gateway tier, its load generator and the scenarios' serve
    identity and append schedule (ports of JAX package modules) are among
    the modules the checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


@pytest.mark.parametrize("module", [
    "fakepta_tpu_torch.scenarios", "fakepta_tpu_torch.scenarios.golden",
    "fakepta_tpu_torch.scenarios.__main__"])
def test_golden_modules_are_checked(module):
    """The golden-run harness and the scenarios CLI (ports of JAX package
    modules) are among the modules the checks below import and read."""
    assert module in _port_modules()
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not IMPORT_RE.findall(path.read_text())


def test_golden_entry_points_default_to_the_card():
    """golden_run meshes the card and the memory lane every visible card
    unless the CPU is asked for; without a card both raise, and the CLI
    exits 2; the memory lane refuses a host device outright (it has no
    watermark there). The package exposes the JAX names."""
    import fakepta_tpu_torch.scenarios as scn_pkg
    from fakepta_tpu_torch.scenarios import __main__ as cli
    from fakepta_tpu_torch.scenarios import golden

    assert scn_pkg.__all__ == ["SCENARIOS", "Scenario", "get", "names",
                               "register"]
    assert cli.build_parser().parse_args(["run", "ng15"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            golden.golden_run("ng15")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            golden.memory_lane("ska_10k", sweep=(8,))
        assert cli.main(["run", "ng15", "--skip", "sample"]) == 2
    with pytest.raises(ValueError, match="watermark"):
        golden.memory_lane("ska_10k", sweep=(8,), devices=["cpu"])


def test_gateway_entry_points_default_to_the_card(tmp_path):
    """A Gateway keys its store by the devices its fleet serves on, and
    run_gateway_loadgen's replicas serve on the card unless the CPU is
    asked for; without a card the load generator fails to start its
    replicas and no CPU replica stands in."""
    from fakepta_tpu_torch.gateway import Gateway, ResultStore, Tenant
    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         ServeConfig, ServeFleet,
                                         run_gateway_loadgen)

    spec = ArraySpec(npsr=4, ntoa=16, n_red=2, n_dm=2, gwb_ncomp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_gateway_loadgen(spec, n_requests=4,
                                store_dir=tmp_path / "gw")
    flt = ServeFleet([LocalReplica("r0", device="cpu",
                                   config=ServeConfig(buckets=(4,)))])
    gw = Gateway(flt, [Tenant("a", "tok-a")],
                 store=ResultStore(tmp_path / "gw"))
    try:
        assert gw.fp.platform == "cpu"
    finally:
        gw.close()


def test_fleet_entry_points_default_to_the_card(tmp_path):
    """Replicas, the fleet load generators and the fleet CLI serve on the
    card unless the CPU is asked for; without a card a replica fails to
    start (a socket replica says why) and no CPU replica stands in."""
    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         SocketReplica, cli,
                                         run_fleet_loadgen)
    from fakepta_tpu_torch.serve.fleet import ReplicaDead

    assert cli.build_parser().parse_args(["fleet"]).device == "cuda"
    assert cli.build_parser().parse_args(["replica"]).device == "cuda"
    spec = ArraySpec(npsr=4, ntoa=16, n_red=2, n_dm=2, gwb_ncomp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LocalReplica("r0")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_fleet_loadgen(spec, fleet=1, transport="inproc")
        with pytest.raises(ReplicaDead, match="device='cpu'"):
            SocketReplica("p0", spec_defaults=spec)
    r = LocalReplica("r1", device="cpu")
    try:
        assert r.pool.mesh.local_device.type == "cpu"
    finally:
        r.close()


def test_serve_entry_points_default_to_the_card():
    """ServePool, run_loadgen and the serve CLI serve on the card unless
    the CPU is asked for; the package exposes the JAX names it ports."""
    import fakepta_tpu_torch.serve as serve_pkg
    from fakepta_tpu_torch.serve import (ArraySpec, ServeConfig, ServePool,
                                         cli, run_loadgen)

    # the JAX package's names
    assert set(serve_pkg.__all__) == {
        "DEFAULT_BUCKETS", "AppendRequest", "ArraySpec", "AutoscaleConfig",
        "Autoscaler", "FleetConfig", "HashRing", "HealthConfig",
        "HealthMonitor", "InferRequest", "LocalReplica", "OSRequest",
        "PoolEntry", "ReplicaDead", "SampleSessionSpec", "SamplingSession",
        "ServeBusy", "ServeClosed", "ServeConfig", "ServeError",
        "ServeFleet", "ServePool", "ServeResult", "ServeTimeout",
        "SimRequest", "SocketReplica", "StreamManager", "StreamRequest",
        "WarmPool", "curn_grid_spec", "run_elastic_loadgen",
        "run_fleet_loadgen", "run_gateway_loadgen", "run_loadgen"}
    assert cli.build_parser().parse_args(["loadgen"]).device == "cuda"
    spec = ArraySpec(npsr=4, ntoa=16, n_red=2, n_dm=2, gwb_ncomp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServePool()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_loadgen(spec, n_requests=2)
        assert cli.main(["loadgen", "--npsr", "4", "--ntoa", "16"]) == 2
    with pytest.raises(ValueError, match="not both"):
        ServePool(mesh=object(), device="cpu")
    pool = ServePool(device="cpu", config=ServeConfig(buckets=(4,)))
    try:
        assert pool.mesh.local_device.type == "cpu"
        assert pool.report().meta["platform"] == "cpu"
    finally:
        pool.close()


def test_tuner_entry_points_default_to_the_card():
    """The tuner fingerprints and searches every visible card unless CPU
    devices are listed; without a GPU that is an error, not the CPU."""
    from fakepta_tpu_torch import tune
    from fakepta_tpu_torch.serve import ArraySpec
    assert tune.fingerprint(["cpu"]).platform == "cpu"
    if not torch.cuda.is_available():
        for call in (tune.fingerprint,
                     lambda: tune.resolve_platform_knob("pipeline_depth"),
                     lambda: ArraySpec(npsr=4, ntoa=32).build()):
            with pytest.raises(RuntimeError, match="cpu"):
                call()


def test_multihost_defaults_to_the_card(monkeypatch):
    """initialize_multihost joins on the card unless CPU devices are
    listed, and NCCL is never picked for (or forced onto) CPU entries or a
    shared card."""
    from fakepta_tpu_torch.parallel import mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="local_devices=\\['cpu'\\]"):
            mesh.initialize_multihost("file:///nonexistent", 1, 0)
    assert mesh.process_index() == 0 and mesh.process_count() == 1
    cpu = [[{"device": "cpu", "card": None}]] * 2
    own = [[{"device": "cuda:0", "card": "a"}],
           [{"device": "cuda:1", "card": "b"}]]
    shared = [[{"device": "cuda:0", "card": "a"}]] * 2
    assert mesh.pick_backend(cpu) == "gloo"
    assert mesh.pick_backend(own) == "nccl"
    assert mesh.pick_backend(shared) == "gloo"
    assert mesh.pick_backend(own, "gloo") == "gloo"
    for layout in (cpu, shared):
        with pytest.raises(ValueError, match="nccl"):
            mesh.pick_backend(layout, "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        mesh.pick_backend(own, "mpi")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.initialize_multihost(local_devices=["cpu"])


def test_stream_entry_points_default_to_the_card():
    """StreamState, run_append_ab and the refreshers' samplers run on the
    card unless the CPU is asked for; the package exposes the JAX names."""
    import fakepta_tpu_torch.stream as stream_pkg
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.detect import StreamingOS
    from fakepta_tpu_torch.stream import (PosteriorRefresher, StreamState,
                                          default_stream_model)
    from fakepta_tpu_torch.stream.bench import run_append_ab

    assert stream_pkg.__all__ == [
        "STREAM_SCHEMA", "FactorizedRefresher", "PosteriorRefresher",
        "RefreshPolicy", "StreamCheckpoint", "StreamState",
        "default_stream_model"]
    assert StreamingOS.__module__ == "fakepta_tpu_torch.detect.streaming"
    tpl = PulsarBatch.synthetic(npsr=2, ntoa=16, n_red=2, n_dm=2,
                                dtype=torch.float64, device="cpu")
    model = default_stream_model(nbin=2)
    t = np.array([[1e6, 2e6], [1.5e6, 2.5e6]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamState(tpl, model)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_append_ab(npsr=2, ntoa=16, n_red=2, n_dm=2, nbin=2,
                          history=8)
        cpu_stream = StreamState(tpl, model, device="cpu")
        cpu_stream.append(t, np.zeros((2, 2)))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PosteriorRefresher(cpu_stream).refresh(2)
    stream = StreamState(tpl, model, device="cpu")
    assert stream.device.type == "cpu"
    info = stream.append(t, np.zeros((2, 2)))
    assert info["n_toas"] == 4 and stream.moments()[0].device.type == "cpu"
    row = run_append_ab(npsr=2, ntoa=16, n_red=2, n_dm=2, nbin=2,
                        history=8, device="cpu", repeats=1)
    assert row["stream_recompiles"] == 0 and row["stream_toas"] == 2 * 24


def test_sample_entry_points_default_to_the_card():
    """SamplingRun, FactorizedRun and the sampler CLI run on the card
    unless the CPU is asked for."""
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    from fakepta_tpu_torch.sample import (FactorizedRun, SampleSpec,
                                          SamplingRun, cli)

    assert cli.build_parser().parse_args(["run"]).device == "cuda"
    batch = PulsarBatch.synthetic(npsr=2, ntoa=16, n_red=2, n_dm=2,
                                  device="cpu")
    model = LikelihoodSpec(components=(ComponentSpec(
        "curn", nbin=2, spectrum="free_spectrum", free=(
            FreeParam("log10_rho", (-9.0, -5.0), per_bin=True),)),))
    spec = SampleSpec(model=model, n_chains=2, warmup=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SamplingRun(batch, spec)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FactorizedRun(batch, spec, lane_bins=1)
        assert cli.main(["run", "--npsr", "4", "--ntoa", "16"]) == 2
    with pytest.raises(ValueError, match="not both"):
        SamplingRun(batch, spec, mesh=object(), device="cpu")
    out = SamplingRun(batch, spec, device="cpu").run(2, segment=2)
    assert out["report"].meta["platform"] == "cpu"
    assert out["theta"].shape == (2, 2, 2)


def test_infer_entry_points_default_to_the_card():
    """InferenceRun and the likelihood CLI run on the card unless the CPU
    is asked for; the package exposes the correlated signals as the JAX
    package does."""
    import fakepta_tpu_torch
    from fakepta_tpu_torch import correlated_noises
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         InferenceRun, LikelihoodSpec, cli)

    assert fakepta_tpu_torch.correlated_noises is correlated_noises
    assert cli.build_parser().parse_args(["run"]).device == "cuda"
    batch = PulsarBatch.synthetic(npsr=4, ntoa=16, n_red=2, n_dm=2,
                                  device="cpu")
    model = LikelihoodSpec(components=(ComponentSpec("red", free=(
        FreeParam("log10_A", (-15.0, -13.0)),), fixed={"gamma": 3.0}),))
    kw = dict(theta=np.array([[-14.0]]), include=("white", "red"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceRun(batch, model, **kw)
        assert cli.main(["run", "--npsr", "4", "--ntoa", "16"]) == 2
    out = InferenceRun(batch, model, device="cpu", **kw).run(2, chunk=2)
    assert out["report"].meta["platform"] == "cpu"
    assert out["lnlike"]["lnl"].shape == (2, 1)


def test_facade_entry_points_default_to_the_card(tmp_path):
    """Pulsar, make_fake_array, copy_array and load_array run on the card
    unless the CPU is asked for; the package exposes the facade as the
    JAX package does."""
    import fakepta_tpu_torch
    from fakepta_tpu_torch.fake_pta import Pulsar, copy_array, make_fake_array
    from fakepta_tpu_torch.utils.io import load_array, save_array

    assert fakepta_tpu_torch.fake_pta.Pulsar is Pulsar
    toas = np.linspace(0.0, 3e8, 32)
    psr = Pulsar(toas, 1e-6, 1.0, 1.0, seed=1, device="cpu")
    psr.add_white_noise()
    path = save_array([psr], tmp_path / "a.pkl")
    if not torch.cuda.is_available():
        for call in (lambda: Pulsar(toas, 1e-6, 1.0, 1.0, seed=1),
                     lambda: make_fake_array(npsrs=2, Tobs=3.0, ntoas=20,
                                             seed=1),
                     lambda: copy_array([psr]),
                     lambda: load_array(path)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    psrs = make_fake_array(npsrs=2, Tobs=3.0, ntoas=20, seed=1,
                           device="cpu")
    assert all(p._device.type == "cpu" for p in psrs)
    assert copy_array(psrs, device="cpu")[0]._device.type == "cpu"
    assert load_array(path, device="cpu")[0]._device.type == "cpu"


def test_detect_entry_points_default_to_the_card():
    """DetectionRun and the detection CLI run on the card unless the CPU
    is asked for."""
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.detect import DetectionRun, cli
    from fakepta_tpu_torch.parallel.montecarlo import GWBConfig

    assert cli.build_parser().parse_args(["run"]).device == "cuda"
    batch = PulsarBatch.synthetic(npsr=4, ntoa=16, n_red=2, n_dm=2,
                                  device="cpu")
    f = np.arange(1, 3) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, -14.0, 13 / 3).numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectionRun(batch, gwb=gwb)
        assert cli.main(["run", "--npsr", "4", "--ntoa", "16"]) == 2
    out = DetectionRun(batch, gwb=gwb, device="cpu").run(4, chunk=4)
    assert out["report"].meta["platform"] == "cpu"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN_ROOTS!r})\n"
        "print(bad)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *ROOT.glob("tools/*.py"), ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_import(path):
    src = (ROOT / path).read_text()
    hits = IMPORT_RE.findall(src)
    assert not hits, f"{path} imports {hits}"
    assert "__import__(\"jax" not in src and "import_module(\"jax" not in src


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.scenarios import registry
    from fakepta_tpu_torch.scenarios.registry import flagship_batch
    from fakepta_tpu_torch.utils import rng

    kw = dict(npsr=4, ntoa=16, n_red=2, n_dm=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rng.key(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PulsarBatch.synthetic(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_batch()
    ng15 = registry.get("ng15").reduced(max_psr=8, max_toa=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ng15.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ng15.batch_parts()
    batch = PulsarBatch.synthetic(**kw, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnsembleSimulator(batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.to("cuda")
    # asking for the CPU explicitly works, the run loop's options too
    sim = EnsembleSimulator(batch, device="cpu")
    out = sim.run(2, seed=0, chunk=2)
    assert out["curves"].shape == (2, 15)
    assert out["report"].meta["platform"] == "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        ck = pathlib.Path(tmp) / "mc.npz"
        again = sim.run(2, seed=0, chunk=2, checkpoint=ck)
        assert not ck.exists()
    assert (again["curves"] == out["curves"]).all()
    lanes = sim.run(2, chunk=2, lanes=[(0, 2)])
    assert (lanes["curves"] == out["curves"]).all()
    # the signal entry points: the orbit state and a scenario with CGW and
    # BayesEphem draws default to the card as well
    from fakepta_tpu_torch.ephemeris import Ephemeris
    from fakepta_tpu_torch.models.roemer import nominal_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nominal_state(Ephemeris(), "jupiter", np.full((2, 4), 4.6e9))
    ipta = registry.get("ipta_dr3").reduced(max_psr=8, max_toa=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ipta.build()
    assert ipta.build(device="cpu").run(2, seed=0, chunk=2)[
        "curves"].shape == (2, 15)


def test_package_data_ships_the_cuda_sources():
    """A non-editable install carries every source the kernels build from."""
    import fnmatch
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["fakepta_tpu_torch"]
    sources = sorted(str(p.relative_to(PORT)) for p in
                     [*PORT.glob("csrc/*.cu"), *PORT.glob("csrc/*.cuh")])
    assert sources
    for src in sources:
        assert any(fnmatch.fnmatch(src, pat) for pat in patterns), src
    from fakepta_tpu_torch.ops import _build
    assert _build.BUILD_DIR.is_relative_to(PORT) or \
        os.environ.get("FAKEPTA_TORCH_BUILD_DIR")
