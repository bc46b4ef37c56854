"""The port's likelihood lane on meshes, across checkpoints and through its
front ends (InferenceRun, the CLI), on the CPU.

Meshes: a float64 deterministic residual (``include=("det",)``) gives the
lane on psr 2, psr 4, toa 2 and psr 2 x toa 2 meshes within 1e-9 relative
of the 1-shard lane (the JAX package's mesh-invariance bound: resharding
moves only summation order). Drawn float32 residuals (every path, ECORR
epochs straddling the toa cells) are held to the 1-shard lane within the
float32 lane bound of tests/lane_bound.py (``LANE_ULPS`` float32 ULP of
the magnitudes U the lane's sums add, derived there).

On a quiet array (white noise and a weak background, so the residual
power is about the TOA count and U is a few times max|lnL|) the float32
lane is also held to the JAX lane within 1e-5 of max|lnL|.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import infer as jinfer
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.fake_pta import Pulsar as JaxPulsar
from fakepta_tpu.infer import cli as jax_cli
from fakepta_tpu.obs.report import RunReport as JaxRunReport
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch import infer as tinfer
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.infer import cli as port_cli
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator, GWBConfig
from test_torch_engine import KW, _noisy_leaves, _psd
from lane_bound import LANE_ULPS, assert_lanes, lane_unit
from test_torch_infer_engine import KW64, _curn, _noisy_model

CPU8 = ["cpu"] * 8
MESHES = {"psr2": dict(psr_shards=2), "psr4": dict(psr_shards=4),
          "toa2": dict(toa_shards=2),
          "psr2xtoa2": dict(psr_shards=2, toa_shards=2)}
# (stat_path, pallas_mxu_binning)
PATHS = (("einsum", True), ("fused", True), ("fused", False), ("mega", True))
PATH_IDS = ("einsum", "fused", "fused-vpu", "mega")
QUIET_TOL = 1e-5


def _spec(pkg, theta, mode="lnlike", nbin=8):
    return pkg.InferSpec(model=_curn(pkg, nbin), theta=theta, mode=mode)


# -- meshes ----------------------------------------------------------------

@pytest.fixture(scope="module")
def det64():
    tb = PulsarBatch.synthetic(**KW64, dtype=torch.float64, device="cpu")
    W = np.random.default_rng(5).standard_normal(tuple(tb.t_own.shape)) \
        * 1e-7
    spec = _spec(tinfer, tinfer.theta_grid(_curn(tinfer), (2, 2)), "grad")
    ref = EnsembleSimulator(tb, include=("det",), waveform=W,
                            stat_path="einsum", device="cpu").run(
        8, seed=0, chunk=8, lnlike=spec)["lnlike"]
    return tb, W, spec, ref


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_f64_lane_mesh_invariance(det64, shape):
    tb, W, spec, ref = det64
    sim = EnsembleSimulator(tb, include=("det",), waveform=W,
                            stat_path="einsum",
                            mesh=make_mesh(CPU8, **MESHES[shape]))
    got = sim.run(8, seed=0, chunk=8, lnlike=spec)["lnlike"]
    for k in ("lnl", "grad"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9,
                                   atol=1e-9 * np.abs(ref[k]).max(),
                                   err_msg=f"{shape} {k}")


@pytest.fixture(scope="module")
def noisy32():
    """The small batch with every stage on (ECORR epochs, chromatic noise,
    two system bands) and its 1-shard einsum lanes."""
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    tb = PulsarBatch.from_numpy(leaves, device="cpu")
    psd = _psd(float(tb.tspan_common))
    theta = tinfer.theta_grid(_noisy_model(tinfer), (2, 2))
    spec = tinfer.InferSpec(model=_noisy_model(tinfer), theta=theta,
                            mode="grad")
    sim = _sim(tb, psd)
    out = sim.run(8, seed=3, chunk=8, lnlike=spec)
    return tb, psd, spec, out, lane_unit(sim, spec, 3, 8)


def _sim(tb, psd, path=("einsum", True), **kw):
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return EnsembleSimulator(tb, gwb=GWBConfig(psd=psd, orf="hd"),
                             stat_path=path[0], pallas_mxu_binning=path[1],
                             pallas_precision="f32", **kw)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
def test_f32_lane_on_psr_meshes(noisy32, path, shards):
    """Every statistic path on a psr mesh (the mega path's sharded operand
    set, #4) gives the 1-shard lanes within the float32 lane bound."""
    tb, psd, spec, ref, unit = noisy32
    out = _sim(tb, psd, path, mesh=make_mesh(CPU8, psr_shards=shards)).run(
        8, seed=3, chunk=8, lnlike=spec)
    assert_lanes(out["lnlike"], ref["lnlike"], unit, ("lnl", "grad"),
                 f"{path} x{shards}")
    np.testing.assert_allclose(out["curves"], ref["curves"], rtol=0,
                               atol=1e-5 * np.abs(ref["curves"]).max())


@pytest.fixture(scope="module")
def straddling():
    """25 epochs of 5 TOAs and one of 3 with ECORR: toa_shards=2 and 4 put
    window boundaries inside epochs (built by the JAX facade and carried
    over leaf for leaf), a free red amplitude, and the JAX XLA lane."""
    day = 86400.0
    toas = np.concatenate([k * 30 * day + np.arange(5 if k < 25 else 3)
                           * 600.0 for k in range(26)])
    psrs = []
    for k in range(8):
        p = JaxPulsar(toas, 1e-7, np.arccos(1 - 2 * (k + 0.5) / 8),
                      2.39996 * k % (2 * np.pi), seed=k,
                      custom_model={"RN": 4, "DM": None, "Sv": None})
        p.noisedict[f"{p.name}_{p.backends[0]}_log10_ecorr"] = -6.3
        psrs.append(p)
    jb = JaxBatch.from_pulsars(psrs, n_red=4, n_dm=4, ecorr=True)
    leaves = {k: np.asarray(getattr(jb, k)) for k in jb.__dataclass_fields__}
    tb = PulsarBatch.from_numpy(leaves, device="cpu")
    include = ("white", "ecorr", "red")

    def model(pkg):
        C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
        return L(components=(C("red", nbin=4, free=(
            F("log10_A", (-15.0, -13.0)),), fixed={"gamma": 13 / 3}),))

    theta = np.array([[-14.5], [-14.0], [-13.5]])
    want = JaxSim(jb, include=include,
                  mesh=jax_make_mesh(jax.devices()[:1])).run(
        8, seed=7, chunk=8, lnlike=jinfer.InferSpec(model=model(jinfer),
                                                    theta=theta))
    return tb, include, tinfer.InferSpec(model=model(tinfer),
                                         theta=theta), want


@pytest.mark.parametrize("shape", ["toa2", "toa4", "psr2xtoa2"])
def test_ecorr_epochs_straddling_toa_cells(straddling, shape):
    """The lane's moment parts add over the toa cells before the ECORR
    downdate, so epochs cut by a window boundary give the 1-shard lanes;
    both agree with the JAX lane."""
    tb, include, spec, want = straddling
    kw = {"toa4": dict(toa_shards=4)}.get(shape, MESHES.get(shape))
    one = EnsembleSimulator(tb, include=include, stat_path="einsum",
                            device="cpu")
    assert one._include[1], "the ECORR stage is live"
    ref = one.run(8, seed=7, chunk=8, lnlike=spec)
    sim = EnsembleSimulator(tb, include=include, stat_path="einsum",
                            mesh=make_mesh(CPU8, **kw))
    windows = [c.ecorr_window for c in sim._shards[0]]
    assert any(lo_b == lo_a + n_a - 1 for (lo_a, n_a), (lo_b, _)
               in zip(windows, windows[1:])), "an epoch straddles a window"
    got = sim.run(8, seed=7, chunk=8, lnlike=spec)
    unit = lane_unit(one, spec, 7, 8)
    assert_lanes(got["lnlike"], ref["lnlike"], unit, what=shape)
    assert_lanes(ref["lnlike"], want["lnlike"], unit, what="vs jax")


def test_grad_lanes_stay_finite_for_a_faint_common_process():
    """A faint CURN puts phi below ~5e-20, where the division's chain rule
    squares a reciprocal past float32's range (the JAX float32 lane gives
    inf and NaN there); the port's derivative lanes stay finite and agree
    with its float64 lanes of the same fixed residual within the lane
    bound."""
    tb = PulsarBatch.synthetic(**KW64, device="cpu")
    W = np.random.default_rng(5).standard_normal(tuple(tb.t_own.shape)) \
        * 1e-7
    C, F, L = tinfer.ComponentSpec, tinfer.FreeParam, tinfer.LikelihoodSpec
    model = L(components=(C("red", spectrum="batch"), C("curn", nbin=8, free=(
        F("log10_A", (-17.0, -15.0)), F("gamma", (2.0, 6.0))))))
    spec = tinfer.InferSpec(model=model, theta=np.array([[-17.0, 2.0],
                                                         [-16.0, 4.0]]),
                            mode="fisher")
    compiled = tinfer.build(model, tb)
    assert float(compiled.phi(torch.as_tensor(spec.theta[0]), tb).min()) \
        < 5e-20
    kw = dict(include=("det",), waveform=W, stat_path="einsum",
              device="cpu")
    sim = EnsembleSimulator(tb, **kw)
    got = sim.run(2, seed=0, chunk=2, lnlike=spec)
    b64 = PulsarBatch.from_numpy(tb.numpy(), device="cpu",
                                 dtype=torch.float64)
    want = EnsembleSimulator(b64, **kw).run(2, seed=0, chunk=2, lnlike=spec)
    for k in ("lnl", "grad", "fisher"):
        assert np.isfinite(got["lnlike"][k]).all(), k
    assert_lanes(got["lnlike"], want["lnlike"],
                 lane_unit(sim, spec, 0, 2), ("lnl", "grad"))


# -- the quiet array: 1e-5 of max|lnL| against the JAX lane --------------

def test_f32_quiet_lane_within_1e5_of_max_lnl_of_jax():
    """White noise and a weak HD background: the float32 lanes carry no
    large cancellation, so the port's lane is held to the JAX XLA lane
    within 1e-5 of max|lnL| (the theta differences within the derived lane
    bound)."""
    kw = dict(KW, n_red=2, n_dm=2)
    jb = JaxBatch.synthetic(**kw)
    tb = PulsarBatch.synthetic(**kw, device="cpu")
    psd = _psd(float(jb.tspan_common), log10_A=-16.0)
    include = ("white", "gwb")
    theta = jinfer.theta_grid(_curn(jinfer, 4), (3, 3))
    want = JaxSim(jb, gwb=JaxGWB(psd=psd, orf="hd"), include=include,
                  mesh=jax_make_mesh(jax.devices()[:1])).run(
        8, seed=3, chunk=8, lnlike=_spec(jinfer, theta, nbin=4))
    sim = _sim(tb, psd, include=include)
    got = sim.run(8, seed=3, chunk=8, lnlike=_spec(tinfer, theta, nbin=4))
    g, w = got["lnlike"], want["lnlike"]
    scale = np.abs(w["lnl"]).max()
    unit = lane_unit(sim, _spec(tinfer, theta, nbin=4), 3, 8)
    assert LANE_ULPS * unit < QUIET_TOL * scale, "no large cancellation"
    np.testing.assert_allclose(g["lnl"], w["lnl"], rtol=0,
                               atol=QUIET_TOL * scale)
    np.testing.assert_allclose(g["lnl"] - g["lnl"][:, :1],
                               w["lnl"] - w["lnl"][:, :1], rtol=0,
                               atol=LANE_ULPS * unit)


# -- checkpoints and the run's options --------------------------------------

def test_checkpoint_resume_keeps_the_lanes(noisy32, tmp_path):
    """A checkpointed lnlike run cut after its first chunk resumes with its
    lanes, bit-identical to the unbroken run; a resume without the lane,
    with the OS lane or with another grid is refused."""
    tb, psd, spec, _, _ = noisy32
    sim = _sim(tb, psd, ("fused", True))
    lnl = tinfer.InferSpec(model=spec.model, theta=spec.theta)
    full = sim.run(24, seed=9, chunk=8, lnlike=lnl)
    ck = tmp_path / "ck.npz"

    def boom(done, nreal):
        if done >= 8:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        sim.run(24, seed=9, chunk=8, lnlike=lnl, checkpoint=ck,
                progress=boom, pipeline_depth=0)
    with pytest.raises(ValueError, match="extra"):
        sim.run(24, seed=9, chunk=8, checkpoint=ck)
    with pytest.raises(ValueError, match="extra"):
        sim.run(24, seed=9, chunk=8, os="hd", checkpoint=ck)
    with pytest.raises(ValueError, match="extra"):
        sim.run(24, seed=9, chunk=8, checkpoint=ck, lnlike=tinfer.InferSpec(
            model=spec.model, theta=spec.theta[:2]))
    out = sim.run(24, seed=9, chunk=8, lnlike=lnl, checkpoint=ck)
    np.testing.assert_array_equal(out["lnlike"]["lnl"],
                                  full["lnlike"]["lnl"])
    np.testing.assert_array_equal(out["curves"], full["curves"])
    assert not ck.exists()


def test_os_with_lnlike_raises_and_lanes_pack_after_the_auto(noisy32):
    tb, psd, spec, ref, _ = noisy32
    sim = _sim(tb, psd)
    with pytest.raises(ValueError, match="cannot combine"):
        sim.run(8, seed=3, chunk=8, os="hd", lnlike=spec)
    lanes = sim._prepare_lanes(None, spec)
    k, d = spec.theta.shape
    assert lanes.n_extra == k * (1 + d)
    assert ref["report"].meta["lnlike"] == {
        "k": k, "d": d, "mode": "grad", "params": ["curn_log10_A",
                                                   "curn_gamma"]}
    assert "lnlike_evals_per_s_per_chip" in ref["report"].summary()


# -- InferenceRun and the CLI ---------------------------------------------

def test_inference_run_matches_jax_and_its_artifact_loads(noisy32, tmp_path):
    tb, psd, _, _, unit = noisy32
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in tb.numpy().items()})
    truth = (-13.2, 13 / 3)
    model = _curn(tinfer, 4)
    study = tinfer.InferenceRun(tb, model, gwb=GWBConfig(psd=psd, orf="hd"),
                                grid_shape=(3, 3), truth=truth,
                                device="cpu", stat_path="einsum")
    assert study.sim.device.type == "cpu"
    out = study.run(8, seed=3, chunk=8)
    want = jinfer.InferenceRun(jb, _curn(jinfer, 4),
                               gwb=JaxGWB(psd=psd, orf="hd"),
                               grid_shape=(3, 3), truth=truth,
                               mesh=jax_make_mesh(jax.devices()[:1])).run(
        8, seed=3, chunk=8)
    assert_lanes(out["lnlike"], want["lnlike"], unit)
    s, ws = out["summary"], want["summary"]
    assert s.keys() == ws.keys()
    assert s["lnlike_grid_k"] == ws["lnlike_grid_k"] == 9
    np.testing.assert_allclose(s["lnlike_lnl_max_mean"],
                               ws["lnlike_lnl_max_mean"], rtol=0,
                               atol=LANE_ULPS * unit)
    path = study.save(tmp_path / "a" / "study.jsonl")
    for loader in (RunReport.load, JaxRunReport.load):
        rep = loader(path)
        assert rep.meta["infer_schema"] == "fakepta_tpu.infer/1"
        summ = rep.summary()
        for k, v in s.items():
            assert summ[k] == v
        assert summ["lnlike_evals_per_s_per_chip"] > 0
    with pytest.raises(ValueError, match="run"):
        tinfer.InferenceRun(tb, model, gwb=GWBConfig(psd=psd),
                            device="cpu").save(tmp_path / "x.jsonl")
    with pytest.raises(ValueError, match="truth"):
        tinfer.InferenceRun(tb, model, gwb=GWBConfig(psd=psd), truth=(1.0,),
                            device="cpu")
    fisher = tinfer.InferenceRun(tb, model, gwb=GWBConfig(psd=psd),
                                 theta=np.array([list(truth)]),
                                 mode="fisher", device="cpu").run(
        4, seed=1, chunk=4)
    H = fisher["lnlike"]["fisher_mean"]
    assert H.shape == (1, 2, 2)
    np.testing.assert_allclose(H, np.swapaxes(H, -1, -2), rtol=1e-5)


def test_cli_matches_jax_cli(tmp_path, capsys):
    """The same study through both CLIs: the summary keys and values, the
    lnL scale within the float32 lane bound of its own size."""
    args = ["run", "--npsr", "8", "--ntoa", "64", "--nreal", "16",
            "--chunk", "8", "--grid", "3", "3"]
    assert port_cli.main(args + ["--device", "cpu", "--out",
                                 str(tmp_path / "t.jsonl")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(args + ["--platform", "cpu"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("artifact") == str(tmp_path / "t.jsonl")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "lnlike_lnl_max_mean":
            # four float32 ULP of a white-weighted power a few hundred
            # times the lnL scale
            np.testing.assert_allclose(got[k], v, rtol=1e-4)
        elif k == "lnlike_map_l2_mean":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=0.1)
        elif k == "lnlike_map_hit_rate":
            assert abs(got[k] - v) <= 2.0 / 16 + 1e-12
        else:
            assert got[k] == v, k
    rep = RunReport.load(tmp_path / "t.jsonl")
    assert rep.meta["platform"] == "cpu"
    assert rep.meta["lnlike"]["k"] == 9


def test_cli_configuration_errors_exit_2(capsys):
    assert port_cli.main(["run", "--device", "nonsense"]) == 2
    assert port_cli.main(["run", "--device", "cpu", "--npsr", "8",
                          "--ntoa", "64", "--nreal", "0"]) == 2
    if not torch.cuda.is_available():
        # the card is the default; without one the CLI says so
        assert port_cli.main(["run", "--npsr", "8", "--ntoa", "64"]) == 2
        assert "device='cpu'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_cli.main(["run", "--mode", "hessian"])
    parsed = port_cli.build_parser().parse_args(["run"])
    want = jax_cli.build_parser().parse_args(["run"])
    assert parsed.device == "cuda"
    assert {k: v for k, v in vars(parsed).items() if k != "device"} == {
        k: v for k, v in vars(want).items() if k != "platform"}
