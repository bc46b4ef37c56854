"""The PyTorch port's detection lane against the JAX package, on the CPU.

``EnsembleSimulator.run(os=...)`` rides the optimal statistic's weight
matrices as extra weight slots of every statistic path, and
``OSSpec(null=True)`` adds the paired noise-only stream under the 0xD7 key
tag. Same batch, same seed: the port's amp2 and null amp2 land on the JAX
engine's within 1e-4 of max|amp2| at f32 (the JAX package's own bound for
its fused OS lanes, tests/test_detect.py) and 1e-2 under bf16 operand
rounding; the curves keep the engine's 1e-5 / 1e-2. The host-f64
operators and ``assemble`` equal the JAX module's to 1e-13.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.detect import OSSpec as JaxOSSpec
from fakepta_tpu.detect import cli as jax_cli
from fakepta_tpu.detect import operators as jax_ops
from fakepta_tpu.obs import RunReport as JaxRunReport
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.detect import DetectionRun, OSSpec
from fakepta_tpu_torch.detect import cli as port_cli
from fakepta_tpu_torch.detect import operators as port_ops
from fakepta_tpu_torch.obs.report import RunReport
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.ops import megakernel as mk
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from test_torch_engine import KW, _noisy_leaves, _psd

OS_TOL = {"f32": 1e-4, "bf16": 1e-2}
TOL = {"f32": 1e-5, "bf16": 1e-2}
# (stat_path, pallas_mxu_binning)
PATHS = (("einsum", True), ("fused", True), ("fused", False), ("mega", True))
PATH_IDS = ("einsum", "fused", "fused-vpu", "mega")
NSIDE = 1
H_MAP = np.random.default_rng(7).uniform(0.2, 1.8, 12 * NSIDE ** 2)
ORFS = ("hd", "monopole", "dipole", "anisotropic")
# every case runs four ORF lanes and the null stream, so one JAX
# executable serves them all (the weights are a traced argument)
SPECS = {
    "noise": dict(orf=ORFS, h_map=H_MAP, null=True),
    "none": dict(orf=ORFS, h_map=H_MAP, weighting="none", null=True),
    "sigma2": dict(orf=ORFS, h_map=H_MAP, null=True,
                   sigma2=np.linspace(1.0, 2.0, KW["npsr"]) * 1e-14),
}


def _gwb(tb):
    return GWBConfig(psd=_psd(float(tb.tspan_common)), orf="hd")


def _port_sim(tb, path=("einsum", True), **kw):
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return EnsembleSimulator(tb, gwb=_gwb(tb), stat_path=path[0],
                             pallas_mxu_binning=path[1], **kw)


def _assert_os(got, want, prec, orfs=ORFS, keys=("amp2", "null_amp2")):
    """Each ORF's lanes within OS_TOL[prec] of max|amp2| of ``want``."""
    for orf in orfs:
        scale = np.abs(want["os"]["stats"][orf]["amp2"]).max()
        for k in keys:
            np.testing.assert_allclose(
                got["os"]["stats"][orf][k], want["os"]["stats"][orf][k],
                rtol=0, atol=OS_TOL[prec] * scale, err_msg=f"{orf}/{k}")


def _assert_curves(got, want, prec):
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                               atol=TOL[prec] * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=TOL[prec])


@pytest.fixture(scope="module")
def noisy():
    """The small batch with every stage on, in both packages."""
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            PulsarBatch.from_numpy(leaves, device="cpu"))


@pytest.fixture(scope="module")
def jax_os(noisy):
    """The JAX XLA engine's OS runs, one per spec, on one executable."""
    sim = JaxSim(noisy[0], gwb=JaxGWB(psd=_psd(float(noisy[0].tspan_common)),
                                      orf="hd"),
                 mesh=jax_make_mesh(jax.devices()[:1]))
    return {name: sim.run(16, seed=3, chunk=8, os=JaxOSSpec(**kw))
            for name, kw in SPECS.items()}


# -- the host-f64 operators -------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_operators_and_assemble_match_jax(noisy, name):
    host = noisy[1].numpy()
    pos, mask, sigma2 = host["pos"], host["mask"], host["sigma2"]
    ops_t = port_ops.build_operators(OSSpec(**SPECS[name]), pos, mask,
                                     sigma2)
    ops_j = jax_ops.build_operators(JaxOSSpec(**SPECS[name]), pos, mask,
                                    sigma2)
    assert [o.orf for o in ops_t] == [o.orf for o in ops_j] == list(ORFS)
    for a, b in zip(ops_t, ops_j):
        np.testing.assert_allclose(a.weights, b.weights, rtol=1e-13,
                                   atol=1e-13 * np.abs(b.weights).max())
        np.testing.assert_allclose(a.sigma, b.sigma, rtol=1e-13)
        np.testing.assert_allclose(a.denom, b.denom, rtol=1e-13)
    rng = np.random.default_rng(11)
    vals, null = rng.standard_normal((2, 40, len(ORFS)))
    got = port_ops.assemble(OSSpec(**SPECS[name]), ops_t, vals, null)
    want = jax_ops.assemble(JaxOSSpec(**SPECS[name]), ops_j, vals, null)
    assert got["schema"] == want["schema"] == port_ops.DETECT_SCHEMA
    assert got.keys() == want.keys() and got["orfs"] == want["orfs"]
    for orf in ORFS:
        g, w = got["stats"][orf], want["stats"][orf]
        assert g.keys() == w.keys()
        for k in ("amp2", "snr", "null_amp2", "p_value"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-13)
        for k in ("sigma", "sigma_analytic", "sigma_empirical"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-13)
        assert g["null_quantiles"].keys() == w["null_quantiles"].keys()
        for q, v in w["null_quantiles"].items():
            np.testing.assert_allclose(g["null_quantiles"][q], v,
                                       rtol=1e-13)
    assert port_ops.NULL_QUANTILES == jax_ops.NULL_QUANTILES


def test_as_spec_and_validation_errors(noisy):
    assert port_ops.as_spec("hd").orfs == ("hd",)
    assert port_ops.as_spec(["hd", "dipole"]).orfs == ("hd", "dipole")
    sim = _port_sim(noisy[1])
    with pytest.raises(ValueError, match="curn"):
        sim.run(8, chunk=8, os="curn")
    with pytest.raises(ValueError, match="unknown ORF"):
        sim.run(8, chunk=8, os="quadrupole")
    with pytest.raises(ValueError, match="weighting"):
        sim.run(8, chunk=8, os=OSSpec(weighting="inverse"))
    with pytest.raises(TypeError, match="OSSpec"):
        sim.run(8, chunk=8, os=123)
    with pytest.raises(ValueError, match="at least one"):
        sim.run(8, chunk=8, os=())
    # the likelihood lane is still refused first, as before
    with pytest.raises(NotImplementedError, match="item 7"):
        sim.run(8, chunk=8, os="hd", lnlike=object())


# -- run(os=...) against the JAX engine --------------------------------------

@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
def test_os_paths_match_jax(noisy, jax_os, path, prec):
    out = _port_sim(noisy[1], path=path).run(
        16, seed=3, chunk=8, precision=prec, os=OSSpec(**SPECS["noise"]))
    want = jax_os["noise"]
    assert out["os"]["schema"] == want["os"]["schema"]
    assert out["os"]["orfs"] == list(ORFS) and out["os"]["null"]
    _assert_os(out, want, prec)
    _assert_curves(out, want, prec)
    meta = out["report"].meta["os"]
    assert meta == {"orfs": list(ORFS), "weighting": "noise", "null": True}
    assert out["report"].summary()["os_real_per_s_per_chip"] > 0


@pytest.mark.parametrize("name", ["none", "sigma2"])
def test_os_weightings_match_jax(noisy, jax_os, name):
    out = _port_sim(noisy[1]).run(16, seed=3, chunk=8,
                                  os=OSSpec(**SPECS[name]))
    _assert_os(out, jax_os[name], "f32")
    for orf in ORFS:
        np.testing.assert_allclose(
            out["os"]["stats"][orf]["sigma_analytic"],
            jax_os[name]["os"]["stats"][orf]["sigma_analytic"], rtol=1e-12)


def test_os_fused_matches_jax_pallas_interpret(noisy):
    """The JAX fused Pallas path in interpret mode at R = 8, full f32, with
    two ORF lanes and the null stream (its second kernel launch)."""
    spec = dict(orf=("hd", "monopole"), null=True)
    want = JaxSim(noisy[0], gwb=JaxGWB(psd=_psd(float(noisy[0].tspan_common)),
                                       orf="hd"),
                  mesh=jax_make_mesh(jax.devices()[:1]), use_pallas=True,
                  pallas_precision="f32").run(8, seed=3, chunk=8,
                                              os=JaxOSSpec(**spec))
    got = _port_sim(noisy[1], path=("fused", True),
                    pallas_precision="f32").run(8, seed=3, chunk=8,
                                                os=OSSpec(**spec))
    _assert_os(got, want, "f32", orfs=spec["orf"])
    _assert_curves(got, want, "f32")


def test_os_without_null_and_keep_corr(noisy, jax_os):
    """``os`` without the null stream packs only the amp2 lanes; with
    keep_corr the einsum run returns the pair correlations beside them, and
    the lanes equal their contraction against the operators."""
    sim = _port_sim(noisy[1], path=("mega", True))
    spec = OSSpec(orf=ORFS, h_map=H_MAP)
    out = sim.run(16, seed=3, chunk=8, os=spec, keep_corr=True)
    assert out["statistic_path"] == "einsum" and not out["os"]["null"]
    assert "null_amp2" not in out["os"]["stats"]["hd"]
    _assert_os(out, jax_os["noise"], "f32", keys=("amp2",))
    counts = sim.pair_counts
    ops = port_ops.build_operators(spec, noisy[1].numpy()["pos"],
                                   noisy[1].numpy()["mask"],
                                   noisy[1].numpy()["sigma2"])
    for op in ops:
        host = op.apply(out["corr"].astype(np.float64) * counts)
        amp2 = out["os"]["stats"][op.orf]["amp2"]
        np.testing.assert_allclose(amp2, host, rtol=0,
                                   atol=1e-5 * np.abs(host).max())
    # an ORF name or a sequence of names is accepted as well
    assert sim.run(8, seed=3, chunk=8, os="hd")["os"]["orfs"] == ["hd"]


# -- the null stream ----------------------------------------------------------

def test_null_stream_deterministic_and_without_the_signal(noisy):
    """The 0xD7 stream is reproducible, does not depend on the chunk size,
    and carries no injected background: a strong GWB lifts amp2 far above
    the null, and the null's own stats equal a GWB-free engine's OS lanes on
    the null keys (same noise stages)."""
    tb = noisy[1]
    loud = EnsembleSimulator(tb, gwb=GWBConfig(
        psd=_psd(float(tb.tspan_common), log10_A=-12.5), orf="hd"),
        device="cpu", stat_path="fused", pallas_precision="f32")
    spec = OSSpec(orf="hd", null=True)
    a = loud.run(32, seed=11, chunk=16, os=spec)
    b = loud.run(32, seed=11, chunk=16, os=spec)
    c = loud.run(32, seed=11, chunk=8, os=spec)
    sa, sb, sc = (x["os"]["stats"]["hd"] for x in (a, b, c))
    for k in ("amp2", "null_amp2"):
        np.testing.assert_array_equal(sa[k], sb[k])
        # another chunk size: the same draws, a contraction of another
        # shape (its float32 summation order may differ)
        np.testing.assert_allclose(sc[k], sa[k], rtol=0,
                                   atol=1e-6 * np.abs(sa["amp2"]).max())
    assert sa["amp2"].mean() > 5.0 * abs(sa["null_amp2"].mean())
    assert np.all((sa["p_value"] > 0.0) & (sa["p_value"] <= 1.0))
    assert sa["sigma"] == sa["sigma_empirical"] > 0.0
    qs = sa["null_quantiles"]
    assert qs["q50"] <= qs["q90"] <= qs["q95"] <= qs["q99"]
    # the null stream is the noise-only engine on fold_in(key, 0xD7):
    # the same stages without the GWB, through the signal lanes
    from fakepta_tpu_torch.parallel.montecarlo import _NULL_TAG, _chunk_keys
    from fakepta_tpu_torch.utils import rng
    quiet = EnsembleSimulator(tb, device="cpu", stat_path="fused",
                              pallas_precision="f32")
    keys = rng.fold_in(_chunk_keys(rng.key(11, device="cpu"), 0, 16),
                       _NULL_TAG)
    res0 = quiet._residuals(keys)
    lanes = loud._prepare_lanes(spec)
    w_null = lanes.weights[id(loud._full)][1]
    want, _ = bc.binned_correlation(res0, res0, w_null, 1, precision="f32")
    np.testing.assert_allclose(sa["null_amp2"][:16], want[:, 0].numpy(),
                               rtol=0, atol=1e-6 * np.abs(sa["amp2"]).max())


def test_mega_null_uses_the_gwb_free_stage_set(noisy):
    """On the mega path the null stream's coefficients stop before the GWB
    stage, and its launch runs on the stage set without it; its lanes equal
    the port's own einsum path (the JAX mega path does not run: ROADMAP
    Queue 3)."""
    sim = _port_sim(noisy[1], path=("mega", True))
    stages, times, scales = sim._mega_tables
    assert sim._mega_stages_null == stages[:len(sim._mega_stages_null)]
    assert mk.stage_k(stages) - mk.stage_k(sim._mega_stages_null) == 8
    spec = OSSpec(orf=ORFS, h_map=H_MAP, null=True)
    ref = _port_sim(noisy[1]).run(16, seed=5, chunk=8, os=spec)
    for prec in ("f32", "bf16"):
        out = sim.run(16, seed=5, chunk=8, os=spec, precision=prec)
        _assert_os(out, ref, prec)
        _assert_curves(out, ref, prec)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
def test_os_on_psr_meshes_match_jax(noisy, jax_os, path, shards):
    out = _port_sim(noisy[1], path=path,
                    mesh=make_mesh(["cpu"] * 8, psr_shards=shards)).run(
        16, seed=3, chunk=8, precision="f32", os=OSSpec(**SPECS["noise"]))
    _assert_os(out, jax_os["noise"], "f32")
    _assert_curves(out, jax_os["noise"], "f32")


def test_os_checkpoint_resume_keeps_the_lanes(noisy, tmp_path):
    """A checkpointed os run cut after its first chunk resumes with its
    lanes, bit-identical to the unbroken run; a resume with other lanes is
    refused."""
    sim = _port_sim(noisy[1], path=("fused", True), pallas_precision="f32")
    spec = OSSpec(orf=("hd", "dipole"), null=True)
    full = sim.run(24, seed=9, chunk=8, os=spec)
    ck = tmp_path / "ck.npz"

    def boom(done, nreal):
        if done >= 8:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        sim.run(24, seed=9, chunk=8, os=spec, checkpoint=ck, progress=boom,
                pipeline_depth=0)
    with pytest.raises(ValueError, match="extra"):
        sim.run(24, seed=9, chunk=8, checkpoint=ck)
    with pytest.raises(ValueError, match="extra"):
        sim.run(24, seed=9, chunk=8, os="hd", checkpoint=ck)
    out = sim.run(24, seed=9, chunk=8, os=spec, checkpoint=ck)
    for orf in spec.orfs:
        for k in ("amp2", "null_amp2", "p_value"):
            np.testing.assert_array_equal(out["os"]["stats"][orf][k],
                                          full["os"]["stats"][orf][k])
    np.testing.assert_array_equal(out["curves"], full["curves"])
    assert not ck.exists()


# -- DetectionRun and the CLI ---------------------------------------------

def test_detection_run_and_its_artifact(noisy, tmp_path):
    tb = noisy[1]
    study = DetectionRun(tb, gwb=GWBConfig(psd=_psd(
        float(tb.tspan_common), log10_A=-13.0), orf="hd"),
        os=("hd", "monopole"), device="cpu")
    assert study.spec.null, "null calibration is forced on"
    out = study.run(32, seed=2, chunk=16)
    direct = study.sim.run(32, seed=2, chunk=16, os=study.spec)
    for orf in ("hd", "monopole"):
        np.testing.assert_array_equal(out["os"]["stats"][orf]["amp2"],
                                      direct["os"]["stats"][orf]["amp2"])
    s = out["summary"]
    assert s["os_hd_significance_sigma"] > 1.0
    assert 0.0 <= s["os_hd_detection_rate"] <= 1.0
    names = {f"os_{o}_{k}" for o in ("hd", "monopole") for k in (
        "significance_sigma", "detection_rate", "amp2_mean",
        "null_amp2_mean", "sigma_empirical", "sigma_analytic", "null_q95",
        "p_value_median")}
    assert set(s) == names
    path = study.save(tmp_path / "study.jsonl")
    for loader in (RunReport.load, JaxRunReport.load):
        rep = loader(path)
        assert rep.meta["detect_schema"] == "fakepta_tpu.detect/1"
        summ = rep.summary()
        for k, v in s.items():
            assert summ[k] == v
        assert summ["os_real_per_s_per_chip"] > 0
    with pytest.raises(ValueError, match="run"):
        DetectionRun(tb, gwb=_gwb(tb), device="cpu").save(tmp_path / "x")


def test_cli_matches_jax_cli(tmp_path, capsys):
    """The same study through both CLIs. The port's runs the engine's
    default path (``"fused"``, bf16 operands), so its values are held at
    the bf16 bound of the amp2 scale."""
    args = ["run", "--npsr", "8", "--ntoa", "64", "--nreal", "16",
            "--chunk", "8", "--log10-A", "-13.0", "--orf", "hd", "dipole"]
    assert port_cli.main(args + ["--device", "cpu", "--out",
                                 str(tmp_path / "t.jsonl")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("artifact") == str(tmp_path / "t.jsonl")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if not k.startswith("os_"):
            assert got[k] == v, k
            continue
        orf = k.split("_")[1]
        scale = max(abs(want[f"os_{orf}_amp2_mean"]),
                    want[f"os_{orf}_sigma_empirical"])
        if k.endswith("_detection_rate"):
            assert abs(got[k] - v) <= 1.0 / 16 + 1e-12, k
        elif k.endswith("_p_value_median"):
            assert abs(got[k] - v) <= 1.0 / 17 + 1e-12, k
        elif k.endswith("_significance_sigma"):
            assert abs(got[k] - v) <= OS_TOL["bf16"] * max(1.0, abs(v)), k
        elif k.endswith("_sigma_analytic"):
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=OS_TOL["bf16"] * scale,
                                       err_msg=k)
    rep = RunReport.load(tmp_path / "t.jsonl")
    assert rep.meta["os"]["null"] and rep.meta["platform"] == "cpu"


def test_cli_configuration_errors_exit_2(capsys):
    assert port_cli.main(["run", "--device", "nonsense"]) == 2
    assert port_cli.main(["run", "--device", "cpu", "--npsr", "8",
                          "--ntoa", "64", "--nreal", "0"]) == 2
    if not torch.cuda.is_available():
        # the card is the default; without one the CLI says so
        assert port_cli.main(["run", "--npsr", "8", "--ntoa", "64"]) == 2
        assert "device='cpu'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_cli.main(["run", "--orf", "curn"])
    assert port_cli.build_parser().parse_args(["run"]).device == "cuda"
