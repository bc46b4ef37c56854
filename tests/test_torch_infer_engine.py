"""The port's likelihood lane (``run(lnlike=...)``) against the JAX engine's
and a host float64 oracle, on the CPU.

Float64 (a deterministic ``include=("det",)`` residual, the engine's draws
being float32 only): ``lnl`` within 1e-10 relative of the JAX lane and of
the dense host oracle, ``grad`` and ``fisher`` within 1e-8 relative of the
JAX lane (the port differentiates forward, the JAX lane ``jacrev``).

Float32 (drawn residuals, the JAX engine on its XLA path with a one-device
mesh): within ``LANE_ULPS`` float32 ULP of the magnitudes U the lane's
float32 sums add (tests/lane_bound.py derives the bound). On the reference
tests' noisy batch the white-weighted residual power (~2e6 against |lnL|
~ 7e3) dominates U, and the JAX lane is itself ~1.4e-4 of max|lnL| off
its float64 oracle there. The port's float32 lane is held to the float64
oracle of its own residuals by the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import infer as jinfer
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch import infer as tinfer
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.ops import woodbury
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig, _chunk_keys)
from fakepta_tpu_torch.utils import rng
from lane_bound import assert_lanes, lane_unit
from test_torch_engine import KW, _noisy_leaves, _psd

F64_RTOL = {"lnl": 1e-10, "grad": 1e-8, "fisher": 1e-8}
# (stat_path, pallas_mxu_binning)
PATHS = (("einsum", True), ("fused", True), ("fused", False), ("mega", True))
PATH_IDS = ("einsum", "fused", "fused-vpu", "mega")
NREAL, CHUNK, SEED = 8, 8, 3
KW64 = dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=8,
            n_dm=8, seed=1)


def _curn(pkg, nbin=8):
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C("red", spectrum="batch"), C("dm", spectrum="batch"),
        C("curn", nbin=nbin, free=(F("log10_A", (-13.8, -12.6)),
                                   F("gamma", (2.0, 6.0))))))


def _noisy_model(pkg):
    """Every GP stage of the noisy batch, the system bands included, and a
    free CURN."""
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C("red", spectrum="batch"), C("dm", spectrum="batch"),
        C("chrom", spectrum="batch"), C("sys", spectrum="batch"),
        C("curn", nbin=4, free=(F("log10_A", (-14.5, -12.5)),
                                F("gamma", (2.0, 6.0))))))


def _scoped_model(pkg):
    """Per-pulsar red amplitudes and a per-bin free-spectrum CURN."""
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C("red", free=(F("log10_A", (-15.0, -13.0), per_pulsar=True),),
          fixed={"gamma": 13 / 3}),
        C("dm", spectrum="batch"),
        C("curn", spectrum="free_spectrum", nbin=3,
          free=(F("log10_rho", (-9.0, -6.0), per_bin=True),))))


def _scoped_theta(d):
    rng_ = np.random.default_rng(8)
    return np.concatenate([rng_.uniform(-15.0, -13.0, (2, d - 3)),
                           rng_.uniform(-9.0, -6.0, (2, 3))], axis=1)


# -- float64, deterministic residuals -----------------------------------------

@pytest.fixture(scope="module")
def det64():
    """(port batch, JAX batch, waveform, theta, the JAX fisher lanes)."""
    jb = JaxBatch.synthetic(**KW64, dtype=jnp.float64)
    tb = PulsarBatch.synthetic(**KW64, dtype=torch.float64, device="cpu")
    W = np.random.default_rng(5).standard_normal(tuple(tb.t_own.shape)) \
        * 1e-7
    theta = jinfer.theta_grid(_curn(jinfer), (3, 3))
    out = JaxSim(jb, include=("det",), waveform=W,
                 mesh=jax_make_mesh(jax.devices()[:1])).run(
        2, seed=0, chunk=2, lnlike=jinfer.InferSpec(
            model=_curn(jinfer), theta=theta, mode="fisher"))
    return tb, jb, W, theta, out["lnlike"]


@pytest.mark.parametrize("mode", ["lnlike", "grad", "fisher"])
def test_f64_lane_matches_jax(det64, mode):
    tb, _, W, theta, want = det64
    out = EnsembleSimulator(tb, include=("det",), waveform=W,
                            stat_path="einsum", device="cpu").run(
        2, seed=0, chunk=2, lnlike=tinfer.InferSpec(
            model=_curn(tinfer), theta=theta, mode=mode))
    got = out["lnlike"]
    assert got["schema"] == want["schema"] == "fakepta_tpu.infer/1"
    assert got["param_names"] == want["param_names"]
    assert got["mode"] == mode
    np.testing.assert_array_equal(got["theta"], want["theta"])
    keys = {"lnlike": ("lnl",), "grad": ("lnl", "grad"),
            "fisher": ("lnl", "grad", "fisher")}[mode]
    assert set(got) - {"schema", "mode", "theta", "param_names"} == set(keys)
    for k in keys:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=F64_RTOL[k],
                                   atol=F64_RTOL[k] * np.abs(want[k]).max(),
                                   err_msg=k)
    if mode == "fisher":
        H = got["fisher"]
        np.testing.assert_allclose(H, np.swapaxes(H, -1, -2), rtol=1e-8)
    assert out["report"].meta["lnlike"] == {
        "k": 9, "d": 2, "mode": mode, "params": want["param_names"]}


def test_f64_lane_matches_the_dense_host_oracle(det64):
    """The lane on a deterministic residual equals a dense f64 covariance
    evaluation per pulsar, summed (every realization is the same)."""
    tb, _, W, theta, _ = det64
    out = EnsembleSimulator(tb, include=("det",), waveform=W,
                            stat_path="einsum", device="cpu").run(
        2, seed=0, chunk=2, lnlike=tinfer.InferSpec(model=_curn(tinfer),
                                                    theta=theta))
    lnl = out["lnlike"]["lnl"]
    np.testing.assert_array_equal(lnl[0], lnl[1])
    compiled = tinfer.build(_curn(tinfer), tb)
    tmat = compiled.basis(tb).numpy()
    sigma2 = tb.sigma2.numpy()
    for k in (0, 4, 8):
        phi = compiled.phi(torch.as_tensor(theta[k]), tb).numpy()
        want = 0.0
        for p in range(tb.npsr):
            C = np.diag(sigma2[p]) + tmat[p] @ np.diag(phi[p]) @ tmat[p].T
            _, ld = np.linalg.slogdet(C)
            want += -0.5 * (W[p] @ np.linalg.solve(C, W[p]) + ld
                            + len(W[p]) * np.log(2 * np.pi))
        np.testing.assert_allclose(lnl[0, k], want, rtol=1e-10)


# -- float32, drawn residuals ------------------------------------------------

@pytest.fixture(scope="module")
def noisy():
    """The small batch with every stage on (ECORR epochs, chromatic noise,
    two system bands) in both packages, and the JAX XLA engine's lanes:
    the noisy model in grad mode and the scoped model (per-pulsar and
    per-bin parameters) in lnlike mode."""
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tb = PulsarBatch.from_numpy(leaves, device="cpu")
    psd = _psd(float(jb.tspan_common))
    jsim = JaxSim(jb, gwb=JaxGWB(psd=psd, orf="hd"),
                  mesh=jax_make_mesh(jax.devices()[:1]))
    theta = jinfer.theta_grid(_noisy_model(jinfer), (2, 2))
    d_scoped = jinfer.build(_scoped_model(jinfer), jb).D
    scoped_theta = _scoped_theta(d_scoped)
    runs = {
        "noisy": jsim.run(NREAL, seed=SEED, chunk=CHUNK,
                          lnlike=jinfer.InferSpec(
                              model=_noisy_model(jinfer), theta=theta,
                              mode="grad")),
        "scoped": jsim.run(NREAL, seed=SEED, chunk=CHUNK,
                           lnlike=jinfer.InferSpec(
                               model=_scoped_model(jinfer),
                               theta=scoped_theta)),
    }
    return tb, psd, {"noisy": theta, "scoped": scoped_theta}, runs


def _port_sim(tb, psd, path=("einsum", True), **kw):
    return EnsembleSimulator(tb, gwb=GWBConfig(psd=psd, orf="hd"),
                             stat_path=path[0], pallas_mxu_binning=path[1],
                             pallas_precision="f32", device="cpu", **kw)


@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
def test_f32_lane_matches_jax_on_every_path(noisy, path):
    tb, psd, thetas, runs = noisy
    sim = _port_sim(tb, psd, path)
    spec = tinfer.InferSpec(model=_noisy_model(tinfer),
                            theta=thetas["noisy"], mode="grad")
    out = sim.run(NREAL, seed=SEED, chunk=CHUNK, lnlike=spec)
    want = runs["noisy"]
    assert out["statistic_path"] == path[0]
    assert_lanes(out["lnlike"], want["lnlike"],
                 lane_unit(sim, spec, SEED, CHUNK), ("lnl", "grad"),
                 str(path))
    # the statistic beside the lane keeps the engine's bound
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(out["curves"], want["curves"], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(out["autos"], want["autos"], rtol=1e-5)


def test_f32_scoped_parameters_match_jax(noisy):
    tb, psd, thetas, runs = noisy
    sim = _port_sim(tb, psd)
    compiled = tinfer.build(_scoped_model(tinfer), tb)
    assert compiled.param_names[0] == "red_log10_A[0]"
    assert compiled.param_names[-1] == "curn_log10_rho[2]"
    spec = tinfer.InferSpec(model=_scoped_model(tinfer),
                            theta=thetas["scoped"])
    out = sim.run(NREAL, seed=SEED, chunk=CHUNK, lnlike=spec)
    assert_lanes(out["lnlike"], runs["scoped"]["lnlike"],
                 lane_unit(sim, spec, SEED, CHUNK), what="scoped")


def test_f32_lane_within_its_bound_of_the_f64_oracle(noisy):
    """The port's float32 lane against float64 Woodbury sums of its own
    float32 residuals, with the ECORR epochs of the batch."""
    tb, psd, thetas, _ = noisy
    sim = _port_sim(tb, psd)
    spec = tinfer.InferSpec(model=_noisy_model(tinfer), theta=thetas["noisy"])
    out = sim.run(NREAL, seed=SEED, chunk=CHUNK, lnlike=spec)
    res = sim._residuals(_chunk_keys(rng.key(SEED, device="cpu"), 0,
                                     CHUNK)).double()
    leaves = tb.numpy()
    b64 = PulsarBatch.from_numpy(leaves, device="cpu", dtype=torch.float64)
    compiled = tinfer.build(_noisy_model(tinfer), b64)
    tmat = compiled.basis(b64)
    ep = b64.max_toa
    args = (tmat, b64.sigma2, b64.mask, b64.epoch_idx, b64.ecorr_amp)
    M, lndetN, nv, corr = woodbury.finish_fixed(
        woodbury.fixed_parts(*args, num_epochs=ep))
    d0, dT = woodbury.finish_res(woodbury.res_parts(res, *args,
                                                    num_epochs=ep), corr)
    want = np.stack([woodbury.lnlike_from_moments(
        d0, dT, M, lndetN, nv,
        compiled.phi(torch.as_tensor(t), b64)).sum(-1).numpy()
        for t in thetas["noisy"]], axis=1)
    assert_lanes(out["lnlike"], {"lnl": want},
                 lane_unit(sim, spec, SEED, CHUNK), what="f64")


def test_lane_reruns_bit_identical_and_keeps_the_statistic(noisy):
    """A rerun gives the same lanes bit for bit; the curves and autos are
    those of the same run without the lane."""
    tb, psd, thetas, _ = noisy
    sim = _port_sim(tb, psd, ("mega", True))
    spec = tinfer.InferSpec(model=_noisy_model(tinfer), theta=thetas["noisy"])
    a = sim.run(NREAL, seed=SEED, chunk=4, lnlike=spec)
    b = sim.run(NREAL, seed=SEED, chunk=4, lnlike=spec)
    np.testing.assert_array_equal(a["lnlike"]["lnl"], b["lnlike"]["lnl"])
    plain = sim.run(NREAL, seed=SEED, chunk=4)
    np.testing.assert_array_equal(a["curves"], plain["curves"])
    np.testing.assert_array_equal(a["autos"], plain["autos"])
