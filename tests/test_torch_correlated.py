"""The port's correlated signals (``correlated_noises.py``, the correlated
draw of ``ops/gwb.py``) against the JAX facade, on the CPU.

The JAX facade runs inside ``jax.enable_x64(False)`` (float32 draws, its
accelerator default); same seeds, same inputs. Tolerances:

- ORFs, antenna patterns and the host diagnostics (``get_correlations``,
  ``bin_curve``, ``optimal_statistic``): host float64 in both, within
  1e-12;
- the correlated coefficient block and the stored ``fourier`` entries:
  1e-6 plus half the PSD bound, relative (the normals under them agree
  to a few float32 ULP, the float32 PSD within 3e-5), as for the facade's
  GP entries (tests/test_torch_facade.py);
- residuals within 1e-5 of each pulsar's residual scale;
- the joint-covariance realization: its host float64 arithmetic on the
  JAX facade's own normals within 1e-10 of scale; end to end (the port's
  normals, a few float32 ULP from the JAX ones, through a Cholesky factor
  of a rank-deficient covariance) within the residual bound;
- the Roemer delay: host float64 in both, within 1e-10 of scale.
"""

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import constants as const
from fakepta_tpu import correlated_noises as jcn
from fakepta_tpu import fake_pta as jfp
from fakepta_tpu.ephemeris import Ephemeris as JaxEphemeris
from fakepta_tpu.ops import gwb as jgwb
from fakepta_tpu.utils import io as jio
from fakepta_tpu.utils import rng as jrng
import fakepta_tpu_torch
from fakepta_tpu_torch import correlated_noises as tcn
from fakepta_tpu_torch import fake_pta as tfp
from fakepta_tpu_torch.ephemeris import Ephemeris
from fakepta_tpu_torch.ops import gwb as tgwb
from fakepta_tpu_torch.utils import io as tio
from fakepta_tpu_torch.utils import rng as trng

HOST_RTOL = 1e-12
PSD_RTOL = 3e-5
COEF_RTOL = 1e-6 + PSD_RTOL / 2
RES_TOL = 1e-5
GP_HOST_TOL = 1e-10
ORFS = ("hd", "monopole", "dipole", "curn", "anisotropic")
H_MAP = np.random.default_rng(7).uniform(0.2, 1.8, 48)


@pytest.fixture
def x64_off():
    with jax.enable_x64(False):
        yield


def _array(mod, npsr=5, ntoa=120, seed=100, ragged=(), ephem=None):
    """Pulsars on a 12-year grid (``ragged``: indices that keep only their
    first 90 TOAs), positions from a seeded numpy stream."""
    rng = np.random.default_rng(seed)
    toas = np.linspace(0, 12 * const.yr, ntoa)
    kw = {} if mod is jfp else {"device": "cpu"}
    if ephem is not None:
        kw["ephem"] = ephem
    out = []
    for k in range(npsr):
        theta, phi = np.arccos(rng.uniform(-1, 1)), rng.uniform(0, 2 * np.pi)
        t = toas[:90] if k in ragged else toas
        out.append(mod.Pulsar(t, 1e-7, theta, phi, seed=seed + k, **kw))
    return out


def _scale_close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _same_common(tps, jps, name="gw_common"):
    """Stored entries and residuals of two arrays within the bounds."""
    for tp, jp in zip(tps, jps):
        te, je = tp.signal_model[name], jp.signal_model[name]
        assert te.keys() == je.keys()
        for k in ("orf", "spectrum", "nbin", "idx", "freqf"):
            assert te[k] == je[k], k
        np.testing.assert_array_equal(te["f"], je["f"])
        np.testing.assert_allclose(te["psd"], np.asarray(je["psd"]),
                                   rtol=PSD_RTOL)
        if "fourier" in je:
            four = np.asarray(je["fourier"])
            np.testing.assert_allclose(te["fourier"], four, rtol=COEF_RTOL,
                                       atol=COEF_RTOL * np.abs(four).max())
        _scale_close(tp.residuals, jp.residuals, RES_TOL, tp.name)


# -- ORFs and the host diagnostics -------------------------------------------

@pytest.mark.parametrize("orf", ORFS)
def test_orfs_match_jax(orf):
    tps, jps = _array(tfp, 7), _array(jfp, 7)
    args = (H_MAP,) if orf == "anisotropic" else ()
    got = getattr(tcn, orf)(tps, *args)
    want = np.asarray(getattr(jcn, orf)(jps, *args))
    _scale_close(got, want, HOST_RTOL, orf)
    pos = np.stack([p.pos for p in tps])
    _scale_close(tgwb.orf_cholesky(tgwb.build_orf(orf, pos, H_MAP)),
                 jgwb.orf_cholesky(jgwb.build_orf(orf, pos, H_MAP)),
                 HOST_RTOL, f"{orf} cholesky")


def test_antenna_patterns_match_jax():
    pos = np.array([0.3, -0.5, np.sqrt(1 - 0.34)])
    th = np.array([np.pi / 2, np.pi / 3, 2.0])
    ph = np.array([0.0, 1.0, 4.0])
    for a, b in zip(tcn.create_gw_antenna_pattern(pos, th, ph),
                    jcn.create_gw_antenna_pattern(pos, th, ph)):
        _scale_close(a, b, HOST_RTOL)


def test_diagnostics_match_jax():
    rng = np.random.default_rng(4)
    tps, jps = _array(tfp, 6), _array(jfp, 6)
    res = [rng.standard_normal(120) * 1e-7 for _ in tps]
    for a, b in zip(tcn.get_correlations(tps, res),
                    jcn.get_correlations(jps, res)):
        _scale_close(a, b, HOST_RTOL)
    corrs, angles, _ = tcn.get_correlations(tps, res)
    for a, b in zip(tcn.bin_curve(corrs, angles, 5),
                    jcn.bin_curve(corrs, angles, 5)):
        np.testing.assert_allclose(a, b, rtol=HOST_RTOL, equal_nan=True)
    corr = rng.standard_normal((9, 6, 6)) * 1e-14
    corr = corr + corr.transpose(0, 2, 1) + 6e-14 * np.eye(6)
    pos = np.stack([p.pos for p in tps])
    counts = rng.integers(50, 120, (6, 6)).astype(float)
    null = rng.standard_normal(30) * 1e-15
    for kw in (dict(counts=counts), dict(counts=counts, null_amp2=null),
               dict(orf="anisotropic", h_map=H_MAP, counts=counts)):
        got = tcn.optimal_statistic(corr, pos, **kw)
        want = jcn.optimal_statistic(corr, pos, **kw)
        for k in ("amp2", "sigma", "snr"):
            _scale_close(got[k], want[k], HOST_RTOL, k)
    with pytest.warns(UserWarning, match="without counts"):
        tcn.optimal_statistic(corr[0], pos)
    with pytest.raises(ValueError, match="undefined"):
        tcn.optimal_statistic(corr, pos, orf="curn", counts=counts)
    with pytest.raises(ValueError, match="equal-length"):
        tcn.get_correlations(tps[:2], [res[0], res[1][:10]])


def test_correlated_draw_matches_jax(x64_off):
    """The (2, ncomp, npsr) block: z @ chol.T times sqrt(psd), z drawn from
    one key, against the JAX draw on the same key."""
    pos = np.stack([p.pos for p in _array(tfp, 9)])
    chol = tgwb.orf_cholesky(tgwb.hd_orf(pos))
    psd = 10.0 ** np.linspace(-20, -24, 12)
    got = tgwb.draw_correlated_coeffs(trng.as_key(5), chol, psd).numpy()
    want = np.asarray(jgwb.draw_correlated_coeffs(
        jrng.as_key(5), jgwb.orf_cholesky(jgwb.hd_orf(pos)).astype(
            np.float32), psd.astype(np.float32)))
    assert got.shape == want.shape == (2, 12, 9) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=COEF_RTOL,
                               atol=COEF_RTOL * np.abs(want).max())


# -- the factorized injector --------------------------------------------------

CASES = {
    # one TOA count: the batched path, fresh then re-injected
    "uniform": dict(ragged=(), calls=[dict(seed=7), dict(seed=8)]),
    # ragged TOAs: the per-pulsar path, fresh then re-injected
    "ragged": dict(ragged=(1, 3), calls=[dict(seed=3), dict(seed=4)]),
    # chromatic entries re-injected with their stored idx / freqf
    "chromatic": dict(ragged=(), calls=[
        dict(idx=2, freqf=700, components=6, seed=1),
        dict(idx=2, freqf=700, components=6, seed=2),
        dict(idx=4, components=5, seed=3)]),
    # an anisotropic background over a custom grid and PSD
    "custom": dict(ragged=(2,), calls=[dict(
        orf="anisotropic", h_map=H_MAP, spectrum="custom",
        f_psd=np.arange(1, 9) / (12 * const.yr),
        custom_psd=10.0 ** np.linspace(-12, -16, 8), seed=11)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_add_common_correlated_noise_matches_jax(x64_off, case):
    spec = CASES[case]
    tps = _array(tfp, ragged=spec["ragged"])
    jps = _array(jfp, ragged=spec["ragged"])
    for call in spec["calls"]:
        kw = dict(dict(log10_A=-14.0, gamma=13 / 3), **call) \
            if call.get("spectrum") != "custom" else call
        got = tcn.add_common_correlated_noise(tps, **kw)
        want = jcn.add_common_correlated_noise(jps, **kw)
        _scale_close(got, want, HOST_RTOL, "orf")
        _same_common(tps, jps)
    for tp, jp in zip(tps, jps):
        assert tp.noisedict == jp.noisedict
        # the GWB is every signal: the stored entry reconstructs it
        _scale_close(tp.reconstruct_signal(["gw_common"]), tp.residuals,
                     RES_TOL, "reconstruct")


def test_batched_and_per_pulsar_paths_draw_alike(x64_off):
    """A ragged array (per-pulsar path) and a uniform one (batched path)
    with the same seed store the same coefficients for the pulsars they
    share."""
    uniform, ragged = _array(tfp, 4, seed=50), _array(tfp, 4, seed=50,
                                                      ragged=(2,))
    for psrs in (uniform, ragged):
        tcn.add_common_correlated_noise(psrs, log10_A=-13.5, gamma=13 / 3,
                                        seed=9)
    for a, b in zip(uniform[:2], ragged[:2]):
        np.testing.assert_array_equal(a.signal_model["gw_common"]["fourier"],
                                      b.signal_model["gw_common"]["fourier"])
    # the projections differ only in their float32 sums' batching
    _scale_close(uniform[0].residuals, ragged[0].residuals, 1e-6)


def test_unseeded_draws_follow_the_jax_stream(x64_off):
    """Without a seed both packages take the next key of their "gwb"
    stream (a process-wide counter in each): the port's draws equal the
    JAX facade's once the two counters are aligned."""
    tps, jps = _array(tfp, 3), _array(jfp, 3)
    trng._auto_streams = jrng._auto_streams = 1000
    tcn.add_common_correlated_noise(tps, log10_A=-14.0, gamma=13 / 3)
    jcn.add_common_correlated_noise(jps, log10_A=-14.0, gamma=13 / 3)
    _same_common(tps, jps)


# -- the joint-covariance injector -------------------------------------------

def test_gp_host_arithmetic_matches_jax_on_the_same_normals(x64_off,
                                                           monkeypatch):
    """The realization's float64 host arithmetic (covariance, jitter,
    Cholesky, product) on the JAX facade's own float32 normals and one
    float64 PSD (a named spectrum's float32 PSDs differ within 3e-5)."""
    tps, jps = _array(tfp, 3, 30), _array(jfp, 3, 30)
    jax_normal = np.asarray(jax.random.normal(jrng.as_key(5), (90,)))
    monkeypatch.setattr(tcn.rng_utils, "normal",
                        lambda key, shape: torch.from_numpy(jax_normal))
    f = np.arange(1, 6) / (12 * const.yr)
    kw = dict(spectrum="custom", f_psd=f, custom_psd=np.asarray(
        jcn.spectrum_lib.powerlaw(f, log10_A=-13.5, gamma=3.0)),
        idx=2, freqf=700, seed=5)
    tcn.add_common_correlated_noise_gp(tps, **kw)
    jcn.add_common_correlated_noise_gp(jps, **kw)
    for tp, jp in zip(tps, jps):
        _scale_close(tp.signal_model["gw_common"]["realization"],
                     jp.signal_model["gw_common"]["realization"],
                     GP_HOST_TOL, tp.name)


def test_gp_then_factorized_replacement_matches_jax(x64_off):
    """A factorized entry replaced by a joint-covariance one, then that
    one by a factorized one (per-pulsar path: a joint entry does not
    batch), against the JAX facade's residuals."""
    tps, jps = _array(tfp, 3, 30), _array(jfp, 3, 30)
    steps = ((tcn.add_common_correlated_noise, jcn.add_common_correlated_noise,
              1),
             (tcn.add_common_correlated_noise_gp,
              jcn.add_common_correlated_noise_gp, 2),
             (tcn.add_common_correlated_noise, jcn.add_common_correlated_noise,
              3))
    for ft, fj, seed in steps:
        kw = dict(log10_A=-13.5, gamma=3.0, components=6, seed=seed)
        ft(tps, **kw)
        fj(jps, **kw)
        for tp, jp in zip(tps, jps):
            _scale_close(tp.residuals, jp.residuals, RES_TOL, tp.name)
            _scale_close(tp.reconstruct_signal(["gw_common"]),
                         tp.residuals, RES_TOL, "reconstruct")
    assert all("fourier" in p.signal_model["gw_common"] for p in tps)


def test_gp_refuses_a_huge_covariance():
    psrs = _array(tfp, 2, 10001)
    with pytest.raises(ValueError, match="joint covariance"):
        tcn.add_common_correlated_noise_gp(psrs, log10_A=-14.0, gamma=3.0,
                                           seed=1)


# -- pickles, the Roemer delay and the package attribute ----------------------

@pytest.mark.parametrize("kind", ["fourier", "realization"])
def test_pickled_common_entries_round_trip(x64_off, tmp_path, kind):
    """A pickled array with a ``gw_common`` entry loads, reconstructs,
    removes and re-injects in the port as the JAX facade's pickle does in
    the JAX facade."""
    inject = {"fourier": (tcn.add_common_correlated_noise,
                          jcn.add_common_correlated_noise),
              "realization": (tcn.add_common_correlated_noise_gp,
                              jcn.add_common_correlated_noise_gp)}[kind]
    tps, jps = _array(tfp, 3, 40), _array(jfp, 3, 40)
    for p in tps + jps:
        p.add_red_noise(log10_A=-14.0, gamma=3.0, seed=4)
    kw = dict(log10_A=-13.5, gamma=3.0, components=6, seed=6)
    inject[0](tps, **kw)
    inject[1](jps, **kw)
    tps = tio.load_array(tio.save_array(tps, tmp_path / "t.pkl"),
                         device="cpu")
    jio.save_array(jps, tmp_path / "j.pkl")
    jps = jio.load_array(tmp_path / "j.pkl")
    assert isinstance(tps[0].signal_model["gw_common"][kind], np.ndarray)
    for tp, jp in zip(tps, jps):
        _scale_close(tp.reconstruct_signal(["gw_common"]),
                     jp.reconstruct_signal(["gw_common"]), RES_TOL)
        tp.remove_signal(["gw_common"])
        jp.remove_signal(["gw_common"])
        _scale_close(tp.residuals, jp.residuals, RES_TOL, "removed")
        _scale_close(tp.residuals, tp.reconstruct_signal(["red_noise"]),
                     RES_TOL, "only red left")
    tcn.add_common_correlated_noise(tps, **dict(kw, seed=8))
    jcn.add_common_correlated_noise(jps, **dict(kw, seed=8))
    _same_common(tps, jps)


def test_add_roemer_delay_matches_jax(x64_off):
    tps = _array(tfp, 3, 60, ephem=Ephemeris())
    jps = _array(jfp, 3, 60, ephem=JaxEphemeris())
    for mod, psrs in ((tcn, tps), (jcn, jps)):
        for p in psrs:
            p.toas = p.toas + 53000 * 86400.0
        mod.add_roemer_delay(psrs, "jupiter", d_mass=1e25, d_Om=1e-3)
    for tp, jp in zip(tps, jps):
        want = jp.ephem.roemer_delay(jp.toas, jp.pos, "jupiter", 1e25, 1e-3)
        _scale_close(tp.ephem.roemer_delay(tp.toas, tp.pos, "jupiter",
                                           1e25, 1e-3), want, GP_HOST_TOL)
        _scale_close(tp.residuals, jp.residuals, GP_HOST_TOL, tp.name)
    bare = _array(tfp, 1, 20)
    with pytest.raises(ValueError, match="ephem"):
        tcn.add_roemer_delay(bare, "jupiter")


def test_package_exposes_the_module_and_rejects_bad_input():
    assert fakepta_tpu_torch.correlated_noises is tcn
    psrs = _array(tfp, 3, 20)
    with pytest.raises(KeyError):
        tcn.add_common_correlated_noise(psrs, orf="nope", log10_A=-14.0,
                                        gamma=3.0, seed=1)
    with pytest.raises(KeyError):
        tcn.add_common_correlated_noise(psrs, spectrum="nope", seed=1)
    with pytest.raises(ValueError, match="custom_psd"):
        tcn.add_common_correlated_noise(psrs, spectrum="custom",
                                        custom_psd=[1.0, 2.0], seed=1)
    with pytest.raises(ValueError, match="h_map"):
        tcn.add_common_correlated_noise(psrs, orf="anisotropic",
                                        log10_A=-14.0, gamma=3.0, seed=1)
    # a failed call leaves no entry behind
    assert all("gw_common" not in p.signal_model for p in psrs)
