"""The port's reference-compatible facade (``fakepta_tpu_torch.fake_pta``,
one pulsar at a time) against the JAX facade, on the CPU.

The JAX facade runs inside ``jax.enable_x64(False)``, its default mode on
every accelerator: float32 draws and residuals, like the port. Same seeds,
same inputs:

- host state (TOAs, frequencies, backends, names, Mmat, noisedicts, key
  words and host generators) is bit-equal;
- float32 PSDs agree within 3e-5 relative (exp of a float32 log-space sum
  near -60, whose ULP is 3.8e-6 relative); the normals under the stored
  Fourier coefficients within 1e-6 relative (a few float32 ULP; the port's
  draws are held to jax.random's in tests/test_torch_rng.py), so the
  coefficients within 1e-6 plus half the PSD bound;
- residuals agree within 1e-5 of each pulsar's residual scale: float32
  cos/sin of float32 phases and float32 sums in another order;
- CGW waveforms, evaluated at float64 on the CPU by both, agree within
  1e-10 of their scale;
- covariances within 1e-5 relative of their largest entry (float32
  products); the Wiener estimate and the Cholesky draw, float32
  factorizations of a covariance whose red part dominates, within 1e-3 of
  their scale.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import constants as const
from fakepta_tpu import spectrum as jspec
from fakepta_tpu.ephemeris import Ephemeris as JEphemeris
from fakepta_tpu.fake_pta import Pulsar as JPulsar
from fakepta_tpu.ops import fourier as jfourier
from fakepta_tpu.ops import white as jwhite
from fakepta_tpu.ops import woodbury as jwood
from fakepta_tpu.utils import rng as jrng
from fakepta_tpu_torch.ephemeris import Ephemeris as TEphemeris
from fakepta_tpu_torch.fake_pta import Pulsar as TPulsar
from fakepta_tpu_torch.ops import fourier as tfourier
from fakepta_tpu_torch.ops import white as twhite
from fakepta_tpu_torch.ops import woodbury as twood
from fakepta_tpu_torch.utils import rng as trng

COEF_RTOL = 1e-6
# a float32 PSD is exp of a float32 log of magnitude <= 64, whose ULP
# (3.8e-6) is its relative rounding: 8 such roundings
PSD_RTOL = 3e-5
RES_TOL = 1e-5
CGW_TOL = 1e-10


@pytest.fixture(autouse=True)
def x64_off():
    """The JAX facade in its accelerator default: float32 draws."""
    with jax.enable_x64(False):
        yield


def _toas(nyears=10.0, n=120):
    return np.linspace(0, nyears * const.yr, n) + 3 * const.yr


def _pair(*args, **kw):
    return (JPulsar(*args, **kw), TPulsar(*args, device="cpu", **kw))


def _jkey(k):
    return np.asarray(jax.random.key_data(k))


def _same_host_state(jp, tp):
    for attr in ("nepochs", "toas", "toaerrs", "Tspan", "custom_model",
                 "flags", "freqs", "backend_flags", "backends", "theta",
                 "phi", "pos", "pdist", "name", "tm_pars", "Mmat", "fitpars",
                 "noisedict", "planetssb", "pos_t"):
        got, want = getattr(tp, attr), getattr(jp, attr)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=attr)
        else:
            assert got == want, attr


def _close_res(got, want, tol=RES_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _same_entry(tp, jp, name):
    te, je = tp.signal_model[name], jp.signal_model[name]
    assert set(te) == set(je)
    for k in ("spectrum", "nbin", "idx", "freqf"):
        assert te[k] == je[k], k
    np.testing.assert_array_equal(te["f"], je["f"])
    tpsd, jpsd = np.asarray(te["psd"]), np.asarray(je["psd"])
    assert tpsd.dtype == jpsd.dtype
    np.testing.assert_allclose(tpsd, jpsd, rtol=PSD_RTOL)
    four = np.asarray(je["fourier"])
    assert te["fourier"].dtype == four.dtype
    # the normals under the coefficients within 1e-6; the coefficients
    # themselves also carry half the PSD's rounding (c = z sqrt(psd))
    z_t = te["fourier"] / np.sqrt(tpsd.astype(np.float64))
    z_j = four / np.sqrt(jpsd.astype(np.float64))
    np.testing.assert_allclose(z_t, z_j, rtol=COEF_RTOL,
                               atol=COEF_RTOL * np.abs(z_j).max())
    np.testing.assert_allclose(te["fourier"], four,
                               rtol=COEF_RTOL + PSD_RTOL / 2,
                               atol=COEF_RTOL * np.abs(four).max())


# -- the key tree's host streams ------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_keystream_bit_exact(seed):
    """Keys, next_spec folds and host generators equal the JAX
    KeyStream's, bit for bit."""
    js, ts = jrng.KeyStream(seed, "make_fake_array"), \
        trng.KeyStream(seed, "make_fake_array")
    for labels in (("init",), ("psr", 3), ("white",), ()):
        np.testing.assert_array_equal(ts.next(*labels).numpy(),
                                      _jkey(js.next(*labels)))
    jb, jf = js.next_spec("red_noise")
    tb, tf = ts.next_spec("red_noise")
    np.testing.assert_array_equal(tf, jf)
    assert tf.dtype == np.uint32
    np.testing.assert_array_equal(trng.fold_key_in_kernel(tb, tf).numpy(),
                                  _jkey(jrng.fold_key_in_kernel(jb, jf)))
    np.testing.assert_array_equal(ts.host_rng("config").uniform(size=5),
                                  js.host_rng("config").uniform(size=5))
    np.testing.assert_array_equal(trng.fold(trng.as_key(seed), "x", 4,
                                            2**32 - 1).numpy(),
                                  _jkey(jrng.fold(jrng.as_key(seed), "x", 4,
                                                  2**32 - 1)))


def test_fold_batches_on_device_and_default_seed():
    """A key batch folds through the tensor hash with the scalar path's
    words; set_default_seed moves as_key(None) as in the JAX package."""
    batch = torch.stack([trng.as_key(3), trng.as_key(9)])
    folded = trng.fold(batch, "white", 5)
    for i, s in enumerate((3, 9)):
        np.testing.assert_array_equal(folded[i].numpy(),
                                      trng.fold(trng.as_key(s), "white",
                                                5).numpy())
    old_t, old_j = trng.get_default_seed(), jrng.get_default_seed()
    try:
        trng.set_default_seed(11)
        jrng.set_default_seed(11)
        np.testing.assert_array_equal(trng.as_key(None).numpy(),
                                      _jkey(jrng.as_key(None)))
    finally:
        trng.set_default_seed(old_t)
        jrng.set_default_seed(old_j)
    with pytest.raises(TypeError):
        trng.as_key("seven")


# -- ops: fourier, white, woodbury, spectrum --------------------------------

def test_fourier_ops_match_jax():
    rng = np.random.default_rng(0)
    toas = np.sort(rng.uniform(0, 3e8, 40))
    f = np.arange(1, 7) / 3e8
    np.testing.assert_allclose(tfourier.fourier_freqs(6, 3e8).numpy(),
                               np.asarray(jfourier.fourier_freqs(6, 3e8)),
                               rtol=1e-7)
    np.testing.assert_allclose(
        tfourier.freq_weights(torch.tensor(f)).numpy(),
        np.asarray(jfourier.freq_weights(f)), rtol=1e-6)
    np.testing.assert_allclose(
        tfourier.phases(torch.tensor(toas), f).numpy(),
        np.asarray(jfourier.phases(toas, f)), rtol=1e-6)
    nu = rng.uniform(700, 2000, 40).astype(np.float32)
    np.testing.assert_allclose(
        tfourier.chromatic_scale(torch.tensor(nu), 2.0).numpy(),
        np.asarray(jfourier.chromatic_scale(nu, 2.0)), rtol=1e-6)
    phase = (2 * np.pi * (np.outer(toas, f) % 1.0)).astype(np.float32)
    scale = rng.uniform(0.5, 2, 40).astype(np.float32)
    tb = tfourier.basis_from_phase(torch.tensor(phase), torch.tensor(scale))
    jb = jfourier.basis_from_phase(phase, scale)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    psd = np.linspace(1e-12, 1e-14, 8).astype(np.float32)
    tc = tfourier.draw_coeffs(trng.as_key(4), torch.tensor(psd))
    jc = jfourier.draw_coeffs(jrng.as_key(4), psd)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=COEF_RTOL)
    df = np.diff(np.concatenate([[0.0], f])).astype(np.float32)
    c6 = np.asarray(jc)[:, :6]
    mask = np.arange(40) < 33
    for tfn, jfn in ((tfourier.inject_from_coeffs,
                      jfourier.inject_from_coeffs),
                     (tfourier.reconstruct_from_fourier,
                      jfourier.reconstruct_from_fourier)):
        _close_res(tfn(tb, torch.tensor(c6), torch.tensor(df),
                       torch.tensor(mask)).numpy(),
                   np.asarray(jfn(jb, c6, df, mask)))
    dfp = np.concatenate([df, np.ones(2, np.float32)])
    phasep = np.pad(phase, ((0, 0), (0, 2)))
    _close_res(tfourier.reconstruct_old_padded(
        torch.tensor(phasep), torch.tensor(scale), torch.tensor(c6),
        torch.tensor(dfp)).numpy(),
        np.asarray(jfourier.reconstruct_old_padded(phasep, scale, c6, dfp)))
    want = np.asarray(jfourier.gp_covariance(jb, psd[:6], df))
    np.testing.assert_allclose(
        tfourier.gp_covariance(tb, torch.tensor(psd[:6]),
                               torch.tensor(df)).numpy(),
        want, rtol=0, atol=RES_TOL * np.abs(want).max())


def test_white_ops_match_jax():
    rng = np.random.default_rng(1)
    n = 50
    err = rng.uniform(1e-7, 1e-6, n).astype(np.float32)
    efac = rng.uniform(0.5, 2, n).astype(np.float32)
    equad = rng.uniform(-8, -6, n).astype(np.float32)
    ts2 = twhite.white_sigma2(torch.tensor(err), torch.tensor(efac),
                              torch.tensor(equad))
    js2 = np.asarray(jwhite.white_sigma2(err, efac, equad))
    np.testing.assert_allclose(ts2.numpy(), js2, rtol=1e-6)
    _close_res(twhite.draw_white(trng.as_key(2), ts2).numpy(),
               np.asarray(jwhite.draw_white(jrng.as_key(2), js2)))
    epoch = np.repeat(np.arange(10), 5)
    ecv = np.full(n, 1e-13, np.float32)
    w = (np.arange(10) % 3 != 0).astype(np.float32)
    _close_res(twhite.draw_white_ecorr(
        trng.as_key(3), ts2, torch.tensor(ecv), torch.tensor(epoch), 10,
        torch.tensor(w)).numpy(),
        np.asarray(jwhite.draw_white_ecorr(jrng.as_key(3), js2, ecv, epoch,
                                           10, w)))
    want = np.asarray(jwhite.white_ecorr_covariance(js2, ecv, epoch, w))
    np.testing.assert_allclose(
        twhite.white_ecorr_covariance(ts2, torch.tensor(ecv),
                                      torch.tensor(epoch),
                                      torch.tensor(w)).numpy(),
        want, rtol=1e-6, atol=0)


def test_cho_solve_psd_matches_jax_and_nan_on_failure():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(12, 12)).astype(np.float32)
    a = (a @ a.T + 12 * np.eye(12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jwood.cho_solve_psd(a, b))
    got = twood.cho_solve_psd(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    bm = rng.normal(size=(12, 3)).astype(np.float32)
    np.testing.assert_allclose(
        twood.cho_solve_psd(torch.tensor(a), torch.tensor(bm)).numpy(),
        np.asarray(jwood.cho_solve_psd(a, bm)), rtol=1e-5, atol=1e-6)
    bad = -np.eye(4, dtype=np.float32)
    assert np.isnan(twood.cho_solve_psd(torch.tensor(bad),
                                        torch.ones(4)).numpy()).all()
    assert np.isnan(np.asarray(jwood.cho_solve_psd(bad, np.ones(4,
                                                                np.float32)))
                    ).all()


@pytest.mark.parametrize("spectrum,kw", [
    ("powerlaw", dict(log10_A=-14.0, gamma=13 / 3)),
    ("turnover", dict(log10_A=-14.5, gamma=4.0, lf0=-8.4)),
    ("free_spectrum", dict(log10_rho=np.linspace(-7, -9, 10)))])
def test_psd_float32_matches_jax_evaluate_host(spectrum, kw):
    """The facade's stored PSD: float32, as the JAX evaluate_host gives it
    with x64 off, within the float32 bound."""
    f = np.arange(1, 11) / (10 * const.yr)
    want = jspec.evaluate_host(spectrum, f, **kw)
    psr = TPulsar(_toas(), 1e-6, 1.0, 1.0, seed=1, device="cpu")
    got, _ = psr._resolve_psd("red_noise", spectrum, f, kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PSD_RTOL)


# -- Pulsar: construction and host state --------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(backends=["A.1400", "B.600"], freqs=(700, 1400, 3000)),
    dict(backends=["NUPPI", "LOFAR"], freqs=(150, 1400), pdist=(0.8, 0.1),
         tm_params={"PX": (0.0, 1e-3)})])
def test_pulsar_host_state_bit_equal(kw):
    jp, tp = _pair(_toas(n=60), 1e-6, 1.1, 2.2, seed=42, **kw)
    _same_host_state(jp, tp)
    assert tp.residuals.dtype == jp.residuals.dtype == np.float64
    assert not tp.residuals.any()


def test_pulsar_with_ephemeris_host_state():
    jp = JPulsar(_toas(n=40), 1e-6, 0.7, 1.3, seed=3, ephem=JEphemeris())
    tp = TPulsar(_toas(n=40), 1e-6, 0.7, 1.3, seed=3, ephem=TEphemeris(),
                 device="cpu")
    assert tp.planetssb.shape == jp.planetssb.shape
    np.testing.assert_allclose(tp.planetssb, jp.planetssb, rtol=1e-12,
                               atol=1e-12 * np.abs(jp.planetssb).max())
    np.testing.assert_array_equal(tp.pos_t, jp.pos_t)


def test_noisedict_resolution_cases():
    """The cases of tests/test_pulsar.py:70-97, held key for key."""
    p0 = TPulsar(_toas(n=30), 1e-6, 0.7, 1.0, seed=5, device="cpu")
    b0 = p0.backends[0]
    custom = {f"{p0.name}_{b0}_efac": 1.7,
              f"{p0.name}_{b0}_log10_tnequad": -7.0,
              "J9999+9999_backend_efac": 9.9,
              f"{p0.name}_red_noise_log10_A": -14.0,
              f"{p0.name}_red_noise_gamma": 3.3}
    cases = [dict(custom_noisedict=custom),
             dict(backends=["NUPPI.1400"],
                  custom_noisedict={"NUPPI.1400_efac": 1.2,
                                    "NUPPI.1400_log10_tnequad": -7.5,
                                    "NUPPI.1400_log10_ecorr": -8.2}),
             dict(backends=["NUPPI.1400"],
                  custom_noisedict={"efac": 1.5, "log10_tnequad": -6.5,
                                    "red_noise_log10_A": -13.5,
                                    "red_noise_gamma": 2.5,
                                    "dm_gp_log10_A": -13.0,
                                    "dm_gp_gamma": 2.0})]
    for kw in cases:
        jp, tp = _pair(_toas(n=30), 1e-6, 0.7, 1.0, seed=5, **kw)
        assert tp.noisedict == jp.noisedict
        assert tp.noisedict
    assert TPulsar(_toas(n=30), 1e-6, 0.7, 1.0, seed=5, device="cpu",
                   custom_noisedict=custom).noisedict[
        f"{p0.name}_{b0}_efac"] == 1.7


def test_coordinates_and_names():
    for ra, dec in (([12, 30], [45, 30]), ([3, 7], [-20, 15]),
                    ([23, 59], [0, 0])):
        assert TPulsar.radec_to_thetaphi(ra, dec) == \
            JPulsar.radec_to_thetaphi(ra, dec)
        th, ph = JPulsar.radec_to_thetaphi(ra, dec)
        assert TPulsar.thetaphi_to_radec(th, ph) == \
            JPulsar.thetaphi_to_radec(th, ph)
    jp, tp = _pair(_toas(n=20), 1e-6, 1.0, 1.0, seed=1)
    for theta, phi in ((0.3, 5.9), (2.9, 0.01), (np.pi / 2, np.pi)):
        jp.update_position(theta, phi, update_name=True)
        tp.update_position(theta, phi, update_name=True)
        assert tp.name == jp.name
        np.testing.assert_array_equal(tp.pos, jp.pos)


# -- Pulsar: stochastic injectors -------------------------------------------

def test_white_noise_draw_for_draw():
    jp, tp = _pair(_toas(n=150), 1e-6, 1.0, 1.0, seed=7,
                   backends=["A.1400", "B.600"])
    for p in (jp, tp):
        p.noisedict[f"{p.name}_A.1400_efac"] = 1.3
        p.add_white_noise()                       # the pulsar's stream
        p.add_white_noise(seed=5)                 # an explicit seed
        p.add_white_noise(seed=6, randomize=True)  # host redraws
    assert tp.noisedict == jp.noisedict
    assert tp.residuals.dtype == np.float32
    _close_res(tp.residuals, jp.residuals)


def test_white_noise_ecorr_draw_for_draw():
    epochs = np.arange(40) * 7 * 86400.0
    toas = np.sort((epochs[:, None]
                    + np.linspace(0, 7200, 4)[None, :]).ravel())
    toas = np.concatenate([toas, [toas[-1] + 30 * 86400.0]])  # a singleton
    jp, tp = _pair(toas, 1e-6, 1.0, 1.0, seed=8)
    for p in (jp, tp):
        p.noisedict[f"{p.name}_{p.backends[0]}_log10_ecorr"] = -6.0
        p.add_white_noise(add_ecorr=True)
        p.add_white_noise(add_ecorr=True, randomize=True, seed=4)
    assert tp.noisedict == jp.noisedict
    _close_res(tp.residuals, jp.residuals)
    assert [g.tolist() for g in tp.quantise_ecorr()] == \
        [g.tolist() for g in jp.quantise_ecorr()]
    assert [g.tolist() for g in tp.quantise_ecorr(backends=[])] == \
        [g.tolist() for g in jp.quantise_ecorr(backends=[])]


@pytest.mark.parametrize("method,name", [
    ("add_red_noise", "red_noise"), ("add_dm_noise", "dm_gp"),
    ("add_chromatic_noise", "chrom_gp")])
def test_gp_injection_and_reinjection(method, name):
    """Fresh draw, re-injection (the old realization replaced inside the
    same update) and a seeded draw: coefficients and residuals."""
    cm = {"RN": 30, "DM": 100, "Sv": 20}
    jp, tp = _pair(_toas(n=128), 1e-6, 1.0, 1.0, seed=9, custom_model=cm,
                   backends=["A", "B"], freqs=(400, 1400, 2000))
    for p in (jp, tp):
        getattr(p, method)(log10_A=-13.5, gamma=3.0)
    _same_entry(tp, jp, name)
    _close_res(tp.residuals, jp.residuals)
    for p in (jp, tp):
        getattr(p, method)(log10_A=-14.0, gamma=4.0, seed=12)
    _same_entry(tp, jp, name)
    assert tp.noisedict == jp.noisedict
    _close_res(tp.residuals, jp.residuals)
    _close_res(tp.reconstruct_signal(name), jp.reconstruct_signal(name))


def test_custom_psd_freqf_and_noisedict_psd():
    jp, tp = _pair(_toas(n=100), 1e-6, 0.5, 0.5, seed=21,
                   custom_noisedict={"efac": 1.0, "log10_tnequad": -8.0,
                                     "red_noise_log10_A": -13.8,
                                     "red_noise_gamma": 3.5})
    f = np.arange(1, 31) / jp.Tspan
    # the replacement at the old realization's scale: float32 rounding of
    # the subtracted draw is relative to the larger of the two
    psd = 0.5 * np.asarray(jspec.powerlaw(f, -13.8, 3.0))
    for p in (jp, tp):
        p.add_red_noise()                      # the noisedict's power law
        p.add_red_noise(spectrum="custom", custom_psd=psd)
        p.add_time_correlated_noise(signal="band", psd=psd[:12],
                                    f_psd=f[:12] * 1.5, idx=1.0, freqf=700)
    for name in ("red_noise", "band"):
        _same_entry(tp, jp, name)
    _close_res(tp.residuals, jp.residuals)
    _close_res(tp.reconstruct_signal(["band"]),
               jp.reconstruct_signal(["band"]))
    _close_res(tp.reconstruct_signal(["band"], freqf=1400),
               jp.reconstruct_signal(["band"], freqf=1400))
    with pytest.raises(ValueError):
        tp.add_red_noise(spectrum="custom", custom_psd=np.ones(5))
    with pytest.raises(KeyError):
        tp.add_red_noise(spectrum="nope", log10_A=-14.0)


def test_system_noise_masked_draw_for_draw():
    jp, tp = _pair(_toas(n=80), 1e-6, 1.0, 1.0, seed=29,
                   backends=["A.1400", "B.600"])
    stored = "A.1400_system_noise_A.1400"
    for p in (jp, tp):
        p.add_system_noise(backend="A.1400", components=10, log10_A=-13.0,
                           gamma=3.0)
        p.add_system_noise(backend="A.1400", components=10, log10_A=-13.2,
                           gamma=2.0, seed=3)          # re-injection
    _same_entry(tp, jp, stored)
    _close_res(tp.residuals, jp.residuals)
    assert not tp.residuals[tp.backend_flags != "A.1400"].any()
    want = jp.make_time_correlated_noise_cov("system_noise_A.1400")
    np.testing.assert_allclose(
        tp.make_time_correlated_noise_cov("system_noise_A.1400"), want,
        rtol=0, atol=RES_TOL * np.abs(want).max())
    tp.remove_signal([stored])
    jp.remove_signal([stored])
    assert tp.noisedict == jp.noisedict
    assert np.abs(tp.residuals).max() < 1e-6 * np.abs(want).max() ** 0.5
    with pytest.raises(ValueError):
        tp.add_system_noise(backend="C.100", log10_A=-13.0, gamma=3.0)


# -- Pulsar: deterministic signals, reconstruction, removal ------------------

CGW = dict(costheta=0.2, phi=1.0, cosinc=0.3, log10_mc=9.2, log10_fgw=-8.0,
           log10_h=-13.6, phase0=0.9, psi=0.4)


def test_cgw_float64_waveform_and_residuals():
    jp, tp = _pair(_toas(n=90) + 4.5e9, 1e-7, 1.2, 0.4, seed=2,
                   pdist=(1.1, 0.2))
    for psrterm in (False, True):
        rec = dict(CGW, psrterm=psrterm)
        want = jp._cw_delay_host64(rec)
        got = tp._cw_delay_host64(rec)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=CGW_TOL * np.abs(want).max())
    for p in (jp, tp):
        p.add_cgw(psrterm=True, **CGW)
        p.add_cgw(psrterm=False, **dict(CGW, log10_fgw=-8.3, phase0=0.1))
    assert tp.signal_model == jp.signal_model
    # float32 residuals of float64 waveforms: within a float32 rounding
    _close_res(tp.residuals, jp.residuals, tol=1e-6)
    np.testing.assert_array_equal(tp.reconstruct_signal("cgw"),
                                  tp.residuals)
    tp.remove_signal("cgw")
    assert "cgw" not in tp.signal_model
    assert np.abs(tp.residuals).max() == 0.0
    assert np.abs(tp.reconstruct_signal("cgw")).max() == 0.0


def test_deterministic_reconstruct_remove_make_ideal():
    def ramp(toas, slope=1e-15):
        return slope * (toas - toas[0])

    jp, tp = _pair(_toas(n=70), 1e-6, 1.0, 1.0, seed=31)
    for p in (jp, tp):
        p.add_white_noise()
        p.add_red_noise(log10_A=-13.5, gamma=3.0)
        p.add_dm_noise(log10_A=-13.0, gamma=3.0)
        p.add_deterministic(ramp, slope=2e-15)
    assert tp.signal_model["ramp"] == jp.signal_model["ramp"]
    _close_res(tp.residuals, jp.residuals)
    for sig in (["ramp"], ["red_noise", "dm_gp"], None):
        _close_res(tp.reconstruct_signal(sig), jp.reconstruct_signal(sig))
    for p in (jp, tp):
        p.remove_signal(["red_noise"])
    assert set(tp.signal_model) == set(jp.signal_model)
    assert tp.noisedict == jp.noisedict
    _close_res(tp.residuals, jp.residuals)
    rec = tp.reconstruct_signal()
    rec[:] = 0.0          # a writable host array, not a view of state
    assert tp.reconstruct_signal().any()
    tp.make_ideal()
    jp.make_ideal()
    assert tp.signal_model == {} and tp.noisedict == jp.noisedict
    assert tp.residuals.dtype == np.float64 and not tp.residuals.any()


def test_covariances_and_draw_noise_model():
    jp, tp = _pair(_toas(n=64), 1e-6, 0.9, 0.2, seed=33,
                   custom_model={"RN": 10, "DM": 20, "Sv": None})
    for p in (jp, tp):
        p.add_white_noise()
        p.add_red_noise(log10_A=-13.5, gamma=3.0)
        p.add_dm_noise(log10_A=-13.8, gamma=2.5)
    for sig in ("red_noise", "dm_gp"):
        want = jp.make_time_correlated_noise_cov(sig)
        got = tp.make_time_correlated_noise_cov(sig)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RES_TOL * np.abs(want).max())
    tw, tr = tp.make_noise_covariance_matrix()
    jw, jr = jp.make_noise_covariance_matrix()
    assert tw.dtype == jw.dtype and tr.dtype == jr.dtype
    np.testing.assert_allclose(tw, jw, rtol=1e-6)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=RES_TOL * np.abs(jr).max())
    # the Cholesky draw: the pulsar's stream and an explicit seed
    for seed in (None, 5):
        want = jp.draw_noise_model(seed=seed)
        got = tp.draw_noise_model(seed=seed)
        _close_res(got, want, tol=1e-3)
    # the Wiener branch on the same residuals
    res = jp.residuals
    _close_res(tp.draw_noise_model(residuals=res),
               jp.draw_noise_model(residuals=res), tol=1e-3)


def test_failed_reinjection_leaves_state_intact():
    tp = TPulsar(_toas(n=50), 1e-6, 1.0, 1.0, seed=13, device="cpu")
    tp.add_red_noise(log10_A=-13.5, gamma=3.0)
    before = tp.residuals.copy()
    with pytest.raises(ValueError):
        tp.add_red_noise(spectrum="custom", custom_psd=np.ones(5))
    np.testing.assert_array_equal(tp.residuals, before)


def test_unseeded_pulsars_get_distinct_noise():
    """Unseeded streams depend on the process-wide counter: only their
    distinctness is held, not equality with the JAX facade."""
    a = TPulsar(_toas(n=50), 1e-6, 1.0, 2.0, device="cpu")
    b = TPulsar(_toas(n=50), 1e-6, 0.5, 4.0, device="cpu")
    a.add_white_noise()
    b.add_white_noise()
    assert not np.allclose(a.residuals, b.residuals)


# -- pickling -----------------------------------------------------------------

def test_pickle_roundtrip_and_attribute_set():
    jp, tp = _pair(_toas(n=60), 1e-6, 1.0, 1.0, seed=41)
    for p in (jp, tp):
        p.add_white_noise()
        p.add_red_noise(log10_A=-14.0, gamma=3.0)
    assert set(tp.__getstate__()) == set(jp.__getstate__())
    assert set(vars(tp)) - {"_device"} == set(vars(jp))
    loaded = pickle.loads(pickle.dumps([tp]))[0]
    assert loaded.residuals.dtype == np.float64
    np.testing.assert_array_equal(loaded.residuals, tp.residuals)
    _same_host_state(jp, loaded)
    assert loaded.signal_model.keys() == tp.signal_model.keys()
    np.testing.assert_array_equal(loaded.signal_model["red_noise"]["fourier"],
                                  tp.signal_model["red_noise"]["fourier"])
    # the device resolves at the next injection: the default needs a card
    assert loaded._device is None
    loaded._device = torch.device("cpu")
    loaded.add_white_noise(seed=1)
    loaded.add_red_noise(log10_A=-14.0, gamma=3.0, seed=2)   # re-injection
    # a JAX facade pickle loads into JAX objects; the port reads them
    jl = pickle.loads(pickle.dumps([jp]))[0]
    np.testing.assert_array_equal(jl.residuals, np.asarray(jp.residuals,
                                                           np.float64))
