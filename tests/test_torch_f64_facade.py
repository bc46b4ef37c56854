"""The port's float64 facade (``Pulsar(dtype=torch.float64)``, the array
factories and injectors, the correlated signals, the pickles and the
float64 batch) against the JAX facade under ``jax_enable_x64``, on the CPU.

The conftest turns x64 on, so the JAX facade draws float64 normals and
keeps float64 residuals; the port gets the same with ``dtype=
torch.float64``. Same seeds, same inputs. Tolerances:

- uniform draws bit for bit, normal draws within ``NORMAL_ULP`` (4)
  float64 ULP of the JAX draw (XLA's float64 erfinv, operation for
  operation, ``utils/rng.py``);
- named PSDs within ``PSD_RTOL`` (1e-13) relative: exp of a float64
  log-space sum of magnitude <= 64, whose ULP (7.1e-15) is its relative
  rounding, a few such roundings;
- stored Fourier coefficients within ``COEF_RTOL`` (1e-13) relative, the
  normals' ULPs plus half the PSD bound;
- residuals, reconstructions and covariances within ``RES_TOL`` (1e-12)
  of their scale: float64 cos/sin and sums in another order;
- CGW waveforms, host float64 in both packages whatever the dtype, within
  ``CGW_TOL`` (1e-10) of their scale, the float32 facade test's bound;
- the noise-model draw and the Wiener estimate, float64 Cholesky solves of
  a covariance whose red part dominates, within 1e-9 of their scale;
- the joint-covariance GWB draw with a custom PSD (so the two host
  covariances are bit-equal: its rank-deficient Cholesky would amplify a
  named PSD's last-ULP differences to ~2e-8 of scale) within ``RES_TOL``;
- the float64 batch's leaves bit for bit (host float64 in both).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import batch as jbatch
from fakepta_tpu import constants as const
from fakepta_tpu import correlated_noises as jcn
from fakepta_tpu import fake_pta as jfp
from fakepta_tpu.ephemeris import Ephemeris as JEphemeris
from fakepta_tpu.utils import rng as jrng
from fakepta_tpu_torch import batch as tbatch
from fakepta_tpu_torch import correlated_noises as tcn
from fakepta_tpu_torch import fake_pta as tfp
from fakepta_tpu_torch.ephemeris import Ephemeris as TEphemeris
from fakepta_tpu_torch.utils import rng as trng

F64 = torch.float64
NORMAL_ULP = 4
PSD_RTOL = 1e-13
COEF_RTOL = 1e-13
RES_TOL = 1e-12
CGW_TOL = 1e-10
CM = {"RN": 12, "DM": 20, "Sv": 8}
CGW = dict(costheta=0.2, phi=1.0, cosinc=0.3, log10_mc=9.2, log10_fgw=-8.0,
           log10_h=-13.6, phase0=0.9, psi=0.4)


def _toas(nyears=10.0, n=96):
    return np.linspace(0, nyears * const.yr, n) + 3 * const.yr


def _close(got, want, tol=RES_TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype == np.float64, what
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _same_entries(tp, jp):
    assert tp.signal_model.keys() == jp.signal_model.keys()
    for name, je in jp.signal_model.items():
        te = tp.signal_model[name]
        if name == "cgw":
            assert te == je
            continue
        assert set(te) == set(je), name
        np.testing.assert_array_equal(te["f"], je["f"])
        np.testing.assert_allclose(np.asarray(te["psd"]),
                                   np.asarray(je["psd"]), rtol=PSD_RTOL)
        for key in ("fourier", "realization"):
            if key in je:
                want = np.asarray(je[key])
                assert np.asarray(te[key]).dtype == want.dtype == np.float64
                np.testing.assert_allclose(
                    te[key], want, rtol=COEF_RTOL,
                    atol=COEF_RTOL * np.abs(want).max(), err_msg=name)


# -- the draws -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16), (96,), (8, 4, 64), (2, 4, 8)])
def test_float64_draws_match_jax_x64(shape):
    """``utils/rng.py`` at float64 is jax.random under x64 at the facade's
    draw shapes (a bucketed coefficient pair, a white vector) and the
    engine's (per-pulsar TOA draws, a GWB block), on folded key batches."""
    keys_j = jax.vmap(lambda i: jax.random.fold_in(jrng.as_key(5), i))(
        np.arange(3))
    keys_t = trng.fold_in(trng.as_key(5), torch.arange(3))
    np.testing.assert_array_equal(keys_t.numpy(),
                                  np.asarray(jax.random.key_data(keys_j)))
    un_j = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, jnp.float64))(keys_j))
    un_t = trng.uniform(keys_t, shape, dtype=F64).numpy()
    np.testing.assert_array_equal(un_t, un_j)
    no_j = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, shape, jnp.float64))(keys_j))
    no_t = trng.normal(keys_t, shape, dtype=F64).numpy()
    assert no_t.dtype == no_j.dtype == np.float64
    ulp = np.abs(no_t - no_j) / np.spacing(np.abs(no_j))
    assert ulp.max() <= NORMAL_ULP


# -- one pulsar ------------------------------------------------------------------

def _pair(*args, **kw):
    return (jfp.Pulsar(*args, **kw),
            tfp.Pulsar(*args, device="cpu", dtype=F64, **kw))


def test_pulsar_injections_match_jax_x64():
    """White (with ECORR), red, DM, chromatic, system noise, a
    re-injection, a custom-PSD band and the CGW, one after the other."""
    epochs = np.arange(40) * 7 * 86400.0 + 3 * const.yr
    toas = np.sort((epochs[:, None] + np.linspace(0, 7200, 3)).ravel())
    jp, tp = _pair(toas, 1e-6, 1.0, 1.0, seed=8, custom_model=CM,
                   backends=["A.1400", "B.600"], pdist=(1.1, 0.2))
    assert tp.residuals.dtype == np.float64
    for p in (jp, tp):
        p.noisedict[f"{p.name}_A.1400_log10_ecorr"] = -6.0
        p.noisedict[f"{p.name}_B.600_log10_ecorr"] = -6.3
        p.add_white_noise(add_ecorr=True)
        p.add_white_noise(seed=4, randomize=True)
        p.add_red_noise(log10_A=-13.5, gamma=3.0)
        p.add_dm_noise(log10_A=-13.8, gamma=2.5)
        p.add_chromatic_noise(log10_A=-14.0, gamma=3.5)
        p.add_system_noise(backend="A.1400", components=6, log10_A=-13.2,
                           gamma=2.0)
        p.add_red_noise(log10_A=-14.0, gamma=4.0, seed=12)   # re-injection
        f = np.arange(1, 7) / p.Tspan
        p.add_time_correlated_noise(signal="band", psd=1e-15 / f ** 2,
                                    f_psd=f * 1.5, idx=1.0, freqf=700)
    assert tp.noisedict == jp.noisedict
    _same_entries(tp, jp)
    _close(tp.residuals, jp.residuals)
    for name in ("red_noise", "chrom_gp", "band"):
        _close(tp.reconstruct_signal(name), jp.reconstruct_signal(name),
               what=name)
    noise = tp.residuals.copy()
    for p in (jp, tp):
        p.add_cgw(psrterm=True, **CGW)
    # the waveform is host float64 in both: its own bound, on its own scale
    _close(tp.residuals - noise, np.asarray(jp.residuals) - noise, CGW_TOL)
    _close(tp.reconstruct_signal("cgw"), jp.reconstruct_signal("cgw"),
           CGW_TOL)
    for p in (jp, tp):
        p.remove_signal(["cgw", "band"])
    _close(tp.residuals, jp.residuals)


def test_covariances_and_noise_model_draw_match_jax_x64():
    jp, tp = _pair(_toas(n=64), 1e-6, 0.4, 2.0, seed=3,
                   custom_model={"RN": 10, "DM": None, "Sv": None})
    for p in (jp, tp):
        p.add_red_noise(log10_A=-13.6, gamma=3.3)
    w_t, red_t = tp.make_noise_covariance_matrix()
    w_j, red_j = jp.make_noise_covariance_matrix()
    _close(w_t, w_j)
    _close(red_t, red_j)
    # a float64 Cholesky of the dominant red part and the Wiener estimate
    _close(tp.draw_noise_model(seed=9), jp.draw_noise_model(seed=9),
           1e-9)
    _close(tp.draw_noise_model(residuals=tp.residuals),
           jp.draw_noise_model(residuals=jp.residuals), 1e-9)


def test_dtype_is_validated_and_kept_per_pulsar():
    with pytest.raises(TypeError, match="float32 or float64"):
        tfp.Pulsar(_toas(), 1e-6, 1.0, 1.0, device="cpu",
                   dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        tfp.make_fake_array(npsrs=2, Tobs=5, ntoas=20, seed=1, device="cpu",
                            dtype=torch.bfloat16)
    p32 = tfp.Pulsar(_toas(), 1e-6, 1.0, 1.0, seed=1, device="cpu")
    p64 = tfp.Pulsar(_toas(), 1e-6, 1.0, 1.0, seed=1, device="cpu",
                     dtype=F64)
    for p in (p32, p64):
        p.add_white_noise()
        p.add_red_noise(log10_A=-14.0, gamma=3.0)
    assert p32.residuals.dtype == np.float32
    assert p64.residuals.dtype == np.float64
    assert p32.signal_model["red_noise"]["fourier"].dtype == np.float32
    assert p64.signal_model["red_noise"]["fourier"].dtype == np.float64
    # a float64 draw is not a widened float32 one: different numbers
    assert not np.allclose(p32.residuals, p64.residuals, rtol=1e-3)
    # the common draw has one dtype
    with pytest.raises(TypeError, match="one dtype"):
        tcn.add_common_correlated_noise([p32, p64], log10_A=-14.0,
                                        gamma=13 / 3, seed=1)


# -- arrays ----------------------------------------------------------------------

MAKE_CASES = {
    "fixed": dict(npsrs=4, Tobs=10, ntoas=100, gaps=False, toaerr=1e-6,
                  pdist=1.0, backends="NUPPI", seed=11),
    "random": dict(npsrs=3, Tobs=3.0, seed=17,
                   custom_model={"RN": 10, "DM": 20, "Sv": 5}),
}


@pytest.fixture(scope="module")
def jax_arrays():
    return {case: jfp.make_fake_array(**kw)
            for case, kw in MAKE_CASES.items()}


@pytest.mark.parametrize("case", sorted(MAKE_CASES))
def test_make_fake_array_matches_jax_x64(jax_arrays, case):
    tps = tfp.make_fake_array(**MAKE_CASES[case], device="cpu", dtype=F64)
    jps = jax_arrays[case]
    assert len(tps) == len(jps)
    for tp, jp in zip(tps, jps):
        assert tp.name == jp.name and tp.noisedict == jp.noisedict
        np.testing.assert_array_equal(tp.toas, jp.toas)
        _same_entries(tp, jp)
        _close(tp.residuals, jp.residuals, what=tp.name)


def test_array_injectors_and_copy_array_match_jax_x64():
    """``copy_array`` keeps its sources' float64, then the batched white
    and GP injectors (fresh and re-injected), both correlated injectors
    and the Roemer delay, each against the JAX facade."""
    kw = dict(npsrs=4, Tobs=8, ntoas=80, gaps=False, toaerr=1e-6,
              pdist=1.0, backends="NUPPI", seed=5,
              custom_model={"RN": 8, "DM": None, "Sv": None})
    src_t = tfp.make_fake_array(**kw, device="cpu", dtype=F64)
    src_j = jfp.make_fake_array(**kw)
    tps = tfp.copy_array(src_t, seed=2, device="cpu")
    jps = jfp.copy_array(src_j, seed=2)
    assert all(p._dtype == F64 for p in tps)
    assert all(p._dtype == torch.float32
               for p in tfp.copy_array(src_t, seed=2, device="cpu",
                                       dtype=torch.float32))
    ephem_t, ephem_j = TEphemeris(), JEphemeris()
    for tp, jp in zip(tps, jps):
        tp.ephem, jp.ephem = ephem_t, ephem_j
    _close(tps[0].residuals, jps[0].residuals)
    tfp.add_white_noise_array(tps)
    jfp.add_white_noise_array(jps)
    for signal in ("red_noise", "red_noise"):
        tfp.add_noise_array(tps, signal, log10_A=-13.7, gamma=3.1)
        jfp.add_noise_array(jps, signal, log10_A=-13.7, gamma=3.1)
    tfp.add_noise_array(tps, "red_noise", seed=3, log10_A=-14.2, gamma=4.0)
    jfp.add_noise_array(jps, "red_noise", seed=3, log10_A=-14.2, gamma=4.0)
    for mod, ps in ((tcn, tps), (jcn, jps)):
        mod.add_common_correlated_noise(ps, orf="hd", log10_A=-14.0,
                                        gamma=13 / 3, components=6, seed=7)
        mod.add_common_correlated_noise(ps, orf="dipole", name="dip",
                                        log10_A=-14.5, gamma=3.0,
                                        components=4, seed=8)
        mod.add_roemer_delay(ps, "jupiter", d_mass=1e24, d_Om=2e-4)
    for tp, jp in zip(tps, jps):
        _same_entries(tp, jp)
        _close(tp.residuals, jp.residuals, what=tp.name)


def test_joint_covariance_draw_matches_jax_x64():
    """The joint dense-covariance GWB at float64 normals: a custom PSD
    keeps the two host covariances bit-equal."""
    kw = dict(npsrs=3, Tobs=6, ntoas=40, gaps=False, toaerr=1e-6,
              pdist=1.0, backends="NUPPI", seed=9,
              custom_model={"RN": None, "DM": None, "Sv": None})
    tps = tfp.make_fake_array(**kw, device="cpu", dtype=F64)
    jps = jfp.make_fake_array(**kw)
    tspan = max(p.toas.max() for p in jps) - min(p.toas.min() for p in jps)
    f = np.arange(1, 6) / tspan
    psd = 1e-13 * (f * tspan) ** (-13 / 3)
    for mod, ps in ((tcn, tps), (jcn, jps)):
        mod.add_common_correlated_noise_gp(ps, orf="hd", spectrum="custom",
                                           custom_psd=psd, components=5,
                                           seed=6)
    for tp, jp in zip(tps, jps):
        _same_entries(tp, jp)
        _close(tp.residuals, jp.residuals, what=tp.name)


def test_float64_pickle_round_trip(tmp_path):
    """A float64 pulsar pickles the JAX attribute set and its dtype, with
    float64 residuals and coefficients, bit for bit; the loaded pulsar
    (through ``save_array`` / ``load_array`` too) injects at float64, and
    ``copy_array`` replays it at its float64, draw for draw with the JAX
    replay."""
    from fakepta_tpu_torch.utils.io import load_array, save_array

    jp, tp = _pair(_toas(n=50), 1e-6, 0.9, 0.3, seed=4, custom_model=CM)
    for p in (jp, tp):
        p.add_white_noise()
        p.add_dm_noise(log10_A=-13.9, gamma=2.2)
    assert set(tp.__getstate__()) == set(jp.__getstate__()) | {"_dtype"}
    res, four = tp.residuals.copy(), tp.signal_model["dm_gp"]["fourier"]
    back = pickle.loads(pickle.dumps([tp]))[0]
    assert back.residuals.dtype == np.float64
    np.testing.assert_array_equal(back.residuals, res)
    np.testing.assert_array_equal(back.signal_model["dm_gp"]["fourier"],
                                  four)
    assert back._dtype == F64
    loaded = load_array(save_array([tp], tmp_path / "psrs.pkl"),
                        device="cpu")[0]
    assert loaded._dtype == F64
    loaded.add_white_noise(seed=2)
    assert loaded._res_current().dtype == F64
    jback = pickle.loads(pickle.dumps([jp]))[0]
    again_t = tfp.copy_array([back], seed=1, device="cpu")[0]
    again_j = jfp.copy_array([jback], seed=1)[0]
    for p in (again_t, again_j):
        p.add_red_noise(log10_A=-13.5, gamma=3.0)
    _same_entries(again_t, again_j)
    _close(again_t.residuals, again_j.residuals)


# -- the float64 batch --------------------------------------------------------------

def test_float64_batch_matches_jax_x64():
    """``from_pulsars`` and ``synthetic`` at float64: every leaf the JAX
    batch's at ``jnp.float64``, bit for bit."""
    kw = dict(npsrs=3, Tobs=5, ntoas=60, gaps=True, toaerr=1e-6,
              pdist=1.0, backends=["A", "B"], seed=13,
              custom_model={"RN": 6, "DM": 8, "Sv": 4})
    tps = tfp.make_fake_array(**kw, device="cpu", dtype=F64)
    for p in tps:
        p.add_system_noise(backend=p.backends[0], components=5,
                           log10_A=-13.0, gamma=2.0)
    pack = dict(n_red=6, n_dm=8, n_chrom=4, n_sys=5, ecorr=True)
    tb = tbatch.PulsarBatch.from_pulsars(tps, dtype=F64, device="cpu", **pack)
    jb = jbatch.PulsarBatch.from_pulsars(tps, dtype=jnp.float64, **pack)
    for name, got in tb.numpy().items():
        want = np.asarray(getattr(jb, name))
        if want.dtype.kind == "f":
            assert got.dtype == np.float64, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), name)
    skw = dict(npsr=4, ntoa=32, tspan_years=8.0, n_red=4, n_dm=6,
               chrom_log10_A=-14.2, n_chrom=3, seed=2)
    ts = tbatch.PulsarBatch.synthetic(**skw, dtype=F64, device="cpu")
    js = jbatch.PulsarBatch.synthetic(**skw, dtype=jnp.float64)
    for name, got in ts.numpy().items():
        want = np.asarray(getattr(js, name))
        np.testing.assert_allclose(got, want.astype(got.dtype),
                                   rtol=PSD_RTOL, atol=0, err_msg=name)
