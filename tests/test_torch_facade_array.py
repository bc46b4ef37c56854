"""The port's array-level facade (``make_fake_array``, ``copy_array``, the
array injectors, the pickle and JSON I/O) and its bridge to the engine
(``PulsarBatch.from_pulsars`` and the ``padded_*`` helpers) against the JAX
package, on the CPU.

The JAX facade runs inside ``jax.enable_x64(False)`` (float32 draws, its
accelerator default); same seeds, same inputs. Tolerances:

- host configuration draws (TOAs, positions, names, backends, drawn
  frequencies, TOA errors, ``tm_pars``, Mmat, noisedicts, ``signal_model``
  keys and ``f`` grids) are bit-equal;
- float32 PSDs within 3e-5 relative and stored coefficients within 1e-6
  plus half that (tests/test_torch_facade.py says why);
- residuals within 1e-5 of each pulsar's residual scale;
- batch leaves packed from one pulsar list are equal (host float64 cast
  once to float32 in both); from the two packages' pulsars, the PSD leaves
  within the PSD bound;
- the engine on a facade-built batch within 1e-5 (f32) / 1e-2 (bf16) of
  the JAX XLA engine's curve scale, the bounds of tests/test_torch_engine.py.
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest

from fakepta_tpu import batch as jbatch
from fakepta_tpu import constants as const
from fakepta_tpu import fake_pta as jfp
from fakepta_tpu import spectrum as jspec
from fakepta_tpu.parallel.mesh import make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu.utils import io as jio
from fakepta_tpu_torch import batch as tbatch
from fakepta_tpu_torch import fake_pta as tfp
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from fakepta_tpu_torch.utils import io as tio

DATA = Path(__file__).resolve().parents[1] / "examples" / "simulated_data"
PSD_RTOL = 3e-5
COEF_RTOL = 1e-6
RES_TOL = 1e-5
ENGINE_TOL = {"f32": 1e-5, "bf16": 1e-2}
HOST_ATTRS = ("nepochs", "toas", "toaerrs", "Tspan", "custom_model", "flags",
              "freqs", "backend_flags", "backends", "theta", "phi", "pos",
              "pdist", "name", "tm_pars", "Mmat", "fitpars", "noisedict")


@pytest.fixture
def x64_off():
    """The JAX facade in its accelerator default: float32 draws."""
    with jax.enable_x64(False):
        yield


def _same_array(tps, jps, residuals=True):
    assert len(tps) == len(jps)
    for tp, jp in zip(tps, jps):
        for attr in HOST_ATTRS:
            got, want = getattr(tp, attr), getattr(jp, attr)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want, err_msg=attr)
            else:
                assert got == want, (tp.name, attr)
        assert tp.signal_model.keys() == jp.signal_model.keys()
        for name, je in jp.signal_model.items():
            te = tp.signal_model[name]
            np.testing.assert_array_equal(te["f"], je["f"])
            tpsd, jpsd = np.asarray(te["psd"]), np.asarray(je["psd"])
            np.testing.assert_allclose(tpsd, jpsd, rtol=PSD_RTOL)
            four = np.asarray(je["fourier"])
            np.testing.assert_allclose(te["fourier"], four,
                                       rtol=COEF_RTOL + PSD_RTOL / 2,
                                       atol=COEF_RTOL * np.abs(four).max())
        if residuals:
            _close_res(tp.residuals, jp.residuals)


def _close_res(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RES_TOL * scale)


# -- make_fake_array and copy_array -----------------------------------------

MAKE_CASES = {
    "fixed": dict(npsrs=4, Tobs=10, ntoas=100, gaps=False, toaerr=1e-6,
                  pdist=1.0, backends="NUPPI", seed=11),
    "random": dict(npsrs=3, Tobs=3.0, seed=17),
    "isotropic_gaps": dict(npsrs=5, Tobs=8.0, ntoas=150, isotropic=True,
                           gaps=True, toaerr=1e-7, pdist=1.0,
                           backends=["NUPPI"], seed=3),
    "per_pulsar": dict(npsrs=2, Tobs=[10.0, 12.0], ntoas=np.array([100, 120]),
                       gaps=False, toaerr=1e-6, seed=23,
                       backends=["A.1400", "B"], freqs=(700, 1400),
                       custom_model={"RN": 10, "DM": 20, "Sv": 5},
                       noisedict={"efac": 1.1, "log10_tnequad": -7.0,
                                  "red_noise_log10_A": -14.0,
                                  "red_noise_gamma": 3.0}),
}


@pytest.mark.parametrize("case", sorted(MAKE_CASES))
def test_make_fake_array_draw_for_draw(x64_off, case):
    kw = MAKE_CASES[case]
    jps = jfp.make_fake_array(**kw)
    tps = tfp.make_fake_array(**kw, device="cpu")
    _same_array(tps, jps)


def test_copy_array_replay_of_the_shipped_jsons(x64_off):
    """The example's --replay path: the seeded 8-pulsar array cloned with
    the shipped noisedict and custom models, then re-injected."""
    noisedict = tio.load_noisedict(DATA / "noisedict_example.json")
    models = tio.load_custom_models(DATA / "custom_models_example.json")
    assert noisedict == jio.load_noisedict(DATA / "noisedict_example.json")
    assert models == jio.load_custom_models(
        DATA / "custom_models_example.json")
    kw = dict(npsrs=8, Tobs=10.0, ntoas=100, isotropic=True, toaerr=1e-6,
              seed=1234)
    jsrc = jfp.make_fake_array(**kw)
    tsrc = tfp.make_fake_array(**kw, device="cpu")
    assert {p.name for p in tsrc} == set(models)
    jcp = jfp.copy_array(jsrc, noisedict, models, seed=42)
    tcp = tfp.copy_array(tsrc, noisedict, models, seed=42, device="cpu")
    _same_array(tcp, jcp)
    # copy_array reads either package's pulsars: from the JAX ones the
    # residuals copy exactly
    tcj = tfp.copy_array(jsrc, noisedict, models, seed=42, device="cpu")
    _same_array(tcj, jcp, residuals=False)
    for a, b in zip(tcj, jcp):
        np.testing.assert_array_equal(a.residuals, b.residuals)
        assert a.residuals.dtype == np.float64
    for ps in (jcp, tcp):
        for p in ps:
            p.make_ideal()
            p.add_white_noise()
            p.add_red_noise()
            p.add_dm_noise()
    _same_array(tcp, jcp)


def test_copy_array_default_models_and_planets(x64_off):
    from fakepta_tpu.ephemeris import Ephemeris as JE
    from fakepta_tpu_torch.ephemeris import Ephemeris as TE

    kw = dict(npsrs=2, Tobs=6.0, ntoas=60, toaerr=1e-6, seed=5)
    jsrc = jfp.make_fake_array(**kw, ephem=JE())
    tsrc = tfp.make_fake_array(**kw, ephem=TE(), device="cpu")
    for tp, jp in zip(tsrc, jsrc):
        np.testing.assert_allclose(tp.planetssb, jp.planetssb, rtol=1e-12,
                                   atol=1e-12 * np.abs(jp.planetssb).max())
    jcp = jfp.copy_array(jsrc, {"efac": 1.2, "log10_tnequad": -7.5},
                         seed=8)
    tcp = tfp.copy_array(tsrc, {"efac": 1.2, "log10_tnequad": -7.5},
                         seed=8, device="cpu")
    _same_array(tcp, jcp)
    assert all(p.planetssb is not None for p in tcp)


# -- the array injectors ----------------------------------------------------

def _uniform(mod, n=5, ntoa=120, **kw):
    toas = np.linspace(0, 10 * const.yr, ntoa)
    dev = {} if mod is jfp else {"device": "cpu"}
    return [mod.Pulsar(toas, 1e-7, 1.0 + 0.1 * k, 0.3 * k + 0.2, seed=10 + k,
                       **kw, **dev) for k in range(n)]


@pytest.mark.parametrize("signal", ["red_noise", "dm_gp"])
def test_add_noise_array_batched(x64_off, signal):
    """The batched path, each pulsar's own stream and then an explicit
    seed (re-injection), equals the JAX batched path; an explicit f_psd."""
    jps, tps = _uniform(jfp), _uniform(tfp)
    for ps, mod in ((jps, jfp), (tps, tfp)):
        mod.add_noise_array(ps, signal=signal, log10_A=-14.0, gamma=3.0)
        mod.add_noise_array(ps, signal=signal, log10_A=-13.5, gamma=4.0,
                            seed=3)
    _same_array(tps, jps)
    f = np.arange(1, 9) / (11 * const.yr)
    for ps, mod in ((jps, jfp), (tps, tfp)):
        mod.add_noise_array(ps, signal=signal, f_psd=f, log10_A=-14.0,
                            gamma=3.0, seed=4)
    _same_array(tps, jps)
    # a batched row's residuals and coefficients are plain host arrays
    r = tps[1].residuals
    r[:] = 0.0
    assert not tps[1].residuals.any() and tps[2].residuals.all()
    assert isinstance(tps[1].signal_model[signal]["fourier"], np.ndarray)


def test_add_noise_array_matches_per_pulsar_loop():
    a, b = _uniform(tfp), _uniform(tfp)
    tfp.add_noise_array(a, signal="red_noise", log10_A=-14.0, gamma=3.0)
    for p in b:
        p.add_red_noise(log10_A=-14.0, gamma=3.0)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa.signal_model["red_noise"]["fourier"],
                                      pb.signal_model["red_noise"]["fourier"])
        _close_res(pa.residuals, pb.residuals)


def test_add_noise_array_fallbacks(x64_off):
    """Ragged TOA counts, mixed Tspans, mixed re-injection states and a
    custom PSD loop the pulsars with fold(key(seed), g) keys."""
    def ragged(mod):
        ps = _uniform(mod, n=4)
        dev = {} if mod is jfp else {"device": "cpu"}
        ps[2] = mod.Pulsar(np.linspace(0, 10 * const.yr, 90), 1e-7, 1.2, 0.4,
                           seed=9, **dev)
        return ps

    jps, tps = ragged(jfp), ragged(tfp)
    for ps, mod in ((jps, jfp), (tps, tfp)):
        for seed in (3, 4):
            mod.add_noise_array(ps, signal="red_noise", log10_A=-14.0,
                                gamma=3.0, seed=seed)
        mod.add_noise_array(ps[:2], signal="chrom_gp", log10_A=-14.0,
                            gamma=3.0, seed=1)            # Sv off: no-op
        ps[0].add_dm_noise(log10_A=-14.0, gamma=3.0)
        mod.add_noise_array(ps[:3], signal="dm_gp", log10_A=-13.8,
                            gamma=2.5)                    # mixed olds
    _same_array(tps, jps)
    jps, tps = _uniform(jfp, n=3), _uniform(tfp, n=3)
    f = np.arange(1, 31) / tps[0].Tspan
    psd = 0.5 * np.asarray(jspec.powerlaw(f, -14.0, 3.0))
    for ps, mod in ((jps, jfp), (tps, tfp)):
        mod.add_noise_array(ps, spectrum="custom", custom_psd=psd, seed=6)
    _same_array(tps, jps)
    with pytest.raises(KeyError):
        tfp.add_noise_array(tps, signal="gwb")


def test_add_white_noise_array_batched_and_fallback(x64_off):
    jps, tps = _uniform(jfp), _uniform(tfp)
    for ps, mod in ((jps, jfp), (tps, tfp)):
        mod.add_white_noise_array(ps)
        mod.add_white_noise_array(ps, seed=3, randomize=True)
    _same_array(tps, jps)
    # ECORR and ragged arrays: the per-pulsar fallback
    jps, tps = _uniform(jfp, n=3), _uniform(tfp, n=3)
    for ps, mod in ((jps, jfp), (tps, tfp)):
        mod.add_white_noise_array(ps, add_ecorr=True, seed=5)
        dev = {} if mod is jfp else {"device": "cpu"}
        ps.append(mod.Pulsar(np.linspace(0, 10 * const.yr, 90), 1e-6, 1.1,
                             0.4, seed=9, **dev))
        mod.add_white_noise_array(ps, seed=7)
    _same_array(tps, jps)


# -- pickles and the JSON configs --------------------------------------------

def test_save_load_array_roundtrip(tmp_path, x64_off):
    tps = tfp.make_fake_array(npsrs=3, Tobs=5.0, ntoas=50, toaerr=1e-6,
                              seed=2, device="cpu")
    path = tio.save_array(tps, tmp_path / "sub" / "psrs.pkl")
    loaded = tio.load_array(path, device="cpu")
    for a, b in zip(loaded, tps):
        assert a.name == b.name and a._device.type == "cpu"
        np.testing.assert_array_equal(a.residuals, b.residuals)
        assert a.residuals.dtype == np.float64
        np.testing.assert_array_equal(a.Mmat, b.Mmat)
        assert a.signal_model.keys() == b.signal_model.keys()
        a.add_red_noise(log10_A=-14.0, gamma=3.0, seed=1)   # still usable
    # the JAX package's own pickle of its array loads through the port
    jps = jfp.make_fake_array(npsrs=2, Tobs=5.0, ntoas=50, seed=2)
    jio.save_array(jps, tmp_path / "jax.pkl")
    back = tio.load_array(tmp_path / "jax.pkl", device="cpu")
    for a, b in zip(back, jps):
        np.testing.assert_array_equal(a.residuals, b.residuals)


def test_json_config_validation(tmp_path):
    bad = tmp_path / "nd.json"
    bad.write_text(json.dumps({"J0000+0000_efac": "one"}))
    with pytest.raises(ValueError):
        tio.load_noisedict(bad)
    bad.write_text(json.dumps({"J0000+0000": {"RN": 3, "DM": None}}))
    with pytest.raises(ValueError):
        tio.load_custom_models(bad)


# -- the bridge to the engine -------------------------------------------------

def _bridge_psrs(mod):
    """A ragged facade array with every batched band: red, DM, chromatic
    (non-default freqf folded into the PSD), a system band, ECORR epochs."""
    dev = {} if mod is jfp else {"device": "cpu"}
    epochs = np.arange(30) * 14 * 86400.0 + 2e8
    psrs = []
    for k in range(4):
        toas = np.sort((epochs[: 30 - 3 * k, None]
                        + np.linspace(0, 3600, 2)[None, :]).ravel())
        p = mod.Pulsar(toas, 1e-7 * (1 + k), 0.4 + 0.5 * k, 0.3 + 1.1 * k,
                       seed=50 + k, backends=["A.1400", "B.700"],
                       pdist=(1.0 + 0.1 * k, 0.2),
                       custom_model={"RN": 6, "DM": 8, "Sv": 4}, **dev)
        p.noisedict[f"{p.name}_A.1400_log10_ecorr"] = -6.5
        p.add_white_noise()
        p.add_red_noise(log10_A=-14.0, gamma=3.0)
        p.add_dm_noise(log10_A=-14.2, gamma=2.0)
        p.add_time_correlated_noise(
            signal="chrom_gp", psd=np.asarray(jspec.powerlaw(
                np.arange(1, 5) / p.Tspan, -14.5, 2.5)),
            f_psd=np.arange(1, 5) / p.Tspan, idx=4.0, freqf=1000)
        p.add_system_noise(backend="B.700", components=5, log10_A=-14.0,
                           gamma=2.0)
        psrs.append(p)
    return psrs


def _leaves(b):
    return {f.name: np.asarray(getattr(b, f.name))
            for f in dataclasses.fields(b)}


@pytest.mark.parametrize("ecorr", [False, True])
def test_from_pulsars_and_padded_helpers(x64_off, ecorr):
    tps, jps = _bridge_psrs(tfp), _bridge_psrs(jfp)
    kw = dict(n_red=6, n_dm=8, n_chrom=4, n_sys=5, ecorr=ecorr)
    # one pulsar list through both packers: equal leaves
    for ps in (tps, jps):
        want = _leaves(jbatch.PulsarBatch.from_pulsars(ps, **kw))
        got = tbatch.PulsarBatch.from_pulsars(ps, **kw, device="cpu").numpy()
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # each package's own pulsars: the PSD leaves within the PSD bound
    got = tbatch.PulsarBatch.from_pulsars(tps, **kw, device="cpu").numpy()
    for k in ("red_psd", "dm_psd", "chrom_psd", "sys_psd"):
        np.testing.assert_allclose(got[k], want[k], rtol=PSD_RTOL)
    assert want["t_own"].shape[1] == 128 and not want["mask"].all()
    np.testing.assert_array_equal(tbatch.padded_abs_toas(tps),
                                  jbatch.padded_abs_toas(jps))
    np.testing.assert_array_equal(tbatch.padded_toaerr2(tps),
                                  jbatch.padded_toaerr2(jps))
    tb_ids, tn = tbatch.padded_backend_ids(tps)
    jb_ids, jn = jbatch.padded_backend_ids(jps)
    assert tn == jn and tb_ids.dtype == jb_ids.dtype
    np.testing.assert_array_equal(tb_ids, jb_ids)
    np.testing.assert_array_equal(tbatch.padded_pdist(tps),
                                  jbatch.padded_pdist(jps))
    cp = tfp.copy_array(tps, device="cpu")
    np.testing.assert_array_equal(tbatch.padded_pdist(cp),
                                  jbatch.padded_pdist(cp))


def test_from_pulsars_validates():
    psrs = _uniform(tfp, n=2, ntoa=40)
    for p in psrs:
        p.add_red_noise(log10_A=-14.0, gamma=3.0,
                        f_psd=np.arange(1, 31) / (2 * p.Tspan))
    with pytest.raises(ValueError, match="frequency grid"):
        tbatch.PulsarBatch.from_pulsars(psrs, device="cpu")
    psrs = _uniform(tfp, n=2, ntoa=40)
    psrs[0].add_cgw(costheta=0.2, phi=1.0, cosinc=0.3, log10_mc=9.0,
                    log10_fgw=-8.0, log10_h=-14.0, phase0=0.1, psi=0.2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tbatch.PulsarBatch.from_pulsars(psrs, device="cpu")
    assert any("cgw" in str(x.message) for x in w)


@pytest.fixture(scope="module")
def bridge():
    """One facade-built array (the port's pulsars) packed by both
    packages, with an HD background of 4 bins, and the JAX XLA engine's
    statistics on it."""
    psrs = _bridge_psrs(tfp)
    kw = dict(n_red=6, n_dm=8, n_chrom=4, n_sys=5, ecorr=True)
    jb = jbatch.PulsarBatch.from_pulsars(psrs, **kw)
    tb = tbatch.PulsarBatch.from_pulsars(psrs, **kw, device="cpu")
    f = np.arange(1, 5) / float(tb.tspan_common)
    psd = np.asarray(jspec.powerlaw(f, log10_A=-13.5, gamma=13 / 3))
    jax_out = JaxSim(jb, gwb=JaxGWB(psd=psd, orf="hd"),
                     mesh=make_mesh(jax.devices()[:1])).run(
                         8, seed=3, chunk=8, keep_corr=True)
    return tb, psd, jax_out


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_facade_batch_through_the_engine(bridge, path, prec):
    tb, psd, want = bridge
    sim = EnsembleSimulator(tb, gwb=GWBConfig(psd=psd, orf="hd"),
                            stat_path=path, device="cpu")
    assert sim.include == (True,) * 7
    out = sim.run(8, seed=3, chunk=8, precision=prec)
    assert out["curves"].shape == (8, 15)
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(out["curves"], want["curves"], rtol=0,
                               atol=ENGINE_TOL[prec] * scale)
    np.testing.assert_allclose(out["autos"], want["autos"],
                               rtol=ENGINE_TOL[prec])
    again = sim.run(8, seed=3, chunk=8, precision=prec)
    np.testing.assert_array_equal(out["curves"], again["curves"])
