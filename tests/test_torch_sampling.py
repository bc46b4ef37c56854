"""Per-realization hyperparameter sampling in the PyTorch port against the
JAX engine, on the CPU.

``NoiseSampling`` (red, DM, chromatic, system and GWB spectra; uniform and
normal draws; power-law and free-spectrum models) and ``WhiteSampling``
(efac + EQUAD, ECORR only, normal draws) run on the same float32 batch and
seeds in both engines:

- draw for draw: the residual blocks of one chunk agree within 128
  float32 ULP of the residual scale. The hyperparameter draws and the
  normals agree to a few ULP (tests/test_torch_rng.py), but a sampled
  power law is exponentiated from a float32 log of magnitude ~80, where
  one ULP of the exponent is ~8e-6 relative, and XLA fuses that sum
  differently from eager torch: the JAX package's own jit and eager
  evaluations of ``spectrum.powerlaw`` on the same float32 inputs differ
  by up to ~300 ULP, so a sampled weight (its square root) carries ~150;
- statistics: curves within 1e-5 of the curve scale, autos 1e-5 relative,
  the bound the port's engine tests hold every path to.

Port-only: zero-width ranges reproduce the fixed run bit for bit, reruns
are bit-identical, the draws do not depend on the mesh (4 x 2 and 1 x 8
over ``["cpu"] * 8``), and the constructor refuses what the JAX engine
refuses, with its messages. One end-to-end case runs ``ng15`` reduced to
16 pulsars and 128 TOAs through both registries and engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel import montecarlo as jmc
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.scenarios import registry as jreg
from fakepta_tpu.utils import compat
from fakepta_tpu_torch import spectrum as tspec
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.parallel import montecarlo as tmc
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.scenarios import registry as treg
from fakepta_tpu_torch.utils import rng
from test_torch_engine import KW, _noisy_leaves

R = 8
SEED = 3
DRAW_ULPS = 128
TOL = 1e-5
EPS32 = 2.0 ** -24     # a float32's ULP is at least this times its size
PATHS = ("einsum", "fused", "mega")

# two backends over the small batch's 64 TOAs
BACKEND_ID = np.tile((np.arange(64) // 20) % 2, (KW["npsr"], 1)).astype(
    np.int32)

# three engine configurations cover the matrix: every NoiseSampling target,
# both draw families, both spectrum kinds, and the three WhiteSampling modes
# ("normal" also runs the background on the anisotropic ORF)
H_MAP = treg._anis_h_map(2, 5)
CASES = {
    "uniform": dict(
        noise_sample=[
            jmc.NoiseSampling("red", log10_A=(-15.0, -13.0),
                              gamma=(2.0, 5.0)),
            jmc.NoiseSampling("dm", log10_A=(-14.5, -13.5), gamma=(2.0, 4.0)),
            jmc.NoiseSampling("chrom", spectrum="free_spectrum",
                              params={"log10_rho": (-8.0, -6.0)}),
            jmc.NoiseSampling("gwb", log10_A=(-15.0, -14.0),
                              gamma=(4.0, 5.0))],
        white_sample=jmc.WhiteSampling(efac=(0.5, 2.5),
                                       log10_tnequad=(-8.0, -6.0)),
        with_white=True),
    "normal": dict(
        noise_sample=[
            jmc.NoiseSampling("red", spectrum="free_spectrum",
                              params={"log10_rho": (-7.0, 0.3)},
                              dist="normal"),
            jmc.NoiseSampling("dm", log10_A=(-14.0, 0.3), gamma=(3.0, 0.5),
                              dist="normal"),
            jmc.NoiseSampling("sys", log10_A=(-14.5, 0.2), gamma=(2.0, 3.0),
                              dist={"log10_A": "normal"}),
            jmc.NoiseSampling("gwb", spectrum="free_spectrum",
                              params={"log10_rho": (-7.5, 0.3)},
                              dist="normal")],
        white_sample=jmc.WhiteSampling(efac=(1.0, 0.2),
                                       log10_tnequad=(-7.0, 0.3),
                                       log10_ecorr=(-6.5, 0.2),
                                       dist="normal"),
        with_white=True, orf="anisotropic"),
    "ecorr_only": dict(
        white_sample=jmc.WhiteSampling(efac=None, log10_tnequad=None,
                                       log10_ecorr=(-7.0, -6.0)),
        with_white=False),
}


def _port_kwargs(case):
    """The JAX configs of a case as the port's dataclasses, plus the
    backend partition (and, where efac/EQUAD is drawn, the raw toaerr2)."""
    kw = {}
    for cfg in case.get("noise_sample", ()):
        kw.setdefault("noise_sample", []).append(
            tmc.NoiseSampling(**dataclasses.asdict(cfg)))
    kw["white_sample"] = tmc.WhiteSampling(
        **dataclasses.asdict(case["white_sample"]))
    kw["backend_id"] = BACKEND_ID
    return kw


def _jax_kwargs(case, leaves):
    kw = {k: case[k] for k in ("noise_sample", "white_sample") if k in case}
    kw["backend_id"] = BACKEND_ID
    if case["with_white"]:
        kw["toaerr2"] = leaves["sigma2"]
    return kw


def _gwb_psd(tspan):
    f = np.arange(1, 5) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-13.5, gamma=13 / 3))


def _gwb(config, batch, case):
    orf = case.get("orf", "hd")
    return config(psd=_gwb_psd(float(batch.tspan_common)), orf=orf,
                  h_map=H_MAP if orf == "anisotropic" else None)


@pytest.fixture(scope="module")
def small():
    """The small all-stages batch (ECORR epochs, chromatic noise, two
    system bands) as numpy leaves and in both packages."""
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    return (leaves, JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            PulsarBatch.from_numpy(leaves, device="cpu"))


def _jax_residuals(sim, keys):
    """The JAX engine's residual blocks for ``keys`` (its shard_map body on
    its own 1-device mesh)."""
    specs = jax.tree_util.tree_map(lambda _: P(), sim.batch)
    fn = jax.jit(compat.shard_map(
        lambda k, b, sp, wp, te, bi: jmc._simulate_block(
            k, b, sim._chol, sim._gwb_w, sim._gwb_idx, sim._gwb_freqf,
            *sim._include, samp_static=sim._samp_static, samp_params=sp,
            white_static=sim._white_static, white_params=wp,
            white_toaerr2=te, white_bid=bi, white_nb=sim._white_nb),
        mesh=sim.mesh, in_specs=(P(), specs, P(), P(), P(), P()),
        out_specs=P(), check_vma=False))
    return np.asarray(fn(keys, sim.batch, sim._samp_params,
                         sim._white_params, sim._white_toaerr2,
                         sim._white_bid))


@pytest.fixture(scope="module")
def jax_runs(small):
    """Per case: the JAX engine's residuals of one chunk and its run."""
    leaves, jb, _ = small
    cache = {}

    def get(name):
        if name not in cache:
            sim = jmc.EnsembleSimulator(
                jb, gwb=_gwb(jmc.GWBConfig, jb, CASES[name]),
                mesh=jax_make_mesh(jax.devices()[:1]),
                **_jax_kwargs(CASES[name], leaves))
            keys = jax.vmap(lambda i: jax.random.fold_in(
                jax.random.key(SEED), i))(np.arange(R))
            cache[name] = (_jax_residuals(sim, keys),
                           sim.run(R, seed=SEED, chunk=R))
        return cache[name]
    return get


def _port_sim(small, case, **kw):
    leaves, _, tb = small
    if case["with_white"]:
        kw.setdefault("toaerr2", leaves["sigma2"])
    return tmc.EnsembleSimulator(tb, gwb=_gwb(tmc.GWBConfig, tb, case),
                                 **_port_kwargs(case), **kw)


def _assert_stats(got, want, tol=TOL):
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_draws_match_jax(small, jax_runs, name):
    want, _ = jax_runs(name)
    sim = _port_sim(small, CASES[name], device="cpu", stat_path="einsum")
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 0, R)
    got = sim._residuals(keys).numpy()
    assert got.shape == want.shape == (R, KW["npsr"], 64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=DRAW_ULPS * EPS32 * scale)
    # the sampled stages are live: the draws differ from the fixed run's
    fixed = tmc.EnsembleSimulator(
        small[2], gwb=tmc.GWBConfig(psd=_gwb_psd(float(
            small[2].tspan_common))), device="cpu")._residuals(keys).numpy()
    assert np.abs(got - fixed).max() > 1e-3 * scale


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_statistics_match_jax(small, jax_runs, name, path):
    _, want = jax_runs(name)
    sim = _port_sim(small, CASES[name], device="cpu", stat_path=path)
    got = sim.run(R, seed=SEED, chunk=R, precision="f32")
    _assert_stats(got, want)
    again = sim.run(R, seed=SEED, chunk=R // 2, precision="f32")
    for key in ("curves", "autos"):
        np.testing.assert_array_equal(got[key], again[key])


def _f32(ndim, value):
    return torch.full((1,) * ndim, value, dtype=torch.float32)


@pytest.mark.parametrize("path", PATHS)
def test_zero_width_reproduces_the_fixed_run(small, path):
    """Pinned ranges give the fixed run bit for bit when the fixed PSDs and
    white variance hold the values the sampler computes (the same float32
    evaluation)."""
    leaves, _, tb = small
    a, g, ag, gg, efac = -14.3, 3.7, -14.6, 13 / 3, 1.3
    f_red = torch.arange(1, 5, dtype=torch.float32) * tb.df_own[:, None]
    f_gwb = torch.arange(1, 5, dtype=torch.float32) / tb.tspan_common
    gwb_psd = tspec.powerlaw(f_gwb, _f32(2, ag), _f32(2, gg))[0].numpy()
    fixed_leaves = dict(leaves)
    fixed_leaves["red_psd"] = tspec.powerlaw(f_red, _f32(3, a),
                                             _f32(3, g))[0].numpy()
    e = torch.full_like(tb.sigma2, efac)
    fixed_leaves["sigma2"] = (e * e * tb.sigma2).numpy()
    fixed = tmc.EnsembleSimulator(
        PulsarBatch.from_numpy(fixed_leaves, device="cpu"),
        gwb=tmc.GWBConfig(psd=gwb_psd), device="cpu", stat_path=path)
    pinned = tmc.EnsembleSimulator(
        tb, gwb=tmc.GWBConfig(psd=np.ones(4)), device="cpu", stat_path=path,
        noise_sample=[tmc.NoiseSampling("red", log10_A=(a, a), gamma=(g, g)),
                      tmc.NoiseSampling("gwb", log10_A=(ag, ag),
                                        gamma=(gg, gg))],
        white_sample=tmc.WhiteSampling(efac=(efac, efac),
                                       log10_tnequad=None),
        toaerr2=leaves["sigma2"], backend_id=BACKEND_ID)
    want = fixed.run(16, seed=2, chunk=8, precision="f32")
    got = pinned.run(16, seed=2, chunk=8, precision="f32")
    for key in ("curves", "autos"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("real,psr", [(4, 2), (1, 8)])
def test_draws_do_not_depend_on_the_mesh(small, real, psr):
    """Each psr shard's residual rows equal the 1-shard engine's bit for
    bit, and the sharded statistics land within 1e-5 of it."""
    case = CASES["normal"]
    one = _port_sim(small, case, device="cpu", stat_path="einsum")
    mesh = make_mesh(["cpu"] * 8, psr_shards=psr)
    assert mesh.shape["real"] == real
    sharded = _port_sim(small, case, mesh=mesh, stat_path="einsum")
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 0, R)
    full = one._residuals(keys)
    rows = torch.cat([sharded._residuals(keys, shard=sh)
                      for sh in sharded._shards[0]], dim=1)
    assert torch.equal(rows, full)
    _assert_stats(sharded.run(R, seed=SEED, chunk=R),
                  one.run(R, seed=SEED, chunk=R))


def _ng15_small():
    return dict(max_psr=16, max_toa=128)


@pytest.fixture(scope="module")
def ng15_jax():
    scn = jreg.get("ng15").reduced(**_ng15_small())
    return scn.build(mesh=jax_make_mesh(jax.devices()[:1])).run(
        R, seed=SEED, chunk=R)


@pytest.mark.parametrize("path", ["einsum", "fused"])
def test_ng15_reduced_end_to_end(ng15_jax, path):
    """ng15 at 16 pulsars x 128 TOAs (padded to 256, four backend bands,
    white hyperprior draws) built by each registry and run by each
    engine."""
    sim = treg.get("ng15").reduced(**_ng15_small()).build(
        device="cpu", stat_path=path)
    assert sim.batch.npsr == 16 and sim.include[5]
    got = sim.run(R, seed=SEED, chunk=R, precision="f32")
    assert got["curves"].shape == (R, 15)
    _assert_stats(got, ng15_jax)


# ------------------------------------------------- the constructor's rules

def _red(**kw):
    return tmc.NoiseSampling("red", **kw)


NOISE_REJECTIONS = [
    ("not registered", {}, _red(spectrum="nope",
                                params={"log10_A": (-14, -13)})),
    ("not hyperparameters", {}, _red(spectrum="turnover",
                                     params={"log10_A": (-14, -13),
                                             "bogus": (0, 1)})),
    ("no parameters", {}, _red()),
    ("not hyperparameters", {}, _red(spectrum="free_spectrum",
                                     log10_A=(-14, -13))),
    ("dist mapping", {}, _red(log10_A=(-14, -13), gamma=(3, 3),
                              dist={"bogus": "normal"})),
    ("nfreq", {}, _red(spectrum="t_process_adapt",
                       params={"log10_A": (-14, -13), "nfreq": (0, 7)})),
    ("not in", {}, tmc.NoiseSampling("white", log10_A=(-14, -13),
                                     gamma=(3, 3))),
    ("duplicate", {}, [_red(log10_A=(-14, -13), gamma=(3, 3)),
                       _red(log10_A=(-15, -14), gamma=(3, 3))]),
    ("dist", {}, _red(log10_A=(-14, -13), gamma=(3, 3), dist="lognormal")),
    ("needs stage", dict(include=("white",)),
     _red(log10_A=(-14, -13), gamma=(3, 3))),
    ("GWBConfig", dict(gwb=None), tmc.NoiseSampling(
        "gwb", log10_A=(-14, -13), gamma=(3, 3))),
    ("system-noise bands", dict(include=("white", "sys")),
     tmc.NoiseSampling("sys", log10_A=(-14, -13), gamma=(3, 3))),
]


@pytest.mark.parametrize("match,kw,samp", NOISE_REJECTIONS)
def test_noise_sampling_rejections(match, kw, samp):
    batch = PulsarBatch.synthetic(**KW, device="cpu")
    kw.setdefault("gwb", tmc.GWBConfig(psd=np.ones(4)))
    with pytest.raises(ValueError, match=match):
        tmc.EnsembleSimulator(batch, device="cpu", noise_sample=samp, **kw)


WHITE_REJECTIONS = [
    (ValueError, "needs stage 'white'", dict(include=("red",)),
     tmc.WhiteSampling()),
    (ValueError, "dist", {}, tmc.WhiteSampling(dist="lognormal")),
    (ValueError, "ECORR", dict(include=("white", "ecorr")),
     tmc.WhiteSampling(log10_ecorr=(-7, -6))),
    (ValueError, "no parameters", {},
     tmc.WhiteSampling(efac=None, log10_tnequad=None)),
    (TypeError, "WhiteSampling", {}, {"efac": (0.5, 2.5)}),
    (ValueError, "toaerr2 shape", dict(toaerr2=np.ones((2, 2))),
     tmc.WhiteSampling()),
    (ValueError, "backend_id shape",
     dict(backend_id=np.zeros((2, 2), np.int32)), tmc.WhiteSampling()),
]


@pytest.mark.parametrize("err,match,kw,samp", WHITE_REJECTIONS)
def test_white_sampling_rejections(err, match, kw, samp):
    batch = PulsarBatch.synthetic(**KW, device="cpu")
    kw.setdefault("include", ("white",))
    kw.setdefault("toaerr2", batch.sigma2.numpy())
    with pytest.raises(err, match=match):
        tmc.EnsembleSimulator(batch, device="cpu", white_sample=samp, **kw)


def test_toaerr2_warning_only_when_efac_or_equad_is_drawn(small):
    import warnings

    _, _, tb = small
    batch = PulsarBatch.synthetic(**KW, device="cpu")
    with pytest.warns(UserWarning, match="toaerr2"):
        tmc.EnsembleSimulator(batch, include=("white",), device="cpu",
                              white_sample=tmc.WhiteSampling())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tmc.EnsembleSimulator(
            tb, include=("white", "ecorr"), device="cpu",
            white_sample=tmc.WhiteSampling(efac=None, log10_tnequad=None,
                                           log10_ecorr=(-7.0, -6.0)),
            backend_id=BACKEND_ID)


def _signal_arguments(module, name, shape):
    """An invalid use of one signal argument (``name``) of the engine in
    ``module`` (either package's montecarlo), with the error it raises."""
    toas = np.full(shape, 4.6e9)
    if name == "cgw":
        return dict(cgw=module.CGWConfig(0.1, 1.0, 0.2, 9.0, -8.0,
                                         log10_h=-14.0)), ValueError, "toas_abs"
    if name == "roemer":
        return dict(roemer=module.RoemerConfig("jupiter", d_mass=1e23)), \
            ValueError, "toas_abs"
    if name == "roemer_sample":
        return dict(roemer_sample=module.RoemerSampling(
            "jupiter", s_mass=1e23)), ValueError, "toas_abs"
    if name == "ephem":
        return dict(ephem=object(), toas_abs=toas,
                    roemer=module.RoemerConfig("jupiter", d_mass=1e23)), \
            AttributeError, "planets"
    if name == "cgw_sample":
        return dict(cgw_sample=module.CGWSampling(log10_h=None),
                    toas_abs=toas), ValueError, "amplitude range"
    return dict(toas_abs=toas[:, :3], cgw_sample=module.CGWSampling()), \
        ValueError, "toas_abs shape"


@pytest.mark.parametrize("name", ["cgw", "roemer", "roemer_sample", "ephem",
                                  "cgw_sample", "toas_abs"])
def test_unported_signal_arguments_raise(name):
    """The signal arguments (ported since the CGW / BayesEphem slice) raise
    where the JAX engine raises, with its error types and messages."""
    batch = PulsarBatch.synthetic(**KW, device="cpu")
    kw, err, match = _signal_arguments(tmc, name, tuple(batch.t_own.shape))
    with pytest.raises(err, match=match):
        tmc.EnsembleSimulator(batch, device="cpu", **kw)
    kw, err, match = _signal_arguments(jmc, name, tuple(batch.t_own.shape))
    with pytest.raises(err, match=match):
        jmc.EnsembleSimulator(JaxBatch.synthetic(**KW),
                              mesh=jax_make_mesh(jax.devices()[:1]), **kw)
