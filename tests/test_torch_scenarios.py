"""The PyTorch port's scenario registry and its foundations against the JAX
package, on the CPU.

Host numpy modules (masks, epoch grouping, cadence draws) must agree
exactly; host float64 geometry (HEALPix, antenna patterns, the anisotropic
ORF) to 1e-13; the cadence batches' float32 leaves to 1 ULP (their PSDs are
float64 exp/log evaluations in two libraries, rounded once to float32);
every scenario's ``spec_hash`` and ``reduced()`` spec equal the JAX
package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fakepta_tpu.ops import gwb as jgwb
from fakepta_tpu.ops import healpix as jhp
from fakepta_tpu.ops import white as jwhite
from fakepta_tpu.scenarios import cadence as jcad
from fakepta_tpu.scenarios import registry as jreg
from fakepta_tpu.utils import masks as jmasks
from fakepta_tpu_torch.ops import gwb as tgwb
from fakepta_tpu_torch.ops import healpix as thp
from fakepta_tpu_torch.ops import white as twhite
from fakepta_tpu_torch.scenarios import cadence as tcad
from fakepta_tpu_torch.scenarios import registry as treg
from fakepta_tpu_torch.utils import masks as tmasks

NAMES = ("flagship_100", "ng15", "ipta_dr3", "ska_10k")
NSIDES = (1, 2, 4)


def _seeded_pos(n, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# ------------------------------------------------------------ foundations

@pytest.mark.parametrize("n,bucket", [(0, 128), (1, 128), (128, 128),
                                      (129, 128), (300, 8), (513, 128)])
def test_bucket_size(n, bucket):
    assert tmasks.bucket_size(n, bucket) == jmasks.bucket_size(n, bucket)


@pytest.mark.parametrize("size", [None, 200])
def test_stack_ragged_and_pad(size):
    r = np.random.default_rng(5)
    arrays = [r.normal(size=k) for k in (3, 140, 17, 1)]
    got, gmask = tmasks.stack_ragged(arrays, size=size, fill=-1.0)
    want, wmask = jmasks.stack_ragged(arrays, size=size, fill=-1.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gmask, wmask)
    np.testing.assert_array_equal(tmasks.pad_1d(arrays[0], 9, 2.0),
                                  jmasks.pad_1d(arrays[0], 9, 2.0))


@pytest.mark.parametrize("dt", [86400.0, 3 * 86400.0, 0.0, -1.0])
def test_quantise_epochs(dt):
    r = np.random.default_rng(11)
    times = np.sort(r.uniform(0, 40 * 86400.0, 90))
    codes = r.choice(np.array(["a:430", "b:1400", "c:820"]), 90)
    got = twhite.quantise_epochs(times, codes, dt=dt)
    want = jwhite.quantise_epochs(times, codes, dt=dt)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("nside", NSIDES)
def test_healpix_geometry(nside):
    npix = 12 * nside * nside
    assert thp.npix2nside(npix) == jhp.npix2nside(npix) == nside
    ipix = np.arange(npix)
    for got, want in zip(thp.pix2ang(nside, ipix), jhp.pix2ang(nside, ipix)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(thp.pixel_directions(npix),
                               jhp.pixel_directions(npix), rtol=0,
                               atol=1e-13)


def test_healpix_rejects_what_it_lacks():
    with pytest.raises(ValueError):
        thp.npix2nside(13)
    with pytest.raises(NotImplementedError):
        thp.pix2ang(2, [0], nest=True)


@pytest.mark.parametrize("nside", NSIDES)
def test_anisotropic_orf_host_f64(nside):
    npix = 12 * nside * nside
    pos = _seeded_pos(9, nside)
    h_map = np.random.default_rng(100 + nside).uniform(0.2, 1.8, npix)
    theta, phi = jhp.pix2ang(nside, np.arange(npix))
    for got, want in zip(tgwb.antenna_patterns(pos, theta, phi),
                         jgwb.antenna_patterns(pos, theta, phi)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    want = np.asarray(jgwb.build_orf("anisotropic", pos, h_map))
    got = tgwb.build_orf("anisotropic", torch.as_tensor(pos), h_map)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(tgwb.orf_cholesky(got),
                               np.asarray(jgwb.orf_cholesky(want)), rtol=0,
                               atol=1e-13)


# ----------------------------------------------------------------- cadence

@pytest.mark.parametrize("cadence", sorted(jcad.CADENCES))
def test_draw_cadence_is_the_jax_draw(cadence):
    assert {k: [dataclasses.asdict(t) for t in v]
            for k, v in tcad.CADENCES.items()} == \
        {k: [dataclasses.asdict(t) for t in v]
         for k, v in jcad.CADENCES.items()}
    kw = dict(tspan_years=12.0, npsr=6, seed=9, thin=2)
    got = tcad.draw_cadence(cadence, **kw)
    want = jcad.draw_cadence(cadence, **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for field in ("t", "freqs", "backend", "efacs"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert g.backends == w.backends


def test_draw_cadence_rejects_unknown_family():
    with pytest.raises(KeyError, match="unknown cadence"):
        tcad.draw_cadence("lofar", 10.0, 2, 0)


def _assert_leaves_1ulp(tb, jb):
    for f in dataclasses.fields(jb):
        want = np.asarray(getattr(jb, f.name))
        got = getattr(tb, f.name).numpy()
        assert got.shape == want.shape, f.name
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype == np.float32, f.name
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=f.name)


@pytest.mark.parametrize("name,kw", [
    ("ng15", {}), ("ng15", dict(max_psr=16, max_toa=128)),
    ("ipta_dr3", {})])
def test_build_batch_matches_jax(name, kw):
    scn_t = treg.get(name).reduced(**kw)
    scn_j = jreg.get(name).reduced(**kw)
    tb, t_abs, t_bid, t_nb = scn_t.batch_parts(device="cpu")
    jb, j_abs, j_bid, j_nb = scn_j.batch_parts()
    _assert_leaves_1ulp(tb, jb)
    np.testing.assert_array_equal(t_abs, j_abs)
    np.testing.assert_array_equal(t_bid, j_bid)
    assert t_bid.dtype == j_bid.dtype
    assert t_nb == j_nb >= 2
    # the JAX package's 1-day ECORR epochs hold one TOA each on these
    # cadences, so every amplitude is zeroed; the port reproduces that
    assert not tb.ecorr_amp.any()
    assert tb.mask.any(dim=1).all()
    assert tb.max_toa % 8 == 0


def test_flagship_parts_match_jax():
    tb, t_abs, t_bid, t_nb = treg.get("flagship_100").batch_parts(
        device="cpu")
    jb, j_abs, j_bid, j_nb = jreg.get("flagship_100").batch_parts()
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(
            getattr(tb, f.name).numpy(),
            np.asarray(getattr(jb, f.name)).astype(
                getattr(tb, f.name).numpy().dtype), err_msg=f.name)
    np.testing.assert_array_equal(t_abs, j_abs)
    np.testing.assert_array_equal(t_bid, j_bid)
    assert t_nb == j_nb == 1


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("name", NAMES)
def test_spec_hash_and_reduced_equal_jax(name):
    t, j = treg.get(name), jreg.get(name)
    assert t.spec_dict() == j.spec_dict()
    assert t.spec_hash() == j.spec_hash()
    for kw in ({}, dict(max_psr=16, max_toa=128)):
        assert t.reduced(**kw).spec_dict() == j.reduced(**kw).spec_dict()
        assert t.reduced(**kw).spec_hash() == j.reduced(**kw).spec_hash()
    assert t.est_cost() == j.est_cost()


def test_registry_names_and_registration():
    assert treg.names() == jreg.names()
    scn = treg.get("ng15")
    treg.register(scn)                    # same spec: a no-op
    with pytest.raises(ValueError, match="ng15"):
        treg.register(dataclasses.replace(scn, npsr=scn.npsr + 8))
    with pytest.raises(KeyError, match="unknown scenario"):
        treg.get("not_a_scenario")


@pytest.mark.parametrize("name", ["ng15", "ipta_dr3"])
def test_sim_kwargs_equal_jax(name):
    """The engine arguments each scenario implies: the JAX package's,
    name for name and value for value (the GWB PSD to float64 rounding,
    the anisotropic map exactly)."""
    t, j = treg.get(name).reduced(), jreg.get(name).reduced()
    t_parts = t.batch_parts(device="cpu")
    j_parts = j.batch_parts()
    tk, jk = t.sim_kwargs(*t_parts), j.sim_kwargs(*j_parts)
    assert sorted(tk) == sorted(jk)
    np.testing.assert_allclose(tk["gwb"].psd, jk["gwb"].psd, rtol=1e-13)
    assert tk["gwb"].orf == jk["gwb"].orf
    if jk["gwb"].h_map is None:
        assert tk["gwb"].h_map is None
    else:
        np.testing.assert_array_equal(tk["gwb"].h_map, jk["gwb"].h_map)
    for key in sorted(set(jk) - {"gwb"}):
        a, b = tk[key], jk[key]
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif isinstance(b, list):
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b], key
        else:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), key


IPTA_SMALL = dict(max_psr=16, max_toa=128)


def test_ipta_dr3_reduced_builds_on_the_cpu():
    """ipta_dr3's engine carries its CGW source population and BayesEphem
    draws: one sampled source without the pulsar term, one sampled body."""
    scn = treg.get("ipta_dr3").reduced(**IPTA_SMALL)
    sim = scn.build(device="cpu", stat_path="einsum")
    assert sim.batch.npsr == 16
    sig = sim._full.signals
    assert sig.det is None and len(sig.roemer) == 1 and len(sig.cgw) == 1
    assert sim._cgw_psrterm == ()
    # the nominal orbit rides the padded (P, T) slots, the source epochs too
    assert sig.roemer[0][0].sinE.shape == tuple(sim.batch.t_own.shape)
    assert sig.cgw[0][2].shape == tuple(sim.batch.t_own.shape)


@pytest.fixture(scope="module")
def ipta_jax():
    from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
    import jax

    scn = jreg.get("ipta_dr3").reduced(**IPTA_SMALL)
    return scn.build(mesh=jax_make_mesh(jax.devices()[:1])).run(
        8, seed=3, chunk=8)


@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_ipta_dr3_reduced_matches_jax(ipta_jax, path):
    """ipta_dr3 at 16 pulsars, built by each registry and run by each
    engine: within rtol 1e-5 and 1e-4 of the curve scale, the bound of the
    JAX package's sampled-signal tests."""
    sim = treg.get("ipta_dr3").reduced(**IPTA_SMALL).build(
        device="cpu", stat_path=path)
    got = sim.run(8, seed=3, chunk=8, precision="f32")
    assert got["curves"].shape == (8, 15)
    scale = np.abs(ipta_jax["curves"]).max()
    np.testing.assert_allclose(got["curves"], ipta_jax["curves"], rtol=1e-5,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got["autos"], ipta_jax["autos"], rtol=1e-5)


def test_build_takes_mesh_or_device():
    from fakepta_tpu_torch.parallel.mesh import make_mesh

    scn = treg.get("ng15").reduced(max_psr=8, max_toa=64)
    with pytest.raises(ValueError, match="not both"):
        scn.build(mesh=make_mesh(["cpu"]), device="cpu")
    sim = scn.build(mesh=make_mesh(["cpu"] * 2, psr_shards=2),
                    stat_path="einsum")
    assert sim.mesh.shape["psr"] == 2 and sim.stat_path == "einsum"
    assert sim.include[5]                 # per-backend system bands
    assert sim._full.hyper.white is not None
