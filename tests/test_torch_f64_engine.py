"""The port's float64 engine (a float64 ``PulsarBatch`` on the einsum path)
against the JAX engine's XLA path under ``jax_enable_x64``, on the CPU.

One float64 batch (8 pulsars, 64 TOA slots, every noise stage on: white,
ECORR, red, DM, chromatic, two system bands, the HD GWB) with every
sampler (noise hyperparameters, white levels), the fixed ``"det"`` block
(a CGW and a Roemer perturbation) and the sampled Roemer and CGW terms
goes through both engines with the same seeds. Tolerances:

- the noise block's residuals within ``RES_TOL`` (1e-12) of their scale
  (the draws within a few float64 ULP, tests/test_torch_f64_facade.py;
  float64 products and sums in another order);
- curves within ``RES_TOL`` of their scale and autos within ``RES_TOL``
  relative, on one device, a psr-2 mesh and a toa-2 mesh of ``["cpu"] *
  8`` (each against the JAX engine on the same mesh); the normalized pair
  correlations too. Both engines round the float64 pair sums to float32
  (the JAX contraction's ``preferred_element_type``), so the curves carry
  float32 pair sums in both and agree far inside the bound; a toa mesh
  adds its windows' float32 sums in float32, so it sits a float32 ULP of
  a pair sum from the one-device run, in both packages;
- the OS lane's amp2 and null amp2 within ``RES_TOL`` of their scale; the
  likelihood lane within ``LNL_RTOL`` (1e-10) relative and its gradient
  within ``GRAD_RTOL`` (1e-9) of its scale, the float64 bounds of
  tests/test_torch_infer_engine.py tightened to what this batch shows;
- ``model_bytes_per_chunk`` and the dispatch surface equal the JAX
  engine's (8-byte elements), bit for bit.

``stat_path=None`` on a float64 batch is the einsum path (the JAX
engine's default path at any dtype); the kernel paths take a float64 batch
too (tests/test_torch_f64_kernels.py holds them to the JAX package), but
not ``pallas_mxu_binning=False``, which the JAX kernel raises on; a tuned
kernel path is taken.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fakepta_tpu import infer as jinfer
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.detect import OSSpec as JaxOSSpec
from fakepta_tpu.parallel import montecarlo as jmc
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.utils import compat
from fakepta_tpu_torch import infer as tinfer
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.detect import OSSpec
from fakepta_tpu_torch.parallel import montecarlo as tmc
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.utils import rng
from test_torch_det_signals import CGW_A, JUPITER, MJD0_S, PDIST, TOAS_ABS
from test_torch_engine import KW, _noisy_leaves, _psd

R, SEED = 8, 3
RES_TOL = 1e-12
LNL_RTOL = 1e-10
GRAD_RTOL = 1e-9
CPU8 = ["cpu"] * 8
MESHES = {"psr2": dict(psr_shards=2), "toa2": dict(toa_shards=2)}


def _leaves64():
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    return {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
            for k, v in leaves.items()}


LEAVES = _leaves64()
TSPAN = float(LEAVES["tspan_common"])
GWB_PSD = _psd(TSPAN)
# every sampler and signal of the JAX engine, in its dataclasses
JAX_KW = dict(
    noise_sample=[
        jmc.NoiseSampling("red", log10_A=(-15.0, -13.0), gamma=(2.0, 5.0)),
        jmc.NoiseSampling("dm", log10_A=(-14.0, 0.3), gamma=(3.0, 0.5),
                          dist="normal"),
        jmc.NoiseSampling("chrom", spectrum="free_spectrum",
                          params={"log10_rho": (-8.0, -6.0)}),
        jmc.NoiseSampling("sys", log10_A=(-14.5, -13.5), gamma=(2.0, 3.0)),
        jmc.NoiseSampling("gwb", log10_A=(-15.0, -14.0), gamma=(4.0, 5.0))],
    white_sample=jmc.WhiteSampling(efac=(0.5, 2.5),
                                   log10_tnequad=(-8.0, -6.0),
                                   log10_ecorr=(-7.5, -6.5)),
    toaerr2=LEAVES["sigma2"],
    cgw=[jmc.CGWConfig(psrterm=True, **CGW_A)],
    roemer=[jmc.RoemerConfig("jupiter", **JUPITER)],
    roemer_sample=jmc.RoemerSampling("jupiter", s_mass=1.5e23, s_Om=2e-4,
                                     s_e=3e-7, s_l0=4e-4),
    cgw_sample=[jmc.CGWSampling(),
                jmc.CGWSampling(psrterm=True, sample_pdist=True,
                                tref=MJD0_S + 0.5 * TSPAN)],
    toas_abs=TOAS_ABS, pdist=PDIST)


def _convert(value):
    """A JAX package config (or a list of them) as the port's."""
    if isinstance(value, list):
        return [_convert(v) for v in value]
    if dataclasses.is_dataclass(value):
        return getattr(tmc, type(value).__name__)(**dataclasses.asdict(value))
    return value


PORT_KW = {k: _convert(v) for k, v in JAX_KW.items()}


def _jax_batch():
    return JaxBatch(**{k: jnp.asarray(v) for k, v in LEAVES.items()})


def _jax_sim(mesh=None, **kw):
    return jmc.EnsembleSimulator(
        _jax_batch(), gwb=jmc.GWBConfig(psd=GWB_PSD, orf="hd"),
        mesh=mesh or jax_make_mesh(jax.devices()[:1]), **JAX_KW, **kw)


def _port_sim(**kw):
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return tmc.EnsembleSimulator(
        PulsarBatch.from_numpy(LEAVES, device="cpu"),
        gwb=tmc.GWBConfig(psd=GWB_PSD, orf="hd"), **PORT_KW, **kw)


def _scale_close(got, want, tol=RES_TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _same_stats(got, want, what=""):
    assert got["curves"].dtype == np.float64, what
    _scale_close(got["curves"], want["curves"], what=what)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=RES_TOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's float64 runs: one device with ``keep_corr``, the
    psr-2 and toa-2 meshes, the OS lane with its null stream and the
    likelihood lane, each compiled once."""
    one = _jax_sim()
    lnl = jinfer.InferSpec(model=_curn(jinfer), theta=_THETA, mode="grad")
    out = {"one": one.run(R, seed=SEED, chunk=R, keep_corr=True),
           "os": one.run(R, seed=SEED, chunk=R,
                         os=JaxOSSpec(orf=("hd", "dipole"), null=True)),
           "lnlike": one.run(R, seed=SEED, chunk=R, lnlike=lnl)["lnlike"],
           "sim": one}
    for name, kw in MESHES.items():
        out[name] = _jax_sim(jax_make_mesh(jax.devices(), **kw)).run(
            R, seed=SEED, chunk=R)
    return out


def _curn(pkg):
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return L(components=(
        C("red", spectrum="batch"), C("dm", spectrum="batch"),
        C("curn", nbin=4, free=(F("log10_A", (-14.5, -12.5)),
                                F("gamma", (2.0, 6.0))))))


_THETA = np.array([[-13.6, 3.3], [-13.1, 4.4], [-12.8, 5.2]])


# -- the path rules --------------------------------------------------------------

def test_float64_defaults_to_einsum_and_the_kernels_refuse_it():
    """The einsum default; both kernel paths taken; the fused path's
    mxu_binning=False refused (the JAX kernel raises); a tuned kernel path
    taken."""
    b64 = PulsarBatch.from_numpy(LEAVES, device="cpu")
    assert tmc.EnsembleSimulator(b64, device="cpu").stat_path == "einsum"
    b32 = PulsarBatch.from_numpy(LEAVES, device="cpu", dtype=torch.float32)
    assert tmc.EnsembleSimulator(b32, device="cpu").stat_path == "fused"
    for path in ("fused", "mega"):
        assert tmc.EnsembleSimulator(b64, device="cpu",
                                     stat_path=path).stat_path == path
    with pytest.raises(ValueError, match="pallas_mxu_binning=False"):
        tmc.EnsembleSimulator(b64, device="cpu", stat_path="fused",
                              pallas_mxu_binning=False)
    # float32 takes the per-slot-reduction kernel, as before
    tmc.EnsembleSimulator(b32, device="cpu", stat_path="fused",
                          pallas_mxu_binning=False)
    sim = tmc.EnsembleSimulator(b64, device="cpu")
    assert sim._path_refusal("fused") is None
    assert sim._path_refusal("mega") is None
    vpu = tmc.EnsembleSimulator(b64, device="cpu", pallas_mxu_binning=False)
    assert "pallas_mxu_binning=False" in vpu._path_refusal("fused")
    assert vpu._path_refusal("mega") is None
    # a tuned kernel path is taken on a float64 simulator
    assert sim._tuned_knobs({"path": "mega", "chunk": 4}, False) == (
        {"path": "mega", "chunk": 4}, "mega")
    b16 = PulsarBatch.from_numpy(LEAVES, device="cpu", dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        tmc.EnsembleSimulator(b16, device="cpu", stat_path="einsum")


def test_model_bytes_and_dispatch_surface_match_jax(jax_runs):
    jsim, sim = jax_runs["sim"], _port_sim()
    assert sim.dispatch_surface() == jsim.dispatch_surface()
    assert sim.dispatch_surface()["dtype_bytes"] == 8
    for chunk in (8, 16, 1024):
        want = jsim.model_bytes_per_chunk(chunk, "xla")
        assert sim.model_bytes_per_chunk(chunk) == want
        assert sim.chunk_cost(chunk)["bytes_per_chunk"] == want
    assert jax_runs["one"]["report"].summary()["model_bytes_per_chunk"] == \
        sim.model_bytes_per_chunk(R)


# -- the residuals ---------------------------------------------------------------

def test_noise_block_matches_jax_x64(jax_runs):
    """Every noise stage with every sampler: the port's residual blocks
    against the JAX engine's shard_map body on the same keys."""
    jsim = jax_runs["sim"]
    specs = jax.tree_util.tree_map(lambda _: P(), jsim.batch)
    fn = jax.jit(compat.shard_map(
        lambda k, b, sp, wp, te, bi: jmc._simulate_block(
            k, b, jsim._chol, jsim._gwb_w, jsim._gwb_idx, jsim._gwb_freqf,
            *jsim._include, samp_static=jsim._samp_static, samp_params=sp,
            white_static=jsim._white_static, white_params=wp,
            white_toaerr2=te, white_bid=bi, white_nb=jsim._white_nb),
        mesh=jsim.mesh, in_specs=(P(), specs, P(), P(), P(), P()),
        out_specs=P(), check_vma=False))
    keys_j = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(SEED),
                                                   i))(np.arange(R))
    want = np.asarray(fn(keys_j, jsim.batch, jsim._samp_params,
                         jsim._white_params, jsim._white_toaerr2,
                         jsim._white_bid))
    sim = _port_sim()
    assert sim.include == (True,) * 7
    keys = rng.fold_in(rng.key(SEED, device="cpu"), torch.arange(R))
    got = tmc._simulate_block(keys, sim.batch, sim._chol, sim._gwb_w,
                              sim._include, sim._terms,
                              hyper=sim._full.hyper)
    assert got.dtype == torch.float64
    _scale_close(got.numpy(), want, what="noise block")
    _scale_close(sim._full.signals.det.numpy(), np.asarray(jsim._det),
                 what="det block")


# -- the statistic, on one device and on meshes ------------------------------------

def test_every_stage_matches_jax_xla_x64(jax_runs):
    want = jax_runs["one"]
    sim = _port_sim()
    out = sim.run(R, seed=SEED, chunk=R, keep_corr=True)
    assert out["statistic_path"] == "einsum" and out["precision"] == "f32"
    _same_stats(out, want)
    assert out["corr"].dtype == np.float64
    _scale_close(out["corr"], want["corr"], what="corr")
    # without keep_corr the default path; a smaller chunk draws the same
    again = sim.run(R, seed=SEED, chunk=R // 2)
    assert again["statistic_path"] == "einsum"
    _same_stats(again, want, "chunk 4")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshes_match_jax_x64(jax_runs, name):
    sim = _port_sim(mesh=make_mesh(CPU8, **MESHES[name]))
    out = sim.run(R, seed=SEED, chunk=R)
    _same_stats(out, jax_runs[name], name)


# -- the lanes ---------------------------------------------------------------------

def test_os_lane_with_null_matches_jax_x64(jax_runs):
    want = jax_runs["os"]
    out = _port_sim().run(R, seed=SEED, chunk=R,
                          os=OSSpec(orf=("hd", "dipole"), null=True))
    _same_stats(out, want)
    for orf in ("hd", "dipole"):
        got, ref = out["os"]["stats"][orf], want["os"]["stats"][orf]
        for key in ("amp2", "null_amp2"):
            _scale_close(got[key], ref[key], what=f"{orf} {key}")


def test_likelihood_lane_matches_jax_x64(jax_runs):
    want = jax_runs["lnlike"]
    out = _port_sim().run(R, seed=SEED, chunk=R, lnlike=tinfer.InferSpec(
        model=_curn(tinfer), theta=_THETA, mode="grad"))
    got = out["lnlike"]
    assert got["param_names"] == want["param_names"]
    np.testing.assert_allclose(got["lnl"], want["lnl"], rtol=LNL_RTOL)
    _scale_close(got["grad"], want["grad"], GRAD_RTOL, "grad")
