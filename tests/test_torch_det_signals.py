"""Deterministic and sampled CGW / BayesEphem signals in the PyTorch port's
engine against the JAX engine, on the CPU.

The same float32 batch (8 pulsars, 64 TOA slots, two of them ragged), the
same absolute epochs, distances and seeds go through both engines:

- fixed signals (``CGWConfig`` in both amplitude modes with and without the
  pulsar term, ``RoemerConfig``, ``waveform=`` arrays, callables and a
  mix): the delay block within 2e-4 of its scale (the JAX package's own
  bound for its fixed CGW block, ``tests/test_cgw_batch_sampling.py``),
  the statistics within 1e-5 of the curve scale and 1e-5 relative on the
  autos;
- sampled signals (``CGWSampling``: uniform, normal, ``log10_dist``,
  ``psrterm``, ``sample_pdist``; ``RoemerSampling``: one and two bodies):
  the uniform draws bit for bit against the JAX draw chain and the
  normal ones within the port's normals' bound (tests/test_torch_rng.py:
  4 ULP of the unit normal), the
  statistics within ``rtol=1e-5, atol=1e-4 * scale``, the bound
  ``tests/test_roemer_sampling.py`` and ``tests/test_cgw_batch_sampling.py``
  hold the JAX engine's sampled runs to.

Port-only: the ``"mega"`` and ``"fused"`` paths against ``"einsum"``
(1e-5 of scale), psr-sharded meshes against the one-shard run, pipeline
depths 0-3 and a checkpoint resume bit-identical, and the constructor's
rules with the JAX engine's messages.

The sampled draws and the sampled signals' statistics against JAX are in
tests/test_torch_det_signals_sampled.py, on this file's batch, cases and
``jax_runs`` fixture.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel import montecarlo as jmc
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.parallel import montecarlo as tmc
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.utils import rng
from test_torch_engine import KW, _psd
from test_torch_rng import NORMAL_MAX_ULP

R = 8
SEED = 3
NORMAL_ULP = NORMAL_MAX_ULP + 1    # the normal, then its product by a scale
TOL = 1e-5                 # fixed signals, and port paths against einsum
SAMPLED = dict(rtol=1e-5, atol=1e-4)
DET_TOL = 2e-4
MJD0_S = 53000.0 * 86400.0
NPSR, NTOA = KW["npsr"], KW["ntoa"]
# two ragged pulsars: their last TOA slots are padding
VALID = np.full(NPSR, NTOA)
VALID[[2, 5]] = (50, 41)

CGW_A = dict(costheta=0.21, phi=2.9, cosinc=0.4, log10_mc=9.2,
             log10_fgw=-7.9, log10_h=-13.6, phase0=1.1, psi=0.7)
CGW_B = dict(costheta=-0.55, phi=0.8, cosinc=-0.2, log10_mc=8.9,
             log10_fgw=-8.3, log10_h=-13.9, phase0=2.6, psi=0.2)
CGW_D = dict(CGW_B, log10_h=None, log10_dist=1.7, psrterm=True)
JUPITER = dict(d_mass=1.2e-4 * 1.899e27, d_Om=3e-4, d_omega=-2e-4,
               d_inc=1e-4, d_a=4e-8, d_e=3e-7, d_l0=-5e-4)


def _leaves():
    leaves = {f.name: np.array(getattr(JaxBatch.synthetic(**KW), f.name))
              for f in dataclasses.fields(JaxBatch)}
    leaves["mask"] = np.arange(NTOA)[None, :] < VALID[:, None]
    return leaves


LEAVES = _leaves()
TSPAN = float(LEAVES["tspan_common"])
TOAS_ABS = (MJD0_S + 1e6 * np.arange(NPSR)[:, None]
            + np.linspace(0.0, TSPAN, NTOA)[None, :])
PDIST = np.column_stack([np.linspace(0.6, 1.8, NPSR),
                         np.linspace(0.05, 0.2, NPSR)])


def _ramp(toas):
    """A waveform callable with the facade's contract: its span and
    minimum are those of the pulsar's real epochs."""
    return 2e-7 * (toas - toas.min()) / (toas.max() - toas.min()) - 1e-7


def _sine(toas, amp):
    return amp * np.sin(2 * np.pi * (toas - MJD0_S) / 3.1e7)


WAVE_ARRAY = 5e-8 * np.cos(np.linspace(0.0, 9.0, NPSR * NTOA)).reshape(
    NPSR, NTOA)

# one engine configuration per case, in the JAX package's dataclasses
FIXED = {
    "cgw": dict(cgw=[jmc.CGWConfig(psrterm=True, **CGW_A),
                     jmc.CGWConfig(**CGW_B), jmc.CGWConfig(**CGW_D)]),
    "roemer": dict(roemer=[jmc.RoemerConfig("jupiter", **JUPITER),
                           jmc.RoemerConfig("saturn", d_mass=4e22)]),
    "waveform": dict(waveform=[WAVE_ARRAY, _ramp,
                               functools.partial(_sine, amp=3e-8)]),
}
SAMPLED_CASES = {
    "cgw_uniform": dict(cgw_sample=jmc.CGWSampling()),
    "cgw_normal_dist": dict(cgw_sample=jmc.CGWSampling(
        log10_h=None, log10_dist=(1.5, 2.0), log10_mc=(9.0, 0.15),
        costheta=(0.1, 0.3), dist={"log10_mc": "normal",
                                   "costheta": "normal"},
        tref=MJD0_S + 0.5 * TSPAN)),
    "cgw_psrterm": dict(cgw_sample=[
        jmc.CGWSampling(psrterm=True, tref=MJD0_S),
        jmc.CGWSampling(psrterm=True, sample_pdist=True,
                        tref=MJD0_S + 0.5 * TSPAN,
                        log10_h=(-13.8, -13.4))]),
    "roemer_one": dict(roemer_sample=jmc.RoemerSampling(
        "jupiter", s_mass=1.5e23, s_Om=2e-4, s_e=3e-7, s_l0=4e-4)),
    "roemer_two": dict(roemer_sample=[
        jmc.RoemerSampling("jupiter", s_mass=1.5e23),
        jmc.RoemerSampling("saturn", s_a=5e-8, s_inc=2e-4)]),
}
# everything at once: the frozen term order of both engines
ALL = dict(FIXED["cgw"], **FIXED["roemer"], waveform=[_ramp],
           roemer_sample=SAMPLED_CASES["roemer_two"]["roemer_sample"],
           cgw_sample=SAMPLED_CASES["cgw_psrterm"]["cgw_sample"])
CASES = dict(FIXED, **SAMPLED_CASES, all=ALL)


def _convert(value):
    """A JAX package config (or a list of them) as the port's."""
    if isinstance(value, list):
        return [_convert(v) for v in value]
    if dataclasses.is_dataclass(value):
        return getattr(tmc, type(value).__name__)(**dataclasses.asdict(value))
    return value


def _signal_kw(case, port):
    kw = {k: (_convert(v) if port else v) for k, v in CASES[case].items()}
    return dict(kw, toas_abs=TOAS_ABS, pdist=PDIST)


def _jax_sim(case, **kw):
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in LEAVES.items()})
    return jmc.EnsembleSimulator(
        jb, gwb=jmc.GWBConfig(psd=_psd(TSPAN)),
        mesh=jax_make_mesh(jax.devices()[:1]), **_signal_kw(case, False),
        **kw)


def _port_sim(case, **kw):
    kw.setdefault("device", "cpu") if "mesh" not in kw else None
    return tmc.EnsembleSimulator(
        PulsarBatch.from_numpy(LEAVES, device="cpu"),
        gwb=tmc.GWBConfig(psd=_psd(TSPAN)), **_signal_kw(case, True), **kw)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(case):
        if case not in cache:
            sim = _jax_sim(case)
            cache[case] = (np.asarray(sim._det),
                           sim.run(R, seed=SEED, chunk=R))
        return cache[case]
    return get


def _assert_stats(got, want, rtol=TOL, atol=TOL):
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=rtol,
                               atol=atol * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=rtol)


# ------------------------------------------------------------- fixed block

@pytest.mark.parametrize("case", sorted(FIXED) + ["all"])
def test_fixed_block_matches_jax(jax_runs, case):
    want, _ = jax_runs(case)
    got = _port_sim(case)._full.signals.det.numpy()
    scale = np.abs(want).max()
    assert scale > 1e-9
    np.testing.assert_allclose(got, want, rtol=0, atol=DET_TOL * scale)
    # padding slots stay zero, the ragged pulsars' real slots do not
    mask = LEAVES["mask"]
    np.testing.assert_array_equal(got[~mask], 0.0)
    assert np.abs(got[2, :VALID[2]]).max() > 0


@pytest.mark.parametrize("case", sorted(FIXED))
def test_fixed_signals_statistics_match_jax(jax_runs, case):
    _, want = jax_runs(case)
    got = _port_sim(case, stat_path="einsum").run(R, seed=SEED, chunk=R)
    _assert_stats(got, want)


def test_waveform_callable_sees_the_real_epochs():
    """The callable is invoked per pulsar on its unpadded epochs only; the
    engine's block is the callable's values there and zero in padding."""
    seen = []

    def wf(toas):
        seen.append(np.array(toas))
        return _ramp(toas)

    sim = tmc.EnsembleSimulator(
        PulsarBatch.from_numpy(LEAVES, device="cpu"), device="cpu",
        waveform=wf, toas_abs=TOAS_ABS)
    assert [len(t) for t in seen] == list(VALID)
    det = sim._full.signals.det.numpy()
    for i in range(NPSR):
        np.testing.assert_allclose(det[i, :VALID[i]],
                                   _ramp(TOAS_ABS[i, :VALID[i]]), rtol=1e-6,
                                   atol=1e-14)


# ------------------------------------------- port paths, meshes, run loop

@pytest.mark.parametrize("path", ["fused", "mega"])
@pytest.mark.parametrize("case", ["cgw_psrterm", "roemer_one", "all"])
def test_kernel_paths_match_einsum(case, path):
    want = _port_sim(case, stat_path="einsum").run(R, seed=SEED, chunk=R,
                                                   precision="f32")
    got = _port_sim(case, stat_path=path).run(R, seed=SEED, chunk=R,
                                              precision="f32")
    _assert_stats(got, want)


@pytest.mark.parametrize("real,psr", [(4, 2), (2, 4)])
def test_signals_do_not_depend_on_the_mesh(real, psr):
    """Each psr shard's residual rows (its rows of the fixed block, of the
    orbit states, of the epochs, distances and bulks) equal the 1-shard
    engine's bit for bit; the sharded statistics land within 1e-5."""
    one = _port_sim("all", stat_path="einsum")
    mesh = make_mesh(["cpu"] * 8, psr_shards=psr)
    assert mesh.shape["real"] == real
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 0, R)
    want = one.run(R, seed=SEED, chunk=R)
    for path in ("einsum", "mega"):
        sharded = _port_sim("all", mesh=mesh, stat_path=path)
        if path == "einsum":
            rows = torch.cat([sharded._residuals(keys, shard=sh)
                              for sh in sharded._shards[0]], dim=1)
            assert torch.equal(rows, one._residuals(keys))
        _assert_stats(sharded.run(R, seed=SEED, chunk=R, precision="f32"),
                      want)


# ---------------------------------------------------------------- run loop

def test_pipeline_depths_and_resume_are_bit_identical(tmp_path):
    """The psrterm bulks are staged per chunk on the host: every depth and
    a resumed checkpoint give the same bits, and so does a chunk-size
    change's stream (within float32 reduction order)."""
    sim = _port_sim("all", stat_path="fused")
    runs = {d: sim.run(4 * R, seed=SEED, chunk=R, pipeline_depth=d,
                       precision="f32") for d in (0, 1, 2, 3)}
    for d in (1, 2, 3):
        for key in ("curves", "autos"):
            np.testing.assert_array_equal(runs[d][key], runs[0][key])
    names = [e["name"] for e in runs[2]["report"].timeline]
    assert "stage_inputs" in names and names.count("precompute") == 3
    ck = tmp_path / "ck.npz"

    class Cut(Exception):
        pass

    def cut(done, nreal):
        if done >= 2 * R:
            raise Cut

    with pytest.raises(Cut):
        sim.run(4 * R, seed=SEED, chunk=R, pipeline_depth=2,
                precision="f32", checkpoint=ck, progress=cut)
    resumed = sim.run(4 * R, seed=SEED, chunk=R, pipeline_depth=2,
                      precision="f32", checkpoint=ck)
    for key in ("curves", "autos"):
        np.testing.assert_array_equal(resumed[key], runs[0][key])
    again = sim.run(4 * R, seed=SEED, chunk=2 * R, precision="f32")
    _assert_stats(again, runs[0])


def test_lanes_refuse_psrterm_sampling():
    with pytest.raises(ValueError, match="psrterm CGW"):
        _port_sim("cgw_psrterm").run(R, chunk=R, lanes=[(1, R)])
    # without a pulsar term, lanes run: each equals its solo run
    sim = _port_sim("cgw_uniform", stat_path="einsum")
    lane = sim.run(R, chunk=R, lanes=[(4, R)])
    solo = sim.run(R, seed=4, chunk=R)
    _assert_stats(lane, solo)


# --------------------------------------------------------- the constructor

def _bare(**kw):
    return tmc.EnsembleSimulator(PulsarBatch.from_numpy(LEAVES, device="cpu"),
                                 device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(cgw=tmc.CGWConfig(**CGW_A)),
    dict(roemer=tmc.RoemerConfig("jupiter", d_mass=1e23)),
    dict(waveform=_ramp),
    dict(roemer_sample=tmc.RoemerSampling("jupiter", s_mass=1e23)),
    dict(cgw_sample=tmc.CGWSampling())], ids=lambda kw: next(iter(kw)))
def test_signals_need_toas_abs(kw):
    with pytest.raises(ValueError, match="toas_abs"):
        _bare(**kw)
    with pytest.raises(ValueError, match="toas_abs shape"):
        _bare(toas_abs=TOAS_ABS[:, :10], **kw)


@pytest.mark.parametrize("match,kw", [
    ("needs psrterm", dict(cgw_sample=tmc.CGWSampling(sample_pdist=True))),
    ("amplitude range", dict(cgw_sample=tmc.CGWSampling(log10_h=None))),
    ("CGWSampling dist must be", dict(cgw_sample=tmc.CGWSampling(
        dist="cauchy"))),
    ("not sampled parameters", dict(cgw_sample=tmc.CGWSampling(
        dist={"log10_h": "normal"}, log10_h=None, log10_dist=(1.0, 2.0)))),
    ("expected the padded batch shape", dict(waveform=np.zeros((2, 3)))),
    ("returned shape", dict(waveform=lambda toas: toas[:3])),
])
def test_constructor_refuses_what_jax_refuses(match, kw):
    with pytest.raises(ValueError, match=match):
        _bare(toas_abs=TOAS_ABS, **kw)
    jkw = {k: (getattr(jmc, type(v).__name__)(**dataclasses.asdict(v))
               if dataclasses.is_dataclass(v) else v) for k, v in kw.items()}
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in LEAVES.items()})
    with pytest.raises(ValueError, match=match):
        jmc.EnsembleSimulator(jb, mesh=jax_make_mesh(jax.devices()[:1]),
                              toas_abs=TOAS_ABS, **jkw)


def test_zero_sigma_pdist_warns_and_zero_scales_are_skipped():
    with pytest.warns(UserWarning, match="all-zero pdist sigmas"):
        _bare(toas_abs=TOAS_ABS, cgw_sample=tmc.CGWSampling(
            psrterm=True, sample_pdist=True))
    # an all-zero RoemerSampling samples nothing: the run is the plain one
    plain = _bare(gwb=tmc.GWBConfig(psd=_psd(TSPAN))).run(R, seed=1, chunk=R)
    zero = _bare(gwb=tmc.GWBConfig(psd=_psd(TSPAN)), toas_abs=TOAS_ABS,
                 roemer_sample=tmc.RoemerSampling("jupiter"))
    assert zero._full.signals.roemer == ()
    got = zero.run(R, seed=1, chunk=R)
    for key in ("curves", "autos"):
        np.testing.assert_array_equal(got[key], plain[key])


def test_det_stage_gates_only_the_fixed_block():
    kw = dict(toas_abs=TOAS_ABS, cgw=tmc.CGWConfig(**CGW_A),
              roemer_sample=tmc.RoemerSampling("jupiter", s_mass=1e23))
    gated = _bare(include=("white", "red"), **kw)
    assert gated._full.signals.det is None
    assert len(gated._full.signals.roemer) == 1
    assert _bare(**kw)._full.signals.det is not None
