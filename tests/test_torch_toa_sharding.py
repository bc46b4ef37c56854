"""The PyTorch port's TOA sharding (``toa_shards > 1``) on the CPU.

A shard of a (real, psr, toa) mesh is a (psr, toa) cell holding a window
of every TOA-width field. Its per-TOA draws are its window's counters of
the full-width draw (bit-equal to the full draw sliced), ECORR epoch
normals index global epoch ids, and the pair sums add over the toa cells
in a fixed order. The port's toa-sharded runs are held against the JAX
engine's on ``make_mesh(jax.devices(), toa_shards=...)`` and against its
own unsharded runs at the JAX package's bound (rtol 5e-5,
tests/test_toa_sharding.py), with bit-identical reruns.
"""

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.fake_pta import Pulsar
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu.parallel.montecarlo import NoiseSampling as JaxNoise
from fakepta_tpu.parallel.montecarlo import WhiteSampling as JaxWhite
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.detect import OSSpec
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import (CGWSampling,
                                                   EnsembleSimulator,
                                                   GWBConfig, NoiseSampling,
                                                   RoemerConfig,
                                                   RoemerSampling,
                                                   WhiteSampling, _chunk_keys)
from fakepta_tpu_torch.utils import rng

BATCH = dict(npsr=8, ntoa=128, tspan_years=10.0, toaerr=1e-7, n_red=8,
             n_dm=8, seed=1)
CPU8 = ["cpu"] * 8
MJD0_S = 53000.0 * 86400.0


def _psd(tspan, ncomp=8, log10_A=-13.5):
    f = np.arange(1, ncomp + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=log10_A, gamma=13 / 3))


def _close(got, want, rtol=5e-5):
    """The JAX package's toa-sharding bound."""
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=rtol,
                               atol=1e-7 * np.abs(want["curves"]).max())
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=rtol)


def _sampling(sigma2):
    """The JAX test's full program: red hyperparameter and white draws."""
    return dict(noise_sample=NoiseSampling("red", log10_A=(-14.5, -13.5),
                                           gamma=(2.0, 5.0)),
                white_sample=WhiteSampling(efac=(0.5, 2.5),
                                           log10_tnequad=(-8.0, -6.0)),
                toaerr2=sigma2)


@pytest.fixture(scope="module")
def batches():
    return (JaxBatch.synthetic(**BATCH),
            PulsarBatch.synthetic(**BATCH, device="cpu"))


@pytest.fixture(scope="module")
def jax_toa(batches):
    """The JAX engine's full program on toa_shards 2 and 4 (8 devices)."""
    jb = batches[0]
    kw = dict(gwb=JaxGWB(psd=_psd(float(jb.tspan_common)), orf="hd"),
              noise_sample=JaxNoise("red", log10_A=(-14.5, -13.5),
                                    gamma=(2.0, 5.0)),
              white_sample=JaxWhite(efac=(0.5, 2.5),
                                    log10_tnequad=(-8.0, -6.0)),
              toaerr2=np.asarray(jb.sigma2))
    return {s: JaxSim(jb, mesh=jax_make_mesh(jax.devices(), toa_shards=s),
                      **kw).run(16, seed=3, chunk=8)
            for s in (2, 4)}


def _port(tb, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return EnsembleSimulator(tb, gwb=GWBConfig(
        psd=_psd(float(tb.tspan_common)), orf="hd"), mesh=mesh,
        stat_path="einsum", **kw)


# -- the window draw ------------------------------------------------------

@pytest.mark.parametrize("start,n", [(0, 64), (64, 64), (32, 32), (96, 32),
                                     (195, 195), (7, 1)])
def test_window_draw_equals_the_full_draw_sliced(start, n):
    keys = rng.split(rng.key(5, device="cpu"), 6)               # (6, 2)
    full = 390
    for draw in (rng.random_bits, rng.uniform, rng.normal):
        got = draw(keys, n, start=start)
        want = draw(keys, full)[..., start:start + n]
        assert got.shape == (6, n)
        assert torch.equal(got, want), draw.__name__


# -- the engine against the JAX engine ------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_toa_sharded_streams_match_jax(batches, jax_toa, shards):
    tb = batches[1]
    kw = _sampling(tb.numpy()["sigma2"])
    sim = _port(tb, make_mesh(CPU8, toa_shards=shards), **kw)
    assert sim.mesh.shape == {"real": 8 // shards, "psr": 1, "toa": shards}
    out = sim.run(16, seed=3, chunk=8)
    _close(out, jax_toa[shards])
    again = sim.run(16, seed=3, chunk=8)
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(out[k], again[k])
    # and the port's own unsharded run
    _close(out, _port(tb, **kw).run(16, seed=3, chunk=8))


def test_psr_and_toa_sharding_compose(batches, jax_toa):
    """A (real 2, psr 2, toa 2) mesh, every axis active: each cell holds 4
    pulsars x 64 TOAs."""
    tb = batches[1]
    kw = _sampling(tb.numpy()["sigma2"])
    sim = _port(tb, make_mesh(CPU8, psr_shards=2, toa_shards=2), **kw)
    cells = sim._shards[0]
    assert [(c.p_offset, c.t_offset) for c in cells] == [
        (0, 0), (0, 64), (4, 0), (4, 64)]
    assert all(c.batch.t_own.shape == (4, 64) for c in cells)
    assert all(c.hyper.toaerr2.shape == (4, 64) for c in cells)
    _close(sim.run(16, seed=3, chunk=8), jax_toa[2])


def test_toa_sharded_keep_corr_and_os_lane(batches):
    """keep_corr's pair correlations and the OS lane with its null stream
    on a psr 2 x toa 2 mesh against the unsharded run."""
    tb = batches[1]
    spec = OSSpec(orf=("hd", "dipole"), null=True)
    ref = _port(tb).run(16, seed=4, chunk=8, os=spec, keep_corr=True)
    for mesh in (make_mesh(CPU8, toa_shards=2),
                 make_mesh(CPU8, psr_shards=2, toa_shards=2)):
        out = _port(tb, mesh).run(16, seed=4, chunk=8, os=spec,
                                  keep_corr=True)
        _close(out, ref)
        np.testing.assert_allclose(out["corr"], ref["corr"], rtol=5e-5,
                                   atol=1e-7 * np.abs(ref["corr"]).max())
        for orf in spec.orfs:
            scale = np.abs(ref["os"]["stats"][orf]["amp2"]).max()
            for k in ("amp2", "null_amp2"):
                np.testing.assert_allclose(
                    out["os"]["stats"][orf][k], ref["os"]["stats"][orf][k],
                    rtol=0, atol=1e-4 * scale, err_msg=f"{orf}/{k}")


# -- ECORR epochs across a window boundary ----------------------------------

@pytest.fixture(scope="module")
def straddling():
    """25 epochs of 5 TOAs and one of 3: toa_shards=4 puts the window
    boundaries at TOA 32 / 64 / 96, inside epochs 6, 12 and 19 (built by
    the JAX facade, as in the JAX package's test, and carried over leaf for
    leaf)."""
    day = 86400.0
    toas = np.concatenate([k * 30 * day + np.arange(5 if k < 25 else 3)
                           * 600.0 for k in range(26)])
    assert toas.size == 128
    psrs = []
    for k in range(8):
        p = Pulsar(toas, 1e-7, np.arccos(1 - 2 * (k + 0.5) / 8),
                   2.39996 * k % (2 * np.pi), seed=k,
                   custom_model={"RN": 4, "DM": None, "Sv": None})
        p.noisedict[f"{p.name}_{p.backends[0]}_log10_ecorr"] = -6.3
        psrs.append(p)
    jb = JaxBatch.from_pulsars(psrs, n_red=4, n_dm=4, ecorr=True)
    leaves = {k: np.asarray(getattr(jb, k)) for k in jb.__dataclass_fields__}
    return jb, PulsarBatch.from_numpy(leaves, device="cpu")


def test_ecorr_epochs_straddling_a_window_boundary(straddling):
    jb, tb = straddling
    kw = dict(include=("white", "ecorr", "red"))
    want = JaxSim(jb, mesh=jax_make_mesh(jax.devices()[:1]), **kw).run(
        16, seed=3, chunk=8)
    sim = EnsembleSimulator(tb, mesh=make_mesh(CPU8, toa_shards=4),
                            stat_path="einsum", **kw)
    assert sim.include[:2] == (True, True)
    cells = sim._shards[0]
    # an epoch straddles each boundary: the windows' epoch ranges overlap
    windows = [c.ecorr_window for c in cells]
    for (lo_a, n_a), (lo_b, _) in zip(windows, windows[1:]):
        assert lo_b == lo_a + n_a - 1
    _close(sim.run(16, seed=3, chunk=8), want)
    # the white + ECORR residuals of the windows are the unsharded ones,
    # bit for bit: one shared normal per epoch on both sides
    noise = EnsembleSimulator(tb, device="cpu", stat_path="einsum",
                              include=("white", "ecorr"))
    sharded = EnsembleSimulator(tb, mesh=make_mesh(CPU8, toa_shards=4),
                                stat_path="einsum",
                                include=("white", "ecorr"))
    keys = _chunk_keys(rng.key(3, device="cpu"), 0, 8)
    full = noise._residuals(keys)
    parts = [sharded._residuals(keys, shard=c) for c in sharded._shards[0]]
    assert torch.equal(torch.cat(parts, dim=2), full)


# -- the signals ---------------------------------------------------------------

def test_toa_sharded_fixed_and_sampled_signals(batches):
    """The fixed Roemer block, a sampled CGW source and a sampled BayesEphem
    body ride the TOA windows: every cell's residuals are the unsharded
    residuals' window (the per-TOA terms bit for bit, the GP projection to
    its rounding), and the run lands within the JAX package's 1e-4 bound
    for these signals."""
    tb = batches[1]
    toas_abs = np.tile(MJD0_S + np.linspace(0, 10 * 3.15576e7, 128), (8, 1))
    kw = dict(roemer=RoemerConfig("jupiter", d_mass=1e-4 * 1.899e27),
              cgw_sample=CGWSampling(tref=float(toas_abs.mean())),
              roemer_sample=RoemerSampling("jupiter", s_mass=1.5e23,
                                           s_Om=1e-3),
              toas_abs=toas_abs)
    ref_sim = _port(tb, **kw)
    sim = _port(tb, make_mesh(CPU8, psr_shards=2, toa_shards=2), **kw)
    keys = _chunk_keys(rng.key(3, device="cpu"), 0, 8)
    full = ref_sim._residuals(keys)
    scale = float(full.abs().max())
    for c in sim._shards[0]:
        win = full[:, c.p_offset:c.p_offset + 4, c.t_offset:c.t_offset + 64]
        got = sim._residuals(keys, shard=c)
        np.testing.assert_allclose(got.numpy(), win.numpy(), rtol=0,
                                   atol=1e-6 * scale)
    out = sim.run(16, seed=3, chunk=8)
    ref = ref_sim.run(16, seed=3, chunk=8)
    np.testing.assert_allclose(out["curves"], ref["curves"], rtol=0,
                               atol=1e-4 * np.abs(ref["curves"]).max())
    np.testing.assert_allclose(out["autos"], ref["autos"], rtol=1e-4)
    again = sim.run(16, seed=3, chunk=8)
    np.testing.assert_array_equal(out["curves"], again["curves"])


# -- what toa sharding refuses ---------------------------------------------

@pytest.mark.parametrize("path,mxu", [("fused", True), ("fused", False),
                                      ("mega", True)])
def test_kernel_paths_refuse_toa_sharding(batches, path, mxu):
    with pytest.raises(ValueError, match="toa sharding"):
        EnsembleSimulator(batches[1], mesh=make_mesh(CPU8, toa_shards=2),
                          stat_path=path, pallas_mxu_binning=mxu)
    # the same path on a psr-only mesh is fine
    EnsembleSimulator(batches[1], mesh=make_mesh(CPU8, psr_shards=2),
                      stat_path=path, pallas_mxu_binning=mxu)


def test_toa_width_fields_are_all_windowed(batches):
    """A batch leaf whose last axis has the TOA width but is not in the
    window list trips the construction-time check."""
    leaves = batches[1].numpy()
    leaves["sys_psd"] = np.zeros((8, 1, 128), np.float32)
    odd = PulsarBatch.from_numpy(leaves, device="cpu")
    with pytest.raises(AssertionError, match="_BATCH_TOA_FIELDS"):
        EnsembleSimulator(odd, mesh=make_mesh(CPU8, toa_shards=2),
                          stat_path="einsum")
    with pytest.raises(ValueError, match="divisible by the toa mesh"):
        EnsembleSimulator(PulsarBatch.synthetic(npsr=8, ntoa=130,
                                                device="cpu"),
                          mesh=make_mesh(CPU8, toa_shards=4),
                          stat_path="einsum")


def test_ipta_dr3_reduced_toa_sharded():
    """The scenario with the most per-TOA state (seven backend bands, white
    hyperprior draws by backend, a sampled CGW source and BayesEphem mass
    draws) at toa_shards 2 against its unsharded run."""
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("ipta_dr3").reduced(max_psr=16, max_toa=128)
    ref = scn.build(device="cpu", stat_path="einsum").run(16, seed=3,
                                                         chunk=8)
    sim = scn.build(mesh=make_mesh(CPU8, psr_shards=2, toa_shards=2),
                    stat_path="einsum")
    assert sim._shards[0][1].signals.cgw[0][2].shape == (
        8, sim.batch.max_toa // 2)
    out = sim.run(16, seed=3, chunk=8)
    np.testing.assert_allclose(out["curves"], ref["curves"], rtol=0,
                               atol=1e-4 * np.abs(ref["curves"]).max())
    np.testing.assert_allclose(out["autos"], ref["autos"], rtol=1e-4)
