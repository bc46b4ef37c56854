"""The PyTorch port's ensemble engine against the JAX engine, on the CPU.

Same batch, same seed: the port's draws equal the JAX engine's to a few
float32 ULP (tests/test_torch_rng.py), so every statistic path must land
on the JAX XLA path's curves within 1e-5 of the curve scale at f32 (autos
within 1e-5 relative) and within 1e-2 under bf16 operand rounding, the
bounds tests/test_megakernel.py and tests/test_montecarlo.py hold the JAX
paths to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel.mesh import make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)

KW = dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=4, n_dm=4,
          seed=1)
TOL = {"f32": 1e-5, "bf16": 1e-2}
PATHS = ("einsum", "fused", "mega")


def _psd(batch_tspan, ncomp=4, log10_A=-13.5):
    f = np.arange(1, ncomp + 1) / batch_tspan
    return np.asarray(jspec.powerlaw(f, log10_A=log10_A, gamma=13 / 3))


def _jax_sim(jb, **kw):
    return JaxSim(jb, gwb=JaxGWB(psd=_psd(float(jb.tspan_common)),
                                 orf="hd"),
                  mesh=make_mesh(jax.devices()[:1]), **kw)


def _port_sim(tb, **kw):
    return EnsembleSimulator(tb, gwb=GWBConfig(
        psd=_psd(float(tb.tspan_common)), orf="hd"), device="cpu", **kw)


def _assert_stats(got, want, prec):
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                               atol=TOL[prec] * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=TOL[prec])


@pytest.fixture(scope="module")
def batches():
    return JaxBatch.synthetic(**KW), PulsarBatch.synthetic(**KW,
                                                           device="cpu")


@pytest.fixture(scope="module")
def noisy(batches):
    """The small batch with every stage on (ECORR, chromatic and system
    noise besides white, red, DM and the GWB), built in both packages from
    the same numpy leaves; the JAX runs below all use it, so each JAX
    program compiles once."""
    leaves = _noisy_leaves(batches[0])
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            PulsarBatch.from_numpy(leaves, device="cpu"))


@pytest.fixture(scope="module")
def jax_xla(noisy):
    """The JAX XLA path (keep_corr=True also returns curves and autos)."""
    return _jax_sim(noisy[0]).run(8, seed=3, chunk=8, keep_corr=True)


@pytest.fixture(scope="module")
def jax_fused(noisy):
    sim = _jax_sim(noisy[0], use_pallas=True)
    return {prec: sim.run(8, seed=3, chunk=8, precision=prec)
            for prec in ("f32", "bf16")}


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("path", PATHS)
def test_paths_match_jax_xla(noisy, jax_xla, path, prec):
    out = _port_sim(noisy[1], stat_path=path).run(8, seed=3, chunk=8,
                                                    precision=prec)
    assert out["statistic_path"] == path and out["precision"] == prec
    assert out["curves"].shape == (8, 15) and out["autos"].shape == (8,)
    np.testing.assert_allclose(out["bin_centers"], jax_xla["bin_centers"])
    _assert_stats(out, jax_xla, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_fused_matches_jax_fused(noisy, jax_fused, prec):
    out = _port_sim(noisy[1], pallas_precision=prec).run(8, seed=3,
                                                           chunk=8)
    assert out["statistic_path"] == "fused" and out["precision"] == prec
    _assert_stats(out, jax_fused[prec], prec)


def test_keep_corr_matches_jax(noisy, jax_xla):
    out = _port_sim(noisy[1], stat_path="mega").run(8, seed=3, chunk=8,
                                                      keep_corr=True)
    assert out["statistic_path"] == "einsum"
    want = jax_xla["corr"]
    assert out["corr"].shape == want.shape == (8, 8, 8)
    np.testing.assert_allclose(out["corr"], want, rtol=0,
                               atol=TOL["f32"] * np.abs(want).max())
    _assert_stats(out, jax_xla, "f32")


@pytest.mark.parametrize("path", PATHS)
def test_rerun_bit_identical_and_chunk_invariant(batches, path):
    sim = _port_sim(batches[1], stat_path=path, pallas_precision="f32")
    a = sim.run(8, seed=3, chunk=8)
    b = sim.run(8, seed=3, chunk=8)
    c = sim.run(8, seed=3, chunk=4)
    d = sim.run(6, seed=3, chunk=4)          # a ragged, truncated tail
    for key in ("curves", "autos"):
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], c[key])
        np.testing.assert_array_equal(a[key][:6], d[key])
    other = sim.run(8, seed=4, chunk=8)
    assert not np.array_equal(a["curves"], other["curves"])


def _noisy_leaves(jb):
    """The small batch with ECORR epochs, chromatic noise and two system
    bands switched on, as numpy leaves both packages load."""
    leaves = {f.name: np.array(getattr(jb, f.name))
              for f in dataclasses.fields(jb)}
    p, t = leaves["t_own"].shape
    tspan = float(jb.tspan_common)
    leaves["epoch_idx"] = np.tile(np.arange(t, dtype=np.int32) // 2, (p, 1))
    leaves["ecorr_amp"] = np.full((p, t), 3e-7, np.float32)
    leaves["freqs"] = np.tile(np.where(np.arange(t) % 3 == 0, 800.0,
                                       1400.0), (p, 1)).astype(np.float32)
    f_ch = np.arange(1, 4) / tspan
    leaves["chrom_psd"] = np.tile(np.asarray(jspec.powerlaw(
        f_ch, log10_A=-14.0, gamma=3.0)), (p, 1)).astype(np.float32)
    sys_mask = np.zeros((p, 2, t), bool)
    sys_mask[:, 0, : t // 2] = True
    sys_mask[:, 1, t // 2:] = True
    leaves["sys_mask"] = sys_mask
    f_sys = np.arange(1, 4) / tspan
    band = np.asarray(jspec.powerlaw(f_sys, log10_A=-14.5, gamma=2.5))
    leaves["sys_psd"] = np.stack([band, 0.5 * band])[None].repeat(
        p, 0).astype(np.float32)
    return leaves


def test_ecorr_chrom_sys_stages_match_jax(batches, noisy, jax_xla):
    plain = _port_sim(batches[1], stat_path="einsum")
    assert plain.include.count(True) == 4       # white, red, dm, gwb
    quiet = plain.run(8, seed=3, chunk=8)
    for path in PATHS:
        sim = _port_sim(noisy[1], stat_path=path)
        assert sim.include == (True,) * 7
        out = sim.run(8, seed=3, chunk=8, precision="f32")
        _assert_stats(out, jax_xla, "f32")
        # the three extra stages move every realization's auto trace
        assert np.all(np.abs(out["autos"] / quiet["autos"] - 1) > 1e-3)


def test_constructor_validates():
    tb = PulsarBatch.synthetic(**KW, device="cpu")
    with pytest.raises(ValueError):
        _port_sim(tb, stat_path="xla")
    with pytest.raises(ValueError):
        _port_sim(tb, pallas_precision="f16")
    with pytest.raises(ValueError):
        _port_sim(tb, include=("white", "roemer"))
    with pytest.raises(ValueError, match="h_map"):
        EnsembleSimulator(tb, gwb=GWBConfig(psd=np.ones(4),
                                            orf="anisotropic"), device="cpu")
    # a deterministic signal needs the absolute epochs, as in the JAX engine
    with pytest.raises(ValueError, match="toas_abs"):
        EnsembleSimulator(tb, cgw=object(), device="cpu")
    sim = _port_sim(tb)
    assert sim.stat_path == "fused"
    # the CUDA kernels take contiguous operands only; the CPU path does not
    # check, so the engine's static operands are checked here
    stages, times, scales = sim._mega_tables
    for x in (sim._stat_weights, times, scales):
        assert x.is_contiguous() and x.dtype == torch.float32
    assert sim._stat_weights.shape == (16, 8, 8)
    with pytest.raises(ValueError):
        sim.run(8, seed=3, precision="f16")
    with pytest.raises(ValueError):
        sim.run(0, seed=3)
