"""Sampled CGW / BayesEphem signals in the PyTorch port's engine against
the JAX engine, on the CPU: the half of tests/test_torch_det_signals.py
that draws (its batch, cases, tolerances and ``jax_runs`` fixture).

- the ``CGWSampling`` and ``RoemerSampling`` draws: uniform draws bit for
  bit against the JAX draw chain, normal ones within the port's normals'
  bound (tests/test_torch_rng.py: 4 ULP of the unit normal), and the
  host's pulsar-term bulks replaying the device's draws;
- the sampled runs' statistics within ``rtol=1e-5, atol=1e-4 * scale``,
  the bound ``tests/test_roemer_sampling.py`` and
  ``tests/test_cgw_batch_sampling.py`` hold the JAX engine's sampled runs
  to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import constants as jconst
from fakepta_tpu.parallel import montecarlo as jmc
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.parallel import montecarlo as tmc
from fakepta_tpu_torch.utils import rng
from test_torch_det_signals import (CASES, LEAVES, NORMAL_ULP, NPSR, PDIST,
                                    R, SAMPLED, SAMPLED_CASES, SEED, TSPAN,
                                    _assert_stats, _port_sim)
from test_torch_det_signals import jax_runs  # noqa: F401 (the fixture)
from test_torch_engine import _psd
from test_torch_rng import _ulp_diff


def _jax_keys():
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(SEED), i))(
        np.arange(R))


def _jax_cgw_draws(cfg, j, ranges):
    """The JAX engine's CGW draw chain (``_sampled_cgw``), jitted."""
    mode = "dist" if cfg.log10_dist is not None else "h"
    names = ("costheta", "phi", "cosinc", "log10_mc", "log10_fgw",
             "log10_dist" if mode == "dist" else "log10_h", "phase0", "psi")
    norm = np.array([d == "normal" for d in jmc._resolve_dists(
        cfg.dist, names, "CGWSampling")])

    def draw(key):
        kz = jax.random.fold_in(jax.random.fold_in(key, 0xC6), j)
        u = jax.random.uniform(kz, (8,), jnp.float32)
        v = ranges[:, 0] + u * (ranges[:, 1] - ranges[:, 0])
        if norm.any():
            g = jax.random.normal(jax.random.fold_in(kz, 1), (8,),
                                  jnp.float32)
            v = jnp.where(jnp.asarray(norm), ranges[:, 0] + g * ranges[:, 1],
                          v)
        kpd = jax.random.fold_in(kz, 2)
        pd = jax.vmap(lambda gi: jax.random.normal(
            jax.random.fold_in(kpd, gi), (), jnp.float32))(jnp.arange(NPSR))
        return v, pd

    return [np.asarray(x) for x in jax.jit(jax.vmap(draw))(_jax_keys())]


@pytest.mark.parametrize("case", ["cgw_uniform", "cgw_normal_dist",
                                  "cgw_psrterm"])
def test_cgw_draws_bit_exact(case):
    sim = _port_sim(case)
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 0, R)
    cfgs = CASES[case]["cgw_sample"]
    cfgs = cfgs if isinstance(cfgs, list) else [cfgs]
    gidx = torch.arange(NPSR)
    for j, (cfg, (static, ranges, _)) in enumerate(
            zip(cfgs, sim._full.signals.cgw)):
        v, pd = tmc._cgw_draws(keys, ranges, static, j, gidx)
        want_v, want_pd = _jax_cgw_draws(cfg, j, jnp.asarray(
            ranges.numpy(), jnp.float32))
        normal = np.array([d == "normal" for d in static[2]])
        # uniform draws bit for bit; a normal draw within the port's
        # normals' bound (NORMAL_ULP of the unit normal, times its std)
        np.testing.assert_array_equal(v.numpy()[:, ~normal],
                                      want_v[:, ~normal])
        width = np.abs(ranges.numpy()[normal, 1])
        g = np.abs((want_v[:, normal] - ranges.numpy()[normal, 0]) / width)
        bound = NORMAL_ULP * np.spacing(g.astype(np.float32)) * width \
            + np.spacing(np.abs(want_v[:, normal]))
        assert np.all(np.abs(v.numpy()[:, normal] - want_v[:, normal])
                      <= bound)
        if cfg.sample_pdist:
            assert _ulp_diff(pd.numpy(), want_pd).max() <= NORMAL_ULP
        else:
            assert pd is None


def test_roemer_draws_bit_exact():
    sim = _port_sim("roemer_two")
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 0, R)
    for j, (_, scales, _) in enumerate(sim._full.signals.roemer):
        kz = rng.fold_in(rng.fold_in(keys, 0x77), j)
        got = (rng.normal(kz, 7) * scales).numpy()
        sc = jnp.asarray(scales.numpy())
        want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(k, 0x77), j), (7,),
            jnp.float32) * sc))(_jax_keys()))
        # zero scales give zeros; the rest within the normals' bound
        live = scales.numpy() != 0
        np.testing.assert_array_equal(got[:, ~live], 0.0)
        assert _ulp_diff(got[:, live], want[:, live]).max() <= NORMAL_ULP


def test_host_bulks_replay_the_device_draws():
    """The host's retarded-phase bulks are computed from the draws the
    device makes: bulk == psrterm_phase_bulk of those draws, per config."""
    from fakepta_tpu_torch.models.cgw import psrterm_phase_bulk
    sim = _port_sim("cgw_psrterm")
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 5, R)
    bulks = sim._host_cgw_bulks(keys)
    assert sim._cgw_psrterm == (0, 1) and len(bulks) == 2
    for j, bulk in enumerate(bulks):
        static, ranges, _ = sim._full.signals.cgw[j]
        v, pd = tmc._cgw_draws(keys, ranges, static, j, torch.arange(NPSR))
        v = v.double().numpy()
        pd = np.zeros((R, NPSR)) if pd is None else pd.double().numpy()
        st = np.sqrt(1 - v[:, :1] ** 2)
        pos = LEAVES["pos"].astype(np.float64)
        cosmu = (st * np.cos(v[:, 1:2]) * pos[:, 0] + st * np.sin(
            v[:, 1:2]) * pos[:, 1] + v[:, :1] * pos[:, 2])
        tau = (PDIST[:, 0] + PDIST[:, 1] * pd) * jconst.kpc / jconst.c \
            * (1 - cosmu)
        want = psrterm_phase_bulk(tau, v[:, 3:4], v[:, 4:5])
        assert bulk.shape == (R, NPSR) and bulk.dtype == torch.float32
        np.testing.assert_allclose(bulk.numpy(), want, rtol=1e-6)


def test_host_bulks_read_the_host_copy_of_the_ranges():
    """The bulks of chunk i + 1 are computed while the card runs chunk i:
    they read a host copy of each psrterm config's ranges, bit for bit the
    device copy, never the device copy (whose read would wait for the
    running chunk)."""
    sim = _port_sim("cgw_psrterm")
    assert sorted(sim._cgw_ranges_host) == list(sim._cgw_psrterm)
    for j, host in sim._cgw_ranges_host.items():
        dev = sim._full.signals.cgw[j][1]
        assert host.device.type == "cpu" and host.dtype == dev.dtype
        assert torch.equal(host, dev.cpu())
    keys = tmc._chunk_keys(rng.key(SEED, device="cpu"), 5, R)
    want = sim._host_cgw_bulks(keys)
    sim._full = dataclasses.replace(sim._full, signals=dataclasses.replace(
        sim._full.signals,
        cgw=tuple((st, None, t) for st, _, t in sim._full.signals.cgw)))
    got = sim._host_cgw_bulks(keys)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------ sampled statistics

@pytest.mark.parametrize("case", sorted(SAMPLED_CASES) + ["all"])
def test_sampled_signals_statistics_match_jax(jax_runs, case):
    _, want = jax_runs(case)
    sim = _port_sim(case, stat_path="einsum")
    got = sim.run(R, seed=SEED, chunk=R)
    _assert_stats(got, want, **SAMPLED)
    # the sampled terms are live: they move every realization
    base = tmc.EnsembleSimulator(
        PulsarBatch.from_numpy(LEAVES, device="cpu"), device="cpu",
        gwb=tmc.GWBConfig(psd=_psd(TSPAN))).run(R, seed=SEED, chunk=R)
    assert np.all(np.abs(got["autos"] / base["autos"] - 1) > 1e-4)


