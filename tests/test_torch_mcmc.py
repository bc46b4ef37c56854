"""The port's MCMC transition kernels (``fakepta_tpu_torch.ops.mcmc``) and
its float64 draws against the JAX package's, on the CPU.

Tolerances: at float64 the leapfrog integrator on the analytic Gaussian
target equals the JAX one to 1e-12 and is reversible to 1e-8 (the JAX
test's detailed-balance witness); the momenta of a transition are the
port's normals, within 4 ULP of ``jax.random.normal`` (3 seen) at float64
and float32; accept decisions, swap permutations and their application are
equal exactly; float64 ``uniform`` draws are bit-exact with
``jax.random.uniform`` under x64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.ops import mcmc as jmcmc
from fakepta_tpu_torch.ops import mcmc
from fakepta_tpu_torch.utils import rng

SCALES = np.array([1.0, 0.5, 2.0])


def _jax_vg(z):
    s2 = jnp.asarray(SCALES, z.dtype) ** 2
    lnl = -0.5 * jnp.sum(z * z / s2, axis=-1)
    zero = jnp.zeros_like(lnl)
    return (lnl, -z / s2, zero, jnp.zeros_like(z))


def _vg(z):
    s2 = torch.as_tensor(SCALES, dtype=z.dtype) ** 2
    lnl = -0.5 * mcmc.fixed_sum(z * z / s2)
    zero = torch.zeros_like(lnl)
    return (lnl, -z / s2, zero, torch.zeros_like(z))


def _keys_np(n, seed=7):
    """n keys folded from key(seed), as a jax key array and as int64
    words."""
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(n))
    words = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    return keys, torch.as_tensor(words)


def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want) / np.spacing(np.abs(want)))


def test_leapfrog_reversibility_and_energy_f64_against_jax():
    c, t, d = 5, 2, 3
    key = jax.random.key(7)
    z0 = np.array(jax.random.normal(jax.random.fold_in(key, 0), (c, t, d),
                                    jnp.float64))
    p0 = np.array(jax.random.normal(jax.random.fold_in(key, 1), (c, t, d),
                                    jnp.float64))
    jbetas = jmcmc.geometric_betas(t, 8.0, jnp.float64)
    jeps = 0.2 / jnp.sqrt(jbetas)[None, :, None]
    jz1, jp1, _ = jmcmc.leapfrog(_jax_vg, jnp.asarray(z0),
                                 _jax_vg(jnp.asarray(z0)), jnp.asarray(p0),
                                 jeps, 8, jbetas)

    betas = mcmc.geometric_betas(t, 8.0, torch.float64)
    np.testing.assert_array_equal(betas.numpy(), np.asarray(jbetas))
    eps = 0.2 / torch.sqrt(betas)[None, :, None]
    z0t, p0t = torch.as_tensor(z0), torch.as_tensor(p0)
    parts0 = _vg(z0t)
    z1, p1, parts1 = mcmc.leapfrog(_vg, z0t, parts0, p0t, eps, 8, betas)
    np.testing.assert_allclose(z1.numpy(), np.asarray(jz1), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p1.numpy(), np.asarray(jp1), rtol=0,
                               atol=1e-12)
    # time reversal: flip the momentum and integrate back
    z2, p2, _ = mcmc.leapfrog(_vg, z1, parts1, -p1, eps, 8, betas)
    np.testing.assert_allclose(z2.numpy(), z0, atol=1e-8)
    np.testing.assert_allclose(-p2.numpy(), p0, atol=1e-8)

    def ham(z, p, parts):
        lnp, _ = mcmc.tempered(parts, betas)
        return lnp - 0.5 * torch.sum(p * p, dim=-1)

    dh_f = ham(z1, p1, parts1) - ham(z0t, p0t, parts0)
    dh_r = ham(z2, p2, _vg(z2)) - ham(z1, -p1, parts1)
    np.testing.assert_allclose(dh_r.numpy(), -dh_f.numpy(), atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hmc_transition_against_jax(dtype):
    """One transition from the same state and keys: the momenta within 4
    ULP of the JAX draws, the positions and parts close, and the accept /
    divergence decisions equal."""
    c, t, d = 64, 2, 3
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkeys, words = _keys_np(c * t, seed=3)
    jkeys = jkeys.reshape(c, t)
    words = words.reshape(c, t, 2)
    z0 = np.array(jax.random.normal(jax.random.key(1), (c, t, d), jdt))
    jbetas = jmcmc.geometric_betas(t, 8.0, jdt)
    jeps = jnp.asarray([0.9, 1.4], jdt)
    jz, jparts, jacc, jdiv = jmcmc.hmc_transition(
        jkeys, jnp.asarray(z0), _jax_vg(jnp.asarray(z0)), _jax_vg, jbetas,
        jeps, 6)

    mom, lnu = mcmc.transition_draws(words, d, tdt)
    jmom = jax.vmap(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, 0), (d,), jdt)))(jkeys)
    assert _ulps(mom.numpy(), jmom) <= 4
    jlnu = jax.vmap(jax.vmap(lambda k: jnp.log(jax.random.uniform(
        jax.random.fold_in(k, 1), (), jdt))))(jkeys)
    assert _ulps(lnu.numpy(), jlnu) <= 4
    betas = mcmc.geometric_betas(t, 8.0, tdt)
    eps = torch.as_tensor(np.array(jeps))
    z0t = torch.as_tensor(z0)
    z, parts, acc, div = mcmc.hmc_transition(words, z0t, _vg(z0t), _vg,
                                             betas, eps, 6)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(div.numpy(), np.asarray(jdiv))
    assert 0 < acc.sum() < c * t          # both outcomes exercised
    tol = 1e-12 if dtype == "float64" else 2e-5
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=tol)
    np.testing.assert_allclose(parts[0].numpy(), np.asarray(jparts[0]),
                               rtol=tol)
    # the transition from pre-drawn momenta is the same transition
    z_b, _, acc_b, _ = mcmc.hmc_step(mom, lnu, z0t, _vg(z0t), _vg, betas,
                                     eps, 6)
    assert torch.equal(z_b, z) and torch.equal(acc_b, acc)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_swap_permutation_and_apply_exact(dtype):
    c, t = 64, 4
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkeys, words = _keys_np(c, seed=11)
    lnl = np.array(jax.random.normal(jax.random.key(999), (c, t),
                                     jdt)) * 5.0
    jbetas = jmcmc.geometric_betas(t, 8.0, jdt)
    betas = torch.as_tensor(np.array(jbetas))
    seen = set()
    for parity in (0, 1):
        want = np.asarray(jmcmc.swap_permutation(jkeys, jnp.asarray(lnl),
                                                 jbetas, parity))
        got = mcmc.swap_permutation(words, torch.as_tensor(lnl), betas,
                                    parity)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        for row in want:
            assert sorted(row.tolist()) == list(range(t))
            seen |= {(min(i, int(p)), max(i, int(p)))
                     for i, p in enumerate(row) if p != i}
        zz = np.broadcast_to(np.arange(t, dtype=np.float64)[None, :, None],
                             (c, t, 2)).copy()
        jz, jl = jmcmc.apply_permutation(jnp.asarray(want), jnp.asarray(zz),
                                         jnp.asarray(lnl))
        tz, tl = mcmc.apply_permutation(got, torch.as_tensor(zz),
                                        torch.as_tensor(lnl))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert seen == {(0, 1), (1, 2), (2, 3)}


@pytest.mark.parametrize("n,max_temp", [(1, 8.0), (2, 8.0), (4, 8.0),
                                        (6, 30.0)])
def test_geometric_betas(n, max_temp):
    b64 = mcmc.geometric_betas(n, max_temp, torch.float64).numpy()
    np.testing.assert_allclose(
        b64, np.asarray(jmcmc.geometric_betas(n, max_temp, jnp.float64)),
        rtol=1e-15)
    b32 = mcmc.geometric_betas(n, max_temp).numpy()
    assert b32.dtype == np.float32 and b32[0] == 1.0
    np.testing.assert_allclose(
        b32, np.asarray(jmcmc.geometric_betas(n, max_temp, jnp.float32)),
        rtol=2e-7)
    if n > 1:
        np.testing.assert_allclose(b64[-1], 1.0 / max_temp, rtol=1e-12)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2048,)])
def test_float64_uniform_bit_exact_with_jax(shape):
    jkeys, words = _keys_np(16, seed=5)
    want = jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float64))(
        jkeys)
    got = rng.uniform(words, shape, dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo_hi = jax.vmap(lambda k: jax.random.uniform(
        k, shape, jnp.float64, -3.0, 5.0))(jkeys)
    np.testing.assert_array_equal(
        rng.uniform(words, shape, -3.0, 5.0, dtype=torch.float64).numpy(),
        np.asarray(lo_hi))


@pytest.mark.parametrize("shape", [(7,), (4096,)])
def test_float64_normal_within_4_ulp_of_jax(shape):
    jkeys, words = _keys_np(16, seed=9)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, shape, jnp.float64))(jkeys))
    got = rng.normal(words, shape, dtype=torch.float64).numpy()
    assert _ulps(got, want) <= 4
    # a window of the draw is the longer draw sliced, bit for bit
    if shape[0] > 8:
        win = rng.normal(words, (8,), start=100, dtype=torch.float64)
        np.testing.assert_array_equal(win.numpy(), got[:, 100:108])


def test_float64_erfinv_and_log1p_against_xla():
    x = np.concatenate([np.random.default_rng(0).uniform(-1, 1, 20000),
                        1 - 10.0 ** -np.linspace(1, 15.5, 400),
                        -0.4138, 0.0, -1.0, 1.0], axis=None)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = rng.erfinv_f64(torch.as_tensor(x)).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert _ulps(got[finite], want[finite]) <= 4
    arg = -x[np.abs(x) < 1] ** 2
    assert _ulps(rng.log1p_xla64(torch.as_tensor(arg)).numpy(),
                 np.asarray(jnp.log1p(jnp.asarray(arg)))) <= 2


def test_fixed_sum_is_independent_of_the_other_axes():
    """The mesh-invariance helper: a row's sum is the same bits whatever
    the shape of the rest of the tensor, and equals the plain sum to
    roundoff."""
    x = torch.randn(16, 7, 9, dtype=torch.float32)
    full = mcmc.fixed_sum(x, dim=1)
    for lo, hi in ((0, 1), (3, 8), (5, 16)):
        assert torch.equal(mcmc.fixed_sum(x[lo:hi], dim=1), full[lo:hi])
    np.testing.assert_allclose(full.numpy(), x.sum(1).numpy(), rtol=1e-5,
                               atol=1e-5)
    m = torch.randn(9, 4)
    mv = mcmc.fixed_matvec(x, m)
    assert torch.equal(mcmc.fixed_matvec(x[2:3], m), mv[2:3])
    np.testing.assert_allclose(mv.numpy(), (x @ m).numpy(), rtol=1e-4,
                               atol=1e-4)
    assert mcmc.fixed_sum(torch.zeros(3, 0)).shape == (3,)
