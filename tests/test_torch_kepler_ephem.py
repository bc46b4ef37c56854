"""The PyTorch port's Kepler solvers and host ephemeris against the JAX
package's, on the CPU.

The numpy code paths (``kepler_newton_np``, ``Ephemeris``) are copies and
must agree to 1e-13 relative (they agree bit for bit today); the torch
solvers run at float64 against the jnp ones to 1e-13, and at float32 within
a few float32 ULP of the float64 answer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import constants as jconst
from fakepta_tpu import ephemeris as jeph
from fakepta_tpu.ops import kepler as jkep
from fakepta_tpu_torch import ephemeris as teph
from fakepta_tpu_torch.ops import kepler as tkep

MJD0_S = 53000.0 * 86400.0
TOAS = MJD0_S + np.linspace(0.0, 15 * jconst.yr, 300)
PLANETS = ("mercury", "venus", "earth", "mars", "jupiter", "saturn",
           "uranus", "neptune")
DELTAS = dict(d_mass=1.2e-4 * 1.899e27, d_Om=3e-4, d_omega=-2e-4,
              d_inc=1e-4, d_a=4e-8, d_e=3e-7, d_l0=-5e-4)
RTOL = 1e-13


def _anomalies(n=500, seed=4):
    r = np.random.default_rng(seed)
    return r.uniform(0.0, 2 * np.pi, n), r.uniform(0.0, 0.25, n)


def test_kepler_newton_np_matches_jax():
    M, e = _anomalies()
    for iters in (3, 10):
        np.testing.assert_allclose(tkep.kepler_newton_np(M, e, iters),
                                   jkep.kepler_newton_np(M, e, iters),
                                   rtol=RTOL, atol=0)
    E = tkep.kepler_newton_np(M, e)
    np.testing.assert_allclose(E - e * np.sin(E), M, rtol=0, atol=1e-12)


def test_kepler_newton_torch_matches_jax():
    M, e = _anomalies()
    got = tkep.kepler_newton(torch.tensor(M), torch.tensor(e)).numpy()
    want = np.asarray(jkep.kepler_newton(jnp.asarray(M), jnp.asarray(e)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)
    # float32: within a few float32 ULP of the float64 solution
    got32 = tkep.kepler_newton(torch.tensor(M, dtype=torch.float32),
                               torch.tensor(e, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got32, want, rtol=0, atol=8 * 2.0 ** -23 *
                               2 * np.pi)


def test_delta_trig_and_kepler_delta_match_jax():
    M, e = _anomalies()
    E = tkep.kepler_newton_np(M, e)
    r = np.random.default_rng(9)
    d = r.normal(0.0, 1e-3, M.shape)
    d_M, d_e = r.normal(0.0, 1e-4, M.shape), r.normal(0.0, 1e-6, M.shape)
    s, c = np.sin(E), np.cos(E)
    got = tkep.delta_trig(torch.tensor(s), torch.tensor(c), torch.tensor(d))
    want = jkep.delta_trig(jnp.asarray(s), jnp.asarray(c), jnp.asarray(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-18)
    got = tkep.kepler_delta_newton(torch.tensor(s), torch.tensor(c),
                                   torch.tensor(e), torch.tensor(d_M),
                                   torch.tensor(d_e)).numpy()
    want = np.asarray(jkep.kepler_delta_newton(s, c, e, d_M, d_e))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-20)
    # the difference form solves the perturbed equation
    Ep = E + got
    np.testing.assert_allclose(Ep - (e + d_e) * np.sin(Ep), M + d_M,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("planet", PLANETS)
def test_planet_orbits_match_jax(planet):
    te, je = teph.Ephemeris(), jeph.Ephemeris()
    np.testing.assert_allclose(te.get_orbit_planet(TOAS, planet),
                               je.get_orbit_planet(TOAS, planet), rtol=RTOL,
                               atol=0)
    el = te.planets[planet]
    np.testing.assert_allclose(
        te.compute_orbit(TOAS, el["T"], el["Om"], el["omega"], el["inc"],
                         None, el["e"], el["l0"]),
        je.compute_orbit(TOAS, el["T"], el["Om"], el["omega"], el["inc"],
                         None, el["e"], el["l0"]), rtol=RTOL, atol=0)


def test_ssb_blocks_and_surface_match_jax():
    te, je = teph.Ephemeris(), jeph.Ephemeris()
    assert te.planet_names == je.planet_names
    assert te.mass_ss == je.mass_ss
    np.testing.assert_allclose(te.get_planet_ssb(TOAS[:80]),
                               je.get_planet_ssb(TOAS[:80]), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(te.get_sunssb(TOAS), je.get_sunssb(TOAS),
                               rtol=RTOL, atol=0)
    vec = np.array([[1.0, 0.3], [0.2, -0.5], [0.0, 0.0]])
    np.testing.assert_allclose(te.do_rotation_op_to_eq(vec, 40.0, 20.0, 5.0),
                               je.do_rotation_op_to_eq(vec, 40.0, 20.0, 5.0),
                               rtol=RTOL, atol=1e-16)
    M, e = _anomalies(50)
    np.testing.assert_allclose(te.solve_kepler_equation(M, e),
                               je.solve_kepler_equation(M, e), rtol=RTOL)
    # a custom body with its semi-major axis from the period
    for eph in (te, je):
        eph.add_planet("x", 1e25, 900.0, [2.0, 0.0], [30.0, 0.0],
                       [60.0, 0.0], None, [0.05, 0.0], [10.0, 100.0])
    assert te.mass_ss == je.mass_ss
    np.testing.assert_allclose(te.get_orbit_planet(TOAS, "x"),
                               je.get_orbit_planet(TOAS, "x"), rtol=RTOL)


@pytest.mark.parametrize("planet", ("jupiter", "saturn", "earth"))
def test_roemer_delay_matches_jax(planet):
    te, je = teph.Ephemeris(), jeph.Ephemeris()
    pos = np.array([0.3, -0.5, np.sqrt(1 - 0.09 - 0.25)])
    got = te.roemer_delay(TOAS, pos, planet, **DELTAS)
    want = je.roemer_delay(TOAS, pos, planet, **DELTAS)
    assert np.abs(want).max() > 1e-9
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # pure: a second call gives the same delay
    np.testing.assert_array_equal(te.roemer_delay(TOAS, pos, planet,
                                                  **DELTAS), got)
