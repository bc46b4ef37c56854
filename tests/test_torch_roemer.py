"""The PyTorch port's device ephemeris (``models/roemer.py``) against the
JAX package's, on the CPU.

- ``nominal_state``: every leaf equal to the JAX package's at float64 and
  float32 (both round the same host float64 propagation once);
- ``roemer_delay_dev`` at float64 to 1e-12 relative of the JAX function and
  to the host float64 perturbed-minus-nominal delay at the JAX package's
  own bound (``tests/test_roemer_dev.py``: 1e-9); at float32 within
  1e-4 of the host delay's scale, the bound ``tests/test_roemer_dev.py``
  holds the JAX kernel to;
- ``orbit_positions_dev`` at float64 (1e-12) and float32 (3e-6 of scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import constants as jconst
from fakepta_tpu.ephemeris import Ephemeris as JEphemeris
from fakepta_tpu.models import roemer as jroe
from fakepta_tpu_torch.ephemeris import Ephemeris
from fakepta_tpu_torch.models import roemer as troe

MJD0_S = 53000.0 * 86400.0
TOAS = MJD0_S + np.linspace(0.0, 15 * jconst.yr, 300)
POS = np.array([0.3, -0.5, np.sqrt(1 - 0.09 - 0.25)])
DELTAS = dict(d_mass=1.2e-4 * 1.899e27, d_Om=3e-4, d_omega=-2e-4,
              d_inc=1e-4, d_a=4e-8, d_e=3e-7, d_l0=-5e-4)
DTYPES = {"f64": (torch.float64, jnp.float64),
          "f32": (torch.float32, jnp.float32)}


def _state(planet, toas, prec):
    return troe.nominal_state(Ephemeris(), planet, toas,
                              dtype=DTYPES[prec][0], device="cpu")


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("planet", ("jupiter", "earth"))
def test_nominal_state_leaves_match_jax(planet, prec):
    toas = np.stack([TOAS[:100], TOAS[100:200]])
    got = _state(planet, toas, prec)
    want = jroe.nominal_state(JEphemeris(), planet, toas,
                              dtype=DTYPES[prec][1])
    for name in got.__dataclass_fields__:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == DTYPES[prec][0], name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_orbit_state_rows_and_to():
    toas = np.stack([TOAS[:50] + k * 1e6 for k in range(4)])
    st = _state("saturn", toas, "f32")
    sub = st.rows(1, 2)
    assert sub.sinE.shape == (2, 50) and sub.pos.shape == (2, 50, 3)
    assert torch.equal(sub.pos, st.pos[1:3]) and sub.mass is st.mass
    moved = sub.to("cpu")
    assert torch.equal(moved.x, sub.x)


@pytest.mark.parametrize("planet", ("jupiter", "saturn"))
def test_roemer_delay_dev_f64_matches_jax_and_host(planet):
    st = _state(planet, TOAS, "f64")
    got = troe.roemer_delay_dev(st, torch.tensor(POS), **DELTAS).numpy()
    jst = jroe.nominal_state(JEphemeris(), planet, TOAS, dtype=jnp.float64)
    want = np.asarray(jroe.roemer_delay_dev(jst, POS, **DELTAS))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    host = Ephemeris().roemer_delay(TOAS, POS, planet, **DELTAS)
    assert np.abs(host).max() > 1e-9
    np.testing.assert_allclose(got, host, rtol=1e-9,
                               atol=1e-9 * np.abs(host).max())


def test_roemer_delay_dev_is_float32_stable():
    host = Ephemeris().roemer_delay(TOAS, POS, "jupiter", **DELTAS)
    scale = np.abs(host).max()
    got = troe.roemer_delay_dev(_state("jupiter", TOAS, "f32"),
                                torch.tensor(POS, dtype=torch.float32),
                                **DELTAS).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - host).max() < 1e-4 * scale
    jst = jroe.nominal_state(JEphemeris(), "jupiter", TOAS,
                             dtype=jnp.float32)
    want = np.asarray(jax.jit(jroe.roemer_delay_dev)(
        jst, jnp.asarray(POS, jnp.float32), **DELTAS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_per_realization_perturbations_broadcast():
    """(R, 1, 1) perturbations against a (P, T) state and (P, 3)
    positions give (R, P, T), each slice the scalar call's delay."""
    toas = MJD0_S + np.stack([np.linspace(0, 10 * jconst.yr, 60),
                              np.linspace(0, 14 * jconst.yr, 60)])
    pos = torch.tensor([[0.0, 0.6, 0.8], [1.0, 0.0, 0.0]],
                       dtype=torch.float64)
    st = _state("saturn", toas, "f64")
    scale = torch.tensor([0.0, 1.0, -2.0], dtype=torch.float64)
    kw = {k: scale.reshape(3, 1, 1) * v for k, v in DELTAS.items()}
    got = troe.roemer_delay_dev(st, pos, **kw)
    assert got.shape == (3, 2, 60)
    for r in range(3):
        one = troe.roemer_delay_dev(
            st, pos, **{k: float(scale[r]) * v for k, v in DELTAS.items()})
        np.testing.assert_allclose(got[r].numpy(), one.numpy(), rtol=1e-14,
                                   atol=1e-22)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)


@pytest.mark.parametrize("prec", sorted(DTYPES))
def test_mass_only_shortcut_equals_the_difference_form(prec):
    """A mass-only perturbation skips the orbit deltas; the full
    difference form with zero orbit perturbations gives the same values
    bit for bit."""
    dt = DTYPES[prec][0]
    st = _state("jupiter", np.stack([TOAS, TOAS + 3e6]), prec)
    pos = torch.tensor(np.stack([POS, POS[::-1]]), dtype=dt)
    d_mass = torch.tensor([1.5e23, -4e22, 0.0], dtype=dt).reshape(3, 1, 1)
    zeros = {k: torch.zeros((), dtype=dt) for k in DELTAS if k != "d_mass"}
    short = troe.roemer_delay_dev(st, pos, d_mass=d_mass)
    full = troe.roemer_delay_dev(st, pos, d_mass=d_mass, **zeros)
    np.testing.assert_array_equal(short.numpy(), full.numpy())
    assert np.abs(short.numpy()[0]).max() > 0


def test_zero_perturbation_is_exactly_zero():
    got = troe.roemer_delay_dev(_state("earth", TOAS[:50], "f32"),
                                torch.tensor([0.0, 0.0, 1.0]))
    np.testing.assert_array_equal(got.numpy(), 0.0)


def _host_elements(planet, toas):
    ephem = Ephemeris()
    el = ephem.planets[planet]
    E, a_t, e_t, Om_t, varpi_t, inc_t = ephem._propagate_elements(
        toas, el["T"], el["Om"], el["omega"], el["inc"], el["a"], el["e"],
        el["l0"])
    argp_t = varpi_t - Om_t
    return dict(M=E - e_t * np.sin(E), e=e_t, a=a_t, sin_Om=np.sin(Om_t),
                cos_Om=np.cos(Om_t), sin_argp=np.sin(argp_t),
                cos_argp=np.cos(argp_t), sin_inc=np.sin(inc_t),
                cos_inc=np.cos(inc_t))


def test_orbit_positions_dev_f64_matches_jax_and_host():
    el = _host_elements("jupiter", TOAS)
    got = troe.orbit_positions_dev(
        **{k: torch.tensor(v) for k, v in el.items()}).numpy()
    want = np.asarray(jroe.orbit_positions_dev(
        **{k: jnp.asarray(v) for k, v in el.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(got, Ephemeris().get_orbit_planet(
        TOAS, "jupiter"), rtol=1e-12, atol=1e-9)


def test_orbit_positions_dev_f32_batched_planets():
    planets = ["earth", "mars", "jupiter", "saturn"]
    els = [_host_elements(p, TOAS) for p in planets]
    got = troe.orbit_positions_dev(**{
        k: torch.tensor(np.stack([e[k] for e in els]), dtype=torch.float32)
        for k in els[0]}).numpy()
    for i, p in enumerate(planets):
        want = Ephemeris().get_orbit_planet(TOAS, p)
        np.testing.assert_allclose(got[i], want,
                                   atol=3e-6 * np.abs(want).max(), err_msg=p)
