"""Solar-system ephemeris: Keplerian planet orbits and BayesEphem-style Roemer delays.

Port of :mod:`fakepta_tpu.ephemeris`, a copy of its host numpy code (the
port imports nothing of the JAX package). Functional parity with the
reference's ``Ephemeris`` class (``ephemeris.py:6-144``): JPL approximate
orbital elements with per-Julian-century rates
(https://ssd.jpl.nasa.gov/planets/approx_pos.html), orbit propagation to
equatorial coordinates in light-seconds, solar-system-barycenter
bookkeeping, and perturbed-orbit Roemer delays projected on the pulsar
direction.

Differences from the reference:

- the per-TOA ``scipy.optimize.newton`` loop and the per-TOA Python rotation loop
  (``ephemeris.py:49-56, 86-89``) are replaced by the vectorized fixed-iteration
  solver in :mod:`fakepta_tpu_torch.ops.kepler` and batched rotation algebra;
- in-plane coordinates use the correct ``x = a (cos E - e)`` (the reference computes
  ``a cos(E - e)``, ``ephemeris.py:81``);
- ``roemer_delay`` is pure: the reference mutates the stored element lists in place
  so repeated calls permanently accumulate perturbations (``ephemeris.py:131-136``);
- ``get_planet_ssb`` fills the velocity slots with analytic two-body velocities
  (the reference returns uninitialized ``np.empty`` memory, ``ephemeris.py:99-101``).

Numerics: the BayesEphem delay is the *difference* between a perturbed and a
nominal orbit, a catastrophic cancellation at float32 (orbit ~ 500
light-seconds, delay ~ 1e-7 s). This module stays host numpy float64; the
engine's device path (:mod:`fakepta_tpu_torch.models.roemer`) takes the
nominal orbit from here and computes only the perturbation on the device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import constants as const
from .ops.kepler import kepler_newton_np

# JPL approximate planetary elements, valid 1800 AD - 2050 AD
# (https://ssd.jpl.nasa.gov/planets/approx_pos.html). Layout per planet:
#   mass [kg]; T = orbital period [days];
#   inc/Om/omega/l0 = [deg at J2000, deg per Julian century]
#   a = [AU, AU per century]; e = [-, per century]
# `omega` is the longitude of perihelion (varpi = Om + arg-periapsis), `l0` the
# mean longitude, matching the JPL table's columns.
_JPL_ELEMENTS = {
    "mercury": dict(mass=3.301e23, T=87.9691,
                    inc=[7.00497902, -0.00594749], Om=[48.33076593, -0.12534081],
                    omega=[77.45779628, 0.16047689], a=[0.38709927, 0.00000037],
                    e=[0.20563661, 0.00001906], l0=[252.25032350, 149472.67411175]),
    "venus": dict(mass=4.867e24, T=224.7,
                  inc=[3.39467605, -0.00078890], Om=[76.67984255, -0.27769418],
                  omega=[131.60246718, 0.00268329], a=[0.72333566, 0.00000390],
                  e=[0.00676399, -0.00004107], l0=[181.97909950, 58517.81538729]),
    "earth": dict(mass=5.972e24, T=365.25636,
                  inc=[-0.00001531, -0.01294668], Om=[0.0, 0.0],
                  omega=[102.93768193, 0.32327364], a=[1.00000261, 0.00000562],
                  e=[0.01673163, -0.00004392], l0=[100.46457166, 35999.37244981]),
    "mars": dict(mass=6.417e23, T=687.0,
                 inc=[1.84969142, -0.00813131], Om=[49.55953891, -0.29257343],
                 omega=[-23.94362959, 0.44441088], a=[1.52371034, 0.00001847],
                 e=[0.09336511, 0.00007882], l0=[-4.55343205, 19140.30268499]),
    "jupiter": dict(mass=1.899e27, T=4331.0,
                    inc=[1.30439695, -0.00183714], Om=[100.47390909, 0.20469106],
                    omega=[14.72847983, 0.21252668], a=[5.20288700, -0.00011607],
                    e=[0.04853590, -0.00013253], l0=[34.39644051, 3034.74612775]),
    "saturn": dict(mass=5.685e26, T=10747.0,
                   inc=[2.48599187, 0.00193609], Om=[113.66242448, -0.28867794],
                   omega=[92.59887831, -0.41897216], a=[9.53667594, -0.00125060],
                   e=[0.05550825, -0.00050991], l0=[49.95424423, 1222.49362201]),
    "uranus": dict(mass=8.683e25, T=30589.0,
                   inc=[0.77263783, -0.00242939], Om=[74.01692503, 0.04240589],
                   omega=[170.95427630, 0.40805281], a=[19.18916464, -0.00196176],
                   e=[0.04685740, -0.00004397], l0=[313.23810451, 428.48202785]),
    "neptune": dict(mass=1.024e26, T=59800.0,
                    inc=[1.77004347, 0.00035372], Om=[131.78422574, -0.00508664],
                    omega=[44.96476227, -0.32241464], a=[30.06992276, 0.00026291],
                    e=[0.00895439, 0.00005105], l0=[-55.12002969, 218.45945325]),
}

_ORDER = ["mercury", "venus", "earth", "mars", "jupiter", "saturn", "uranus", "neptune"]


def _rotate_orbital_to_equatorial(x, y, Om, argp, inc):
    """Batched orbital-plane -> ecliptic -> equatorial rotation.

    All angles in radians, arrays broadcastable to the TOA shape. ``argp`` is the
    argument of periapsis (varpi - Om). Replaces the reference's per-TOA 3x3 matmul
    loop (``ephemeris.py:86-89``) with closed-form component algebra.
    """
    cO, sO = np.cos(Om), np.sin(Om)
    cw, sw = np.cos(argp), np.sin(argp)
    ci, si = np.cos(inc), np.sin(inc)
    # ecliptic coordinates of the in-plane point (z_plane = 0)
    x_ec = x * (cO * cw - sO * ci * sw) + y * (-cO * sw - sO * ci * cw)
    y_ec = x * (sO * cw + cO * ci * sw) + y * (-sO * sw + cO * ci * cw)
    z_ec = x * (si * sw) + y * (si * cw)
    # tilt by the obliquity of the ecliptic
    ce, se = np.cos(const.OBLIQUITY), np.sin(const.OBLIQUITY)
    return np.stack([x_ec, ce * y_ec - se * z_ec, se * y_ec + ce * z_ec], axis=-1)


class Ephemeris:
    """Keplerian solar-system ephemeris with perturbable orbital elements."""

    def __init__(self):
        self.planets: Dict[str, dict] = {k: {p: (list(v) if isinstance(v, list) else v)
                                             for p, v in el.items()}
                                         for k, el in _JPL_ELEMENTS.items()}
        self.planet_names = list(self.planets)
        self.mass_ss = const.Msun + sum(p["mass"] for p in self.planets.values())

    # -- core orbit computation ------------------------------------------------

    @staticmethod
    def _propagate_elements(times, T, Om, omega, inc, a, e, l0):
        """Propagate ``[value, rate/century]`` elements to each TOA and solve Kepler.

        Returns ``(E, a_t, e_t, Om_t, varpi_t, inc_t)`` in radians / light-seconds.
        ``a=None`` derives the semi-major axis from the period via Kepler's third
        law (ref ``ephemeris.py:60-61``). Shared by position, velocity and
        perturbed-orbit paths so the propagation math exists exactly once.
        """
        times = np.asarray(times, dtype=np.float64)
        if a is None:
            a = [(const.GMsun * (T * const.day) ** 2 / (4 * np.pi**2)) ** (1 / 3)
                 / const.AU, 0.0]
        # Julian centuries since J2000 (MJD epoch offset 2400000.5 - 2451545)
        t = (times / const.day + 2400000.5 - 2451545.0) / 36525.0
        Om_t = np.deg2rad(Om[0] + Om[1] * t)
        varpi_t = np.deg2rad(omega[0] + omega[1] * t)
        inc_t = np.deg2rad(inc[0] + inc[1] * t)
        a_t = (a[0] + a[1] * t) * const.AU / const.c
        e_t = e[0] + e[1] * t
        l0_t = np.deg2rad(l0[0] + l0[1] * t)
        mean_anom = np.mod(l0_t - varpi_t, 2.0 * np.pi)
        E = kepler_newton_np(mean_anom, e_t)
        return E, a_t, e_t, Om_t, varpi_t, inc_t

    def do_rotation_op_to_eq(self, vec, Om, omega, inc):
        """Rotate an in-plane vector to the equatorial frame (ref
        ``ephemeris.py:34-47``).

        Reference-parity public API: angles in DEGREES, ``vec`` of shape
        ``(3,)`` or ``(3, N)`` with its z-component ignored (the reference's
        rotation matrix has a zero third column). Delegates to the same
        batched closed-form rotation ``compute_orbit`` uses.
        """
        vec = np.asarray(vec, dtype=np.float64)
        out = _rotate_orbital_to_equatorial(
            vec[0], vec[1], np.deg2rad(Om), np.deg2rad(omega),
            np.deg2rad(inc))
        return np.moveaxis(out, -1, 0)

    def solve_kepler_equation(self, M, e):
        """Eccentric anomalies with ``M = E - e sin E`` (ref
        ``ephemeris.py:49-56``).

        Reference-parity public API over the vectorized fixed-iteration
        Newton solver (the reference runs a sequential per-TOA
        ``scipy.optimize.newton`` loop).
        """
        return kepler_newton_np(M, e)

    def compute_orbit(self, times, T, Om, omega, inc, a, e, l0, mass=None):
        """Equatorial position [light-seconds] of a body at each TOA (n_toa, 3).

        ``times`` are MJD seconds (ref ``ephemeris.py:58-91``).
        """
        E, a_t, e_t, Om_t, varpi_t, inc_t = self._propagate_elements(
            times, T, Om, omega, inc, a, e, l0)
        x = a_t * (np.cos(E) - e_t)
        y = a_t * np.sqrt(1.0 - e_t**2) * np.sin(E)
        return _rotate_orbital_to_equatorial(x, y, Om_t, varpi_t - Om_t, inc_t)

    def _orbit_and_velocity(self, times, planet):
        """Position and analytic two-body velocity (both (n_toa, 3), light-sec units).

        Velocities use ``dE/dt = n / (1 - e cos E)`` with the mean motion from the
        orbital period; slow element rates are neglected (they contribute at the
        1e-6 relative level over decades).
        """
        el = self.planets[planet]
        E, a_t, e_t, Om_t, varpi_t, inc_t = self._propagate_elements(
            times, el["T"], el["Om"], el["omega"], el["inc"], el["a"], el["e"],
            el["l0"])
        pos = _rotate_orbital_to_equatorial(
            a_t * (np.cos(E) - e_t), a_t * np.sqrt(1.0 - e_t**2) * np.sin(E),
            Om_t, varpi_t - Om_t, inc_t)

        n_motion = 2.0 * np.pi / (el["T"] * const.day)          # rad/s
        E_dot = n_motion / (1.0 - e_t * np.cos(E))
        vx = -a_t * np.sin(E) * E_dot
        vy = a_t * np.sqrt(1.0 - e_t**2) * np.cos(E) * E_dot
        vel = _rotate_orbital_to_equatorial(vx, vy, Om_t, varpi_t - Om_t, inc_t)
        return pos, vel

    # -- public surface (parity with ref ephemeris.py:93-144) ------------------

    def get_orbit_planet(self, times, planet):
        el = self.planets[planet]
        return self.compute_orbit(times, el["T"], el["Om"], el["omega"], el["inc"],
                                  el["a"], el["e"], el["l0"])

    def get_planet_ssb(self, times):
        """(n_toa, 8, 6) ENTERPRISE planetssb block: positions AND velocities.

        The reference leaves the velocity slots as uninitialized memory
        (``ephemeris.py:99-101``); here they are the analytic two-body values.
        """
        times = np.asarray(times, dtype=np.float64)
        out = np.zeros((len(times), len(self.planet_names), 6))
        for i, planet in enumerate(self.planet_names):
            pos, vel = self._orbit_and_velocity(times, planet)
            out[:, i, :3] = pos
            out[:, i, 3:] = vel
        return out

    def get_sunssb(self, times):
        """Solar reflex motion: ``-sum_p (m_p/Msun) x_p`` (ref ``ephemeris.py:104-110``)."""
        times = np.asarray(times, dtype=np.float64)
        sunssb = np.zeros((len(times), 3))
        for planet in self.planets:
            sunssb -= (self.planets[planet]["mass"] / const.Msun
                       * self.get_orbit_planet(times, planet))
        return sunssb

    def add_planet(self, name, mass, T, inc, Om, omega, a, e, l0):
        """Register a custom body (ref ``ephemeris.py:112-116``).

        ``a=None`` is legal — the semi-major axis is then derived from the period
        by every orbit computation.
        """
        self.planets[name] = dict(mass=mass, T=T, inc=list(inc), Om=list(Om),
                                  omega=list(omega),
                                  a=(None if a is None else list(a)),
                                  e=list(e), l0=list(l0))
        self.planet_names = list(self.planets)
        self.mass_ss = const.Msun + sum(p["mass"] for p in self.planets.values())

    def roemer_delay(self, toas, psr_pos, planet, d_mass=0.0, d_Om=0.0, d_omega=0.0,
                     d_inc=0.0, d_a=0.0, d_e=0.0, d_l0=0.0):
        """BayesEphem-style Roemer-delay perturbation projected on the pulsar.

        ``delta_x_SSB = [(m + dm) orbit(alpha + dalpha) - m orbit(alpha)] / M_ss``
        dotted with the pulsar direction (ref ``ephemeris.py:118-144``). Pure: the
        stored elements are copied, never mutated (the reference's in-place ``+=``
        accumulates perturbations across calls — bug fixed).
        """
        el = self.planets[planet]
        pert = {key: list(el[key]) for key in ("Om", "omega", "inc", "a", "e", "l0")}
        pert["Om"][0] += d_Om
        pert["omega"][0] += d_omega
        pert["inc"][0] += d_inc
        pert["a"][0] += d_a
        pert["e"][0] += d_e
        pert["l0"][0] += d_l0

        perturbed = self.compute_orbit(toas, el["T"], pert["Om"], pert["omega"],
                                       pert["inc"], pert["a"], pert["e"], pert["l0"])
        nominal = self.get_orbit_planet(toas, planet)
        d_ssb = ((el["mass"] + d_mass) * perturbed - el["mass"] * nominal) / self.mass_ss
        return d_ssb @ np.asarray(psr_pos)
