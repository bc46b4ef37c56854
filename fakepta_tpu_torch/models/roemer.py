"""Device-side solar-system ephemeris: batched orbits and BayesEphem deltas
(port of fakepta_tpu.models.roemer).

The host :class:`fakepta_tpu_torch.ephemeris.Ephemeris` computes Roemer-delay
perturbations as the float64 difference of a perturbed and a nominal orbit
(reference ``ephemeris.py:118-144``): a ~1e-7 s difference of ~1e3
light-second positions, hopeless in float32. This module runs the same
physics in float32 on the device by never forming that difference:

- the **nominal** orbit state (eccentric anomaly, elements, in-plane
  coordinates, rotation trig, equatorial position) is propagated once on
  the host in float64 and stored on the device as an :class:`OrbitState`;
- the **perturbation response** is computed on the device in difference
  form only: ``dE`` from :func:`..ops.kepler.kepler_delta_newton` (Newton on
  the *difference* of the Kepler equations), trig differences through
  ``2 sin(d/2) cos(mid)`` identities, rotation deltas per axis. Every
  intermediate is O(perturbation), so float32 round-off enters only
  multiplicatively.

Perturbations broadcast against the state's TOA shape: a (P, T) state and
(R, 1, 1) draws give (R, P, T) delays, one per realization.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as const
from ..device import DeviceLike, resolve_device
from ..ops.kepler import delta_trig as _delta_trig
from ..ops.kepler import kepler_delta_newton, kepler_newton


@dataclasses.dataclass(frozen=True)
class OrbitState:
    """Nominal orbit of one body, propagated on the host in f64, stored on
    the device at the batch dtype.

    All per-TOA leaves share the TOA shape ``(..., T)``; ``pos`` appends the
    coordinate axis. Angles are stored as sine/cosine pairs so the device
    never evaluates trig of a large or precision-critical angle.
    """

    sinE: torch.Tensor       # (..., T) eccentric anomaly
    cosE: torch.Tensor
    e: torch.Tensor          # (..., T) eccentricity (element rates make it per-TOA)
    a: torch.Tensor          # (..., T) semi-major axis [light-s]
    b: torch.Tensor          # (..., T) sqrt(1 - e^2)
    x: torch.Tensor          # (..., T) in-plane coordinates [light-s]
    y: torch.Tensor
    sin_argp: torch.Tensor   # (..., T) argument of periapsis (varpi - Om)
    cos_argp: torch.Tensor
    sin_inc: torch.Tensor
    cos_inc: torch.Tensor
    sin_Om: torch.Tensor
    cos_Om: torch.Tensor
    pos: torch.Tensor        # (..., T, 3) nominal equatorial position [light-s]
    mass: torch.Tensor       # () body mass [kg]
    mass_ss: torch.Tensor    # () total solar-system mass [kg]

    def rows(self, lo: int, n: int) -> "OrbitState":
        """Rows ``lo .. lo + n - 1`` of every per-TOA leaf (a psr shard's
        pulsars of a (P, T) state); the masses stay whole."""
        return OrbitState(**{
            f.name: (getattr(self, f.name) if f.name in ("mass", "mass_ss")
                     else getattr(self, f.name).narrow(0, lo, n).contiguous())
            for f in dataclasses.fields(self)})

    def toas(self, lo: int, n: int) -> "OrbitState":
        """TOAs ``lo .. lo + n - 1`` of every per-TOA leaf of a (P, T)
        state (a toa shard's window); the masses stay whole."""
        return OrbitState(**{
            f.name: (getattr(self, f.name) if f.name in ("mass", "mass_ss")
                     else getattr(self, f.name).narrow(1, lo, n).contiguous())
            for f in dataclasses.fields(self)})

    def to(self, device: DeviceLike) -> "OrbitState":
        """The same state on another device."""
        dev = resolve_device(device)
        return OrbitState(**{f.name: getattr(self, f.name).to(dev)
                             for f in dataclasses.fields(self)})


def nominal_state(ephem, planet: str, toas, dtype=torch.float32,
                  device: DeviceLike = None) -> OrbitState:
    """Propagate the nominal orbit on the host in float64 and store it on
    ``device`` (default ``"cuda"``) at ``dtype``.

    ``ephem``: a host :class:`fakepta_tpu_torch.ephemeris.Ephemeris`;
    ``toas`` MJD seconds of any shape (e.g. ``(T,)`` or padded ``(P, T)``).
    """
    dev = resolve_device(device)
    el = ephem.planets[planet]
    toas64 = np.asarray(toas, dtype=np.float64)
    E, a_t, e_t, Om_t, varpi_t, inc_t = ephem._propagate_elements(
        toas64, el["T"], el["Om"], el["omega"], el["inc"], el["a"], el["e"],
        el["l0"])
    argp_t = varpi_t - Om_t
    b_t = np.sqrt(1.0 - e_t**2)
    x = a_t * (np.cos(E) - e_t)
    y = a_t * b_t * np.sin(E)
    pos = ephem.get_orbit_planet(toas64, planet)

    def put(arr):
        return torch.from_numpy(np.array(arr, dtype=np.float64)).to(
            dtype).to(dev)

    def leaf(arr):
        return put(np.broadcast_to(arr, np.shape(E)))

    return OrbitState(
        sinE=leaf(np.sin(E)), cosE=leaf(np.cos(E)), e=leaf(e_t), a=leaf(a_t),
        b=leaf(b_t), x=leaf(x), y=leaf(y),
        sin_argp=leaf(np.sin(argp_t)), cos_argp=leaf(np.cos(argp_t)),
        sin_inc=leaf(np.sin(inc_t)), cos_inc=leaf(np.cos(inc_t)),
        sin_Om=leaf(np.sin(Om_t)), cos_Om=leaf(np.cos(Om_t)),
        pos=put(pos), mass=put(np.float64(el["mass"])),
        mass_ss=put(np.float64(ephem.mass_ss)))


def _is_zero(v) -> bool:
    """A perturbation given as the plain number 0 (not a tensor)."""
    return not isinstance(v, torch.Tensor) and float(v) == 0.0


def roemer_delay_dev(state: OrbitState, psr_pos, d_mass=0.0, d_Om=0.0,
                     d_omega=0.0, d_inc=0.0, d_a=0.0, d_e=0.0, d_l0=0.0):
    """BayesEphem Roemer delay [s] on the state's device, float32-stable.

    Same parameterization and units as the host
    :meth:`fakepta_tpu_torch.ephemeris.Ephemeris.roemer_delay` (angles in
    degrees, ``d_a`` in AU, ``d_mass`` in kg): the SSB shift is
    ``[(m + dm) r' - m r] / M_ss`` projected on the pulsar direction,
    computed as ``[m (r' - r) + dm r'] / M_ss`` with ``r' - r`` assembled
    from difference identities only. Perturbations are numbers or tensors
    broadcastable to the TOA shape: (R, 1, 1) draws against a (P, T) state
    give (R, P, T), one delay per realization.

    ``psr_pos``: ``(..., 3)`` unit vectors broadcasting against the state's
    leading axes (e.g. ``(P, 3)`` with a ``(P, T)`` state).

    Where every orbit perturbation is the number 0 (a mass-only draw, as
    BayesEphem's usual Jupiter-mass nuisance), ``r' - r`` is exactly zero
    and only the mass term is evaluated: the same values as the full
    difference form, whose O(perturbation) terms are then all signed zeros.
    """
    dtype, dev = state.x.dtype, state.x.device

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    psr_pos = t(psr_pos)
    if all(_is_zero(v) for v in (d_Om, d_omega, d_inc, d_a, d_e, d_l0)):
        d_r = None
    else:
        d_r = _orbit_delta(state, t, d_Om, d_omega, d_inc, d_a, d_e, d_l0)
    d_mass = t(d_mass)
    out = None
    for i in range(3):
        pos_i = state.pos[..., i]
        if d_r is None:
            d_ssb = d_mass * pos_i / state.mass_ss
        else:
            d_ssb = (state.mass * d_r[i] + d_mass * (pos_i + d_r[i])) \
                / state.mass_ss
        term = d_ssb * psr_pos[..., i:i + 1]
        out = term if out is None else out + term
    return out


def _orbit_delta(state: OrbitState, t, d_Om, d_omega, d_inc, d_a, d_e,
                 d_l0):
    """``r' - r`` per equatorial axis, in difference form only."""
    dtype = state.x.dtype
    deg = t(np.deg2rad(1.0))
    d_M = (t(d_l0) - t(d_omega)) * deg
    d_varpi = t(d_omega) * deg
    d_Om_r = t(d_Om) * deg
    d_argp = d_varpi - d_Om_r
    d_inc_r = t(d_inc) * deg
    d_a_ls = t(d_a) * (const.AU / const.c)
    d_e = t(d_e)

    e, a, b = state.e, state.a, state.b
    dE = kepler_delta_newton(state.sinE, state.cosE, e, d_M, d_e)
    d_sinE, d_cosE = _delta_trig(state.sinE, state.cosE, dE)

    e_p = e + d_e
    a_p = a + d_a_ls
    # b' - b = (e^2 - e'^2)/(b + b')
    d_b = -(d_e * (e + e_p)) / (b + torch.sqrt(torch.clamp(1.0 - e_p**2,
                                                           min=0.0)))
    b_p = b + d_b

    # in-plane deltas (x = a (cos E - e), y = a b sin E)
    d_x = a_p * (d_cosE - d_e) + d_a_ls * (state.cosE - e)
    d_y = a_p * b_p * d_sinE + (a_p * d_b + d_a_ls * b) * state.sinE

    # stage 1: in-plane rotation by argp
    d_s_argp, d_c_argp = _delta_trig(state.sin_argp, state.cos_argp, d_argp)
    c_argp_p = state.cos_argp + d_c_argp
    s_argp_p = state.sin_argp + d_s_argp
    u = state.x * state.cos_argp - state.y * state.sin_argp
    v = state.x * state.sin_argp + state.y * state.cos_argp
    d_u = d_x * c_argp_p - d_y * s_argp_p + state.x * d_c_argp \
        - state.y * d_s_argp
    d_v = d_x * s_argp_p + d_y * c_argp_p + state.x * d_s_argp \
        + state.y * d_c_argp

    # stage 2: inclination about the node line
    d_s_inc, d_c_inc = _delta_trig(state.sin_inc, state.cos_inc, d_inc_r)
    p = state.cos_inc * v
    d_p = (state.cos_inc + d_c_inc) * d_v + v * d_c_inc
    d_q = (state.sin_inc + d_s_inc) * d_v + v * d_s_inc

    # stage 3: rotation by Om about the ecliptic pole
    d_s_Om, d_c_Om = _delta_trig(state.sin_Om, state.cos_Om, d_Om_r)
    c_Om_p = state.cos_Om + d_c_Om
    s_Om_p = state.sin_Om + d_s_Om
    d_x_ec = c_Om_p * d_u - s_Om_p * d_p + u * d_c_Om - p * d_s_Om
    d_y_ec = s_Om_p * d_u + c_Om_p * d_p + u * d_s_Om + p * d_c_Om
    d_z_ec = d_q

    # constant obliquity tilt (exactly linear: applies to the delta directly)
    ce = torch.tensor(np.cos(const.OBLIQUITY), dtype=dtype, device=e.device)
    se = torch.tensor(np.sin(const.OBLIQUITY), dtype=dtype, device=e.device)
    return (d_x_ec, ce * d_y_ec - se * d_z_ec, se * d_y_ec + ce * d_z_ec)


def orbit_positions_dev(M, e, a, sin_Om, cos_Om, sin_argp, cos_argp,
                        sin_inc, cos_inc):
    """Nominal equatorial positions [light-s] on the tensors' device through
    :func:`..ops.kepler.kepler_newton`, batched over any leading shape
    (planet x pulsar x TOA in one call); returns ``(..., 3)``.

    ``M`` must be reduced mod 2 pi on the host (float64) before casting: the
    raw mean longitude spans ~1e3 revolutions over a century, far beyond
    float32.
    """
    E = kepler_newton(M, e)
    b = torch.sqrt(1.0 - e**2)
    x = a * (torch.cos(E) - e)
    y = a * b * torch.sin(E)
    u = x * cos_argp - y * sin_argp
    v = x * sin_argp + y * cos_argp
    p = cos_inc * v
    q = sin_inc * v
    x_ec = cos_Om * u - sin_Om * p
    y_ec = sin_Om * u + cos_Om * p
    z_ec = q
    obl = torch.tensor(const.OBLIQUITY, dtype=x_ec.dtype, device=x_ec.device)
    ce, se = torch.cos(obl), torch.sin(obl)
    return torch.stack([x_ec, ce * y_ec - se * z_ec, se * y_ec + ce * z_ec],
                       dim=-1)
