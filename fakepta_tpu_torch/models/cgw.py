"""Continuous gravitational waves from circular supermassive-black-hole
binaries (port of fakepta_tpu.models.cgw).

The timing residual of a circular binary (Ellis, Siemens & Creighton 2012),
the JAX package's replacement for the reference's external
``enterprise_extensions.deterministic.cw_delay`` (``fake_pta.py:436-441``):

- strain amplitude ``h0 = 2 mc^{5/3} (pi f)^{2/3} / d`` in natural units;
- quadrupole evolution of the orbital angular frequency
  ``omega(t) = omega0 (1 - (256/5) mc^{5/3} omega0^{8/3} t)^{-3/8}`` and
  phase ``Phi(t) = Phi0 + (omega0^{-5/3} - omega(t)^{-5/3}) / (32 mc^{5/3})``;
- residual ``s(t) = F+ r+(t) + Fx rx(t)`` with the plus/cross responses of
  :func:`_polarisation_terms`;
- the pulsar term at the retarded time ``t - L (1 - cos mu)``.

The phase difference ``omega0^{-5/3} - omega^{-5/3}`` is evaluated as
``-expm1((5/8) log1p(-x))``, stable at any precision.

Every function is dtype-generic and broadcasts: the pulsar positions
``pos`` are ``(..., 3)``, the source parameters broadcast against their
leading shape, and epochs are ``(..., T)``. The same code runs at float64 on
the CPU for the engine's fixed sources and at float32 on the card for
sources sampled per realization: parameters shaped (R, 1) against (P, 3)
positions and (P, T) epochs give (R, P, T) residuals. Powers are taken at
float64 and rounded once to the input's dtype, so a value does not depend
on where it lies in a tensor (torch's CPU kernels round their vector lanes
and their scalar tail differently); the trig of a source's angles likewise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const

# fraction of the coalescence time at which the evolution freezes: the
# quadrupole model diverges at x -> 1 (merger), and a draw from a wide
# population prior that merges mid-span would otherwise turn the whole
# realization into NaNs
_MERGER_CLAMP = 1.0 - 1e-6


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _once(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` at float64, rounded once to ``x``'s dtype."""
    return fn(x.double()).to(x.dtype)


def _pow(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` at float64, rounded once to ``x``'s dtype."""
    return torch.pow(x.double(), p).to(x.dtype)


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """``10 ** x`` at float64, rounded once to ``x``'s dtype."""
    return torch.pow(10.0, x.double()).to(x.dtype)


def _lead(x: torch.Tensor) -> torch.Tensor:
    """A per-pulsar or per-source value against (..., T) epochs."""
    return x.unsqueeze(-1)


def antenna_pattern(pos, gwtheta, gwphi):
    """Plus/cross antenna patterns and cos(angle to source).

    Same geometry as the ORF construction: basis vectors m, n transverse to
    the propagation direction omhat. ``pos``: ``(..., 3)`` pulsar unit
    vectors; ``gwtheta`` / ``gwphi``: numbers or tensors broadcasting
    against ``pos``'s leading shape.
    """
    pos = torch.as_tensor(pos)
    gwtheta = _as(gwtheta, pos)
    gwphi = _as(gwphi, pos)
    sin_t, cos_t = _once(torch.sin, gwtheta), _once(torch.cos, gwtheta)
    sin_p, cos_p = _once(torch.sin, gwphi), _once(torch.cos, gwphi)
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    mdp = sin_p * px + (-cos_p) * py
    ndp = (-cos_t * cos_p) * px + (-cos_t * sin_p) * py + sin_t * pz
    odp = (-sin_t * cos_p) * px + (-sin_t * sin_p) * py + (-cos_t) * pz
    fplus = 0.5 * (mdp**2 - ndp**2) / (1.0 + odp)
    fcross = mdp * ndp / (1.0 + odp)
    cos_mu = -odp
    return fplus, fcross, cos_mu


def _orbital_evolution(t, omega0, mc53):
    """Stable ``(omega(t), Phi(t) - Phi0)`` for a quadrupole-driven circular
    inspiral. ``x = t / t_coalescence`` is clamped just below 1: epochs past
    the binary's merger hold the near-merger frequency and phase instead of
    going NaN."""
    x = (256.0 / 5.0) * mc53 * _pow(omega0, 8.0 / 3.0) * t
    log1mx = torch.log1p(-torch.clamp(x, max=_MERGER_CLAMP))
    omega = omega0 * torch.exp(-(3.0 / 8.0) * log1mx)
    # (omega0^{-5/3} - omega^{-5/3}) / (32 mc^{5/3}), cancellation-free
    dphase = -torch.expm1((5.0 / 8.0) * log1mx) * _pow(omega0, -5.0 / 3.0) \
        / (32.0 * mc53)
    return omega, dphase


def _polarisation_terms(phase, omega, mc53, dist, cos2i, cosi, psi):
    """r+, rx of one term (earth or pulsar); the source values ``mc53``,
    ``dist``, ``cos2i``, ``cosi`` and ``psi`` come shaped against the
    epochs."""
    amp = mc53 / (dist * _pow(omega, 1.0 / 3.0))
    a_t = -0.5 * torch.sin(2.0 * phase) * (3.0 + cos2i)
    b_t = 2.0 * torch.cos(2.0 * phase) * cosi
    c2psi = _once(torch.cos, 2.0 * psi)
    s2psi = _once(torch.sin, 2.0 * psi)
    rplus = amp * (-a_t * c2psi + b_t * s2psi)
    rcross = amp * (a_t * s2psi + b_t * c2psi)
    return rplus, rcross


def _source(toas, cos_gwtheta, cos_inc, log10_mc, log10_fgw, log10_dist,
            log10_h):
    """(mc^{5/3}, omega0, inc, gwtheta, distance [s]) of one source
    parameterization, as tensors at the epochs' dtype."""
    mc = _pow10(_as(log10_mc, toas)) * const.Tsun
    mc53 = _pow(mc, 5.0 / 3.0)
    fgw = _pow10(_as(log10_fgw, toas))
    omega0 = math.pi * fgw
    inc = _once(torch.arccos, _as(cos_inc, toas))
    gwtheta = _once(torch.arccos, _as(cos_gwtheta, toas))
    if log10_h is not None:
        dist = 2.0 * mc53 * _pow(omega0, 2.0 / 3.0) \
            / _pow10(_as(log10_h, toas))
    elif log10_dist is not None:
        dist = _pow10(_as(log10_dist, toas)) * const.Mpc / const.c
    else:
        raise ValueError("one of log10_dist or log10_h must be given")
    return mc53, omega0, inc, gwtheta, dist


def _psr_dist_sec(pdist, p_dist, like):
    """The pulsar distance [s]: ``(mean + sigma * p_dist)`` kpc."""
    return (_as(pdist[0], like) + _as(pdist[1], like) * _as(p_dist, like)) \
        * const.kpc / const.c


def cw_delay(toas, pos, pdist, cos_gwtheta=0.0, gwphi=0.0, cos_inc=0.0,
             log10_mc=9.0, log10_fgw=-8.0, log10_dist=None, log10_h=None,
             phase0=0.0, psi=0.0, psrTerm=False, p_dist=0.0, p_phase=None,
             evolve=True, phase_approx=False, tref=0.0):
    """Timing residual [s] of a circular SMBHB continuous wave at ``toas``.

    ``phase0`` is the GW phase at ``tref`` (orbital phase is half of it);
    ``pdist`` is the ``(mean, sigma)`` pulsar distance in kpc with
    ``p_dist`` the draw in units of sigma; ``log10_h`` (if given) fixes the
    strain and overrides ``log10_dist``.

    Modes: ``evolve``: full frequency evolution at earth and pulsar;
    ``phase_approx``: constant frequencies (earth at omega0, pulsar at the
    retarded frequency) with linear phases, ``p_phase`` optionally pinning
    the pulsar-term phase offset; neither: rigid monochromatic wave at
    both. ``toas`` (..., T) against ``pos`` (..., 3) (module docstring).
    """
    toas = torch.as_tensor(toas)
    mc53, omega0, inc, gwtheta, dist = _source(
        toas, cos_gwtheta, cos_inc, log10_mc, log10_fgw, log10_dist,
        log10_h)
    fplus, fcross, cos_mu = antenna_pattern(_as(pos, toas), gwtheta, gwphi)
    p_dist_sec = _psr_dist_sec(pdist, p_dist, toas)

    t = toas - tref
    tau = p_dist_sec * (1.0 - cos_mu)
    phase_orb0 = _lead(_as(phase0, toas) / 2.0)
    omega0_l, mc53_l = _lead(omega0), _lead(mc53)

    phase_p = omega_p = None
    if evolve:
        omega_e, dph_e = _orbital_evolution(t, omega0_l, mc53_l)
        phase_e = phase_orb0 + dph_e
        if psrTerm:
            omega_p, dph_p = _orbital_evolution(t - _lead(tau), omega0_l,
                                                mc53_l)
            phase_p = phase_orb0 + dph_p
    elif phase_approx:
        omega_e = omega0_l
        # pulsar-term frequency at the (constant) retarded epoch
        omega_p, _ = _orbital_evolution(_lead(-p_dist_sec * (1.0 - cos_mu)),
                                        omega0_l, mc53_l)
        phase_e = phase_orb0 + omega0_l * t
        if p_phase is None:
            phase_p = phase_orb0 + omega_p * t \
                - omega_p * _lead(p_dist_sec) * _lead(1.0 - cos_mu)
        else:
            phase_p = phase_orb0 + _lead(_as(p_phase, toas)) + omega_p * t
    else:
        omega_e = omega_p = omega0_l
        phase_e = phase_orb0 + omega0_l * t
        phase_p = phase_orb0 + omega0_l * (t - _lead(tau))

    cos2i = _lead(_once(torch.cos, 2.0 * inc))
    cosi = _lead(_once(torch.cos, inc))
    src = (_lead(mc53), _lead(dist), cos2i, cosi, _lead(_as(psi, toas)))
    rplus_e, rcross_e = _polarisation_terms(phase_e, omega_e, *src)
    fplus, fcross = _lead(fplus), _lead(fcross)
    if psrTerm:
        rplus_p, rcross_p = _polarisation_terms(phase_p, omega_p, *src)
        return fplus * (rplus_p - rplus_e) + fcross * (rcross_p - rcross_e)
    return -fplus * rplus_e - fcross * rcross_e


def psrterm_phase_bulk(tau, log10_mc, log10_fgw):
    """Host-f64 orbital-phase bulk ``dph(-tau)`` of the retarded time, mod 2pi.

    ``tau = L (1 - cos mu)`` is the pulsar term's retardation (seconds),
    ~1e11 s, so the orbital phase accumulated over it is ~1e3-1e4 rad, far
    beyond float32. Evaluated here at float64 (numpy) and reduced mod 2pi,
    so only the small residual phase is left to the device
    (:func:`cw_delay_psrterm_split`; the identity ``dph(t - tau) =
    dph(-tau) + dph(t; omega0 (1 + k tau)^{-3/8})`` is exact). Mirrors
    :func:`_orbital_evolution`'s merger clamp. Broadcasts over any common
    shape.
    """
    mc53 = (10.0 ** np.asarray(log10_mc, dtype=np.float64)
            * const.Tsun) ** (5.0 / 3.0)
    omega0 = np.pi * 10.0 ** np.asarray(log10_fgw, dtype=np.float64)
    k = (256.0 / 5.0) * mc53 * omega0 ** (8.0 / 3.0)
    x = np.minimum(-k * np.asarray(tau, dtype=np.float64), _MERGER_CLAMP)
    bulk = (-np.expm1((5.0 / 8.0) * np.log1p(-x))
            * omega0 ** (-5.0 / 3.0) / (32.0 * mc53))
    return np.mod(bulk, 2.0 * np.pi)


def cw_delay_psrterm_split(toas, pos, pdist, psr_bulk, cos_gwtheta=0.0,
                           gwphi=0.0, cos_inc=0.0, log10_mc=9.0,
                           log10_fgw=-8.0, log10_dist=None, log10_h=None,
                           phase0=0.0, psi=0.0, p_dist=0.0):
    """Evolving pulsar-term CGW residual with the retarded-phase bulk supplied.

    Float32-stable form of ``cw_delay(evolve=True, psrTerm=True)``:
    ``psr_bulk`` is the pulsar term's orbital-phase bulk ``dph(-tau)`` mod
    2pi, precomputed at float64 (:func:`psrterm_phase_bulk`), shaped like
    the pulsars' leading shape. With ``s0 = 1 + k tau`` the retarded
    evolution factors exactly as ``dph(t - tau) = dph(-tau) + dph(t;
    omega0')``, ``omega0' = omega0 s0^{-3/8}``, so the device only handles
    phases of order ``omega' t``. ``toas`` are epochs relative to the
    caller's ``tref``.
    """
    t = torch.as_tensor(toas)
    mc53, omega0, inc, gwtheta, dist = _source(
        t, cos_gwtheta, cos_inc, log10_mc, log10_fgw, log10_dist, log10_h)
    fplus, fcross, cos_mu = antenna_pattern(_as(pos, t), gwtheta, gwphi)
    tau = _psr_dist_sec(pdist, p_dist, t) * (1.0 - cos_mu)
    k = (256.0 / 5.0) * mc53 * _pow(omega0, 8.0 / 3.0)
    # s0 = 1 - x(-tau), clamped exactly like _orbital_evolution clamps x
    s0 = torch.clamp(1.0 + k * tau, min=1.0 - _MERGER_CLAMP)
    omega0_p = omega0 * _pow(s0, -3.0 / 8.0)

    phase_orb0 = _as(phase0, t) / 2.0
    omega_e, dph_e = _orbital_evolution(t, _lead(omega0), _lead(mc53))
    omega_p, dph_p = _orbital_evolution(t, _lead(omega0_p), _lead(mc53))
    phase_e = _lead(phase_orb0) + dph_e
    phase_p = _lead(phase_orb0 + _as(psr_bulk, t)) + dph_p

    cos2i = _lead(_once(torch.cos, 2.0 * inc))
    cosi = _lead(_once(torch.cos, inc))
    src = (_lead(mc53), _lead(dist), cos2i, cosi, _lead(_as(psi, t)))
    rplus_e, rcross_e = _polarisation_terms(phase_e, omega_e, *src)
    rplus_p, rcross_p = _polarisation_terms(phase_p, omega_p, *src)
    fplus, fcross = _lead(fplus), _lead(fcross)
    return fplus * (rplus_p - rplus_e) + fcross * (rcross_p - rcross_e)


def cw_delay_batched(toas, pos, pdist, cos_gwtheta, gwphi, cos_inc, log10_mc,
                     log10_fgw, log10_h=None, log10_dist=None, phase0=0.0,
                     psi=0.0, psrTerm=False, evolve=True, tref=0.0):
    """Summed timing residual (P, T) of a BATCH of S circular SMBHB sources.

    All per-source parameters are (S,) arrays (scalars broadcast); exactly
    one of ``log10_h`` / ``log10_dist`` must be given and applies to every
    source. ``toas`` (P, T), ``pos`` (P, 3), ``pdist`` (P, 2); returns the
    sources' summed delay, equal to looping :func:`cw_delay` per source and
    accumulating. The sources ride a leading (S, 1) axis against the
    pulsars.
    """
    if (log10_h is None) == (log10_dist is None):
        raise ValueError("exactly one of log10_h or log10_dist must be given")
    toas = torch.as_tensor(toas)
    amp = log10_h if log10_h is not None else log10_dist
    raw = [_as(a, toas) for a in (cos_gwtheta, gwphi, cos_inc, log10_mc,
                                  log10_fgw, amp, phase0, psi)]
    shape = torch.broadcast_shapes(*(a.shape for a in raw))
    S = shape[0] if shape else 1
    ct, gp, ci, mc, fg, am, p0, ps = (a.broadcast_to((S,)).reshape(S, 1)
                                      for a in raw)
    pdist = _as(pdist, toas)
    kw = {"log10_h" if log10_h is not None else "log10_dist": am}
    delay = cw_delay(toas, _as(pos, toas), (pdist[:, 0], pdist[:, 1]),
                     cos_gwtheta=ct, gwphi=gp, cos_inc=ci, log10_mc=mc,
                     log10_fgw=fg, phase0=p0, psi=ps, psrTerm=psrTerm,
                     evolve=evolve, tref=tref, **kw)
    return delay.sum(dim=0)
