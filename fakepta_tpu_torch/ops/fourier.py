"""Fourier-basis Gaussian-process helpers (port of fakepta_tpu.ops.fourier).

Every time-correlated noise of the facade (red, DM, chromatic, system) is a
sum over a cos/sin basis, as one einsum over a precomputed basis.

Conventions (the reference's, so the ``signal_model`` provenance dict stays
an exact contract):

- frequency grid ``f_n = (1..N)/Tspan`` unless given; ``df = diff([0, f])``
- raw coefficients ``c ~ N(0, sqrt(psd_n))`` independently for cos and sin
- residual contribution ``(freqf/nu)^idx * sum_n sqrt(df_n) (c_cos_n
  cos(2pi f_n t) + c_sin_n sin(2pi f_n t))``
- stored Fourier coefficients ``a = c / sqrt(df)`` with shape ``(2, N)``
  (row 0 cos, row 1 sin), so reconstruction is ``sum_n df_n (a_0n cos +
  a_1n sin)``.

Phases ``2 pi f t`` are computed by the caller (host float64 for the
facade) because absolute TOAs in seconds overflow float32 mantissas. The
functions keep their inputs' dtype and device.
"""

from __future__ import annotations

import math

import torch

from ..utils import rng


def _t(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x)


def fourier_freqs(nbin: int, tspan) -> torch.Tensor:
    """Default GP frequency grid ``(1..nbin)/Tspan``."""
    return torch.arange(1, nbin + 1, dtype=torch.float64) / tspan


def freq_weights(f_psd) -> torch.Tensor:
    """``df = diff([0, f])``: the bin widths that scale the PSD draws."""
    f_psd = _t(f_psd)
    return torch.diff(f_psd, prepend=f_psd.new_zeros(1))


def phases(toas, f_psd) -> torch.Tensor:
    """``2 pi f_n t`` as an (ntoa, N) tensor. Use float64 for absolute
    TOAs."""
    toas = _t(toas)
    return 2.0 * math.pi * toas[:, None] * _t(f_psd, toas)[None, :]


def chromatic_scale(radio_freqs, idx, freqf=1400.0) -> torch.Tensor:
    """``(freqf / nu)^idx`` per-TOA chromatic scaling."""
    return (freqf / _t(radio_freqs)) ** idx


def basis_from_phase(phase, scale=None) -> torch.Tensor:
    """The (ntoa, 2, N) cos/sin design tensor, optionally chromatic-scaled:
    ``basis[t, 0, n] = scale_t cos(phase_tn)``, ``basis[t, 1, n] = scale_t
    sin(phase_tn)``; leading axes broadcast."""
    phase = _t(phase)
    b = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-2)
    if scale is not None:
        b = b * _t(scale, phase)[..., :, None, None]
    return b


def draw_coeffs(key, psd) -> torch.Tensor:
    """Raw Fourier coefficients ``c ~ N(0, sqrt(psd))``, shape (..., 2, N)
    for a (..., 2) key batch and a (..., N) PSD, drawn at the PSD's dtype
    (float32 or float64): both the cos and the sin coefficient of bin n
    have standard deviation ``sqrt(psd_n)``."""
    psd = _t(psd)
    z = rng.normal(key.to(psd.device), (2, psd.shape[-1]), dtype=psd.dtype)
    return z * torch.sqrt(psd)[..., None, :]


def inject_from_coeffs(basis, coeffs, df, toa_mask=None) -> torch.Tensor:
    """Residual contribution of raw coefficients ``c``: ``basis @ (sqrt(df)
    c)``. basis (..., ntoa, 2, N); coeffs (..., 2, N); df (N,)."""
    w = coeffs * torch.sqrt(_t(df, coeffs))[..., None, :]
    res = torch.einsum("...tkn,...kn->...t", basis, w)
    if toa_mask is not None:
        res = torch.where(_t(toa_mask).to(res.device), res,
                          res.new_zeros(()))
    return res


def reconstruct_from_fourier(basis, fourier, df, toa_mask=None
                             ) -> torch.Tensor:
    """Time-domain realization from stored coefficients ``a = c/sqrt(df)``:
    ``sum_n df_n (a_0n cos + a_1n sin)``."""
    w = _t(fourier, basis) * _t(df, basis)[..., None, :]
    res = torch.einsum("...tkn,...kn->...t", basis, w)
    if toa_mask is not None:
        res = torch.where(_t(toa_mask).to(res.device), res,
                          res.new_zeros(()))
    return res


def reconstruct_old_padded(old_phase, old_scale, old_fourier, old_df
                           ) -> torch.Tensor:
    """Realization of a stored GP entry on its own phase/scale tables, with
    the stored ``(2, nbin)`` coefficients zero-padded to the table's bin
    count (padded bins contribute nothing)."""
    old_df = _t(old_df)
    four = _t(old_fourier, old_df)
    four = torch.nn.functional.pad(four, (0, old_df.shape[-1]
                                          - four.shape[-1]))
    basis = basis_from_phase(old_phase, old_scale)
    return reconstruct_from_fourier(basis, four, old_df)


def gp_covariance(basis, psd, df) -> torch.Tensor:
    """Dense GP covariance ``F diag(repeat(psd*df, 2)) F^T``: basis (ntoa,
    2, N) -> (ntoa, ntoa)."""
    w = _t(psd, basis) * _t(df, basis)
    return torch.einsum("tkn,n,ukn->tu", basis, w, basis)
