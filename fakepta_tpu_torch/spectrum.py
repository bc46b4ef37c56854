"""Power-spectral-density models, as torch functions (port of fakepta_tpu.spectrum).

The seven PSDs and the explicit registry of the JAX package, operation for
operation: every model exponentiates a summed log (the naive power-law
product runs through ~1e-42 intermediates that flush to zero in float32), so
a PSD evaluated here agrees with the JAX one to the last few ULP of its
dtype. Inputs keep their dtype: numpy float64 grids (the host staging path
``PulsarBatch.synthetic`` uses) evaluate in float64 on the CPU.

All PSDs map frequency [Hz] -> one-sided timing PSD [s^3] (s^2/Hz).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from . import constants as const


def _t(x, like=None):
    """``x`` as a tensor (the dtype/device of ``like`` for python scalars)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None and not isinstance(x, np.ndarray):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(x))


def _softplus(x):
    """Numerically-stable ``log(1 + exp(x))`` for log-space PSD evaluation."""
    return torch.logaddexp(x, torch.zeros_like(x))


_LN_12PI2 = math.log(12.0 * math.pi ** 2)


def powerlaw(f, log10_A=-15.0, gamma=13 / 3):
    """Power-law timing PSD: ``A^2/(12 pi^2) fyr^(gamma-3) f^-gamma``."""
    f = _t(f)
    log10_A, gamma = _t(log10_A, f), _t(gamma, f)
    ln_psd = (2.0 * log10_A * const.ln10 - _LN_12PI2
              + (gamma - 3.0) * math.log(const.fyr)
              - gamma * torch.log(f))
    return torch.exp(ln_psd)


def turnover(f, log10_A=-15.0, gamma=4.33, lf0=-8.5, kappa=10 / 3, beta=0.5):
    """Turnover strain spectrum converted to timing PSD via
    ``hc(f)^2/(12 pi^2 f^3)``."""
    f = _t(f)
    log10_A, gamma, lf0, kappa, beta = (_t(v, f) for v in
                                        (log10_A, gamma, lf0, kappa, beta))
    ln_hcf = (log10_A * const.ln10
              + 0.5 * (3.0 - gamma) * torch.log(f / const.fyr)
              - beta * _softplus(kappa * (lf0 * const.ln10 - torch.log(f))))
    return torch.exp(2.0 * ln_hcf - _LN_12PI2 - 3.0 * torch.log(f))


def t_process(f, log10_A=-15.0, gamma=4.33, alphas=None):
    """Fuzzy power law: per-frequency multipliers ``alphas``."""
    f = _t(f)
    alphas = torch.ones_like(f) if alphas is None else _t(alphas, f)
    return powerlaw(f, log10_A=log10_A, gamma=gamma) * alphas


def t_process_adapt(f, log10_A=-15.0, gamma=4.33, alphas_adapt=None,
                    nfreq=None):
    """Adaptive t-process: fuzz a single frequency bin ``nfreq``."""
    f = _t(f)
    if alphas_adapt is None:
        alpha_model = torch.ones_like(f)
    elif nfreq is None:
        alpha_model = _t(alphas_adapt, f)
    else:
        # functional (no in-place write), so torch.func transforms pass
        idx = torch.round(_t(nfreq, f)).to(torch.int64)
        bins = torch.arange(f.shape[-1], device=f.device)
        alpha_model = torch.where(bins == idx, _t(alphas_adapt, f),
                                  torch.ones_like(f))
    return powerlaw(f, log10_A=log10_A, gamma=gamma) * alpha_model


def turnover_knee(f, log10_A=-15.0, gamma=13 / 3, lfb=-8.7, lfk=-8.0,
                  kappa=10 / 3, delta=0.1):
    """Turnover spectrum with an additional high-frequency knee."""
    f = _t(f)
    log10_A, gamma, lfb, lfk, kappa, delta = (
        _t(v, f) for v in (log10_A, gamma, lfb, lfk, kappa, delta))
    ln_hcf = (log10_A * const.ln10
              + 0.5 * (3.0 - gamma) * torch.log(f / const.fyr)
              + delta * torch.log1p(f / 10.0 ** lfk)
              - 0.5 * _softplus(kappa * (lfb * const.ln10 - torch.log(f))))
    return torch.exp(2.0 * ln_hcf - _LN_12PI2 - 3.0 * torch.log(f))


def broken_powerlaw(f, log10_A=-15.0, gamma=13 / 3, delta=0.1,
                    log10_fb=-8.5, kappa=0.1):
    """Broken power law with smooth transition at ``10^log10_fb``."""
    f = _t(f)
    log10_A, gamma, delta, log10_fb, kappa = (
        _t(v, f) for v in (log10_A, gamma, delta, log10_fb, kappa))
    ln_hcf = (log10_A * const.ln10
              + 0.5 * (3.0 - gamma) * torch.log(f / const.fyr)
              + 0.5 * kappa * (gamma - delta)
              * _softplus((torch.log(f) - log10_fb * const.ln10) / kappa))
    return torch.exp(2.0 * ln_hcf - _LN_12PI2 - 3.0 * torch.log(f))


def free_spectrum(f, log10_rho=None):
    """Free spectral model: ``psd_i = 10^(2 log10_rho_i) * Tspan`` on the
    standard grid ``f_i = i/Tspan`` (``Tspan`` inferred as ``1/f_1``); a
    non-standard grid raises instead of rescaling every bin wrongly. A
    (..., N) stack of grids (one per pulsar) is checked and evaluated row
    by row. Inside a ``torch.func`` transform (the sampler's gradients, the
    JAX check's traced case) the grid is not read back, so the check is
    skipped; callers on the batch's standard grids are pre-validated."""
    f = _t(f)
    if torch._C._functorch.is_functorch_wrapped_tensor(f):
        f_host = None
    else:
        # fakepta: allow[dtype-policy] the host copy of the grid check
        f_host = f.detach().cpu().double().numpy().reshape(-1, f.shape[-1])
    expect = (None if f_host is None
              else np.arange(1, f_host.shape[1] + 1) * f_host[:, :1])
    if f_host is not None and not np.allclose(f_host, expect, rtol=1e-5,
                                              atol=0.0):
        raise ValueError(
            "free_spectrum needs the standard grid f_i = i/Tspan (it infers "
            "Tspan = 1/f[0]); got a non-uniform/offset grid. Compute the PSD "
            "yourself (psd_i = 10**(2*log10_rho_i)/df_i) and pass it via "
            "custom_psd instead")
    log10_rho = (torch.zeros_like(f) if log10_rho is None
                 else _t(log10_rho, f))
    return torch.exp(2.0 * log10_rho * const.ln10 - torch.log(f[..., :1]))


@dataclasses.dataclass(frozen=True)
class SpectrumModel:
    """A registered PSD model: the callable and its hyper-parameter names."""

    fn: Callable
    params: Tuple[str, ...]

    def __call__(self, f, **kwargs):
        return self.fn(f, **kwargs)


SPECTRA: Dict[str, SpectrumModel] = {}
spec: Dict[str, Callable] = {}
spec_params: Dict[str, list] = {}


def register_spectrum(fn: Callable, name: str | None = None,
                      params: Tuple[str, ...] | None = None):
    """Register a PSD model so every consumer accepts it by name.

    ``params`` defaults to the function's keyword argument names minus ``f``.
    """
    import inspect

    name = name or fn.__name__
    if params is None:
        sig = inspect.signature(fn)
        params = tuple(p for p in sig.parameters if p != "f")
    SPECTRA[name] = SpectrumModel(fn=fn, params=params)
    spec[name] = fn
    spec_params[name] = list(params)
    return fn


for _fn in (powerlaw, turnover, t_process, t_process_adapt, turnover_knee,
            broken_powerlaw, free_spectrum):
    register_spectrum(_fn)


def evaluate(spectrum: str, f, **kwargs):
    """Evaluate a registered PSD by name with keyword hyper-parameters."""
    if spectrum not in SPECTRA:
        raise KeyError(
            f"unknown spectrum {spectrum!r}; registered: {sorted(SPECTRA)}")
    return SPECTRA[spectrum](f, **kwargs)


def evaluate_host(spectrum: str, f, **kwargs) -> np.ndarray:
    """:func:`evaluate` on the CPU, returned as a numpy array."""
    f = _t(f).cpu()
    return evaluate(spectrum, f, **kwargs).numpy()


# fakepta: allow[dtype-policy] the dtype table of evaluate_host_at, no cast
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def evaluate_host_at(spectrum: str, f, dtype: torch.dtype,
                     **kwargs) -> np.ndarray:
    """:func:`evaluate_host` at ``dtype`` (float32 or float64): ``f`` and
    the array-valued ``kwargs`` are cast to it first, scalars stay Python
    numbers."""
    np_dtype = _NP_DTYPES[dtype]
    args = {k: np.asarray(v, dtype=np_dtype) if np.ndim(v) else v
            for k, v in kwargs.items()}
    return evaluate_host(spectrum, np.asarray(f, dtype=np_dtype), **args)
