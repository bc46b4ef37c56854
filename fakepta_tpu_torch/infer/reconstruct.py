"""Batched conditional-mean (Wiener) GP reconstruction (port of
fakepta_tpu.infer.reconstruct).

The posterior-mean GP coefficients given residuals are ``b = Sigma^{-1}
T^T N^{-1} r`` with ``Sigma = B^{-1} + T^T N^{-1} T`` (rank 2M, never
n_toa^3), and the conditional-mean signal is ``T b``: the dense smoother
``T B T^T C^{-1} r`` with the n_toa^3 inverse replaced by one rank-2M
Cholesky solve (:func:`..ops.woodbury.conditional_mean`). One call smooths
a whole ensemble's (..., P, T) residual blocks, on the batch's device and
dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import woodbury
from .model import CompiledLikelihood, LikelihoodSpec, build


def _compiled(model, batch) -> CompiledLikelihood:
    if isinstance(model, CompiledLikelihood):
        return model
    if isinstance(model, LikelihoodSpec):
        return build(model, batch)
    raise TypeError(f"model must be a LikelihoodSpec or CompiledLikelihood, "
                    f"got {type(model).__name__}")


def wiener_coefficients(model, batch, residuals, theta=None,
                        ecorr: bool = False) -> torch.Tensor:
    """Posterior-mean GP coefficients for (..., P, T) residual blocks.

    ``model`` is a :class:`LikelihoodSpec` (or a compiled one); ``theta``
    supplies its free parameters (omit for all-fixed models).
    ``ecorr=True`` includes the batch's per-epoch ECORR blocks in the white
    noise. Returns (..., P, 2M) coefficients in the model's column layout.
    """
    compiled = _compiled(model, batch)
    if theta is None:
        if compiled.D:
            raise ValueError(f"the model has {compiled.D} free parameter(s) "
                             f"({list(compiled.param_names)}); pass theta")
        theta_arr = np.zeros((0,))
    else:
        theta_arr = compiled.validate_theta(theta)[0]
    tmat = compiled.basis(batch)
    phi = compiled.phi(theta_arr, batch)
    num_ep = batch.max_toa if ecorr else 0
    epoch = batch.epoch_idx if ecorr else None
    amp = batch.ecorr_amp if ecorr else None
    onehot = (woodbury.epoch_onehot(epoch, num_ep, tmat.dtype)
              if ecorr else None)
    M, _, _, corr = woodbury.finish_fixed(woodbury.fixed_parts(
        tmat, batch.sigma2, batch.mask, epoch, amp, num_epochs=num_ep,
        onehot=onehot))
    res = torch.as_tensor(residuals).to(dtype=tmat.dtype,
                                        device=tmat.device)
    parts = woodbury.res_parts(res, tmat, batch.sigma2, batch.mask, epoch,
                               amp, num_epochs=num_ep, onehot=onehot)
    _, dT = woodbury.finish_res(parts, corr)
    return woodbury.conditional_mean(M, phi, dT)


def wiener_reconstruct(model, batch, residuals, theta=None,
                       ecorr: bool = False) -> torch.Tensor:
    """Conditional-mean GP signal ``T b`` for (..., P, T) residual blocks,
    masked to each pulsar's valid TOAs."""
    compiled = _compiled(model, batch)
    coeffs = wiener_coefficients(compiled, batch, residuals, theta=theta,
                                 ecorr=ecorr)
    tmat = compiled.basis(batch)
    with woodbury.full_f32():
        recon = torch.einsum("...pk,ptk->...pt", coeffs, tmat)
    return torch.where(batch.mask, recon, torch.zeros_like(recon))
