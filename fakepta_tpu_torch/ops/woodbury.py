"""Cholesky solves for covariance matrices (port of the JAX package's
``ops/woodbury.py::cho_solve_psd``; the rest of that module, the
GP-marginalized likelihood, is ROADMAP Queue 1 item 7)."""

from __future__ import annotations

import torch


def cho_solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for symmetric positive-definite ``a``: one
    Cholesky factorization and two triangular solves, no explicit inverse.

    A factorization that fails (``a`` not positive definite at its dtype)
    gives NaN, as the JAX package's CPU Cholesky does; it does not raise,
    so no host sync is needed to check it.
    """
    chol, info = torch.linalg.cholesky_ex(a)
    vec = b.ndim == a.ndim - 1
    x = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, chol)
    ok = (info == 0)[..., None, None]
    x = torch.where(ok, x, torch.full_like(x, float("nan")))
    return x.squeeze(-1) if vec else x
