"""Rank-2N Woodbury algebra for the GP-marginalized PTA likelihood (port of
fakepta_tpu.ops.woodbury).

The van Haasteren & Vallisneri formulation (arXiv:1407.1838) replaces the
dense ``n_toa x n_toa`` covariance ``C = N + T B T^T`` by solves of the
rank-2N system ``Sigma = B^{-1} + T^T N^{-1} T``:

    lnL = -1/2 [ r^T N^{-1} r  -  r^T N^{-1} T Sigma^{-1} T^T N^{-1} r ]
          -1/2 [ ln det N + ln det B + ln det Sigma ]  -  n/2 ln 2 pi

Everything is expressed as *moments*: ``T^T N^{-1} T`` and ``ln det N``
depend only on the batch, ``T^T N^{-1} r`` and ``r^T N^{-1} r`` on each
realization, and the hyperparameters enter only through the diagonal prior
``B = diag(phi)``, so a K-point grid costs K Choleskys of Sigma plus K
batched triangular solves.

``N`` is diagonal white noise plus optional per-epoch ECORR blocks
``u_e u_e^T``, handled by per-block Sherman-Morrison on per-epoch sums. The
per-epoch sums are one contraction against a one-hot (T, E) epoch table:
a fixed-order reduction with no atomics, so reruns on the card are
bit-identical (a scatter-add would add in a different order each run).
All parts are plain sums over TOAs, so a time-sharded caller adds the part
dicts over its TOA windows before :func:`finish_fixed` /
:func:`finish_res`. Masked padding TOAs carry zero weight throughout.

Unlike the JAX module, whose functions take one pulsar and are vmapped,
these broadcast over leading axes: ``tmat`` (..., T, 2M) with ``sigma2``,
``mask``, ``epoch_idx``, ``ecorr_amp`` (..., T); a residual block ``r`` may
carry extra leading (realization) axes. They keep their inputs' dtype and
device, use Cholesky factorizations and triangular solves only (no dense
inverse), and take no host sync: a failed factorization gives NaN, as the
JAX package's does, instead of raising. Their products run at full float32
(no TF32). Every op is functional, so ``torch.func`` transforms (the
engine's forward-mode gradient and Hessian lanes) pass through them.
"""

from __future__ import annotations

import torch

from .megakernel import full_f32

LN_2PI = 1.8378770664093453


def _phi_floor(dtype) -> float:
    """Positive floor for prior variances: a zero-variance (padded or
    disabled) basis column must contribute nothing, not a division by zero.
    The pair ``ln phi + ln Sigma_jj -> ln(1 + phi M_jj) -> 0`` and the
    column's solve contribution vanish as phi -> 0, so flooring at
    ``4/dtype_max`` (whose reciprocal still fits the dtype) is exact in the
    limit and inert for any physical phi."""
    return 4.0 / torch.finfo(dtype).max


def cho_solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for symmetric positive-definite ``a``: one
    Cholesky factorization and two triangular solves, no explicit inverse.

    A factorization that fails (``a`` not positive definite at its dtype)
    gives NaN, as the JAX package's CPU Cholesky does; it does not raise,
    so no host sync is needed to check it.
    """
    chol = _cholesky(a)
    vec = b.ndim == a.ndim - 1
    x = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, chol)
    return x.squeeze(-1) if vec else x


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization fails."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))


def _masked_weights(sigma2, mask):
    """(..., T) inverse white variances, exactly zero on padding TOAs."""
    safe = torch.where(mask, sigma2, torch.ones_like(sigma2))
    return torch.where(mask, 1.0 / safe, torch.zeros_like(sigma2))


def epoch_onehot(epoch_idx: torch.Tensor, num_epochs: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """(..., T, E) one-hot epoch table of (..., T) epoch ids: the operand of
    the per-epoch sums (ids outside ``[0, num_epochs)`` belong to no
    epoch, as ``segment_sum`` drops them)."""
    e = torch.arange(num_epochs, device=epoch_idx.device)
    return (epoch_idx[..., :, None] == e).to(dtype)


def _vecmat(x, m):
    """(..., K) row vectors times (..., K, N) matrices; ``x`` may carry
    extra leading (realization) axes over ``m``'s batch axes, which ride
    as rows of one batched product per matrix (a broadcast matmul would
    copy ``m`` once per extra index). The per-epoch sums are this product
    with the one-hot epoch table."""
    b = "abcdefgh"[:m.dim() - 2]
    return torch.einsum(f"...{b}k,{b}kn->...{b}n", x, m)


def _solve_columns(solve, chol, v):
    """``solve(chol, rhs)`` for (..., 2M) vectors ``v`` whose leading axes
    may extend ``chol``'s batch axes: the extra axes ride as right-hand
    side columns of one solve per factor (a broadcast solve would copy the
    factor once per extra index)."""
    extra = v.dim() - (chol.dim() - 1)
    if extra <= 0:
        return solve(chol, v[..., None])[..., 0]
    lead, tail = v.shape[:extra], v.shape[extra:]
    rhs = torch.movedim(v.reshape(-1, *tail), 0, -1)
    return torch.movedim(solve(chol, rhs), -1, 0).reshape(*lead, *tail)


def _onehot(epoch_idx, num_epochs, dtype, onehot):
    return onehot if onehot is not None else epoch_onehot(
        epoch_idx, num_epochs, dtype)


def fixed_parts(tmat, sigma2, mask, epoch_idx=None, ecorr_amp=None,
                num_epochs: int = 0, onehot=None) -> dict:
    """Residual-independent moment parts (additive over TOAs).

    ``tmat`` (..., T, 2M) basis, ``sigma2`` / ``mask`` (..., T) white
    variances and validity. With ``num_epochs > 0``, ``epoch_idx`` (..., T)
    integer global epoch ids and ``ecorr_amp`` (..., T) per-TOA ECORR
    amplitudes add the per-epoch rank-1 pieces; ``onehot`` is their
    precomputed :func:`epoch_onehot` table (built here when omitted).
    Returns a dict of plain sums: add the dicts of a time-sharded caller's
    windows before :func:`finish_fixed`.
    """
    w = _masked_weights(sigma2, mask)
    logs = torch.log(torch.where(mask, sigma2, torch.ones_like(sigma2)))
    with full_f32():
        parts = {
            "M": tmat.transpose(-1, -2) @ (w[..., None] * tmat),
            "lndetN": torch.sum(torch.where(mask, logs,
                                            torch.zeros_like(logs)), -1),
            "n_valid": torch.sum(mask.to(tmat.dtype), -1),
        }
        if num_epochs:
            oh = _onehot(epoch_idx, num_epochs, tmat.dtype, onehot)
            q = w * ecorr_amp                       # D^{-1} u, elementwise
            parts["a"] = _vecmat(q * ecorr_amp, oh)
            parts["v"] = oh.transpose(-1, -2) @ (q[..., None] * tmat)
    return parts


def res_parts(r, tmat, sigma2, mask, epoch_idx=None, ecorr_amp=None,
              num_epochs: int = 0, onehot=None) -> dict:
    """Residual-dependent moment parts (additive over TOAs): ``r``
    (..., T), with any extra leading axes over ``tmat``'s."""
    w = _masked_weights(sigma2, mask)
    with full_f32():
        parts = {
            "d0": torch.sum(w * r * r, -1),
            "dT": _vecmat(w * r, tmat),
        }
        if num_epochs:
            oh = _onehot(epoch_idx, num_epochs, tmat.dtype, onehot)
            parts["s"] = _vecmat(w * ecorr_amp * r, oh)
    return parts


def pad_epoch_parts(parts: dict, num_epochs: int) -> dict:
    """Zero-extend the per-epoch ECORR arrays (``a``/``v``/``s``) to a
    larger epoch capacity; exact, since a zero epoch row has ``a_e = 0``
    (gain 1 on zero sums, ``log1p(0) = 0``)."""
    out = dict(parts)
    for key in ("a", "v", "s"):
        if key not in parts:
            continue
        x = parts[key]
        axis = x.dim() - (2 if key == "v" else 1)
        have = x.shape[axis]
        if num_epochs < have:
            raise ValueError(f"epoch capacity cannot shrink: parts[{key!r}] "
                             f"has {have} epochs, requested {num_epochs}")
        if num_epochs > have:            # at capacity: no copy
            pad = [0, 0] * (x.dim() - 1 - axis) + [0, num_epochs - have]
            out[key] = torch.nn.functional.pad(x, pad)
    return out


def append_parts(parts: dict, tmat, sigma2, mask, r=None, epoch_idx=None,
                 ecorr_amp=None, num_epochs: int = 0, onehot=None) -> dict:
    """Additive update of summed moment parts with a block of new TOAs on
    the same frozen basis grid: the block's parts, added (the epoch arrays
    zero-padded to ``max(num_epochs, existing)`` first). A residual dict
    (``"d0" in parts``) requires ``r``; a fixed dict forbids it.
    ``onehot`` is the block's precomputed :func:`epoch_onehot` table
    (shared by a fixed and a residual update). Returns a new dict."""
    is_res = "d0" in parts
    if is_res and r is None:
        raise ValueError("appending to a res_parts dict requires r")
    if not is_res and r is not None:
        raise ValueError("appending to a fixed_parts dict forbids r "
                         "(did you mean the res_parts dict?)")
    cap = num_epochs
    for key in ("a", "s"):
        if key in parts:
            cap = max(cap, parts[key].shape[-1])
    if is_res:
        block = res_parts(r, tmat, sigma2, mask, epoch_idx, ecorr_amp,
                          num_epochs=num_epochs, onehot=onehot)
    else:
        block = fixed_parts(tmat, sigma2, mask, epoch_idx, ecorr_amp,
                            num_epochs=num_epochs, onehot=onehot)
    old = pad_epoch_parts(parts, cap) if cap else dict(parts)
    new = pad_epoch_parts(block, cap) if cap else block
    out = {k: old[k] + new[k] if k in new else old[k] for k in old}
    for k in new:
        if k not in out:      # the first ECORR-bearing block
            out[k] = new[k]
    return out


def finish_fixed(parts: dict):
    """(M, lndetN, n_valid, corr) from summed fixed parts: the per-epoch
    Sherman-Morrison downdate ``M -= sum_e v_e v_e^T / (1 + a_e)`` and the
    block determinant ``ln det N += sum_e ln(1 + a_e)``; ``corr`` carries
    ``(a, v)`` for :func:`finish_res` (None for purely diagonal noise)."""
    M, lndetN, n_valid = parts["M"], parts["lndetN"], parts["n_valid"]
    if "a" not in parts:
        return M, lndetN, n_valid, None
    a, v = parts["a"], parts["v"]
    g = 1.0 / (1.0 + a)
    with full_f32():
        M = M - v.transpose(-1, -2) @ (g[..., None] * v)
    lndetN = lndetN + torch.sum(torch.log1p(a), -1)
    return M, lndetN, n_valid, {"a": a, "v": v}


def finish_res(parts: dict, corr=None):
    """(d0, dT) from summed residual parts (+ the ECORR downdate)."""
    d0, dT = parts["d0"], parts["dT"]
    if corr is None:
        return d0, dT
    g = 1.0 / (1.0 + corr["a"])
    s = parts["s"]
    with full_f32():
        d0 = d0 - torch.sum(g * s * s, -1)
        dT = dT - _vecmat(g * s, corr["v"])
    return d0, dT


def _reciprocal(phi):
    """``1/phi``, whose derivative is taken as ``-(1/phi) (dphi/phi)``
    through ``exp(-ln phi)``: the chain rule of the division, ``-dphi
    (1/phi)^2``, squares a reciprocal that overflows float32 for phi below
    ~5e-20 (a faint common process's top bins), and its inf times a zero
    tangent poisons every derivative lane with NaN. The value is the
    division's, bit for bit."""
    via_log = torch.exp(-torch.log(phi))
    return (1.0 / phi).detach() + (via_log - via_log.detach())


def _sigma(M, phi):
    phi = torch.clamp(phi, min=_phi_floor(phi.dtype))
    return phi, M + torch.diag_embed(_reciprocal(phi))


def lnlike_factors(M, phi):
    """Hyperparameter-side factorization: ``Sigma = diag(1/phi) + M`` for
    (..., 2M, 2M) ``M`` and (..., 2M) ``phi``. Returns ``(chol, lnnorm)``
    with ``lnnorm = ln det B + ln det Sigma``."""
    phi, sigma = _sigma(M, phi)
    chol = _cholesky(sigma)
    lnnorm = torch.sum(torch.log(phi), -1) + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
    return chol, lnnorm


def quad_forms(chol, dT):
    """Batched ``dT^T Sigma^{-1} dT`` by one forward triangular solve:
    ``chol`` (P, 2M, 2M) lower factors, ``dT`` (R, P, 2M) -> (R, P)."""
    rhs = torch.movedim(dT, 0, -1)                        # (P, 2M, R)
    with full_f32():
        y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.movedim(torch.sum(y * y, -2), -1, 0)     # (R, P)


def _forward(chol, dT):
    with full_f32():
        return _solve_columns(
            lambda c, b: torch.linalg.solve_triangular(c, b, upper=False),
            chol, dT)


def lnlike_from_moments(d0, dT, M, lndetN, n_valid, phi):
    """Woodbury lnL from moments and the prior diagonal (leading axes
    broadcast: one pulsar, or a stack of them)."""
    chol, lnnorm = lnlike_factors(M, phi)
    y = _forward(chol, dT)
    quad = d0 - torch.sum(y * y, -1)
    return -0.5 * (quad + lndetN + lnnorm + n_valid * LN_2PI)


def lnlike_and_grad_phi(M, phi, d0, dT, lndetN, n_valid):
    """Woodbury lnL plus its closed-form gradient with respect to phi:

        d lnL / d phi_j = -1/2 [ 1/phi_j - (Sigma^{-1})_jj / phi_j^2
                                 - (Sigma^{-1} dT)_j^2 / phi_j^2 ]

    one Cholesky, one triangular inverse and two triangular solves.
    Returns ``(lnl, dlnl_dphi)`` with shapes ``(...)`` and ``(..., 2M)``.
    """
    phi, sigma = _sigma(M, phi)
    chol = _cholesky(sigma)
    lnnorm = torch.sum(torch.log(phi), -1) + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
    y = _forward(chol, dT)
    quad = d0 - torch.sum(y * y, -1)
    lnl = -0.5 * (quad + lndetN + lnnorm + n_valid * LN_2PI)
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    with full_f32():
        # b = Sigma^{-1} dT by back-substitution; diag(Sigma^{-1}) from the
        # triangular inverse: (Sigma^{-1})_jj = sum_k (L^-1)_kj^2
        b = _solve_columns(
            lambda c, r: torch.linalg.solve_triangular(
                c.transpose(-2, -1), r, upper=True), chol, y)
        linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                             upper=False)
    sdiag = torch.sum(linv * linv, -2)
    inv_phi2 = 1.0 / (phi * phi)
    glnl = -0.5 * (1.0 / phi - sdiag * inv_phi2 - (b * b) * inv_phi2)
    return lnl, glnl


def _a_factor(M, phi):
    """``(phi, sqrt(phi), L)`` with ``L`` the lower Cholesky factor of
    ``A = I + Phi^1/2 M Phi^1/2``: the same system as ``Sigma = M +
    Phi^-1 = Phi^-1/2 A Phi^-1/2``, but with eigenvalues >= 1, where
    Sigma's span the prior variances' ~1e-14..1e-40 range (float32
    overflows its ``1/phi^2``)."""
    phi = torch.clamp(phi, min=_phi_floor(phi.dtype))
    s = torch.sqrt(phi)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return phi, s, _cholesky(s[..., :, None] * M * s[..., None, :] + eye)


def lnlike_lnphi(M, phi, d0, dT, lndetN, n_valid, order: int = 0):
    """The Woodbury lnL in the well-conditioned form (:func:`_a_factor`),
    with ``order`` 1 its gradient and ``order`` 2 also its Hessian with
    respect to ``psi = ln phi`` (floored as :func:`_sigma` floors phi):

        lnL = -1/2 [ d0 - |L^-1 Phi^1/2 dT|^2 + lndetN + ln det A
                     + n ln 2 pi ]
        d lnL / d psi_j = 1/2 (beta_j^2 - 1 + W_jj)
        d2 lnL / d psi_i d psi_j = beta_i beta_j W_ij + W_ij^2 / 2
                                   - delta_ij (1/2 + d lnL / d psi_j)

    with ``W = A^-1`` and ``beta = W Phi^1/2 dT`` (``ln det A = ln det B +
    ln det Sigma``, the lnL of :func:`lnlike_from_moments`). A zero-phi
    (padding) column gives ``W_jj = 1``, ``beta_j = 0``: no gradient.
    Returns ``lnl`` (...), with ``order`` >= 1 ``grad`` (..., 2M), with 2
    ``hess`` (..., 2M, 2M)."""
    phi, s, chol = _a_factor(M, phi)
    y = _forward(chol, s * dT)
    lnl = -0.5 * (d0 - torch.sum(y * y, -1) + lndetN + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
        + n_valid * LN_2PI)
    if order == 0:
        return lnl
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    with full_f32():
        beta = _solve_columns(
            lambda c, r: torch.linalg.solve_triangular(
                c.transpose(-2, -1), r, upper=True), chol, y)
        linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                             upper=False)
    grad = 0.5 * (beta * beta - 1.0 + torch.sum(linv * linv, -2))
    if order == 1:
        return lnl, grad
    with full_f32():
        w = linv.transpose(-2, -1) @ linv
    hess = (beta[..., :, None] * beta[..., None, :] * w + 0.5 * w * w
            - torch.diag_embed(0.5 + grad))
    return lnl, grad, hess


def conditional_mean(M, phi, dT):
    """Posterior-mean GP coefficients ``b = Sigma^{-1} T^T N^{-1} r`` (the
    Woodbury form of the Wiener filter); ``dT`` may carry extra leading
    axes over ``M``'s."""
    _, sigma = _sigma(M, phi)
    chol = _cholesky(sigma)
    with full_f32():
        return _solve_columns(lambda c, b: torch.cholesky_solve(b, c),
                              chol, dT)


def woodbury_lnlike(r, tmat, phi, sigma2, mask=None, epoch_idx=None,
                    ecorr_amp=None, num_epochs: int = 0):
    """One-shot lnL (tests, host operators, small problems); the engine
    lane composes the split pieces so the fixed moments amortize."""
    mask = torch.ones(r.shape, dtype=torch.bool, device=r.device) \
        if mask is None else mask
    onehot = (epoch_onehot(epoch_idx, num_epochs, tmat.dtype)
              if num_epochs else None)
    fparts = fixed_parts(tmat, sigma2, mask, epoch_idx, ecorr_amp,
                         num_epochs=num_epochs, onehot=onehot)
    rparts = res_parts(r, tmat, sigma2, mask, epoch_idx, ecorr_amp,
                       num_epochs=num_epochs, onehot=onehot)
    M, lndetN, n_valid, corr = finish_fixed(fparts)
    d0, dT = finish_res(rparts, corr)
    return lnlike_from_moments(d0, dT, M, lndetN, n_valid, phi)


def restrict_moments(moments, cols):
    """Restrict ``(M, lndetN, n_valid, d0, dT)`` to a column subset of the
    trailing 2M axis (exact indexing of the staged moments)."""
    cols = torch.as_tensor(cols, dtype=torch.int64)
    M, lndetN, n_valid, d0, dT = moments
    cols = cols.to(M.device)
    M_r = M.index_select(-1, cols).index_select(-2, cols)
    return (M_r, lndetN, n_valid, d0, dT.index_select(-1, cols))


def block_coupling(M, blocks):
    """Max normalized cross-block coupling ``|M_jk| / sqrt(M_jj M_kk)``
    over column pairs in different ``blocks`` (1-D index arrays), reduced
    over every leading axis: 0 where the blocks are exactly orthogonal."""
    M = torch.as_tensor(M)
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    norm = torch.sqrt(torch.abs(diag[..., :, None] * diag[..., None, :]))
    ratio = torch.abs(M) / torch.clamp(norm, min=_phi_floor(norm.dtype))
    worst = torch.zeros((), dtype=M.dtype, device=M.device)
    for a in range(len(blocks)):
        for b in range(len(blocks)):
            if a == b:
                continue
            ia = torch.as_tensor(blocks[a], dtype=torch.int64,
                                 device=M.device)
            ib = torch.as_tensor(blocks[b], dtype=torch.int64,
                                 device=M.device)
            sub = ratio.index_select(-2, ia).index_select(-1, ib)
            worst = torch.maximum(worst, sub.max())
    return worst
