"""Batched gradient-informed MCMC transition kernels, HMC and tempering
(port of ``fakepta_tpu.ops.mcmc``).

The device-side half of :mod:`..sample`: a Hamiltonian Monte Carlo
transition over a ``(chains, temps, D)`` state tensor plus adjacent
replica-exchange (parallel tempering) swaps expressed as on-device
permutations. No host decision anywhere: selections are ``torch.where``,
never a Python ``bool`` of a device tensor or an ``.item()``, so a
segment of transitions enqueues its kernels without one host sync.

Design contracts (the JAX module's):

- **Pure and dtype-polymorphic**: plain torch on whatever dtype the state
  carries (float64 in the oracle tests, the batch dtype in the sampler).
  No op writes into its inputs.
- **Target-agnostic**: the (tempered) posterior enters only through a
  ``vg(z) -> (lnl, glnl, lnpri, glnpri)`` callable evaluated on the full
  ``(C, T, D)`` tensor at once, so the caller controls batching, sharding
  and the fixed-order reductions that keep chains bit-identical on every
  mesh.
- **Stream discipline**: every draw comes from a per-(chain, temp) key the
  caller derives by folding the GLOBAL chain index; the momenta fold
  subtag 0 and the accept uniform subtag 1 (:func:`transition_draws`).
  The draws depend on the keys alone, so a caller may draw a whole
  segment's at once and pass them to :func:`hmc_step`, bit for bit what
  :func:`hmc_transition` draws step by step.
- **Tempering**: only the likelihood is tempered (``beta_t * lnl +
  lnpri``), so the swap accept ratio reduces to ``(beta_i - beta_j)(lnl_j
  - lnl_i)``.

The JAX module's ``lax.scan`` over leapfrog steps is a Python loop here,
and ``jnp.take_along_axis`` is ``torch.gather``. Reductions over the
parameter axis go through :func:`fixed_sum`, a pairwise tree of
elementwise adds whose order does not depend on the other axes' sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import rng

#: divergence threshold: a leapfrog trajectory whose energy error exceeds
#: this (or goes non-finite) is counted divergent and always rejected
MAX_ENERGY_ERROR = 50.0


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by pairwise halving (zero-padded to a power of
    two): elementwise adds only, so each output's rounding is a function of
    its own row, whatever the shape of the rest of ``x``. A library
    reduction may choose its accumulation order from the whole shape
    (on the card, from the number of outputs), which would tie a chain's
    bits to the mesh."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    width = 1 << (n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def fixed_matvec(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m`` for (..., K) rows ``x`` and a (K, N) matrix, each output
    a :func:`fixed_sum` of its products (mesh-invariant bits)."""
    return fixed_sum(x[..., :, None] * m, dim=-2)


def tempered(parts, betas):
    """(lnp, grad) of the tempered target from vg parts. ``betas`` (T,)."""
    lnl, glnl, lnpri, glnpri = parts
    return (betas * lnl + lnpri, betas[..., None] * glnl + glnpri)


def leapfrog(vg, z, parts, p, eps, n_steps: int, betas):
    """``n_steps`` of the leapfrog integrator on the full (C, T, D) tensor.

    ``eps`` broadcasts against (C, T, 1): per-temperature step sizes are
    ``eps[None, :, None]``. The merged-kick form (initial half kick, full
    kicks, undo half): ``n_steps`` gradient evaluations, exactly reversible
    up to roundoff. Returns ``(z, p, parts)`` at the trajectory end.
    """
    _, g = tempered(parts, betas)
    p = p + 0.5 * eps * g
    for _ in range(n_steps):
        z = z + eps * p
        parts = vg(z)
        _, g = tempered(parts, betas)
        p = p + eps * g
    _, g = tempered(parts, betas)
    p = p - 0.5 * eps * g
    return z, p, parts


def transition_draws(keys: torch.Tensor, d: int, dtype: torch.dtype):
    """``(momenta (..., D), ln u (...))`` of one HMC transition for each
    per-(chain, temp) key in ``keys`` (..., 2): the momenta from
    ``fold_in(key, 0)``, the accept uniform from ``fold_in(key, 1)``."""
    mom = rng.normal(rng.fold_in(keys, 0), (d,), dtype=dtype)
    lnu = torch.log(rng.uniform(rng.fold_in(keys, 1), (), dtype=dtype))
    return mom, lnu


def hmc_step(mom, lnu, z, parts, vg, betas, eps, n_leapfrog: int,
             max_energy_error: float = MAX_ENERGY_ERROR):
    """One batched HMC transition from pre-drawn momenta ``mom`` (C, T, D)
    and accept log-uniforms ``lnu`` (C, T) (:func:`transition_draws`);
    see :func:`hmc_transition`."""
    lnp0, _ = tempered(parts, betas)
    h0 = lnp0 - 0.5 * fixed_sum(mom * mom)
    eps_b = eps[None, :, None]
    z1, p1, parts1 = leapfrog(vg, z, parts, mom, eps_b, n_leapfrog, betas)
    lnp1, _ = tempered(parts1, betas)
    h1 = lnp1 - 0.5 * fixed_sum(p1 * p1)
    dh = h1 - h0
    ok = torch.isfinite(dh)
    divergent = (~ok) | (dh < -max_energy_error)
    accept = ok & (lnu < dh)
    sel = accept[..., None]
    z = torch.where(sel, z1, z)
    lnl, glnl, lnpri, glnpri = parts
    lnl1, glnl1, lnpri1, glnpri1 = parts1
    parts = (torch.where(accept, lnl1, lnl),
             torch.where(sel, glnl1, glnl),
             torch.where(accept, lnpri1, lnpri),
             torch.where(sel, glnpri1, glnpri))
    return z, parts, accept, divergent


def hmc_transition(keys, z, parts, vg, betas, eps, n_leapfrog: int,
                   max_energy_error: float = MAX_ENERGY_ERROR):
    """One batched HMC transition for every (chain, temp).

    ``keys`` (C, T, 2) per-(chain, temp) keys (the caller already folded
    step index, global chain index and temperature), ``z`` (C, T, D),
    ``parts`` the ``vg(z)`` 4-tuple, ``betas`` (T,), ``eps`` (T,)
    per-temperature step sizes. Returns ``(z, parts, accept, divergent)``
    with accept / divergent (C, T) bools; non-finite or > ``max_energy_
    error`` trajectories count as divergent and are always rejected.
    """
    mom, lnu = transition_draws(keys, z.shape[-1], z.dtype)
    return hmc_step(mom, lnu, z, parts, vg, betas, eps, n_leapfrog,
                    max_energy_error)


def swap_from_uniforms(us, lnl, betas, parity: int):
    """:func:`swap_permutation` from the chains' (C, T) uniforms ``us``
    (drawn by ``uniform(key, (T,))`` per chain)."""
    t_count = lnl.shape[-1]
    t = torch.arange(t_count, device=lnl.device)
    up = (t % 2) == (parity % 2)
    partner = torch.clamp(torch.where(up, t + 1, t - 1), 0, t_count - 1)
    lo = torch.minimum(t, partner)
    ln_r = (betas[t] - betas[partner]) * (lnl[..., partner] - lnl[..., t])
    acc = (torch.log(us[..., lo]) < ln_r) & (partner != t)
    return torch.where(acc, partner, t).to(torch.int32)


def swap_permutation(keys, lnl, betas, parity: int):
    """Adjacent-pair replica-exchange permutation along the temperature
    axis.

    ``keys`` (C, 2) per-chain keys, ``lnl`` (C, T) untempered
    log-likelihoods, ``parity`` 0/1 selects which adjacent pairs ``(t,
    t+1)`` propose this round. Both members of a pair share one uniform and
    the log accept ratio is symmetric under the pair swap, so the result
    is a permutation; apply it with :func:`apply_permutation`. Returns
    (C, T) int32 gather indices (``t`` itself where no swap).
    """
    us = rng.uniform(keys, (lnl.shape[-1],), dtype=lnl.dtype)
    return swap_from_uniforms(us, lnl, betas, parity)


def apply_permutation(perm, *arrays):
    """Gather each array's temperature axis (axis 1) through ``perm``.

    Arrays are (C, T) or (C, T, D); every per-(chain, temp) state tensor
    (position, cached likelihood / prior values and gradients) rides the
    same permutation so the swapped chains stay self-consistent.
    """
    out = []
    idx = perm.to(torch.int64)
    for a in arrays:
        i = idx if a.dim() == 2 else idx[..., None]
        out.append(torch.gather(a, 1, i.expand(a.shape)))
    return tuple(out)


def geometric_betas(n_temps: int, max_temp: float,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """The geometric inverse-temperature ladder: ``beta_t =
    max_temp^(-t/(T-1))`` with ``beta_0 = 1`` (the cold, target chain);
    computed in float64 on the host and rounded once to ``dtype``."""
    if n_temps == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    # fakepta: allow[dtype-policy] the ladder at host f64, rounded once
    expo = np.arange(n_temps, dtype=np.float64) / (n_temps - 1)
    return torch.as_tensor(float(max_temp) ** (-expo)).to(dtype=dtype,
                                                          device=device)
