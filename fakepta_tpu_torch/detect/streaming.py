"""Rolling optimal-statistic tracker for streaming ingestion (port of
``fakepta_tpu.detect.streaming``).

The batch OS lane (:mod:`..detect`) cross-correlates engine realizations
inside the chunk step; a *stream* has exactly one realization (the sky),
but its data grows, and the question "is the CURN process showing
cross-correlations yet?" should be answerable after every append without
restaging anything. :class:`StreamingOS` answers it from the stream's
accumulated Woodbury moments alone:

- per pulsar, the conditional-mean GP coefficients at a pinned reference
  theta, ``b_a = Sigma_a^{-1} dT_a`` (one Cholesky solve, the Wiener
  filter of :func:`..ops.woodbury.conditional_mean`), restricted to the
  CURN basis columns;
- pair correlation ``rho_ab = c_a . c_b`` with variance
  ``v_ab = sum_k (Sigma_a^{-1})_kk (Sigma_b^{-1})_kk`` over the same
  columns (the diagonal via one triangular inverse);
- the ORF-matched filter ``X = sum_pairs gam_ab rho_ab / v_ab`` with
  normalization ``sum_pairs gam_ab^2 / v_ab``: ``amp2 = X / norm`` is the
  OS amplitude estimate and ``snr = X / sqrt(norm)`` its significance in
  sigma units.

An update is one batched Cholesky of ``M + diag(1/phi)`` (phi floored),
one ``cholesky_solve``, one batched triangular inverse and the pair sums,
on the moments' device at their dtype; the shapes depend only on (P, C),
so the statistic's operands (pair indices, ORF values, the prior
diagonal) are staged once per tracker. Crossings of the significance
threshold are edge-triggered: flight-recorded (``stream_detection``) and
counted (``stream.detections``) on the upward crossing only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..obs import flightrec, metrics
from ..ops import gwb as gwb_ops
from ..ops.woodbury import _cholesky, _phi_floor


class StreamingOS:
    """Per-append detection-statistic tracker over stream moments.

    ``compiled`` is the stream's :class:`..infer.model.CompiledLikelihood`
    (it must contain exactly ONE CURN component: the statistic is a
    cross-correlation of that process's coefficients); ``batch_views`` the
    namespace ``compiled.phi`` reads (the stream's frozen template views,
    whose dtype and device the statistic runs at); ``pos`` the (P, 3) sky
    positions; ``orf`` an ORF template name ('curn' excluded: it has no
    cross-correlation signal to match). ``theta_ref`` pins the noise model
    the filter whitens against (default: the compiled model's box
    midpoint).
    """

    def __init__(self, compiled, batch_views, pos, orf: str = "hd",
                 theta_ref=None, threshold_sigma: float = 3.0):
        curn = [(s, e) for (t, s, e) in compiled.column_slices()
                if t == "curn"]
        if len(curn) != 1:
            raise ValueError(f"StreamingOS needs exactly one 'curn' "
                             f"component in the model, found {len(curn)}")
        self._lo, self._hi = curn[0]
        self.orf = str(orf)
        if self.orf == "curn":
            raise ValueError("'curn' has no cross-correlation signature; "
                             "pick 'hd', 'monopole' or 'dipole'")
        self.threshold_sigma = float(threshold_sigma)
        pos = np.asarray(pos, dtype=np.float64)
        npsr = pos.shape[0]
        if npsr < 2:
            raise ValueError("the optimal statistic needs >= 2 pulsars")
        orfs = np.asarray(gwb_ops.build_orf(self.orf, pos))
        a, b = np.triu_indices(npsr, k=1)
        self._a, self._b = a, b
        self._gam = orfs[a, b]
        if not np.any(self._gam != 0.0):
            raise ValueError(f"ORF {self.orf!r} is zero on every pulsar "
                             f"pair for these positions")
        if theta_ref is None:
            theta_ref = compiled.theta_from_unit(np.full(compiled.D, 0.5))
        self.theta_ref = np.asarray(theta_ref, dtype=np.float64)
        self._compiled = compiled
        self._views = batch_views
        self._ops = None
        self.count = 0
        self.last: Optional[dict] = None
        self._above = False

    def _operands(self, like: torch.Tensor) -> dict:
        """The statistic's fixed operands at ``like``'s dtype and device,
        staged on the first update: the floored prior diagonal at
        ``theta_ref``, the pair indices and ORF values, the identity."""
        if self._ops is None:
            dt, dev = like.dtype, like.device
            theta = torch.as_tensor(self.theta_ref).to(dtype=dt, device=dev)
            phi = self._compiled.phi(theta, self._views).to(dtype=dt,
                                                             device=dev)
            phi = torch.clamp(phi, min=_phi_floor(dt))
            self._ops = {
                "inv_phi": torch.diag_embed(1.0 / phi),
                "a": torch.as_tensor(self._a).to(dev),
                "b": torch.as_tensor(self._b).to(dev),
                "gam": torch.as_tensor(self._gam).to(dtype=dt, device=dev),
                "eye": torch.eye(like.shape[-1], dtype=dt, device=dev),
            }
        return self._ops

    def statistic(self, m: torch.Tensor, dt_: torch.Tensor):
        """``(amp2, snr)`` as 0-d tensors on the moments' device (no host
        sync) from ``M`` (P, C, C) and ``dT`` (P, C)."""
        ops = self._operands(m)
        lo, hi = self._lo, self._hi
        low = _cholesky(m + ops["inv_phi"])
        coeff = torch.cholesky_solve(dt_[..., None], low)[..., 0]
        linv = torch.linalg.solve_triangular(
            low, ops["eye"].expand_as(low), upper=False)
        sdiag = torch.sum(linv * linv, dim=-2)
        coeff, sdiag = coeff[:, lo:hi], sdiag[:, lo:hi]
        a, b, gam = ops["a"], ops["b"], ops["gam"]
        rho = torch.sum(coeff[a] * coeff[b], dim=1)
        var = torch.sum(sdiag[a] * sdiag[b], dim=1)
        num = torch.sum(gam * rho / var)
        den = torch.sum(gam * gam / var)
        return num / den, num / torch.sqrt(den)

    def update(self, moments) -> dict:
        """Refresh the statistic from finished stream moments
        ``(M, lndetN, n_valid, d0, dT)``; returns (and keeps as ``last``)
        ``{"amp2", "snr", "significance_sigma"}``."""
        m, _, _, _, dt_ = moments
        amp2, snr = torch.stack(self.statistic(m, dt_)).tolist()
        self.count += 1
        out = {"amp2": amp2, "snr": snr, "significance_sigma": snr}
        self.last = out
        above = snr >= self.threshold_sigma
        if above and not self._above:
            metrics.count("stream.detections")
            flightrec.note("stream_detection", orf=self.orf,
                           snr=round(snr, 3), amp2=amp2,
                           update=self.count)
        self._above = above
        return out
