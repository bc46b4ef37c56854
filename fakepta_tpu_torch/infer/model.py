"""Declarative GP-marginalized likelihood models over a PulsarBatch (port of
fakepta_tpu.infer.model).

A :class:`LikelihoodSpec` names which Gaussian-process components the
likelihood marginalizes (red / DM / chromatic / per-backend system bands per
pulsar, plus a common CURN process on the array grid) and which of their
spectrum hyperparameters are free; everything resolves against the same
registered spectrum library the injectors use (:mod:`..spectrum`) and the
engine's own Fourier bases (:func:`..batch.fourier_basis_norm`).

:func:`build` compiles a spec against a batch into a
:class:`CompiledLikelihood`: a static column layout plus ``basis(batch)``
(the (P, T, 2M) design tensor, legal on any psr or toa shard of the batch)
and ``phi(theta, batch)`` (the (P, 2M) prior diagonal of one
hyperparameter point). Theta enters the likelihood only through ``phi``,
and every op on that path is functional, so ``torch.func.jacfwd`` of
:meth:`CompiledLikelihood.lnl_local` gives exact gradients and Hessians
(the engine's ``grad`` and ``fisher`` lanes).

Free parameters are scalars shared across pulsars by default;
``FreeParam(per_pulsar=True)`` gives every pulsar its own theta slot and
``FreeParam(per_bin=True)`` one slot per frequency bin. Priors are box
transforms from the single ``FreeParam.bounds``: :func:`theta_grid`,
:meth:`CompiledLikelihood.theta_from_unit`, :func:`box_log_prior` and the
logit transform (:func:`box_to_unconstrained` /
:func:`box_from_unconstrained`) see the same box.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import spectrum as spectrum_lib
from ..batch import fourier_basis_norm
from ..ops import woodbury

#: schema tag for inference-run artifacts (the JAX package's, unchanged)
INFER_SCHEMA = "fakepta_tpu.infer/1"

#: GP targets a component may marginalize; 'curn' is the common
#: uncorrelated red-noise process on the array grid (cross-pulsar ORF
#: terms would couple pulsars and break the per-pulsar factorization)
TARGETS = ("red", "dm", "chrom", "sys", "curn")

#: sentinel spectrum name: the component's PSD is the batch's stored one
#: (a fixed, fully marginalized nuisance, no free parameters)
BATCH_SPECTRUM = "batch"

MODES = ("lnlike", "grad", "fisher")


@dataclasses.dataclass(frozen=True)
class FreeParam:
    """One free spectrum hyperparameter: name, box bounds, scope.

    ``per_pulsar`` gives every pulsar its own theta slot; ``per_bin`` one
    slot per frequency bin of the component (the named hyperparameter must
    accept a per-bin vector, e.g. ``log10_rho``). The two scopes are
    mutually exclusive.
    """

    name: str
    bounds: Tuple[float, float]
    per_pulsar: bool = False
    per_bin: bool = False

    def __post_init__(self):
        object.__setattr__(self, "bounds", tuple(self.bounds))
        if self.per_pulsar and self.per_bin:
            raise ValueError(f"FreeParam {self.name!r} cannot be both "
                             f"per_pulsar and per_bin")


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    """One GP component of the likelihood model.

    ``spectrum`` names a registered PSD model, or :data:`BATCH_SPECTRUM` to
    pin the component at the batch's stored PSD. ``nbin`` defaults to the
    batch's bin count for the target (CURN: the red bin count).
    ``bin_offset`` restricts the component to the bin block ``[bin_offset,
    bin_offset + nbin)`` of the standard grid.
    """

    target: str
    spectrum: str = "powerlaw"
    free: Tuple[FreeParam, ...] = ()
    fixed: tuple = ()             # ((name, value), ...); dicts are normalized
    nbin: Optional[int] = None
    bin_offset: int = 0

    def __post_init__(self):
        if isinstance(self.fixed, dict):
            object.__setattr__(self, "fixed",
                               tuple(sorted(self.fixed.items())))
        else:
            object.__setattr__(self, "fixed", tuple(self.fixed))
        object.__setattr__(self, "free", tuple(self.free))
        if int(self.bin_offset) < 0:
            raise ValueError(f"bin_offset must be >= 0, got "
                             f"{self.bin_offset}")
        if self.bin_offset and self.nbin is None:
            raise ValueError("a bin_offset component needs an explicit "
                             "nbin (the block width)")


@dataclasses.dataclass(frozen=True)
class LikelihoodSpec:
    """The declarative model: an ordered tuple of GP components. Hashable
    (it keys the engine's compiled-model cache). White noise is always in
    the model, from the batch's ``sigma2`` and, when the simulator's ECORR
    stage is live, its epoch and amplitude arrays."""

    components: Tuple[ComponentSpec, ...]

    def __post_init__(self):
        comps = self.components
        if isinstance(comps, ComponentSpec):
            comps = (comps,)
        object.__setattr__(self, "components", tuple(comps))


@dataclasses.dataclass(frozen=True, eq=False)
class InferSpec:
    """Configuration of the engine's lnlike lane (``run(lnlike=...)``).

    ``theta`` is the (K, D) hyperparameter batch evaluated against every
    realization; ``mode`` selects the packed lanes per point: ``'lnlike'``
    (1), ``'grad'`` (1 + D: lnL and its exact gradient), ``'fisher'``
    (1 + D + D^2: and the dense Hessian; the per-realization observed
    Fisher information is ``-H``).
    """

    model: LikelihoodSpec
    theta: np.ndarray
    mode: str = "lnlike"


def as_spec(lnlike) -> InferSpec:
    """Validate a run's ``lnlike=`` argument."""
    if not isinstance(lnlike, InferSpec):
        raise TypeError(
            f"lnlike must be an InferSpec (a LikelihoodSpec plus a (K, D) "
            f"theta batch and a mode), got {type(lnlike).__name__}")
    if lnlike.mode not in MODES:
        raise ValueError(f"InferSpec.mode must be one of {MODES}, got "
                         f"{lnlike.mode!r}")
    return lnlike


def lanes_per_point(mode: str, d: int) -> int:
    """Packed statistic lanes per theta point for a mode (see InferSpec)."""
    return {"lnlike": 1, "grad": 1 + d, "fisher": 1 + d + d * d}[mode]


def theta_grid(model: LikelihoodSpec, shape: Union[int, Sequence[int]]):
    """(K, D) regular grid over every free parameter's box bounds.

    ``shape`` gives the points per free parameter in declaration order (one
    int broadcasts). Per-pulsar and per-bin parameters have no dense grid:
    pass an explicit theta for those models.
    """
    params = [fp for comp in model.components for fp in comp.free]
    if not params:
        raise ValueError("theta_grid needs at least one free parameter")
    if any(fp.per_pulsar or fp.per_bin for fp in params):
        raise ValueError("theta_grid cannot grid per-pulsar/per-bin "
                         "parameters; pass an explicit theta array instead")
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),) * len(params)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(params):
        raise ValueError(f"grid shape {shape} must give one size per free "
                         f"parameter ({len(params)})")
    axes = [np.linspace(fp.bounds[0], fp.bounds[1], s)
            for fp, s in zip(params, shape)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


# ---------------------------------------------------------------------------
# box priors and the unconstrained <-> box transform: the single source of
# prior mass (theta_grid / theta_from_unit mesh the same bounds). They keep
# the dtype and device of theta.
# ---------------------------------------------------------------------------

def _bounds(bounds, like: torch.Tensor):
    """(D, 2) bounds at ``like``'s dtype and device; a tensor already there
    is used as it is (no host copy)."""
    if not isinstance(bounds, torch.Tensor):
        bounds = torch.as_tensor(np.asarray(bounds, dtype=np.float64))
    return bounds.to(dtype=like.dtype, device=like.device)


def _as_float(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x, dtype=np.float64))


def box_log_prior(theta, bounds):
    """ln p(theta) of the uniform box prior: ``-sum ln(hi - lo)`` inside
    the box, ``-inf`` outside. ``theta`` (..., D), ``bounds`` (D, 2)."""
    theta = _as_float(theta)
    b = _bounds(bounds, theta)
    lo, hi = b[:, 0], b[:, 1]
    inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
    lnv = -torch.sum(torch.log(hi - lo))
    return torch.where(inside, lnv, torch.full_like(lnv, -float("inf")))


def box_to_unconstrained(theta, bounds):
    """Logit transform box -> R^D: ``v = logit((theta - lo)/(hi - lo))``."""
    theta = _as_float(theta)
    b = _bounds(bounds, theta)
    u = (theta - b[:, 0]) / (b[:, 1] - b[:, 0])
    return torch.log(u) - torch.log1p(-u)


def box_from_unconstrained(v, bounds):
    """Inverse logit R^D -> box: ``theta = lo + (hi - lo) sigmoid(v)``."""
    v = _as_float(v)
    b = _bounds(bounds, v)
    return b[:, 0] + (b[:, 1] - b[:, 0]) * torch.sigmoid(v)


def box_unconstrained_log_prior(v):
    """ln density of the box prior in the unconstrained variable, up to
    the bounds-independent constant: ``sum [log sigmoid(v) + log
    sigmoid(-v)]``, summed in a fixed pairwise order
    (:func:`..ops.mcmc.fixed_sum`: a row's bits do not depend on how many
    rows ``v`` holds, which keeps the sampler's chains mesh-invariant)."""
    from ..ops.mcmc import fixed_sum
    v = _as_float(v)
    return fixed_sum(torch.nn.functional.logsigmoid(v)
                     + torch.nn.functional.logsigmoid(-v))


def box_unconstrained_log_prior_grad(v):
    """Gradient of :func:`box_unconstrained_log_prior`:
    ``sigmoid(-v) - sigmoid(v)`` elementwise."""
    v = _as_float(v)
    return torch.sigmoid(-v) - torch.sigmoid(v)


def _batch_bins(batch, target: str) -> int:
    if target == "red":
        return batch.red_psd.shape[1]
    if target == "dm":
        return batch.dm_psd.shape[1]
    if target == "chrom":
        return batch.chrom_psd.shape[1]
    if target == "sys":
        return batch.sys_psd.shape[2]
    return batch.red_psd.shape[1]          # curn: the red grid's size


class CompiledLikelihood:
    """A LikelihoodSpec resolved against one batch (see :func:`build`)."""

    def __init__(self, spec: LikelihoodSpec, batch):
        if not spec.components:
            raise ValueError("LikelihoodSpec needs at least one component")
        self.spec = spec
        self.npsr = int(batch.npsr)
        comps, names, bounds = [], [], []
        d = 0
        for ci, comp in enumerate(spec.components):
            if comp.target not in TARGETS:
                raise ValueError(f"unknown likelihood target "
                                 f"{comp.target!r}; known: {TARGETS}")
            nbatch = _batch_bins(batch, comp.target)
            nbin = int(comp.nbin) if comp.nbin is not None else nbatch
            bin_offset = int(comp.bin_offset)
            if bin_offset and comp.target == "sys":
                raise ValueError("bin_offset is not supported on 'sys' "
                                 "components (per-band column maps)")
            bands = 1
            if comp.target == "sys":
                if not bool(batch.sys_mask.any()):
                    raise ValueError(
                        "a 'sys' component needs system-noise bands in the "
                        "batch (build it from pulsars with system_noise "
                        "entries)")
                bands = int(batch.sys_psd.shape[1])
            if comp.spectrum == BATCH_SPECTRUM:
                if comp.free or comp.fixed:
                    raise ValueError(
                        f"spectrum='batch' pins component {ci} "
                        f"({comp.target}) at the batch's stored PSD; it "
                        f"takes no free or fixed hyperparameters")
                if comp.target == "curn":
                    raise ValueError("the batch stores no common-process "
                                     "PSD; give the 'curn' component a "
                                     "parametric spectrum")
                if bin_offset + nbin > nbatch:
                    raise ValueError(
                        f"component {ci} ({comp.target}) asks for bins "
                        f"[{bin_offset}, {bin_offset + nbin}) but the "
                        f"batch stores {nbatch}")
            else:
                if comp.spectrum not in spectrum_lib.SPECTRA:
                    raise ValueError(
                        f"spectrum {comp.spectrum!r} is not registered; "
                        f"known: {sorted(spectrum_lib.SPECTRA)}")
                reg = spectrum_lib.SPECTRA[comp.spectrum]
                for pname in ([fp.name for fp in comp.free]
                              + [k for k, _ in comp.fixed]):
                    if pname not in reg.params:
                        raise ValueError(
                            f"{pname!r} is not a hyperparameter of "
                            f"{comp.spectrum!r} (has {list(reg.params)})")
                fixed_names = {k for k, _ in comp.fixed}
                dup = [fp.name for fp in comp.free if fp.name in fixed_names]
                if dup:
                    raise ValueError(f"parameters {dup} are both free and "
                                     f"fixed in component {ci}")
            free_entries = []
            for fp in comp.free:
                if fp.per_pulsar and comp.target == "curn":
                    raise ValueError("'curn' is a common process; its "
                                     "hyperparameters cannot be per_pulsar")
                length = (self.npsr if fp.per_pulsar
                          else nbin if fp.per_bin else 1)
                free_entries.append((fp.name, d, fp.per_pulsar, fp.per_bin))
                if fp.per_pulsar:
                    names.extend(f"{comp.target}_{fp.name}[{p}]"
                                 for p in range(self.npsr))
                elif fp.per_bin:
                    # absolute bin labels, as the parent model's slots
                    names.extend(f"{comp.target}_{fp.name}[{b}]"
                                 for b in range(bin_offset,
                                                bin_offset + nbin))
                else:
                    names.append(f"{comp.target}_{fp.name}")
                bounds.extend([list(fp.bounds)] * length)
                d += length
            comps.append({
                "target": comp.target, "spectrum": comp.spectrum,
                "nbin": nbin, "bands": bands, "free": tuple(free_entries),
                "fixed": dict(comp.fixed), "bin_offset": bin_offset,
            })
        self._comps = comps
        self.D = d
        self.param_names = tuple(names)
        self.bounds = np.asarray(bounds, dtype=float).reshape(d, 2)
        #: total basis columns (2 quadratures per bin, per band)
        self.ncols = 2 * sum(c["nbin"] * c["bands"] for c in comps)

    # -- host helpers ------------------------------------------------------
    def column_slices(self):
        """``((target, start, stop), ...)``: the basis-column extent of
        every component in declaration order (a ``'sys'`` component gives
        one entry per band)."""
        out = []
        start = 0
        for c in self._comps:
            width = 2 * c["nbin"]
            for _ in range(c["bands"]):
                out.append((c["target"], start, start + width))
                start += width
        return tuple(out)

    def validate_theta(self, theta) -> np.ndarray:
        """Coerce a theta batch to a host (K, D) float array."""
        arr = np.asarray(theta, dtype=float)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.ndim != 2 or arr.shape[1] != self.D:
            raise ValueError(
                f"theta must be (K, {self.D}) for parameters "
                f"{list(self.param_names)}; got shape {np.shape(theta)}")
        if not np.all(np.isfinite(arr)):
            raise ValueError("theta contains non-finite entries")
        return arr

    def theta_from_unit(self, u) -> np.ndarray:
        """Affine box transform from the unit cube to physical parameters."""
        u = np.asarray(u, dtype=float)
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u * (hi - lo)

    def log_prior(self, theta):
        """Uniform-box ln p(theta) over this model's bounds."""
        return box_log_prior(theta, self.bounds)

    def to_unconstrained(self, theta):
        """Box -> R^D logit transform."""
        return box_to_unconstrained(theta, self.bounds)

    def from_unconstrained(self, v):
        """R^D -> box inverse logit."""
        return box_from_unconstrained(v, self.bounds)

    # -- device functions (on any psr or toa shard of the batch) -----------
    def basis(self, batch) -> torch.Tensor:
        """(P, T, 2M) concatenated Fourier design tensor on a batch shard.

        Per-pulsar targets use the pulsar-normalized times (grid
        ``n/Tspan_p``), CURN the common-origin normalized times (grid
        ``n/Tspan_array``): the bases the injections project through.
        """
        p_local, t_local = batch.t_own.shape
        blocks = []
        for c in self._comps:
            n, off = c["nbin"], c["bin_offset"]
            if c["target"] == "curn":
                b = fourier_basis_norm(batch.t_common, n, bin_offset=off)
            elif c["target"] == "dm":
                b = fourier_basis_norm(batch.t_own, n,
                                       scale=(1400.0 / batch.freqs) ** 2,
                                       bin_offset=off)
            elif c["target"] == "chrom":
                b = fourier_basis_norm(batch.t_own, n,
                                       scale=(1400.0 / batch.freqs) ** 4,
                                       bin_offset=off)
            else:                        # 'red' and 'sys' share the own grid
                b = fourier_basis_norm(batch.t_own, n, bin_offset=off)
            if c["target"] == "sys":
                for band in range(c["bands"]):
                    masked = b * batch.sys_mask[:, band][:, :, None, None]
                    blocks.append(masked.reshape(p_local, t_local, -1))
            else:
                blocks.append(b.reshape(p_local, t_local, -1))
        return torch.cat(blocks, dim=-1)

    def phi(self, theta, batch, psr_offset: int = 0) -> torch.Tensor:
        """(P, 2M) prior variance diagonal for ONE theta point.

        ``psr_offset`` is the shard's global pulsar offset (it slices the
        per-pulsar theta slots). Layout matches :meth:`basis` column for
        column.
        """
        p_local = batch.t_own.shape[0]
        dtype, dev = batch.t_own.dtype, batch.t_own.device
        theta = (theta.to(dtype) if isinstance(theta, torch.Tensor)
                 else torch.as_tensor(np.asarray(theta, dtype=np.float64)
                                      ).to(dtype=dtype, device=dev))
        cols = []
        for c in self._comps:
            n, off = c["nbin"], c["bin_offset"]
            # an offset component evaluates its spectrum on the full grid
            # (1..off+n) df and keeps the tail (registered spectra are
            # elementwise in f), so f[0] == df as free_spectrum needs
            ntot = off + n
            if c["target"] == "curn":
                df = 1.0 / batch.tspan_common
            else:
                df = batch.df_own[:, None]
            f = torch.arange(1, ntot + 1, dtype=dtype, device=dev) * df
            if c["spectrum"] == BATCH_SPECTRUM:
                if c["target"] == "sys":
                    for band in range(c["bands"]):
                        pd = batch.sys_psd[:, band, :n] * df
                        cols.append(torch.cat([pd, pd], dim=-1))
                    continue
                stored = {"red": batch.red_psd, "dm": batch.dm_psd,
                          "chrom": batch.chrom_psd}[c["target"]]
                pd = stored[:, off:off + n] * df
                cols.append(torch.cat([pd, pd], dim=-1))
                continue
            kwargs = dict(c["fixed"])
            for pname, start, per_psr, per_bin in c["free"]:
                if per_psr:
                    kwargs[pname] = theta.narrow(
                        0, start + psr_offset, p_local)[:, None]
                elif per_bin:
                    # one slot per bin; an offset component front-pads the
                    # skipped bins with zeros (sliced away below)
                    v = theta.narrow(0, start, n)
                    if off:
                        v = torch.cat([v.new_zeros(off), v])
                    kwargs[pname] = v
                else:
                    kwargs[pname] = theta[start]
            psd = spectrum_lib.evaluate(c["spectrum"], f, **kwargs)
            if off:
                psd = psd[..., off:]
            pd = torch.broadcast_to(psd * df, (p_local, n))
            block = torch.cat([pd, pd], dim=-1)
            for _ in range(c["bands"]):
                cols.append(block)
        return torch.cat(cols, dim=-1)

    def lnl_local(self, theta, moments, batch, psr_offset: int = 0):
        """(R,) local-pulsar partial lnL sums for ONE theta point.

        ``moments = (M, lndetN, n_valid, d0, dT)`` with leading (P,) /
        (R, P) axes (:mod:`..ops.woodbury`). The caller sums the partials
        of a pulsar mesh's shards; theta enters only through ``phi``, so
        forward-mode derivatives of this function are exact.
        """
        M, lndetN, n_valid, d0, dT = moments
        phi = self.phi(theta, batch, psr_offset)
        chol, lnnorm = woodbury.lnlike_factors(M, phi)
        quad = d0 - woodbury.quad_forms(chol, dT)                 # (R, P)
        lnl = -0.5 * (quad + lndetN[None] + lnnorm[None]
                      + n_valid[None] * woodbury.LN_2PI)
        return torch.sum(lnl, dim=1)


def build(spec: LikelihoodSpec, batch) -> CompiledLikelihood:
    """Compile a LikelihoodSpec against a batch (validates everything)."""
    return CompiledLikelihood(spec, batch)


def assemble(spec: InferSpec, compiled: CompiledLikelihood, lanes) -> dict:
    """Schema-versioned result dict from the packed lnlike lanes.

    ``lanes`` is the (R, K*L) host block the engine unpacked; returns
    ``lnl`` (R, K) and, per mode, ``grad`` (R, K, D) / ``fisher``
    (R, K, D, D): the Hessian of lnL, so the observed Fisher matrix is
    ``-fisher`` averaged over realizations.
    """
    theta = compiled.validate_theta(spec.theta)
    k, d = theta.shape[0], compiled.D
    lanes = np.asarray(lanes, dtype=float).reshape(
        -1, k, lanes_per_point(spec.mode, d))
    out = {
        "schema": INFER_SCHEMA,
        "mode": spec.mode,
        "theta": theta,
        "param_names": list(compiled.param_names),
        "lnl": lanes[:, :, 0],
    }
    if spec.mode in ("grad", "fisher"):
        out["grad"] = lanes[:, :, 1:1 + d]
    if spec.mode == "fisher":
        out["fisher"] = lanes[:, :, 1 + d:].reshape(-1, k, d, d)
    return out
