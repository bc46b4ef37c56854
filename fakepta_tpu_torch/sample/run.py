"""SamplingRun: batched MCMC over the Woodbury likelihood on the card (port
of ``fakepta_tpu.sample.run``).

The posterior-characterization lane: gradient-informed HMC chains times
tempering rungs on the device. The data side is staged once on the host in
float64: residuals reduce to per-pulsar Woodbury moments (:mod:`..ops.
woodbury`, the algebra of the likelihood lane), and a damped-Newton Laplace
fit (``torch.func.grad`` / ``hessian``, float64 on the CPU) supplies both
the chains' warm start and the whitening preconditioner. From then on a
run dispatches one SEGMENT at a time: ``segment`` steps of HMC transitions,
swap permutations, thinning and the R-hat / ESS / acceptance accumulators,
enqueued without one host sync (every selection is a ``torch.where``, every
draw of the segment comes from its keys, drawn at the segment's start).
Thinned draws and state snapshots drain through the pipeline's writer
thread like the engine's chunk outputs (:mod:`..parallel.pipeline`: a
pinned host buffer per ring slot, the copy on a copy stream, the depth
bound asserted by :class:`..obs.memwatch.PackedLedger`), with timeline
spans per segment, checkpoints at segment boundaries and the recovery
policy of :mod:`..faults` (the ``sample.segment`` site).

Mesh (:mod:`..parallel.mesh`): the chains split into contiguous blocks over
the ``'real'`` entries; the per-pulsar likelihood rows over the ``'psr'``
entries (the ``'toa'`` axis replicates). A real row's segment runs on its
first device; each psr cell computes its pulsars' (lnL, gradient) rows on
its own device, and the rows are concatenated over ``'psr'`` in pulsar
order and summed in one fixed order. That gather is the chain loop's only
collective, as in the JAX program. On a multi-process mesh
(:func:`..parallel.mesh.initialize_multihost`) a rank runs the real rows
it has cells in, the psr gather crosses ranks where the cells do, and
each segment's rows are gathered to every rank, so every rank holds the
whole state; checkpoints are rank 0's to write, the drain is serial and
a segment failure raises on every rank instead of retrying on one. The
``'toa'`` axis replicates there too: a psr cell is the ``toa = 0``
entry's, whose owner computes it and whose row lead broadcasts the row
(a rank that owns only ``toa > 0`` entries computes nothing and receives
every row), so each row's work is the one-process mesh's, bit for bit.

Bitwise reproducibility: per-step draws fold the GLOBAL chain index, and
every reduction whose inputs a mesh could reshape is either a fixed-order
pairwise sum (:func:`..ops.mcmc.fixed_sum`) or runs in row groups of one
fixed size (:data:`ROW_GROUP` (chain, temp, pulsar) rows per batched
factorization; the last group padded), so each kernel sees the same batch
shape on every mesh. Thinned streams are then bit-identical across mesh
shapes, pipeline depths and checkpoint resumes.

The state carry is never written in place (every step makes new tensors),
so a snapshot the writer thread checkpoints cannot be overwritten by a
later segment, the counterpart of the JAX program never donating its
carry.

``run(tuned=True)`` takes the tuner's pipeline depth (:mod:`..tune`);
``warm_start()`` primes a segment's shapes on the device in place of the
JAX method's compilation into XLA's cache. Each drained segment
publishes its count as the live ``sample.segments_done`` gauge of
:mod:`..obs.telemetry`, as the JAX run does.
"""

from __future__ import annotations

import collections
import io
import json
import threading
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from .. import faults as faults_mod
from ..batch import PulsarBatch
from ..device import DeviceLike
from ..infer import model as infer_model
from ..obs import flightrec
from ..obs import metrics as obs_metrics
from ..obs import telemetry
from ..obs.memwatch import HbmSampler, PackedLedger
from ..obs.report import RunReport
from ..obs.timing import now
from ..ops import mcmc, woodbury
from ..parallel import pipeline as pipeline_mod
from ..parallel.mesh import PSR_AXIS, REAL_AXIS
from ..parallel.mesh import backend as mesh_backend
from ..parallel.mesh import make_mesh, process_count, process_index
from ..tune import defaults as tune_defaults
from ..utils import rng as rng_utils
from .model import SAMPLE_SCHEMA, SAMPLE_TAG, SWAP_TAG, as_spec, diagnostics

#: carry fields the checkpoint snapshot preserves (the JAX layout). The
#: cached likelihood / prior values and gradients are part of it: a 1-ULP
#: difference in a recomputed cached lnL flips Metropolis decisions, so a
#: resume carries the exact values
_SNAP_KEYS = ("z", "lnl", "glnl", "lnpri", "glnpri",
              "n", "npair", "prev_valid", "s1", "s2", "s11", "prev",
              "accept", "swap", "swap_att", "divergent", "nonfinite")
#: the cached-parts subset: a snapshot without them (a z-only warm start)
#: recomputes them against the current data
_PART_KEYS = ("lnl", "glnl", "lnpri", "glnpri")

#: (chain, temp, pulsar) rows per batched factorization group: every
#: group has exactly this many rows (the last one padded), so the library
#: Cholesky, the triangular solves and the reductions inside them see one
#: batch shape whatever the mesh (a library kernel may pick its algorithm
#: from the batch size). A run with fewer rows in all uses that count
ROW_GROUP = 800
#: the CPU's row block (:meth:`SamplingRun._vg`): SIMD loops round a
#: tensor's scalar tail apart from its vector lanes, so row counts padded
#: to whole blocks keep every row on the vector lanes; ROW_GROUP is a
#: multiple of it
_CPU_ROWS = 64


def f64_batch_views(batch) -> PulsarBatch:
    """The batch on the CPU with every float field in float64: the host
    staging math runs at full precision whatever the batch dtype."""
    return PulsarBatch.from_numpy(batch.numpy(), device="cpu",
                                  dtype=torch.float64)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def synthesize_residuals(compiled, batch, truth, data_seed,
                         nsb64=None) -> np.ndarray:
    """Self-consistent synthetic residuals drawn FROM the model at the
    truth point: white (+ ECORR epoch offsets) plus the model's GP
    components with prior variance ``phi(truth)``, the generative process
    the likelihood marginalizes. A host numpy draw from
    ``KeyStream(data_seed, "sample_data")``, draw for draw the JAX
    package's, so both packages sample the same data vector.
    """
    rng = rng_utils.KeyStream(data_seed, "sample_data").host_rng()
    ecorr_on = bool(np.any(_host(batch.ecorr_amp) > 0.0))
    if nsb64 is None:
        nsb64 = f64_batch_views(batch)
    basis = compiled.basis(nsb64).numpy()
    phi = compiled.phi(torch.as_tensor(np.asarray(truth, dtype=np.float64)),
                       nsb64).numpy()
    coef = rng.standard_normal(phi.shape) * np.sqrt(phi)
    res = np.einsum("ptm,pm->pt", basis, coef)
    sigma2 = _host(batch.sigma2).astype(np.float64)
    res += rng.standard_normal(sigma2.shape) * np.sqrt(sigma2)
    if ecorr_on:
        amp = _host(batch.ecorr_amp).astype(np.float64)
        idx = _host(batch.epoch_idx)
        eps = rng.standard_normal(amp.shape)
        res += amp * np.take_along_axis(eps, idx, axis=1)
    return res * _host(batch.mask)


def stage_moments(compiled, batch, residuals, nsb64=None):
    """Per-pulsar Woodbury moments ``(M, lndetN, n_valid, d0, dT)`` of ONE
    data vector, host float64, computed unsharded in one fixed order so the
    staged moments are identical on every mesh."""
    ecorr_on = bool(np.any(_host(batch.ecorr_amp) > 0.0))
    num_ep = batch.max_toa if ecorr_on else 0
    nsb = nsb64 if nsb64 is not None else f64_batch_views(batch)
    tmat = compiled.basis(nsb)
    fixed = woodbury.fixed_parts(tmat, nsb.sigma2, nsb.mask, nsb.epoch_idx,
                                 nsb.ecorr_amp, num_epochs=num_ep)
    resp = woodbury.res_parts(
        torch.as_tensor(np.asarray(residuals, dtype=np.float64)), tmat,
        nsb.sigma2, nsb.mask, nsb.epoch_idx, nsb.ecorr_amp,
        num_epochs=num_ep)
    m, lndet, nv, corr = woodbury.finish_fixed(fixed)
    d0, dt = woodbury.finish_res(resp, corr)
    return tuple(x.numpy() for x in (m, lndet, nv, d0, dt))


class SampleCheckpoint:
    """Append-only segment checkpoint for a sampling run (the JAX layout).

    ``<path>`` is the manifest (JSON, written last, atomically); thinned
    post-warmup draws append as ``<path>.s<k>.npz`` and the carry snapshot
    overwrites ``<path>.state.npz``. Every file lands through
    :func:`..utils.io.write_atomic` and the manifest records a CRC32 per
    kept segment and the snapshot. A torn or corrupt file found at resume is
    flight-recorded and the checkpoint discarded: the snapshot accumulates
    every earlier segment, so the only sound rollback is a restart from
    step 0, which reproduces the uninterrupted chains bit for bit
    (absolute-index keys). :meth:`save` is the ``ckpt.append`` chaos site:
    its ``"torn"`` action truncates the snapshot and raises
    :class:`..faults.KillFault`. A checkpoint the JAX package wrote
    resumes here and the other way round.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._sums: dict = {}       # "s<idx>"/"state" -> CRC32

    def _seg_path(self, idx: int) -> Path:
        return self.path.with_name(self.path.name + f".s{idx:05d}.npz")

    def _state_path(self) -> Path:
        return self.path.with_name(self.path.name + ".state.npz")

    def save(self, ident: dict, done: int, snapshot: dict, thinned):
        from ..utils.io import npz_bytes, write_atomic
        self.path.parent.mkdir(parents=True, exist_ok=True)
        act = faults_mod.check("ckpt.append", done=int(done))
        if thinned is not None:
            self._sums[f"s{done - 1:05d}"] = write_atomic(
                self._seg_path(done - 1), npz_bytes(thinned=thinned))
        self._sums["state"] = write_atomic(self._state_path(),
                                           npz_bytes(**snapshot))
        manifest = dict(ident, schema=SAMPLE_SCHEMA, done=int(done),
                        kept=sorted(int(p.name.rsplit(".s", 1)[1][:5])
                                    for p in self._glob_segs()),
                        sums=dict(self._sums))
        write_atomic(self.path, json.dumps(manifest).encode())
        if act == "torn":
            # chaos harness: the torn write fsync cannot prevent, then
            # process death; a resume must see the bad CRC and restart
            sp = self._state_path()
            data = sp.read_bytes()
            sp.write_bytes(data[:max(len(data) // 2, 1)])
            raise faults_mod.KillFault(
                f"injected torn sample-checkpoint write at segment "
                f"{done - 1}")

    def _glob_segs(self):
        return self.path.parent.glob(
            self.path.name + ".s" + "[0-9]" * 5 + ".npz")

    def _corrupt(self, what: str, exc) -> None:
        flightrec.note("ckpt_rollback", path=str(self.path), what=what,
                       error=repr(exc)[:200])
        self.delete()

    def load(self, ident: dict):
        if not self.path.exists():
            return None
        try:
            manifest = json.loads(self.path.read_text())
        except (OSError, ValueError) as exc:
            self._corrupt("manifest", exc)
            return None
        for k, v in ident.items():
            if manifest.get(k) != v:
                return None
        sums = manifest.get("sums", {})
        try:
            data = self._state_path().read_bytes()
            if "state" in sums and zlib.crc32(data) != int(sums["state"]):
                raise ValueError("state snapshot checksum mismatch "
                                 "(torn write)")
            snap = dict(np.load(io.BytesIO(data)))
            thinned = []
            for i in manifest["kept"]:
                data = self._seg_path(i).read_bytes()
                key = f"s{i:05d}"
                if key in sums and zlib.crc32(data) != int(sums[key]):
                    raise ValueError(f"segment {i} checksum mismatch "
                                     f"(torn write)")
                thinned.append(np.load(io.BytesIO(data))["thinned"])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as exc:
            self._corrupt("segments", exc)
            return None
        self._sums = {k: int(v) for k, v in sums.items()}
        return {"done": int(manifest["done"]), "snapshot": snap,
                "thinned": thinned}

    def delete(self):
        for p in list(self._glob_segs()) + [self._state_path(), self.path]:
            p.unlink(missing_ok=True)
        self._sums = {}


class _Cell:
    """One psr cell of a real row: its pulsars' staged moments and batch
    rows on its device, and its global pulsar offset."""

    def __init__(self, device, offset: int, batch, moments):
        self.device = device
        self.offset = offset
        self.batch = batch
        self.moments = moments
        self.npsr = batch.npsr


class SamplingRun:
    """Batched-MCMC posterior study over a PulsarBatch.

    ``spec`` is a :class:`.model.SampleSpec` (or a bare
    :class:`..infer.LikelihoodSpec` for the kernel defaults).
    ``residuals`` is the (P, T) data vector; omit it and the study
    synthesizes self-consistent data from the model at ``truth`` (box
    midpoints by default). ``moments``: an exact ``(M, lndetN, n_valid,
    d0, dT)`` 5-tuple instead (the factorized bin lanes' injected
    moments); the restage is then skipped. ``warm_from``: a previous
    run's :meth:`laplace_state` starts the Newton fit at its mode.

    ``mesh`` is the engine's (real, psr[, toa]) mesh: chains shard over
    'real', the per-pulsar likelihood over 'psr'. Without one the study
    runs on ``device``, which defaults to ``"cuda"`` and raises without a
    GPU unless ``device="cpu"``; pass one of the two. The chains run at
    the batch's dtype (float32, or float64 for a float64 batch).
    """

    def __init__(self, batch, spec, residuals=None, truth=None, mesh=None,
                 data_seed=0, warm_from=None, moments=None,
                 device: DeviceLike = None):
        if mesh is None:
            mesh = make_mesh(["cuda" if device is None else device])
        elif device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.spec = as_spec(spec)
        self.batch = batch
        self.compiled = infer_model.build(self.spec.model, batch)
        self.mesh = mesh
        self._n_real_shards = mesh.shape[REAL_AXIS]
        n_psr_shards = mesh.shape[PSR_AXIS]
        if self.spec.n_chains % self._n_real_shards != 0:
            raise ValueError(
                f"n_chains={self.spec.n_chains} must be divisible by the "
                f"real mesh axis ({self._n_real_shards})")
        if batch.npsr % n_psr_shards != 0:
            raise ValueError(
                f"npsr={batch.npsr} must be divisible by the psr mesh axis "
                f"({n_psr_shards}); pad the batch")
        self.device = mesh.local_device
        self._dtype = batch.t_own.dtype
        if truth is None:
            truth = self.compiled.theta_from_unit(
                np.full(self.compiled.D, 0.5))
        self.truth = np.asarray(truth, dtype=np.float64)
        if self.truth.shape != (self.compiled.D,):
            raise ValueError(f"truth must be a ({self.compiled.D},) vector "
                             f"for {list(self.compiled.param_names)}")

        # --- one-off host-f64 staging: data -> Woodbury moments -> Laplace
        self._nsb64 = f64_batch_views(batch)
        if moments is not None:
            self._mom64 = tuple(np.asarray(_host(m), dtype=np.float64)
                                for m in moments)
            if len(self._mom64) != 5:
                raise ValueError("moments must be the 5-tuple "
                                 "(M, lndetN, n_valid, d0, dT)")
            ncols = self.compiled.ncols
            if self._mom64[0].shape[-2:] != (ncols, ncols):
                raise ValueError(
                    f"moments M has trailing shape "
                    f"{self._mom64[0].shape[-2:]}; this model stages "
                    f"({ncols}, {ncols})")
            self.residuals = (None if residuals is None
                              else np.asarray(residuals, dtype=np.float64))
        else:
            if residuals is None:
                residuals = synthesize_residuals(
                    self.compiled, batch, self.truth, data_seed,
                    nsb64=self._nsb64)
            residuals = np.asarray(residuals, dtype=np.float64)
            if residuals.shape != tuple(batch.t_own.shape):
                raise ValueError(f"residuals shape {residuals.shape} != "
                                 f"batch {tuple(batch.t_own.shape)}")
            self.residuals = residuals
            self._mom64 = stage_moments(self.compiled, batch, residuals,
                                        nsb64=self._nsb64)
        v0 = None
        if warm_from is not None:
            v0 = np.asarray(warm_from["mode_v"], dtype=np.float64)
            if v0.shape != (self.compiled.D,):
                raise ValueError(
                    f"warm_from mode_v has shape {v0.shape}; this model "
                    f"has D={self.compiled.D}")
        self._fit_laplace(v0=v0)
        self._stage_device()
        #: no program is compiled at run time, so nothing retraces; kept
        #: for the JAX facade's attribute
        self.retraces = 0
        self.last_report = None
        self.last_result = None
        self.last_z = None

    # ------------------------------------------------------------------
    # host-f64 staging
    # ------------------------------------------------------------------
    def _lnpost64(self, v: torch.Tensor) -> torch.Tensor:
        """float64 unconstrained log posterior (the warm-start objective)."""
        m, lndet, nv, d0, dt = self._mom64_t
        theta = infer_model.box_from_unconstrained(v, self.compiled.bounds)
        phi = self.compiled.phi(theta, self._nsb64)
        lnl = torch.sum(woodbury.lnlike_from_moments(d0, dt, m, lndet, nv,
                                                     phi))
        return lnl + infer_model.box_unconstrained_log_prior(v)

    def lnpost_unconstrained(self, v) -> float:
        """The warm-start objective at ``v`` (host float64)."""
        self._host_tensors()
        return float(self._lnpost64(torch.as_tensor(
            np.asarray(v, dtype=np.float64))))

    def lnpost_grad(self, v) -> np.ndarray:
        self._host_tensors()
        return torch.func.grad(self._lnpost64)(torch.as_tensor(
            np.asarray(v, dtype=np.float64))).numpy()

    def _host_tensors(self) -> None:
        self._mom64_t = tuple(torch.as_tensor(m) for m in self._mom64)

    def _hessian(self, v) -> np.ndarray:
        """The warm-start objective's Hessian at ``v`` (host float64) in
        closed form: the Woodbury identities in ln phi
        (:func:`..ops.woodbury.lnlike_lnphi`) carried to v through the
        ``torch.func.jacfwd`` Jacobian and second derivatives of ``ln
        phi(v)`` (cheap: elementwise spectra), plus the box prior's.
        ``torch.func.hessian`` of :meth:`_lnpost64` gives the same to
        roundoff at ~20 objective evaluations (tens of seconds at 100
        pulsars x 320 columns on 8 host cores); this costs ~4."""
        from torch.func import jacfwd
        m, lndet, nv, d0, dt = self._mom64_t
        compiled, nsb = self.compiled, self._nsb64
        vt = torch.as_tensor(np.asarray(v, dtype=np.float64))
        floor = woodbury._phi_floor(torch.float64)

        def lnphi(x):
            th = infer_model.box_from_unconstrained(x, compiled.bounds)
            return torch.log(torch.clamp(compiled.phi(th, nsb), min=floor))

        _, g, h = woodbury.lnlike_lnphi(m, torch.exp(lnphi(vt)), d0, dt,
                                        lndet, nv, order=2)
        jac = jacfwd(lnphi)(vt)                          # (P, 2M, D)
        jac2 = jacfwd(jacfwd(lnphi))(vt)                 # (P, 2M, D, D)
        sig = torch.sigmoid(vt)
        hess = (torch.einsum("pmd,pmn,pne->de", jac, h, jac)
                + torch.einsum("pm,pmde->de", g, jac2)
                - torch.diag(2.0 * sig * (1.0 - sig)))
        return hess.numpy()

    def _fit_laplace(self, max_iter: int = 60, v0=None):
        """Damped-Newton mode fit + Laplace factor: chains start at ``mode
        + C z, z ~ N(0, I)`` and the HMC kernel runs in the C-whitened
        space (``C C^T = (-H)^{-1}``). ``v0`` starts the Newton iteration
        from a previous mode. Host float64, as the JAX package stages on
        its host CPU: its ``jax.grad`` is ``torch.func.grad``, its
        ``jax.hessian`` the closed form of :meth:`_hessian`."""
        d = self.compiled.D
        self._host_tensors()
        grad_fn = torch.func.grad(self._lnpost64)

        def f_of(x):
            return float(self._lnpost64(torch.as_tensor(x)))

        v = np.zeros(d) if v0 is None else np.array(v0, dtype=float)
        f = f_of(v)
        self.laplace_iters = 0
        for _ in range(max_iter):
            self.laplace_iters += 1
            g = grad_fn(torch.as_tensor(v)).numpy()
            a = -self._hessian(v)
            ridge = 1e-10 * max(float(np.trace(a)) / d, 1.0)
            while True:
                try:
                    np.linalg.cholesky(a + ridge * np.eye(d))
                    break
                except np.linalg.LinAlgError:
                    ridge *= 10.0
            delta = np.linalg.solve(a + ridge * np.eye(d), g)
            step = 1.0
            for _ in range(30):
                f_new = f_of(v + step * delta)
                if np.isfinite(f_new) and f_new >= f:
                    break
                step *= 0.5
            v = v + step * delta
            moved = float(np.linalg.norm(step * delta))
            converged = abs(f_new - f) <= 1e-9 * (1.0 + abs(f))
            f = f_new
            if converged and moved < 1e-6:
                break
        a = -self._hessian(v)
        ridge = 0.0
        while True:
            try:
                chol_a = np.linalg.cholesky(
                    a + (ridge * np.eye(d) if ridge else 0.0))
                break
            except np.linalg.LinAlgError:
                ridge = max(ridge * 10.0, 1e-8 * abs(np.trace(a)) / d)
        linv = torch.linalg.solve_triangular(
            torch.as_tensor(chol_a), torch.eye(d, dtype=torch.float64),
            upper=False).numpy()
        self.mode_v = v                        # (D,) unconstrained mode
        self.chol_cov = linv.T                 # C with C C^T = (-H)^{-1}
        self.mode_theta = np.asarray(
            self.compiled.theta_from_unit(1 / (1 + np.exp(-v))))

    def laplace_state(self) -> dict:
        """The Laplace fit as a plain dict, a new run's ``warm_from=``
        (either package's)."""
        return {"mode_v": np.array(self.mode_v),
                "chol_cov": np.array(self.chol_cov)}

    def _stage_device(self) -> None:
        """The staged moments on each psr cell's device and the Laplace
        preconditioner on each real row's device, at the batch dtype."""
        dt = self._dtype
        n_psr = self.mesh.shape[PSR_AXIS]
        p_local = self.batch.npsr // n_psr
        made, self._cells, self._rows, self._comms = {}, [], [], []
        for r in range(self._n_real_shards):
            cells = []
            self._comms.append(self.mesh.comm([(r, s, 0)
                                               for s in range(n_psr)]))
            for s in range(n_psr):
                dev = self.mesh.devices[r, s, 0]
                if not self.mesh.owns((r, s, 0)):
                    cells.append(None)      # another rank's cell
                    continue
                if (s, dev) not in made:
                    lo = s * p_local
                    batch = PulsarBatch(**{
                        name: (x if name == "tspan_common"
                               else x.narrow(0, lo, p_local)).to(dev)
                        for name, x in vars(self.batch).items()})
                    mom = tuple(torch.as_tensor(
                        m[lo:lo + p_local]).to(dtype=dt, device=dev)
                        for m in self._mom64)
                    made[(s, dev)] = _Cell(dev, lo, batch, mom)
                cells.append(made[(s, dev)])
            self._cells.append(cells)
            if not any(cells):
                self._rows.append(None)     # another rank's row
                continue
            dev = next(c.device for c in cells if c is not None)
            self._rows.append({
                "device": dev,
                "mode_v": torch.as_tensor(self.mode_v).to(dt).to(dev),
                "chol_cov_t": torch.as_tensor(
                    self.chol_cov.T.copy()).to(dt).to(dev),
                "chol_cov": torch.as_tensor(self.chol_cov).to(dt).to(dev),
                "bounds": torch.as_tensor(np.asarray(
                    self.compiled.bounds)).to(dt).to(dev)})
            # the tempering ladder and per-rung step sizes, staged once
            # (a host value copied into a segment would sync with it)
            row = self._rows[-1]
            row["betas"] = mcmc.geometric_betas(
                self.spec.n_temps, self.spec.max_temp, dt, dev)
            row["eps"] = torch.full((), self.spec.step_size, dtype=dt,
                                    device=dev) / torch.sqrt(row["betas"])
        # the whole run's preconditioner on this rank's first device (the
        # thinned draws' map; a rank may hold no row)
        self._head = {
            "mode_v": torch.as_tensor(self.mode_v).to(dt).to(self.device),
            "chol_cov_t": torch.as_tensor(
                self.chol_cov.T.copy()).to(dt).to(self.device),
            "bounds": torch.as_tensor(np.asarray(
                self.compiled.bounds)).to(dt).to(self.device)}
        spec = self.spec
        rows = spec.n_chains * spec.n_temps * self.batch.npsr
        self._group = min(ROW_GROUP, rows + (-rows) % _CPU_ROWS)

    def restage(self, residuals=None, moments=None) -> None:
        """Swap the data under the chains: exactly one of ``residuals``
        (a (P, T) vector, restaged host float64) or ``moments`` (an exact
        5-tuple). The Laplace fit re-runs warm from the previous mode."""
        if (residuals is None) == (moments is None):
            raise ValueError("restage() takes exactly one of residuals= "
                             "or moments=")
        if moments is not None:
            self._mom64 = tuple(np.asarray(_host(m), dtype=np.float64)
                                for m in moments)
        else:
            residuals = np.asarray(residuals, dtype=np.float64)
            if residuals.shape != tuple(self.batch.t_own.shape):
                raise ValueError(
                    f"residuals shape {residuals.shape} != batch "
                    f"{tuple(self.batch.t_own.shape)}")
            self.residuals = residuals
            self._mom64 = stage_moments(self.compiled, self.batch,
                                        residuals, nsb64=self._nsb64)
        self._fit_laplace(v0=self.mode_v)
        self._stage_device()

    # ------------------------------------------------------------------
    # the likelihood rows and the segment
    # ------------------------------------------------------------------
    def _pulsar_rows(self, cell: _Cell, flat_v: torch.Tensor, bounds,
                     x_count: int):
        """(lnL (X, P_l), gradient in v (X, P_l, D)) of one psr cell's
        pulsars at the first ``x_count`` of the unconstrained points
        ``flat_v`` (the rest CPU padding), computed in row groups of
        exactly ``self._group`` (chain, temp, pulsar) rows."""
        from torch.func import jacfwd, vmap

        compiled, off = self.compiled, cell.offset
        floor = woodbury._phi_floor(flat_v.dtype)

        def lnphi_aux(vv):
            p = compiled.phi(infer_model.box_from_unconstrained(vv, bounds),
                             cell.batch, off)
            return torch.log(torch.clamp(p, min=floor)), p

        dpsi, phi = vmap(jacfwd(lnphi_aux, has_aux=True))(flat_v)
        dpsi, phi = dpsi[:x_count], phi[:x_count]
        _, p_l, m2 = phi.shape
        d = flat_v.shape[-1]
        rows = x_count * p_l
        g = self._group
        n_groups = -(-rows // g)
        idx = torch.arange(n_groups * g, device=flat_v.device)
        idx = torch.where(idx < rows, idx, torch.zeros_like(idx))
        phi_r = phi.reshape(rows, m2)
        dpsi_r = dpsi.reshape(rows, m2, d)
        m, lndet, nv, d0, dt = cell.moments
        lnl_out, grad_out = [], []
        for k in range(n_groups):
            sel = idx[k * g:(k + 1) * g]
            psel = sel % p_l
            lnl_g, gpsi = woodbury.lnlike_lnphi(
                m[psel], phi_r[sel], d0[psel], dt[psel], lndet[psel],
                nv[psel], order=1)
            lnl_out.append(lnl_g)
            grad_out.append(mcmc.fixed_sum(gpsi[:, :, None] * dpsi_r[sel],
                                           dim=1))
        lnl = torch.cat(lnl_out)[:rows].reshape(x_count, p_l)
        grad = torch.cat(grad_out)[:rows].reshape(x_count, p_l, d)
        return lnl, grad

    def _vg(self, r: int):
        """The (C, T, D) whitened positions -> (lnl, glnl, lnpri, glnpri)
        function of real row ``r`` (on its first device)."""
        row, cells = self._rows[r], self._cells[r]
        dev, d = row["device"], self.compiled.D

        def vg(zz):
            flat_z = zz.reshape(-1, d)
            x_count = flat_z.shape[0]
            if dev.type == "cpu":
                # the CPU's SIMD loops round a tensor's scalar tail apart
                # from its vector lanes: padded to whole 64-row blocks,
                # every row of every op below takes the vector lanes, so
                # its bits do not depend on how many chains the row holds
                flat_z = torch.nn.functional.pad(
                    flat_z, (0, 0, 0, (-x_count) % _CPU_ROWS))
            v = row["mode_v"] + mcmc.fixed_matvec(flat_z, row["chol_cov_t"])
            lnpri = infer_model.box_unconstrained_log_prior(v)[:x_count]
            glnpri = mcmc.fixed_matvec(
                infer_model.box_unconstrained_log_prior_grad(v),
                row["chol_cov"])[:x_count]
            lnl_rows, grad_rows = [], []
            for cell in cells:
                if cell is None:
                    lnl_rows.append(None)
                    grad_rows.append(None)
                    continue
                lnl_c, grad_c = self._pulsar_rows(
                    cell, v.to(cell.device), row["bounds"].to(cell.device),
                    x_count)
                lnl_rows.append(lnl_c.to(dev))
                grad_rows.append(grad_c.to(dev))
            # the gather over 'psr' in pulsar order, then one fixed-order
            # sum: the chain loop's only collective
            comm = self._comms[r]
            lnl_all = next(x for x in comm.all_gather(lnl_rows, dim=1)
                           if x is not None)
            grad_all = next(x for x in comm.all_gather(grad_rows, dim=1)
                            if x is not None)
            lnl = mcmc.fixed_sum(lnl_all, dim=1)
            glnl = mcmc.fixed_matvec(mcmc.fixed_sum(grad_all, dim=1),
                                     row["chol_cov"])
            return (lnl.reshape(zz.shape[:-1]), glnl.reshape(zz.shape),
                    lnpri.reshape(zz.shape[:-1]),
                    glnpri.reshape(zz.shape))

        return vg

    def _row_chains(self, r: int) -> slice:
        kl = self.spec.n_chains // self._n_real_shards
        return slice(r * kl, (r + 1) * kl)

    def _gather(self, blocks, like: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
        """The real rows' blocks concatenated along ``dim`` in row order on
        this rank's first device; across ranks (None for another rank's
        row) through :meth:`..parallel.mesh.Mesh.gather_real`, at
        ``like``'s shape and dtype (one row's block, which a rank that
        holds no row cannot take from its own)."""
        if not self.mesh.multiprocess:
            return torch.cat([x.to(self.device) for x in blocks], dim=dim)
        like = like.movedim(dim, 0)
        got = self.mesh.gather_real(
            [None if x is None else x.movedim(dim, 0) for x in blocks],
            like.shape, like.dtype, self.device)
        return got.movedim(0, dim).contiguous()

    def _refresh(self, z: torch.Tensor) -> dict:
        """The cached parts (lnl, glnl, lnpri, glnpri) of positions ``z``
        (K, T, D), row by row, on this rank's first device."""
        parts = []
        for r in range(self._n_real_shards):
            if self._rows[r] is None:
                parts.append([None] * len(_PART_KEYS))
                continue
            zr = z[self._row_chains(r)].to(self._rows[r]["device"])
            parts.append([p.to(self.device) for p in self._vg(r)(zr)])
        # lnl / lnpri per (chain, rung); their gradients per coordinate
        z0 = z[self._row_chains(0)]
        likes = (z0[..., 0], z0, z0[..., 0], z0)
        return {k: self._gather([p[i] for p in parts], likes[i])
                for i, k in enumerate(_PART_KEYS)}

    def _transition_draws(self, base_key: torch.Tensor, seg_start: int,
                          seg_steps: int):
        """``(step keys (S, 2), momenta (S, K, T, D), ln u (S, K, T))`` of
        a segment's steps for every chain and rung, on the first device."""
        dev0 = self.device
        steps = torch.arange(seg_start, seg_start + seg_steps, device=dev0)
        cg = torch.arange(self.spec.n_chains, device=dev0)
        t_idx = torch.arange(self.spec.n_temps, device=dev0)
        sk = rng_utils.fold_in(rng_utils.fold_in(base_key.to(dev0),
                                                 SAMPLE_TAG), steps)
        keys = rng_utils.fold_in(
            rng_utils.fold_in(sk[:, None, :], cg)[:, :, None, :], t_idx)
        return (sk, *mcmc.transition_draws(keys, self.compiled.D,
                                           self._dtype))

    def _segment(self, state: dict, base_key: torch.Tensor, seg_start: int,
                 seg_steps: int, warmup: int):
        """One segment of ``seg_steps`` steps from ``state`` (every field
        on the mesh's first device): ``(new state, thinned (n_out, K, D))``.
        Enqueues its work without a host sync; no tensor of ``state`` is
        written.

        The segment's draws (for every chain, from its keys) and the
        thinned draws with their accumulators are computed on whole-run
        (K-chain) tensors on the first device, the transitions per real
        row: so every op whose rounding could depend on a tensor's size
        sees one size on every mesh."""
        spec = self.spec
        t_count, thin, dt = spec.n_temps, spec.thin, self._dtype
        n_out = seg_steps // thin
        dev0 = self.device
        head = self._head
        # every draw of the segment, from its keys, at its start
        cg = torch.arange(spec.n_chains, device=dev0)
        t_idx0 = torch.arange(t_count, device=dev0)
        sk, mom_all, lnu_all = self._transition_draws(base_key, seg_start,
                                                      seg_steps)
        us_all = None
        if t_count > 1:
            skeys = rng_utils.fold_in(
                rng_utils.fold_in(sk, SWAP_TAG)[:, None, :], cg)
            us_all = rng_utils.uniform(skeys, (t_count,), dtype=dt)

        rows_out, inc, cold = [], [], []
        for r in range(self._n_real_shards):
            if self._rows[r] is None:
                rows_out.append(None)   # another rank's row
                inc.append(None)
                cold.append(None)
                continue
            dev = self._rows[r]["device"]
            ch = self._row_chains(r)
            kl = ch.stop - ch.start
            vg = self._vg(r)
            betas, eps = self._rows[r]["betas"], self._rows[r]["eps"]
            t_idx = t_idx0.to(dev)
            mom = mom_all[:, ch].to(dev)
            lnu = lnu_all[:, ch].to(dev)
            us = None if us_all is None else us_all[:, ch].to(dev)
            z = state["z"][ch].to(dev)
            parts = tuple(state[k][ch].to(dev) for k in _PART_KEYS)
            accept = torch.zeros((t_count,), dtype=torch.int32, device=dev)
            swap = torch.zeros_like(accept)
            swap_att = torch.zeros_like(accept)
            divergent = torch.zeros((), dtype=torch.int32, device=dev)
            nonfinite = torch.zeros_like(divergent)
            z_cold = []
            for s_loc in range(seg_steps):
                abs_step = seg_start + s_loc
                z, parts, ok, div = mcmc.hmc_step(
                    mom[s_loc], lnu[s_loc], z, parts, vg, betas, eps,
                    spec.n_leapfrog, spec.max_energy_error)
                accept = accept + torch.sum(ok, dim=0, dtype=torch.int32)
                divergent = divergent + torch.sum(div, dtype=torch.int32)
                nonfinite = nonfinite + torch.sum(
                    ~torch.isfinite(parts[0]), dtype=torch.int32)
                if t_count > 1 and (abs_step % spec.swap_every
                                    == spec.swap_every - 1):
                    parity = (abs_step // spec.swap_every) % 2
                    perm = mcmc.swap_from_uniforms(us[s_loc], parts[0],
                                                   betas, parity)
                    z, *parts = mcmc.apply_permutation(perm, z, *parts)
                    parts = tuple(parts)
                    swap = swap + torch.sum(perm == (t_idx[None] + 1),
                                            dim=0, dtype=torch.int32)
                    swap_att = swap_att + torch.where(
                        ((t_idx % 2) == parity) & (t_idx < t_count - 1),
                        kl, 0).to(torch.int32)
                if (s_loc + 1) % thin == 0:
                    z_cold.append(z[:, 0, :])
            rows_out.append((z, parts))
            cold.append(torch.stack(z_cold).to(dev0))
            inc.append((accept, swap, swap_att, divergent, nonfinite))

        def field(get):
            return [None if o is None else get(o) for o in rows_out]

        ch0 = self._row_chains(0)
        new = {"z": self._gather(field(lambda o: o[0]), state["z"][ch0])}
        for i, k in enumerate(_PART_KEYS):
            new[k] = self._gather(field(lambda o, i=i: o[1][i]),
                                  state[k][ch0])
        # the counters' increments, added over the real rows in row order
        for i, k in enumerate(("accept", "swap", "swap_att", "divergent",
                               "nonfinite")):
            total = state[k]
            parts = self._gather([None if p is None else p[i][None]
                                  for p in inc], state[k][None])
            for part in parts:
                total = total + part
            new[k] = total
        # the thinned cold-chain draws and their accumulators, in emit
        # order (a warm-up emit adds nothing)
        cold_like = state["z"][ch0][:, 0, :].expand(n_out, -1, -1)
        thinned = infer_model.box_from_unconstrained(
            head["mode_v"] + mcmc.fixed_matvec(
                self._gather(cold, cold_like, dim=1), head["chol_cov_t"]),
            head["bounds"])
        acc = {k: state[k] for k in ("n", "npair", "prev_valid", "s1", "s2",
                                     "s11", "prev")}
        for j in range(n_out):
            if seg_start + (j + 1) * thin - 1 < warmup:
                continue
            theta, pair_w = thinned[j], acc["prev_valid"]
            acc = dict(
                n=acc["n"] + 1,
                npair=acc["npair"] + (pair_w > 0).to(torch.int32),
                s1=acc["s1"] + theta,
                s2=acc["s2"] + theta * theta,
                s11=acc["s11"] + pair_w * theta * acc["prev"],
                prev=theta,
                prev_valid=torch.clamp(acc["prev_valid"], min=1.0))
        new.update(acc)
        return new, thinned

    # ------------------------------------------------------------------
    # state construction / resume
    # ------------------------------------------------------------------
    def _np_dtype(self):
        return torch.empty((), dtype=self._dtype).numpy().dtype

    def _zero_accum_host(self):
        spec, d = self.spec, self.compiled.D
        k, t = spec.n_chains, spec.n_temps
        dt = self._np_dtype()
        return dict(n=np.zeros((), np.int32), npair=np.zeros((), np.int32),
                    prev_valid=np.zeros((), dt),
                    s1=np.zeros((k, d), dt), s2=np.zeros((k, d), dt),
                    s11=np.zeros((k, d), dt), prev=np.zeros((k, d), dt),
                    accept=np.zeros((t,), np.int32),
                    swap=np.zeros((t,), np.int32),
                    swap_att=np.zeros((t,), np.int32),
                    divergent=np.zeros((), np.int32),
                    nonfinite=np.zeros((), np.int32))

    def _init_state(self, seed, snapshot=None) -> dict:
        """Device state from the Laplace warm start (z from the host draw
        ``KeyStream(seed, "sample_init")``, identical on every mesh and in
        both packages) or from a checkpoint snapshot, whose cached parts
        are taken as they are (bit-exact resume); a snapshot without them
        recomputes them."""
        spec, d = self.spec, self.compiled.D
        k, t = spec.n_chains, spec.n_temps
        if snapshot is None:
            rng = rng_utils.KeyStream(seed, "sample_init").host_rng()
            host = dict(self._zero_accum_host(),
                        z=rng.standard_normal((k, t, d)).astype(
                            self._np_dtype()))
        else:
            host = {k2: np.asarray(v) for k2, v in snapshot.items()}
        state = {k2: torch.as_tensor(np.array(v)).to(self.device)
                 for k2, v in host.items() if k2 in _SNAP_KEYS}
        if any(k2 not in state for k2 in _PART_KEYS):
            state.update(self._refresh(state["z"]))
        return state

    def _normalize(self, n_steps: int, segment):
        thin = self.spec.thin
        if segment is None:
            segment = min(max(n_steps, thin), 256)
        segment = max(int(segment), thin)
        segment += (-segment) % thin
        warmup = self.spec.warmup
        warmup_n = ((warmup + segment - 1) // segment) * segment \
            if warmup else 0
        post_n = ((int(n_steps) + segment - 1) // segment) * segment
        return segment, warmup_n, post_n

    def warm_start(self, n_steps: int = 256, segment=None) -> float:
        """Make the first :meth:`run` of this segment shape start warm;
        returns the seconds spent. The JAX method compiles the segment
        program into XLA's persistent cache; the port compiles nothing, so
        this draws one segment's transition draws at the run's shapes from
        a fixed key and runs one gradient evaluation of every chain at
        them, synchronized and discarded: that primes the cuBLAS / cuSOLVER
        handles and the caching allocator. Its events go to a throwaway
        collector and it touches no chain stream, so a later run's draws
        are bit-identical to a cold one's. On a multi-process mesh every
        rank calls it (the evaluation gathers across ranks)."""
        t0 = now()
        segment, _, _ = self._normalize(n_steps, segment)
        spec = self.spec
        with obs_metrics.collect(obs_metrics.Collector()):
            # a fixed key: the warm-up's draws are discarded, its kernels kept
            # fakepta: allow[rng-discipline] warm-up draws, discarded
            self._transition_draws(rng_utils.key(0, device=self.device), 0,
                                   segment)
            self._refresh(torch.zeros(
                (spec.n_chains, spec.n_temps, self.compiled.D),
                dtype=self._dtype, device=self.device))
            for dev in {dv for dv in self.mesh.local_devices
                        if dv.type == "cuda"}:
                # the timed warm-up includes the card's work
                # fakepta: allow[host-sync-in-jit] one barrier per card
                torch.cuda.synchronize(dev)
        return now() - t0

    # ------------------------------------------------------------------
    # the run loop (mirrors EnsembleSimulator.run's pipeline structure)
    # ------------------------------------------------------------------
    def run(self, n_steps: int, seed=0, segment=None, checkpoint=None,
            pipeline_depth=None, progress=None, eventlog=None,
            recovery=None, tuned: bool = False, on_segment=None,
            init_z=None) -> dict:
        """Run ``n_steps`` post-warmup MCMC steps (plus the spec's warmup).

        One segment of ``segment`` steps (HMC, tempering swaps, thinning,
        accumulators) is dispatched at a time, and its thinned draws and
        state snapshot drain through the writer thread
        (``pipeline_depth`` segments in flight, default 2; 0 is the serial
        loop). ``checkpoint``: a path for segment-boundary resume,
        bit-identical to the uninterrupted chains (an integer seed is
        required). Returns ``theta`` (S, K, D) thinned post-warmup draws,
        ``diag`` (R-hat / ESS / acceptance from the accumulators), a flat
        ``summary`` and ``report`` (a :class:`..obs.report.RunReport`),
        the JAX result's keys.

        ``recovery`` (:class:`..faults.RecoveryPolicy`; ``None`` the
        default policy, ``False`` disabled): a transient segment dispatch
        or drain failure (the ``sample.segment`` / ``pipeline.writer``
        sites, a CUDA out-of-memory error) retries with bounded backoff;
        a segment is a pure function of ``(base key, seg_start, state)``
        and the state is never written in place, so the retry is
        bit-identical. ``watchdog_s`` bounds the wait for the oldest
        in-flight drain and the final flush. Non-finite thinned draws
        abort loudly before the checkpoint takes them; a torn checkpoint
        found at resume restarts from step 0.

        ``on_segment(idx, thinned)`` receives each post-warmup segment's
        draws as it drains (on the writer thread, before the checkpoint
        append). ``init_z`` seeds the chains' whitened positions (a
        (K, T, D) array) instead of the Laplace draw; a checkpoint resume
        wins over it. ``progress(done_steps, total_steps)`` after each
        segment; an exception it raises ends the run.

        ``eventlog``: a directory; after the run each process writes its
        report there as ``events-p<process_index:03d>.jsonl`` (merge the
        shards with ``python -m fakepta_tpu_torch.obs trace``).

        ``tuned=True`` takes the pipeline depth, a platform-shaped knob,
        from the newest tuner store entry for this mesh's devices
        (``tune.resolve_platform_knob``) when the caller gave none; an
        explicit ``pipeline_depth`` always wins. The applied knob lands in
        ``meta["tuned"]``.
        """
        policy = faults_mod.as_policy(recovery)
        multi = self.mesh.multiprocess
        rank, n_proc = process_index(), process_count()
        t_run0 = now()
        collector = obs_metrics.Collector()
        tuned_applied = None
        if tuned and pipeline_depth is None:
            from .. import tune as tune_mod
            from ..tune.search import mesh_entries
            depth_t = tune_mod.resolve_platform_knob(
                "pipeline_depth", devices=mesh_entries(self.mesh))
            if depth_t is not None:
                pipeline_depth = int(depth_t)
                tuned_applied = {"pipeline_depth": pipeline_depth}
        if pipeline_depth is None:
            pipeline_depth = tune_defaults.DEFAULT_PIPELINE_DEPTH
        spec, compiled = self.spec, self.compiled
        k, t_count, d = spec.n_chains, spec.n_temps, compiled.D
        segment, warmup_n, post_n = self._normalize(n_steps, segment)
        total_steps = warmup_n + post_n
        n_segments = total_steps // segment
        warm_segments = warmup_n // segment
        n_out = segment // spec.thin
        if isinstance(seed, (int, np.integer)):
            base = rng_utils.key(int(seed), device=self.device)
        else:
            base = rng_utils.as_key(seed).to(self.device)

        ident = {"seed": int(seed) if isinstance(seed, (int, np.integer))
                 else None, "n_chains": k, "n_temps": t_count, "d": d,
                 "segment": segment, "warmup": warmup_n,
                 "total_steps": total_steps, "thin": spec.thin}
        ckpt = None
        done_segments = 0
        out: list = []
        snapshot0 = None
        if checkpoint is not None:
            if not isinstance(seed, (int, np.integer)):
                raise TypeError("checkpointing requires an integer seed")
            ckpt = SampleCheckpoint(checkpoint)
            resume = ckpt.load(ident)
            if resume is not None:
                done_segments = resume["done"]
                snapshot0 = resume["snapshot"]
                out = list(resume["thinned"])
        if snapshot0 is None and init_z is not None:
            z0 = np.asarray(init_z, dtype=self._np_dtype())
            if z0.shape != (k, t_count, d):
                raise ValueError(f"init_z must have shape "
                                 f"({k}, {t_count}, {d}); got {z0.shape}")
            snapshot0 = dict(self._zero_accum_host(), z=z0)
        state = self._init_state(seed, snapshot0)

        depth = max(int(pipeline_depth), 0)
        # a multi-process run drains serially, as the JAX sampler does
        pipelined = depth > 0 and n_proc == 1
        ring_size = max(depth, 1)
        # maxlen pins the depth bound (the loop pops the oldest before
        # every append at capacity, so the cap is never exercised)
        ring: collections.deque = collections.deque(maxlen=ring_size)
        on_card = self.device.type == "cuda"
        compute = torch.cuda.current_stream(self.device) if on_card else None
        copy_stream = (torch.cuda.Stream(self.device)
                       if on_card and pipelined else None)
        meta = {
            "kind": "sample",
            # chain transitions play the role of realizations in the
            # report's throughput derivations (steps x chains x rungs)
            "nreal": int(total_steps * k * t_count),
            "chunk": int(segment * k * t_count),
            "platform": "gpu" if on_card else "cpu",
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if on_card else "cpu"),
            "n_devices": len(set(zip(self.mesh.ranks.flat,
                                     self.mesh.devices.flat))),
            "mesh_shape": {a: int(v) for a, v in self.mesh.shape.items()},
            "npsr": int(self.batch.npsr),
            "pipeline_depth": int(depth),
            "process_index": rank, "process_count": n_proc,
            "backend": mesh_backend(),
            "sample": {"k": k, "t": t_count, "d": d,
                       "steps": int(total_steps), "warmup": int(warmup_n),
                       "thin": int(spec.thin), "segment": int(segment),
                       "n_leapfrog": int(spec.n_leapfrog),
                       "step_size": float(spec.step_size),
                       "params": list(compiled.param_names)},
        }
        if isinstance(seed, (int, np.integer)):
            meta["seed"] = int(seed)
        if tuned_applied is not None:
            meta["tuned"] = {"knobs": dict(tuned_applied)}

        timeline: list = []
        seg_records: list = []
        ledger = PackedLedger(int(n_out) * k * d * self._np_dtype().itemsize,
                              ring_size, pipelined)
        sampler = HbmSampler(self.mesh.local_devices)
        sampler.start()
        flightrec.note("run_start", spec_hash=flightrec.spec_hash(meta),
                       steps=int(total_steps), segment=int(segment),
                       depth=int(depth), resume_done=int(done_segments))
        writer = pipeline_mod.make_writer(pipelined)

        def seg_dispatch_recover(seg_idx, state):
            """One segment under the recovery policy: transient failures
            retry with bounded backoff on the intact state (bit-identical
            to the unfaulted run); a ``"poison"`` action NaNs the thinned
            draws, which the drain's finite guard must abort on."""
            attempts, delay = 0, policy.backoff_s
            while True:
                try:
                    act = faults_mod.check("sample.segment", idx=seg_idx)
                    new, thinned = self._segment(
                        state, base, seg_idx * segment, segment, warmup_n)
                    if act == "poison":
                        thinned = thinned * float("nan")
                    return new, thinned
                except Exception as exc:  # noqa: BLE001 — triaged below;
                    # unrecognized failures re-raise unchanged; across
                    # ranks nothing is retried on one rank alone
                    if (multi or faults_mod.classify(exc) != "transient"
                            or attempts >= policy.max_retries):
                        raise
                    attempts += 1
                    if faults_mod.is_oom(exc) and on_card:
                        torch.cuda.empty_cache()
                    collector.count("faults.retries")
                    flightrec.note("segment_retry", idx=seg_idx,
                                   attempt=attempts, error=repr(exc)[:200])
                    timeline.append({"name": "retry", "tid": "main",
                                     "t0": now() - t_run0, "dur": delay,
                                     "chunk": seg_idx, "attempt": attempts})
                    faults_mod.sleep(delay)
                    delay = policy.next_backoff(delay)

        def drain(job: dict) -> None:
            """Writer-thread completion work for ONE segment: its thinned
            draws on the host, the finite guard, ``on_segment``, the
            checkpoint append, the progress call (a transient failure
            retries in place: every step is idempotent). Sets the
            segment's drained event even when it fails."""
            rec, idx = job["rec"], job["rec"]["idx"]
            t_d0 = now()
            t_ready = None

            def body() -> None:
                nonlocal t_ready
                # chaos site: the writer-thread drain
                faults_mod.check("pipeline.writer", idx=idx)
                if pipelined:
                    arr = pipeline_mod.materialize_copy(job["host"],
                                                        job["copied"])
                else:
                    arr = job["thinned"].cpu().numpy()
                t_ready = now()
                if not np.all(np.isfinite(arr)):
                    flightrec.note("nan_lnl_abort", segment=idx)
                    raise FloatingPointError(
                        f"sampling segment {idx} produced non-finite chain "
                        f"draws (nan-lnL); see the flight-recorder dump")
                out[job["slot"]] = arr if job["post"] else None
                if on_segment is not None and job["post"]:
                    on_segment(idx, arr)
                if ckpt is not None and rank == 0:
                    # only rank 0 writes; every rank holds the whole state
                    t_ck = now()
                    snap_h = {k2: v.cpu().numpy()
                              for k2, v in job["snapshot"].items()}
                    ckpt.save(ident, idx + 1, snap_h,
                              arr if job["post"] else None)
                    rec["ckpt_wait_s"] = now() - t_ck
                    timeline.append({"name": "ckpt_append", "tid": "writer",
                                     "t0": t_ck - t_run0,
                                     "dur": rec["ckpt_wait_s"], "chunk": idx})
                if progress is not None:
                    progress(min(job["done_steps"], total_steps),
                             total_steps)
                flightrec.note("segment_drained", idx=idx)
                collector.count("sample.segments_done")
                # live progress gauge for the telemetry plane
                telemetry.publish("sample.segments_done", int(idx) + 1)

            try:
                pipeline_mod.run_drain_with_retry(
                    body, policy,
                    on_retry=lambda a: collector.count("faults.retries"))
            finally:
                job["thinned"] = job["snapshot"] = None
                if t_ready is not None:
                    rec["t_ready_s"] = t_ready - t_run0
                    timeline.append(
                        {"name": "execute", "tid": "device",
                         "t0": rec["t0_s"],
                         "dur": max(t_ready - t_run0 - rec["t0_s"], 0.0),
                         "chunk": idx})
                timeline.append({"name": "drain", "tid": "writer",
                                 "t0": t_d0 - t_run0, "dur": now() - t_d0,
                                 "chunk": idx})
                if job["drained"] is not None:
                    job["drained"].set()

        try:
            with obs_metrics.collect(collector):
                for seg_idx in range(done_segments, n_segments):
                    t_seg0 = now()
                    rec = {"idx": seg_idx, "wall_s": 0.0, "stall_s": 0.0,
                           "ckpt_wait_s": 0.0,
                           "synced": bool(not pipelined),
                           "t0_s": t_seg0 - t_run0}
                    reuse = None
                    if len(ring) >= ring_size:
                        # the depth bound, and the watchdog's deadline on
                        # the oldest in-flight drain when the policy arms one
                        reuse = ring.popleft()
                        t_wait = now()
                        if not reuse["drained"].wait(policy.watchdog_s):
                            late = reuse["rec"]["idx"]
                            flightrec.note("watchdog_abort", idx=late,
                                           deadline_s=policy.watchdog_s)
                            raise faults_mod.WatchdogTimeout(
                                f"drain of segment {late} exceeded the "
                                f"watchdog deadline ({policy.watchdog_s}s); "
                                f"aborting, see the flight-recorder dump")
                        t_now = now()
                        rec["stall_s"] += t_now - t_wait
                        timeline.append({"name": "stall", "tid": "main",
                                         "t0": t_wait - t_run0,
                                         "dur": t_now - t_wait,
                                         "chunk": seg_idx})
                    state, thinned = seg_dispatch_recover(seg_idx, state)
                    done_ev = None
                    if on_card:
                        done_ev = torch.cuda.Event()
                        done_ev.record(compute)
                    flightrec.note("segment_dispatch", idx=seg_idx,
                                   step=seg_idx * segment)
                    rec["live_packed"] = ledger.track(thinned)
                    host = copied = drained = None
                    if pipelined:
                        if reuse is None:
                            host = pipeline_mod.host_buffer(thinned)
                        else:
                            host = reuse["host"]
                            timeline.append(
                                {"name": "recycle", "tid": "main",
                                 "t0": now() - t_run0, "dur": None,
                                 "chunk": seg_idx,
                                 "from_chunk": reuse["rec"]["idx"]})
                        copied = pipeline_mod.start_d2h(
                            thinned, host, after=done_ev,
                            stream=copy_stream)
                        collector.count("pipeline.d2h_async")
                        drained = threading.Event()
                    slot = len(out)
                    out.append(None)
                    job = {"rec": rec, "slot": slot, "thinned": thinned,
                           "snapshot": {k2: state[k2] for k2 in _SNAP_KEYS},
                           "post": seg_idx >= warm_segments,
                           "done_steps": (seg_idx + 1) * segment,
                           "host": host, "copied": copied,
                           "drained": drained}
                    del thinned
                    if pipelined:
                        rec["stall_s"] += writer.submit(
                            lambda job=job: drain(job), drained.set)
                        ring.append(job)
                    else:
                        writer.submit(lambda job=job: drain(job))
                    rec["wall_s"] = now() - t_seg0
                    timeline.append({"name": "dispatch", "tid": "main",
                                     "t0": rec["t0_s"], "dur": rec["wall_s"],
                                     "chunk": seg_idx})
                    seg_records.append(rec)
                writer.close(timeout=(policy.watchdog_s * (len(ring) + 2)
                                      if policy.watchdog_s else None))
                ring.clear()
                ledger.check()
                t_f0 = now()
                state_h = {k2: v.cpu().numpy() for k2, v in state.items()
                           if k2 in _SNAP_KEYS}
                timeline.append({"name": "final_fetch", "tid": "main",
                                 "t0": t_f0 - t_run0, "dur": now() - t_f0})
        except BaseException as exc:
            writer.abort()
            sampler.stop()
            flightrec.note("run_abort", error=repr(exc)[:500])
            rec_dir = flightrec.dump_dir(checkpoint)
            if rec_dir is not None:
                flightrec.dump(rec_dir, meta, chunks=seg_records,
                               error=repr(exc)[:500], process_index=rank)
            raise
        total_s = now() - t_run0
        flightrec.note("run_end", total_s=round(total_s, 3))

        kept = [a for a in out if a is not None]
        theta = (np.concatenate(kept, axis=0) if kept
                 else np.zeros((0, k, d), self._np_dtype()))
        #: final whitened chain positions (a later run's init_z)
        self.last_z = np.asarray(state_h["z"])
        diag = diagnostics(state_h, k, t_count, total_steps)
        if diag["divergences"] > 0:
            flightrec.note("chain_divergences",
                           count=int(diag["divergences"]))
        n_dev = max(len(set(zip(self.mesh.ranks.flat,
                                self.mesh.devices.flat))), 1)
        summary = {
            "rhat_max": round(diag.get("rhat_max", float("nan")), 5),
            "ess_min": round(diag.get("ess_min", 0.0), 2),
            "ess_per_s_per_chip": round(
                diag.get("ess_min", 0.0) / total_s / n_dev, 3),
            "sample_steps_per_s_per_chip": round(
                total_steps * k * t_count / total_s / n_dev, 2),
            "accept_rate": round(diag["accept_rate"], 4),
            "divergences": diag["divergences"],
            "nonfinite_lnl": diag["nonfinite_lnl"],
        }
        if "swap_rate" in diag:
            summary["swap_rate"] = round(diag["swap_rate"], 4)
        if ckpt is not None and rank == 0:
            ckpt.delete()

        collector.count("obs.chunks", len(seg_records))
        memory = sampler.stop()
        memory.update(ledger.memory_fields())
        if memory.get("peak_bytes_in_use"):
            memory["peak_hbm_bytes"] = memory["peak_bytes_in_use"]
            memory["peak_hbm_source"] = "allocator"
        meta["extra_metrics"] = dict(summary)
        report = RunReport.from_collector(collector, meta, retraces=0,
                                          total_s=total_s, memory=memory)
        report.chunks = seg_records
        report.spans = sorted(set(collector.spans))
        report.timeline = sorted(timeline, key=lambda e: e.get("t0", 0.0))
        self.last_report = report
        result = {
            "schema": SAMPLE_SCHEMA,
            "theta": theta,
            "param_names": list(compiled.param_names),
            "bounds": np.asarray(compiled.bounds),
            "truth": np.asarray(self.truth),
            "mode_theta": np.asarray(self.mode_theta),
            "betas": float(spec.max_temp) ** -(
                np.arange(t_count, dtype=np.float64)
                / max(t_count - 1, 1)),
            "diag": diag,
            "summary": summary,
            "report": report,
        }
        self.last_result = result
        if eventlog is not None:
            shard_dir = Path(eventlog)
            shard_dir.mkdir(parents=True, exist_ok=True)
            report.save(shard_dir / f"events-p{rank:03d}.jsonl")
        return result

    def save(self, path, result=None) -> str:
        """Write the run's summary artifact (the obs JSON-lines framing
        with the ``fakepta_tpu.sample/1`` payload schema), readable by
        either package's ``RunReport.load``."""
        result = result if result is not None else self.last_result
        if result is None:
            raise ValueError("run() the sampler before saving its artifact")
        report = result["report"]
        report.meta["sample_schema"] = SAMPLE_SCHEMA
        report.meta["extra_metrics"] = dict(result["summary"])
        return report.save(path)
