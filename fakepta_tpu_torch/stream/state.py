"""StreamState: the per-pulsar append-TOA container (port of
``fakepta_tpu.stream.state``).

**The frozen-grid contract.** Woodbury moments are additive over TOAs only
if every TOA, old and new, is projected onto the SAME Fourier basis. The
batch layer normalizes times by Tspan (``t/Tspan_p`` per pulsar,
``t/Tspan_array`` for CURN), so rebuilding the batch with the new data
would change Tspan and with it every *old* basis value. A stream therefore
pins its grids ONCE from a template batch (``df_own``, the per-pulsar bin
width, and ``tspan_common``) and normalizes every appended absolute TOA
against those frozen scales, in the stream dtype, never re-derived from
the data. Appends are then exactly additive
(:func:`..ops.woodbury.append_parts`). ECORR epochs use *global* ids
(``floor(t_abs / ecorr_dt)``, on the host) for the same reason: an epoch's
identity never changes when later data arrives. The per-epoch sums are one
contraction against a one-hot epoch table (no atomics: reruns and resumes
are bit-identical on the card).

**Re-bucket policy.** Three shapes churn as a stream grows, and each rides
its own geometric ladder (:mod:`..tune.defaults`: ``STREAM_BLOCK_BUCKETS``
/ ``STREAM_GROWTH_RATIO``) so the kernel key set stays O(log growth): the
append-block width (pads to the smallest ladder rung), the ECORR epoch
capacity, and the host storage capacity. The JAX package counts compiles
inside its jitted bodies, once per trace; a torch function has no trace,
so the port counts at its kernel cache instead: a miss in
:meth:`StreamState._kernel` or :meth:`StreamState._finish_fn` is one
build (``compiles``). The cache never drops a key, so ``recompiles``
(a second build of a key; JAX's ``stream_recompiles`` canary) is 0 by
construction here and kept for parity, with ``_trace_counts`` at one per
key, as the JAX guard keeps them. What can fail is a build on a steady
append: a rung crossing is one counted ``stream.rebuckets`` event and at
most one build, and an append at built rungs builds nothing.

**Staging.** An append stages its seven padded (P, nb) host arrays (times,
mask, white variances, observing frequencies, epoch ids, ECORR amplitudes,
residuals) into one float64 buffer, pinned when the stream is on the card,
and copies it to each device in one transfer; the append's latency runs to
a synchronize, as the JAX append's to ``block_until_ready``. The raw store
the restage and the refreshers read stays host numpy.

**Mesh.** With ``mesh=``, the pulsars split into contiguous blocks (cells)
over the mesh's ``'psr'`` axis, replicated over ``'real'`` and ``'toa'``
as the JAX stream's ``_put`` shards over ``psr`` alone: a cell's parts
live on the device of the first entry of its psr column, and the
finished moments are gathered in pulsar order onto this process's first
entry's device. On a mesh that spans processes
(:func:`..parallel.mesh.initialize_multihost`) every rank makes the same
calls with the same arguments (one program, many processes): it builds
the cells of the psr columns it owns an entry of, appends every block
(each rank keeps the whole host raw store, as each JAX process keeps its
``_store``) but stages and ingests only its own cells' rows, and the
gathers broadcast each column no rank set holds whole from the owner of
its first entry, in column order, so every rank holds the one-process
mesh's moments bit for bit. An append opens with one exchange of the
block's bucket rungs and checksum on the host transport
(:meth:`..parallel.mesh.Mesh.agreement`): ranks whose rungs or blocks
differ raise together, and so does every rank when the append's fault
site fired on one. Checkpoint files are the lead rank's to write; every
rank resumes from the shared directory.

**Torn-append recovery.** With a checkpoint attached, every appended block
lands as its own ``.b<k>.npz`` via :func:`..utils.io.write_atomic` with a
CRC32 manifest, in the JAX package's layout (each package resumes the
other's); resume replays the blocks through the same append kernels
(bit-identical), and a torn final block rolls back to the last consistent
state (chaos site ``ingest.append``, kind ``torn``).
"""

from __future__ import annotations

import dataclasses
import io as _io
import zipfile
import zlib
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import faults
from ..batch import PulsarBatch, _host
from ..device import DeviceLike
from ..infer import model as infer_model
from ..obs import flightrec, metrics
from ..obs.timing import now
from ..ops import woodbury
from ..parallel.mesh import PSR_AXIS, make_mesh
from ..tune import defaults as tune_defaults
from ..utils.io import npz_bytes, write_atomic

#: schema tag for stream artifacts (manifest + served stats payloads); the
#: JAX package's string
STREAM_SCHEMA = "fakepta_tpu.stream/1"

#: rows of the staged append buffer, in order
_STAGED = ("t", "mask", "sigma2", "freqs", "eidx", "ecorr", "r")


def default_stream_model(nbin: int = 10, log10_A=(-15.5, -13.5),
                         gamma=(2.0, 6.0)):
    """The standard streaming model: batch-pinned red + DM noise plus a
    free-powerlaw CURN component (the process the rolling detection
    statistic watches), with the stream's default bounds."""
    return infer_model.LikelihoodSpec(components=(
        infer_model.ComponentSpec(target="red", spectrum="batch"),
        infer_model.ComponentSpec(target="dm", spectrum="batch"),
        infer_model.ComponentSpec(target="curn", nbin=int(nbin), free=(
            infer_model.FreeParam("log10_A", tuple(log10_A)),
            infer_model.FreeParam("gamma", tuple(gamma)))),
    ))


def _snap(n: int, ladder, ratio: int) -> int:
    """Smallest ladder rung >= n; past the top rung, keep multiplying by
    ``ratio`` (so bulk history appends stay legal with O(log) extra
    builds)."""
    if n <= 0:
        raise ValueError(f"bucket size must be positive, got {n}")
    for b in ladder:
        if n <= b:
            return int(b)
    b = int(ladder[-1])
    while b < n:
        b *= int(ratio)
    return b


class StreamCheckpoint:
    """Append-block checkpoint: one small ``.b<k>.npz`` per append plus a
    CRC32 manifest, every file via :func:`..utils.io.write_atomic`, in the
    JAX package's layout. Resume replays the raw blocks through the
    stream's own append kernels (deterministic, so the resumed state is
    bit-identical), and a torn block rolls back to the last consistent
    append (``stream_rollback`` flight-recorded, ``faults.rollbacks``
    counted)."""

    def __init__(self, path):
        self.path = Path(path)
        self._sums: dict = {}        # block index -> CRC32

    def _block_path(self, k: int) -> Path:
        return self.path.with_name(self.path.name + f".b{k:06d}.npz")

    def _write_manifest(self, ident: dict, n_blocks: int) -> None:
        manifest = dict(
            npsr=np.int64(ident["npsr"]), ncols=np.int64(ident["ncols"]),
            ecorr_dt=np.float64(ident["ecorr_dt"]),
            n_blocks=np.int64(n_blocks),
            sums=np.asarray([self._sums.get(k, 0) for k in range(n_blocks)],
                            dtype=np.int64))
        write_atomic(self.path, npz_bytes(**manifest))

    def save_block(self, ident: dict, k: int, arrays: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._sums[k] = write_atomic(self._block_path(k),
                                     npz_bytes(**arrays))
        self._write_manifest(ident, k + 1)

    def corrupt_block(self, k: int) -> None:
        """Chaos-harness hook: simulate the torn write fsync cannot prevent
        (failing storage drops the block's pages after the rename became
        durable); resume must detect the bad CRC and roll back."""
        p = self._block_path(k)
        data = p.read_bytes()
        p.write_bytes(data[:max(len(data) // 2, 1)])

    def load_blocks(self, ident: dict, repair: bool = True):
        """``(blocks, rolled_back)``: verified raw append blocks in order,
        after rolling back past the first torn or corrupt one. With
        ``repair=False`` (a rank that does not write) the files are left
        as they are and nothing is counted."""
        if not self.path.exists():
            return [], 0
        try:
            with np.load(self.path, allow_pickle=False) as z:
                manifest = {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile) as exc:
            if repair:
                flightrec.note("stream_manifest_corrupt",
                               path=str(self.path), error=repr(exc)[:200])
                self.delete()
            return [], 0
        for key in ("npsr", "ncols"):
            if int(manifest[key]) != int(ident[key]):
                raise ValueError(
                    f"stream checkpoint {self.path} was written by a "
                    f"different stream ({key}={int(manifest[key])}, this "
                    f"stream has {int(ident[key])}); delete it or use a "
                    f"different path")
        if float(manifest["ecorr_dt"]) != float(ident["ecorr_dt"]):
            raise ValueError(
                f"stream checkpoint {self.path} uses ecorr_dt="
                f"{float(manifest['ecorr_dt'])}, this stream "
                f"{float(ident['ecorr_dt'])}; delete it or use a "
                f"different path")
        total = int(manifest["n_blocks"])
        sums = manifest["sums"]
        blocks = []
        good = total
        self._sums = {}
        for k in range(total):
            try:
                data = self._block_path(k).read_bytes()
                crc = zlib.crc32(data)
                if k < len(sums) and crc != int(sums[k]):
                    raise ValueError(f"block {k} checksum mismatch "
                                     f"(torn write)")
                with np.load(_io.BytesIO(data), allow_pickle=False) as z:
                    blocks.append({key: z[key] for key in z.files})
                self._sums[k] = crc
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile) as exc:
                if repair:
                    flightrec.note("stream_rollback", block=k,
                                   error=repr(exc)[:200])
                good = k
                blocks = blocks[:good]
                break
        if good < total and repair:
            # drop the bad tail and rewrite the manifest: the on-disk
            # checkpoint is the last CONSISTENT StreamState again
            for k in range(good, total):
                self._block_path(k).unlink(missing_ok=True)
                self._sums.pop(k, None)
            metrics.count("faults.rollbacks", total - good)
            if good == 0:
                self.delete()
            else:
                self._write_manifest(ident, good)
        return blocks, total - good

    def delete(self) -> None:
        for p in self.path.parent.glob(self.path.name + ".b*.npz"):
            p.unlink(missing_ok=True)
        self.path.unlink(missing_ok=True)
        self._sums = {}


class _Cell:
    """One psr block of the stream: its column, pulsars, device and pinned
    grid."""

    __slots__ = ("s", "device", "lo", "n", "df_own", "tspan", "fixed",
                 "res")

    def __init__(self, s, device, lo, n, df_own, tspan):
        self.s, self.device, self.lo, self.n = s, device, lo, n
        self.df_own, self.tspan = df_own, tspan
        self.fixed: dict = {}
        self.res: dict = {}


class StreamState:
    """Append-TOA state for one PTA: frozen grids, accumulated device
    moments, bucketed O(new-epoch) append kernels (module docstring).

    ``template`` (a :class:`..batch.PulsarBatch`) pins the geometry (npsr,
    sky positions, stored noise PSDs) and the FROZEN frequency grids
    (``df_own``, ``tspan_common``); the stream itself starts empty: the
    template's TOAs are reference scales, not data. ``model`` is the
    :class:`..infer.LikelihoodSpec` whose basis and phi the moments live
    on (default :func:`default_stream_model`); ``'sys'`` components are
    rejected (their per-band TOA masks are not defined for data not yet
    seen). ``ecorr_dt`` (seconds) enables ECORR epoch blocks with global
    epoch ids. ``watch`` names an ORF ("hd", ...) to arm the rolling
    :class:`..detect.streaming.StreamingOS` refreshed on every append.
    ``checkpoint`` attaches a :class:`StreamCheckpoint` path and REPLAYS
    any existing consistent blocks before returning. ``dtype`` is the
    torch accumulation dtype (float64 by default: ``M`` entries scale like
    1/sigma^2 ~ 1e14; a float32 stream is legal on request).

    The stream runs on ``device`` (default ``"cuda"``, raising without a
    GPU unless ``device="cpu"``) or on ``mesh``'s psr entries, on one
    process or across ranks (module docstring); pass one of the two.
    Appended absolute TOAs are seconds from the stream's shared origin
    (the template's own origin: its synthetic arrays start at 0).
    """

    def __init__(self, template, model=None, *, theta_ref=None, mesh=None,
                 device: DeviceLike = None,
                 ecorr_dt: Optional[float] = None, watch=None,
                 checkpoint=None, block_buckets=None, growth_ratio=None,
                 dtype=torch.float64):
        if mesh is None:
            mesh = make_mesh(["cuda" if device is None else device])
        elif device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.template = template
        self.model = model if model is not None else default_stream_model()
        self._compiled = infer_model.build(self.model, template)
        if any(c["target"] == "sys" for c in self._compiled._comps):
            raise ValueError("streaming does not support 'sys' components "
                             "(per-band TOA membership is undefined for "
                             "future data); model red/dm/chrom/curn only")
        self.npsr = int(template.npsr)
        self.ncols = int(self._compiled.ncols)
        self.mesh = mesh
        shards = int(mesh.shape[PSR_AXIS])
        if self.npsr % shards != 0:
            raise ValueError(f"npsr={self.npsr} must be divisible by "
                             f"the psr mesh axis ({shards})")
        self.device = mesh.local_device
        # checkpoint files are the lead rank's to write
        self._writer = mesh.rank == mesh.lead
        self._dtype = dtype
        self.ecorr_dt = None if ecorr_dt is None else float(ecorr_dt)
        if theta_ref is None:
            theta_ref = self._compiled.theta_from_unit(
                np.full(self._compiled.D, 0.5))
        self.theta_ref = np.asarray(theta_ref, dtype=np.float64)
        self._buckets = tuple(block_buckets if block_buckets is not None
                              else tune_defaults.STREAM_BLOCK_BUCKETS)
        self._ratio = int(growth_ratio if growth_ratio is not None
                          else tune_defaults.STREAM_GROWTH_RATIO)

        # frozen grids + per-pulsar defaults from the template (host f64)
        self._df_own = _host(template.df_own).astype(np.float64)
        self._tspan = float(_host(template.tspan_common))
        tmask = _host(template.mask).astype(np.float64)
        tsig = _host(template.sigma2).astype(np.float64)
        self._sigma2_default = (np.sum(tsig * tmask, axis=1)
                                / np.maximum(np.sum(tmask, axis=1), 1.0))
        self._nsb = self._template_views()
        per = self.npsr // shards
        # this rank's cells: the psr columns it owns an entry of, each on
        # its first owned entry's device; a column some rank lacks is
        # broadcast from the owner of its first entry (_gather)
        self._cells = []
        self._shares = []
        for s in range(shards):
            owned = [mesh.devices[i] for i in np.ndindex(mesh.devices.shape)
                     if i[1] == s and mesh.owns(i)]
            if set(mesh.ranks[:, s, :].flat) != set(mesh.members):
                self._shares.append((s, int(mesh.ranks[0, s, 0])))
            if not owned:
                continue
            self._cells.append(_Cell(
                s, owned[0], s * per, per,
                self._cast(self._df_own[s * per:(s + 1) * per], owned[0]),
                self._cast(np.float64(self._tspan), owned[0])))
        self._pinned = any(c.device.type == "cuda" for c in self._cells)
        self._staging: dict = {}

        # host store of raw appended data (the restage/refresh source)
        self._cap = 0
        self._n = np.zeros(self.npsr, dtype=np.int64)
        self._store: dict = {}
        # accumulated device moment parts (per cell)
        self._ecap = 0
        for cell in self._cells:
            cell.fixed, cell.res = self._zero_parts(cell)
        self._kernels: dict = {}
        self._trace_counts: dict = {}
        self.appends = 0
        self.rebuckets = 0
        self.recompiles = 0
        self.compiles = 0
        self.rolled_back = 0
        self._moments_cache = None
        self._watch = None
        self._watch_orf = watch
        self.last_stats: Optional[dict] = None

        self._ckpt = None
        if checkpoint is not None:
            self._ckpt = (checkpoint if isinstance(checkpoint,
                                                   StreamCheckpoint)
                          else StreamCheckpoint(checkpoint))
            self._resume()

    # ------------------------------------------------------------------
    # staging helpers
    # ------------------------------------------------------------------
    def _cast(self, arr, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, dtype=np.float64)).to(
            dtype=self._dtype, device=device)

    def _template_views(self) -> SimpleNamespace:
        """Stream-dtype views of the template fields ``phi`` reads, on the
        gather device (times are NOT data here)."""
        b = self.template
        return SimpleNamespace(**{
            name: self._cast(_host(getattr(b, name)), self.device)
            for name in ("t_own", "t_common", "freqs", "df_own",
                         "tspan_common", "red_psd", "dm_psd", "chrom_psd",
                         "sys_psd")})

    def _zero_parts(self, cell: _Cell):
        p, c, kw = cell.n, self.ncols, dict(dtype=self._dtype,
                                            device=cell.device)
        fixed = {"M": torch.zeros((p, c, c), **kw),
                 "lndetN": torch.zeros(p, **kw),
                 "n_valid": torch.zeros(p, **kw)}
        res = {"d0": torch.zeros(p, **kw), "dT": torch.zeros((p, c), **kw)}
        if self._ecap:
            fixed["a"] = torch.zeros((p, self._ecap), **kw)
            fixed["v"] = torch.zeros((p, self._ecap, c), **kw)
            res["s"] = torch.zeros((p, self._ecap), **kw)
        return fixed, res

    def _sync(self) -> None:
        for dev in {c.device for c in self._cells if c.device.type == "cuda"}:
            # staging returns once every cell's copy is done
            # fakepta: allow[host-sync-in-jit] one barrier per card
            torch.cuda.synchronize(dev)

    def _stage(self, rows, nb: int):
        """The seven (P, nb) arrays ``rows`` as (P, 7, nb) float64 device
        tensors per cell, from one host buffer (pinned and reused per
        rung on the card: every staging ends in a synchronize, so the
        buffer is free again by the next one) in one copy per cell."""
        if self._pinned:
            host = self._staging.get(nb)
            if host is None:
                host = torch.empty((self.npsr, len(_STAGED), nb),
                                   dtype=torch.float64).pin_memory()
                self._staging[nb] = host
        else:
            host = torch.empty((self.npsr, len(_STAGED), nb),
                               dtype=torch.float64)
        view = host.numpy()
        for k, arr in enumerate(rows):
            view[:, k] = arr
        return [host[c.lo:c.lo + c.n].to(c.device, non_blocking=True)
                for c in self._cells]

    def _note_trace(self, signature) -> None:
        """The retrace guard, counted at the kernel cache: a first build
        is a compile, a second build of a key a recompile (none happen:
        the cache never drops a key; module docstring)."""
        n = self._trace_counts.get(signature, 0) + 1
        self._trace_counts[signature] = n
        if n > 1:
            self.recompiles += 1
            metrics.count("stream.recompiles")
        else:
            self.compiles += 1
            metrics.count("stream.compiles")

    # ------------------------------------------------------------------
    # kernels (cached per (block bucket, epoch capacity))
    # ------------------------------------------------------------------
    def _kernel(self, nb: int):
        key = (int(nb), int(self._ecap))
        fn = self._kernels.get(key)
        if fn is None:
            self._note_trace(("append",) + key)
            fn = self._build_kernel(*key)
            self._kernels[key] = fn
        return fn

    def _build_kernel(self, nb: int, ecap: int):
        compiled, dtype = self._compiled, self._dtype

        def kern(cell: _Cell, fixed, res, staged):
            t_abs = staged[:, 0].to(dtype)
            mask = staged[:, 1] != 0.0
            sigma2 = staged[:, 2].to(dtype)
            freqs = staged[:, 3].to(dtype)
            r = staged[:, 6].to(dtype)
            # the frozen-grid normalization: absolute seconds against the
            # PINNED per-pulsar df_own / common tspan, never re-derived
            # from the accumulated data (module docstring)
            bview = SimpleNamespace(
                t_own=t_abs * cell.df_own[:, None],
                t_common=t_abs / cell.tspan, freqs=freqs,
                sys_mask=torch.zeros((cell.n, 1, nb), dtype=torch.bool,
                                     device=cell.device))
            tmat = compiled.basis(bview)
            if ecap:
                eidx = staged[:, 4].to(torch.int64)
                amp = staged[:, 5].to(dtype)
                onehot = woodbury.epoch_onehot(eidx, ecap, dtype)
                kw = dict(epoch_idx=eidx, ecorr_amp=amp, num_epochs=ecap,
                          onehot=onehot)
            else:
                kw = {}
            return (woodbury.append_parts(fixed, tmat, sigma2, mask, **kw),
                    woodbury.append_parts(res, tmat, sigma2, mask, r=r,
                                          **kw))

        return kern

    def _finish_fn(self):
        key = ("finish", int(self._ecap))
        fn = self._kernels.get(key)
        if fn is None:
            self._note_trace(key)

            def fin(fixed, res):
                m, lndet, nv, corr = woodbury.finish_fixed(fixed)
                d0, dt = woodbury.finish_res(res, corr)
                return m, lndet, nv, d0, dt

            fn = fin
            self._kernels[key] = fn
        return fn

    def _gather(self, per_cell):
        """Per-cell tuples of pulsar-leading tensors (one per cell of this
        rank), concatenated in pulsar order on the gather device; across
        ranks each shared column's tensors are broadcast from its first
        entry's owner in one transfer, in column order (every cell has
        the same shapes, so this rank's first cell's are the likes)."""
        by_col = {c.s: tuple(xs) for c, xs in zip(self._cells, per_cell)}
        likes = per_cell[0]
        for s, src in self._shares:
            got = self.mesh.broadcast_tensors(by_col.get(s), src, likes)
            if src != self.mesh.rank:
                by_col[s] = tuple(got)
        cols = [by_col[s] for s in sorted(by_col)]
        if len(cols) == 1:
            return cols[0]
        return tuple(torch.cat([x.to(self.device) for x in xs], dim=0)
                     for xs in zip(*cols))

    def _gather_parts(self, per_cell) -> dict:
        """Per-cell part dicts gathered key by key (:meth:`_gather`)."""
        keys = list(per_cell[0])
        return dict(zip(keys, self._gather([[d[k] for k in keys]
                                            for d in per_cell])))

    # ------------------------------------------------------------------
    # capacity ladders
    # ------------------------------------------------------------------
    def _grow_epochs(self, need: int) -> None:
        """Snap the ECORR epoch capacity up to the next rung and zero-pad
        the accumulated parts (exact: woodbury.pad_epoch_parts)."""
        new_cap = _snap(need, self._buckets, self._ratio)
        first = self._ecap == 0
        self._ecap = new_cap
        for cell in self._cells:
            if first:
                z_f, z_r = self._zero_parts(cell)
                cell.fixed = dict(cell.fixed, a=z_f["a"], v=z_f["v"])
                cell.res = dict(cell.res, s=z_r["s"])
            else:
                cell.fixed = woodbury.pad_epoch_parts(cell.fixed, new_cap)
                cell.res = woodbury.pad_epoch_parts(cell.res, new_cap)
        if not first:                 # first allocation is not a rebucket
            self.rebuckets += 1
            metrics.count("stream.rebuckets")
            flightrec.note("stream_rebucket", what="epochs",
                           capacity=int(new_cap))

    def _grow_store(self, need: int) -> None:
        """Snap the host raw-data capacity up to the next rung (the
        restage/refresh source arrays; a host realloc, no build)."""
        new_cap = _snap(need, self._buckets, self._ratio)
        p = self.npsr
        grown = {}
        for key, fill in (("t", 0.0), ("r", 0.0), ("sigma2", 1.0),
                          ("freqs", 1400.0), ("ecorr", 0.0)):
            arr = np.full((p, new_cap), fill, dtype=np.float64)
            if self._cap:
                arr[:, :self._cap] = self._store[key]
            grown[key] = arr
        mask = np.zeros((p, new_cap), dtype=bool)
        eidx = np.zeros((p, new_cap), dtype=np.int64)
        if self._cap:
            mask[:, :self._cap] = self._store["mask"]
            eidx[:, :self._cap] = self._store["eidx"]
        grown["mask"], grown["eidx"] = mask, eidx
        self._store = grown
        if self._cap:
            self.rebuckets += 1
            metrics.count("stream.rebuckets")
            flightrec.note("stream_rebucket", what="store",
                           capacity=int(new_cap))
        self._cap = new_cap

    # ------------------------------------------------------------------
    # the append path
    # ------------------------------------------------------------------
    def _ident(self) -> dict:
        return {"npsr": self.npsr, "ncols": self.ncols,
                "ecorr_dt": 0.0 if self.ecorr_dt is None else self.ecorr_dt}

    def append(self, toas, residuals, *, sigma2=None, freqs=None,
               ecorr_amp=None, counts=None) -> dict:
        """Ingest one block of new TOAs: O(block), never O(history).

        ``toas``/``residuals`` are (P, B) absolute seconds / seconds;
        ``counts`` (P,) marks how many leading entries per pulsar are real
        (default: all B). ``sigma2`` defaults to the template's mean white
        variance per pulsar; ``freqs`` to 1400 MHz; ``ecorr_amp`` (legal
        only with ``ecorr_dt`` set) to zero. Returns the append stats dict
        (latency, bucket, totals, and, with ``watch`` armed, the rolling
        detection statistic).

        Across ranks every rank appends the same block; the append's
        checks end in one exchange (module docstring), so a failure of
        them on one rank raises on every rank before any state moves.
        """
        t0 = now()
        with self.mesh.agreement("stream append") as agreed:
            act = faults.check("ingest.append", seq=int(self.appends))
            block = self._block(toas, residuals, sigma2, freqs, ecorr_amp,
                                counts)
            agreed.value = self._rungs(block)
        if any(v != agreed.lead_value for v in agreed.values):
            raise ValueError(
                f"stream append {self.appends}: the ranks' bucket rungs "
                f"and block checksums (nb, epoch capacity, store capacity, "
                f"crc32) differ: {agreed.values} in rank order; every rank "
                f"must append the same block")
        info = self._ingest(block, record=True, t0=t0)
        if act == "torn":
            # chaos harness: the block landed and the manifest references
            # it, then failing storage tore its pages and the process died;
            # resume must roll back to the last consistent StreamState
            if self._ckpt is not None and self._writer:
                self._ckpt.corrupt_block(self.appends - 1)
            raise faults.KillFault(
                f"injected torn stream append at block {self.appends - 1}")
        return info

    def _block(self, toas, residuals, sigma2, freqs, ecorr_amp,
               counts) -> dict:
        """The validated host block of one append."""
        toas = np.asarray(toas, dtype=np.float64)
        residuals = np.asarray(residuals, dtype=np.float64)
        if toas.ndim != 2 or toas.shape[0] != self.npsr:
            raise ValueError(f"toas must be ({self.npsr}, B), got "
                             f"{toas.shape}")
        if residuals.shape != toas.shape:
            raise ValueError(f"residuals shape {residuals.shape} != toas "
                             f"shape {toas.shape}")
        b0 = toas.shape[1]
        if counts is None:
            counts = np.full(self.npsr, b0, dtype=np.int64)
        else:
            counts = np.asarray(counts, dtype=np.int64)
            if counts.shape != (self.npsr,) or np.any(counts < 0) \
                    or np.any(counts > b0):
                raise ValueError(f"counts must be ({self.npsr},) in "
                                 f"[0, {b0}]")
        if ecorr_amp is not None and self.ecorr_dt is None:
            raise ValueError("ecorr_amp given but the stream was built "
                             "without ecorr_dt")

        def full(x, default):
            if x is None:
                return np.broadcast_to(default, toas.shape).copy()
            return np.broadcast_to(np.asarray(x, dtype=np.float64),
                                   toas.shape).copy()

        return {
            "t": toas, "r": residuals, "counts": counts,
            "sigma2": full(sigma2, self._sigma2_default[:, None]),
            "freqs": full(freqs, 1400.0),
            "ecorr": full(ecorr_amp, 0.0),
        }

    def _epoch_ids(self, block: dict, valid: np.ndarray):
        """Global ECORR epoch ids of a block's valid TOAs (0 elsewhere) and
        the epoch capacity they need."""
        eidx = np.floor_divide(block["t"], self.ecorr_dt).astype(np.int64)
        eidx = np.where(valid, eidx, 0)
        if np.any(eidx < 0):
            raise ValueError("TOAs before the stream origin are not "
                             "appendable (negative epoch id)")
        need = int(eidx.max(initial=-1)) + 1 if np.any(valid) else 0
        return eidx, need

    def _rungs(self, block: dict) -> tuple:
        """``(block bucket, epoch capacity, store capacity, crc32)`` after
        ``block``: what every rank's append must agree on (on one process
        nothing reads it)."""
        if not self.mesh.multiprocess:
            return None
        counts = block["counts"]
        b0 = block["t"].shape[1]
        ecap = self._ecap
        if self.ecorr_dt is not None:
            valid = np.arange(b0)[None, :] < counts[:, None]
            need = self._epoch_ids(block, valid)[1]
            if need > ecap:
                ecap = _snap(need, self._buckets, self._ratio)
        cap = self._cap
        need_cap = int((self._n + counts).max())
        if need_cap > cap:
            cap = _snap(need_cap, self._buckets, self._ratio)
        crc = 0
        for key in ("t", "r", "counts", "sigma2", "freqs", "ecorr"):
            crc = zlib.crc32(np.ascontiguousarray(block[key]).tobytes(), crc)
        return (_snap(b0, self._buckets, self._ratio), ecap, cap, crc)

    def _ingest(self, block: dict, record: bool, t0=None) -> dict:
        t0 = now() if t0 is None else t0
        toas, counts = block["t"], block["counts"]
        b0 = toas.shape[1]
        nb = _snap(b0, self._buckets, self._ratio)
        valid = np.arange(b0)[None, :] < counts[:, None]

        def padded(arr, fill):
            out = np.full((self.npsr, nb), fill, dtype=np.float64)
            out[:, :b0] = np.where(valid, arr, fill)
            return out

        rebucketed = False
        ei_pad = np.zeros((self.npsr, nb), dtype=np.int64)
        if self.ecorr_dt is not None:
            eidx, need = self._epoch_ids(block, valid)
            if need > self._ecap:
                grew = self._ecap > 0
                self._grow_epochs(need)
                rebucketed = rebucketed or grew
            ei_pad[:, :b0] = eidx
        m_pad = np.zeros((self.npsr, nb), dtype=np.float64)
        m_pad[:, :b0] = valid

        need_cap = int((self._n + counts).max())
        if need_cap > self._cap:
            grew = self._cap > 0      # first allocation is not a rebucket
            self._grow_store(need_cap)
            rebucketed = rebucketed or grew

        kernel = self._kernel(nb)
        staged = self._stage((padded(toas, 0.0), m_pad,
                              padded(block["sigma2"], 1.0),
                              padded(block["freqs"], 1400.0), ei_pad,
                              padded(block["ecorr"], 0.0),
                              padded(block["r"], 0.0)), nb)
        for cell, st in zip(self._cells, staged):
            cell.fixed, cell.res = kernel(cell, cell.fixed, cell.res, st)
        self._sync()
        self._moments_cache = None

        # host raw store (restage oracle + posterior refresh source): each
        # pulsar's valid prefix lands after its stored TOAs
        rows = np.nonzero(valid)[0]
        cols = (self._n[:, None] + np.arange(b0)[None, :])[valid]
        for key, src in (("t", toas), ("r", block["r"]),
                         ("sigma2", block["sigma2"]),
                         ("freqs", block["freqs"]),
                         ("ecorr", block["ecorr"]),
                         ("eidx", ei_pad[:, :b0])):
            self._store[key][rows, cols] = src[valid]
        self._store["mask"][rows, cols] = True
        self._n = self._n + counts
        k = self.appends
        self.appends += 1

        if record and self._ckpt is not None and self._writer:
            self._ckpt.save_block(self._ident(), k, {
                "t": toas, "r": block["r"], "counts": counts,
                "sigma2": block["sigma2"], "freqs": block["freqs"],
                "ecorr": block["ecorr"]})

        info = {
            "schema": STREAM_SCHEMA, "append": k,
            "n_new": int(counts.sum()), "n_toas": int(self._n.sum()),
            "block_bucket": int(nb), "epoch_capacity": int(self._ecap),
            "rebucketed": bool(rebucketed),
            "rebuckets": int(self.rebuckets),
            "compiles": int(self.compiles),
            "recompiles": int(self.recompiles),
        }
        if record:
            metrics.count("stream.appends")
            if self._watch_orf is not None:
                info.update(self._watcher().update(self.moments()))
        info["latency_ms"] = round((now() - t0) * 1e3, 3)
        self.last_stats = info
        return info

    def _resume(self) -> None:
        """Replay the checkpoint's consistent blocks. Across ranks the
        lead loads first (rolling a torn tail back on disk), then the
        others read what it left, and all must count the same blocks (a
        checkpoint directory the ranks do not share raises on every
        rank)."""
        ident = self._ident()
        blocks = []
        with self.mesh.agreement("stream resume") as agreed:
            if self._writer:
                blocks, rolled_back = self._ckpt.load_blocks(ident)
                agreed.value = (len(blocks), int(rolled_back))
        n_blocks, rolled_back = agreed.lead_value
        with self.mesh.agreement("stream resume") as agreed:
            if not self._writer:
                blocks, _ = self._ckpt.load_blocks(ident, repair=False)
            agreed.value = len(blocks)
        if any(n != n_blocks for n in agreed.values):
            raise ValueError(
                f"stream checkpoint {self._ckpt.path}: the ranks read "
                f"{agreed.values} consistent blocks (rank order), the lead "
                f"{n_blocks}; every rank must resume from one shared "
                f"directory")
        self.rolled_back = int(rolled_back)
        for blk in blocks:
            self._ingest({k: np.asarray(v) for k, v in blk.items()},
                         record=False)
            metrics.count("stream.replays")
        if blocks and self._watch_orf is not None:
            self._watcher().update(self.moments())

    # ------------------------------------------------------------------
    # consumers: moments, likelihood, detection, restage, refresh views
    # ------------------------------------------------------------------
    def moments(self):
        """``(M, lndetN, n_valid, d0, dT)`` finished from the accumulated
        parts (cached until the next append), on the gather device."""
        if self._moments_cache is None:
            fin = self._finish_fn()
            self._moments_cache = self._gather(
                [fin(c.fixed, c.res) for c in self._cells])
        return self._moments_cache

    def lnlike(self, theta) -> float:
        """GP-marginalized lnL of the accumulated data at one theta."""
        m, lndet, nv, d0, dt = self.moments()
        phi = self._compiled.phi(self._cast(theta, self.device), self._nsb)
        lnl = woodbury.lnlike_from_moments(d0, dt, m, lndet, nv, phi)
        return float(torch.sum(lnl))

    def _watcher(self):
        if self._watch is None:
            from ..detect.streaming import StreamingOS
            self._watch = StreamingOS(
                self._compiled, self._nsb,
                _host(self.template.pos).astype(np.float64),
                orf=self._watch_orf, theta_ref=self.theta_ref)
        return self._watch

    def _restage_cells(self):
        if self._cap == 0:
            return [self._zero_parts(c) for c in self._cells]
        nb = self._cap            # already rung-snapped by _grow_store
        kernel = self._kernel(nb)
        st = self._store
        staged = self._stage((st["t"], st["mask"], st["sigma2"],
                              st["freqs"], st["eidx"], st["ecorr"],
                              st["r"]), nb)
        out = [kernel(c, *self._zero_parts(c), s)
               for c, s in zip(self._cells, staged)]
        self._sync()
        return out

    def restage(self):
        """Recompute the moment parts from ALL stored raw data in one shot
        (the O(history) path a stream exists to avoid), on the same kernel
        at the store's capacity rung. Kept as the A/B baseline, the
        oracle's reference, and the drift bound for float32 streams.
        Returns fresh ``(fixed, res)`` part dicts gathered in pulsar
        order; the accumulated state is untouched."""
        cells = self._restage_cells()
        return tuple(self._gather_parts([c[i] for c in cells])
                     for i in (0, 1))

    def restage_moments(self):
        """Finished moments from a fresh :meth:`restage` (the append-vs-
        restage oracle's reference side)."""
        fin = self._finish_fn()
        return self._gather([fin(f, r) for f, r in self._restage_cells()])

    @property
    def tspan(self) -> float:
        """The frozen common-grid span (seconds) this stream is pinned
        to."""
        return self._tspan

    def raw_data(self) -> dict:
        """The host raw store, trimmed to capacity, plus per-pulsar counts:
        absolute TOAs, replayable onto ANY wider frozen-grid template via
        one bulk :meth:`append`."""
        cap = self._cap
        if cap == 0:
            z = np.zeros((self.npsr, 0), dtype=np.float64)
            return {"t": z, "r": z.copy(), "sigma2": z.copy(),
                    "freqs": z.copy(), "ecorr": z.copy(),
                    "counts": np.zeros(self.npsr, dtype=np.int64)}
        st = self._store
        out = {k: st[k][:, :cap].copy()
               for k in ("t", "r", "sigma2", "freqs", "ecorr")}
        out["counts"] = self._n.copy()
        return out

    def batch_view(self) -> PulsarBatch:
        """The accumulated data as a PulsarBatch on the FROZEN grids, at
        the template's dtype on the stream's gather device: the
        posterior-refresh input (:mod:`..sample` consumes it). ECORR epoch
        ids are densified per pulsar (grouping is all the Sherman-Morrison
        correction needs)."""
        if self._cap == 0:
            raise ValueError("stream has no data yet")
        cap = self._cap
        t_abs = self._store["t"]
        mask = self._store["mask"]
        eidx = np.zeros((self.npsr, cap), dtype=np.int64)
        if self.ecorr_dt is not None:
            for p in range(self.npsr):
                n = int(self._n[p])
                if n:
                    _, inv = np.unique(self._store["eidx"][p, :n],
                                       return_inverse=True)
                    eidx[p, :n] = inv
        tpl = self.template.to(self.device)
        dt, dev = tpl.t_own.dtype, self.device

        def put(x, dtype=dt):
            return torch.as_tensor(np.asarray(x)).to(dtype=dtype,
                                                     device=dev)

        return dataclasses.replace(
            tpl,
            t_own=put(t_abs * self._df_own[:, None]),
            t_common=put(t_abs / self._tspan),
            mask=put(mask, torch.bool),
            freqs=put(self._store["freqs"]),
            sigma2=put(np.where(mask, self._store["sigma2"], 1.0)),
            epoch_idx=put(eidx, torch.int64),
            ecorr_amp=put(self._store["ecorr"]),
            sys_psd=torch.zeros((self.npsr, 1, 1), dtype=dt, device=dev),
            sys_mask=torch.zeros((self.npsr, 1, cap), dtype=torch.bool,
                                 device=dev))

    def residuals_view(self) -> np.ndarray:
        """(P, cap) masked residuals aligned with :meth:`batch_view`."""
        return self._store["r"] * self._store["mask"]

    def stats(self) -> dict:
        """The stream's stats payload: totals, bucket state, and the last
        rolling-detection numbers."""
        out = {
            "schema": STREAM_SCHEMA,
            "appends": int(self.appends),
            "n_toas": int(self._n.sum()),
            "npsr": int(self.npsr),
            "capacity": int(self._cap),
            "epoch_capacity": int(self._ecap),
            "rebuckets": int(self.rebuckets),
            "compiles": int(self.compiles),
            "recompiles": int(self.recompiles),
            "rolled_back": int(self.rolled_back),
        }
        if self.last_stats is not None:
            for key in ("snr", "amp2", "significance_sigma", "latency_ms"):
                if key in self.last_stats:
                    out[key] = self.last_stats[key]
        return out
