#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase (the default)
    python3 chip_smoke.py --phases build kernels

Phases, in order (any failure exits non-zero; no phase catches its own):

1. ``build``: print the card's name and power limit, compile every CUDA
   kernel from ``fakepta_tpu_torch/csrc`` (one nvcc per source, in
   parallel) and print the build seconds, ptxas' register report and the
   number of ``HMMA`` (tensor-core) instructions in each kernel's SASS
   (``cuobjdump -sass``); it fails if the kernels of
   ``binned_correlation``, ``binned_correlation_vpu`` or ``chunk_stats``'
   projection pass have none.
2. ``kernels``: at the flagship shapes (R = 1024 realizations, 100 pulsars,
   780 TOAs), hold each kernel against its plain torch version on the same
   inputs, at both precisions, and time kernel, plain version, the
   byte/FLOP bound and (where one exists) a single PyTorch library call;
   the sharded kernels at a psr shard's rows (PL = 25 or 50) against the
   whole array. For ``binned_correlation`` also its tiling and the 'f32'
   mode's 3xTF32 arithmetic emulated on 16 realizations against float64;
   for ``binned_correlation_vpu`` its tiling and realizations per block;
   for ``chunk_stats`` and ``chunk_stats_sharded`` the time of each of
   their two passes (projection, then ``binned_correlation``'s kernel)
   beside the whole, and one full-f32 ``einsum`` of the projection against
   a prebuilt dense basis as the projection's yardstick.
3. ``engine``: run ``EnsembleSimulator`` on the flagship batch with an HD
   background for ``stat_path`` ``"fused"``, ``"fused"`` with
   ``pallas_mxu_binning=False`` (``"fused-vpu"``) and ``"mega"`` at
   ``'f32'`` and ``'bf16'``; each must agree with the ``"einsum"`` path, rerun
   bit-identically and launch its kernel (launch counts are zeroed just
   before these runs and read just after). A small array is also held
   against the CPU engine.
4. ``mesh``: the flagship batch on ``make_mesh(["cuda:0"] * S,
   psr_shards=S)`` for S = 2 and 4, every path (einsum, fused, fused with
   ``pallas_mxu_binning=False``, mega) at both precisions: each must agree
   with the 1-shard einsum run, rerun bit-identically and launch its
   kernel once per shard and chunk (counts zeroed just before, read just
   after). The shards of such a mesh run one after another on the one
   card. A small array at one pulsar per shard is held against the CPU
   engine on the same mesh shape. On the 2-shard ``"mega"`` mesh (#4 at
   PL = 50) a depth-2 run must equal a depth-0 run bit for bit, and a
   1-shard run's checkpoint, cut after its first chunk, must resume there
   with the stored chunk unchanged and within the mesh bounds of the
   unbroken 1-shard run. Then TOA sharding, on the einsum path (the only
   one that takes it): the flagship at ``toa_shards`` 2 and 4 and on a
   psr 2 x toa 2 mesh, ``ipta_dr3`` at ``toa_shards=2`` and the flagship's
   OS lane with its null stream at ``toa_shards=2``, each at both
   precisions within rtol 5e-5 of the 1-shard einsum run (the JAX
   package's bound), rerun bit-identically, launching no kernel.
5. ``scenarios``: the scenario registry's arrays. ``ng15``, uncut (68
   pulsars padded to 512 TOAs, four backend bands, white hyperprior
   draws), built by ``registry.get("ng15").build(device="cuda")``: each
   kernel held against its plain version and timed at its shapes (PL = 68
   and a 2-shard mesh's PL = 34), then ``run(4096, chunk=1024)`` on
   ``"einsum"`` f32 (the yardstick), ``"fused"``, ``"fused"`` with
   ``pallas_mxu_binning=False`` and ``"mega"`` at both precisions, each
   held to the einsum run with bit-identical reruns and its kernel's
   launches. The flagship with BASELINE config 8's ``NoiseSampling``
   (per-pulsar red U(-17, -13) x U(1, 5), GWB amplitude U(-15, -14)) and
   config 11's ``WhiteSampling`` (efac U(0.5, 2.5), log10_tnequad U(-8,
   -5)) on ``"fused"`` the same way; a zero-width ``NoiseSampling`` run
   equal to the fixed-PSD run bit for bit; ``ng15`` on
   ``make_mesh(["cuda:0"] * 2, psr_shards=2)`` through every path, within
   the mesh bounds of the 1-shard einsum run; ``ng15`` reduced against the
   CPU engine.
6. ``signals``: ``ipta_dr3`` uncut (120 pulsars padded to 896 TOA slots,
   seven backend bands, per-pulsar red hyperprior draws, an anisotropic
   background, a CGW source and a BayesEphem Jupiter-mass draw per
   realization), built by ``registry.get("ipta_dr3").build(device="cuda")``:
   each kernel held against its plain version and timed at its shapes
   (PL = 120 and a 2-shard mesh's PL = 60, K = 320), then ``run(4096,
   chunk=1024)`` on ``"einsum"`` f32 (the yardstick), ``"fused"``,
   ``"fused"`` with ``pallas_mxu_binning=False`` and ``"mega"`` at both
   precisions (bit-identical reruns, kernel launches, ``peak_hbm_bytes``);
   the 2-shard mesh through every path within the mesh bounds; a
   checkpointed cut-and-resume round on ``"mega"``; the device time of one
   chunk split into keys, draws, Roemer, CGW and the statistic from the
   engine's spans in one ``torch.profiler``-traced step, and the Roemer
   term's mass-only shortcut against its full difference form (bit for
   bit, both timed). Then the flagship
   with BASELINE config 6 (a fixed Jupiter-mass ``RoemerConfig``), config
   9 (``CGWSampling``) and config 9 with the pulsar term and sampled
   distances (the host's per-chunk bulk staging timed) on ``"fused"``.
7. ``run``: the run loop at the flagship's full width, on ``"fused"``,
   ``"fused"`` with ``pallas_mxu_binning=False`` and ``"mega"`` at both
   precisions: ``run(4096, chunk=1024, pipeline_depth=d)`` for d = 0..3,
   bit-identical, each with its realizations/s and its allocator peak
   (which must stay under one bare step's peak plus the packed buffers the
   loop may hold, plus 2 MiB of allocator rounding per live large block);
   the checkpointed depth-2 run beside the plain one
   (``ckpt_wait_s``, ``pipeline_stall_s``); a checkpointed run cut by its
   progress callback after 3 chunks and resumed, and again with a torn
   chunk file rolled back, both bit-identical to the unbroken run with the
   checkpoint files gone after; a 1024-slot cohort of RNG lanes, each lane
   bit-identical to the lane alone at the same chunk and within tolerance
   of its solo run. Then one pipelined cut-and-resume round of ``ng15`` on
   ``"mega"``. Every run's launches are counted (zeroed just before, read
   just after).
8. ``detect``: the detection lane. Every kernel held against its plain
   version and timed at the OS lane's shapes: the main launch (16 + 3 OS
   weight slots, NB = 19; K = 320 for ``chunk_stats``), the null stream's
   (NB = 4, the GWB-free stage set K = 260), on the shared set and a
   2-shard mesh's rows, ``os="hd"``'s (NB = 17) and ``ipta_dr3``'s. Then
   the flagship's ``run(4096, chunk=1024, os=OSSpec(orf=("hd",
   "monopole", "dipole"), null=True))`` on ``"einsum"`` f32 (the
   yardstick), ``"fused"``, ``"fused"`` with ``pallas_mxu_binning=False``
   and ``"mega"`` at both precisions: amp2 and null amp2 within 1e-4 (f32)
   / 1e-2 (bf16) of max|amp2| of the einsum run, the curves within the
   engine's bounds, reruns bit-identical, each kernel launched twice per
   chunk (the main launch and the null stream's); one traced step per path
   split into keys, draws, statistic and the null stream; ``os="hd"``
   without the null stream through every path; every path on a 2-shard
   psr mesh; ``DetectionRun`` on the flagship batch (its launches counted,
   its artifact loaded back) and ``python -m fakepta_tpu_torch.detect run
   --npsr 100 --ntoa 780 --nreal 4096 --chunk 1024 --out build/detect.jsonl``
   in a subprocess (exit 0, the artifact loads); ``ipta_dr3`` uncut on
   ``"fused"`` with an HD and its own anisotropic template and the null
   stream (``peak_hbm_bytes``).
9. ``profile`` (only when asked for): per statistic path, the device time
   of one flagship chunk split into key derivation, draws + residual
   assembly and the statistic, plus torch.profiler's busiest kernels; then
   one 4-shard einsum chunk's host enqueue time against each card's busy
   time (over ``--mesh-cards`` cards).

The last lines are the kernel table as JSON (one entry per kernel and
shape the main path launched it at), the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
Details go to ``build/chip_smoke.json`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense)
PEAK_HBM_BPS = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

NREAL = 4096
CHUNK = 1024
TOL = {"f32": 1e-5, "bf16": 1e-2}
# the detection lane: amp2 and null amp2 within this share of max|amp2| of
# the einsum run (the JAX package's bound, tests/test_detect.py), three ORF
# templates with the paired null stream
OS_TOL = {"f32": 1e-4, "bf16": 1e-2}
DETECT_ORFS = ("hd", "monopole", "dipole")
# the toa rows: the JAX package's toa-sharding bound
TOA_RTOL = 5e-5
# the mesh phase: psr shard counts on one card, a shorter run, and the JAX
# package's own mesh-invariance bounds
MESH_SHARDS = (2, 4)
MESH_NREAL = 2048
MESH_TOL = {"f32": 1e-5, "bf16": 5e-3}
# a psr shard's rows in the kernel rows (100 pulsars over 4 and 2 shards)
SHARD_PL = (25, 50)
# the run phase: realizations per run, pipeline depths, a 1024-slot lane
# cohort
RUN_NREAL = 4096
RUN_DEPTHS = (0, 1, 2, 3)
RUN_LANES = ((11, 300), (22, 500), (33, 224))
# the most a live large-pool block of the caching allocator can exceed its
# request by, with room: a reused block is split only when more than 1 MiB
# would be left over, so a peak may read up to that much high per block
ALLOCATOR_GRANULE = 2 << 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, iters: int) -> dict:
    """Time each variant twice in the order a, b, b, a (one card, one call)
    and return each variant's mean of the two."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(time_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in got.items()}


def bound(bytes_moved: float, fp32_flops: float, bf16_flops: float,
          tf32_flops: float = 0.0):
    """(bound ms, 'bytes' | 'operations'): the larger of the byte time and
    the operation time at the card's published peaks."""
    t_bytes = bytes_moved / PEAK_HBM_BPS
    t_ops = (fp32_flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
             + tf32_flops / PEAK_TF32_FLOPS)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def stat_flops(R: int, PL: int, PF: int, T: int, NB: int, shared: bool):
    """(correlation FLOPs, binning FLOPs) that the statistic needs. With one
    operand set (res_local is res_full) each (P, P) block is symmetric, so
    only its P(P+1)/2 distinct pairs are needed: the binning folds
    w + w^T onto them, one multiply-add per pair and slot."""
    pairs = PL * (PL + 1) / 2 if shared else PL * PF
    return 2.0 * R * pairs * T, 2.0 * R * NB * pairs


def compare(got, want, prec: str, what: str, tol=None, rtol=None,
            ntoa: int = 128) -> dict:
    """Max abs/rel error of (curves, autos) against a reference; raises
    past the tolerance (``tol``, default TOL[prec], times max |reference
    curve| for the curves, relative for the autos). ``rtol`` instead holds
    each curve value within ``rtol`` of its reference plus 1e-7 of the
    scale per 128 of the ``ntoa`` TOA slots summed, and the autos within
    ``rtol``: the JAX package's toa-sharding bound (rtol 5e-5, 1e-7 of the
    scale at its test's 128 TOAs), its absolute term grown with the sum
    whose float32 rounding it bounds."""
    import torch
    gc, ga = (torch.as_tensor(x).double().cpu() for x in got)
    wc, wa = (torch.as_tensor(x).double().cpu() for x in want)
    if gc.shape != wc.shape or ga.shape != wa.shape:
        raise AssertionError(f"{what}: shape {tuple(gc.shape)} != "
                             f"{tuple(wc.shape)}")
    if not (torch.isfinite(gc).all() and torch.isfinite(ga).all()):
        raise AssertionError(f"{what}: non-finite output")
    scale = float(wc.abs().max())
    err_c = float((gc - wc).abs().max())
    err_a = float((ga - wa).abs().max())
    # an auto slot of zero weights (the null stream's) must come out zero
    rel_a = float(((ga - wa).abs() / wa.abs().clamp_min(1e-300)).max())
    tol = TOL[prec] if tol is None else tol
    atol = 1e-7 * max(ntoa / 128, 1.0)
    row = {"what": what, "precision": prec, "max_abs_err": max(err_c, err_a),
           "curves_err_over_scale": err_c / scale, "autos_rel_err": rel_a,
           "tolerance": tol if rtol is None
           else f"rtol {rtol} + {atol:.3g} of scale"}
    print(f"  {what} [{prec}]: curves max|d|/scale {err_c / scale:.3e}, "
          f"autos max rel {rel_a:.3e} (tolerance {row['tolerance']})",
          flush=True)
    if rtol is None:
        bad = err_c > tol * scale or rel_a > tol
    else:
        bad = bool(((gc - wc).abs() > rtol * wc.abs() + atol * scale).any()
                   or rel_a > rtol)
    if bad:
        raise AssertionError(f"{what} [{prec}] outside tolerance: {row}")
    return row


def os_compare(got: dict, want: dict, prec: str, what: str) -> dict:
    """Each ORF's amp2 (and null amp2 where the run has the null stream)
    against the reference run's within OS_TOL[prec] of its max|amp2| (the
    JAX package's bound for the fused OS lanes); raises past it."""
    errs = {}
    for orf in got["os"]["orfs"]:
        g, w = got["os"]["stats"][orf], want["os"]["stats"][orf]
        scale = float(np.abs(w["amp2"]).max())
        for k in ("amp2", "null_amp2"):
            if k not in g:
                continue
            if not np.isfinite(g[k]).all() or g[k].shape != w[k].shape:
                raise AssertionError(f"{what} {orf}/{k}: shape "
                                     f"{g[k].shape} or non-finite values")
            errs[f"{orf}/{k}"] = float(np.abs(g[k] - w[k]).max()) / scale
    worst = max(errs.values())
    print(f"  {what} [{prec}]: OS lanes max|d|/max|amp2| {worst:.3e} "
          f"(tolerance {OS_TOL[prec]:g})", flush=True)
    if worst > OS_TOL[prec]:
        raise AssertionError(f"{what} [{prec}] OS lanes outside tolerance: "
                             f"{errs}")
    return {"os_err_over_scale": errs, "os_tolerance": OS_TOL[prec]}


def flagship_sim(stat_path: str, mesh=None, batch=None, **kw):
    """The registry's ``flagship_100`` (its batch and HD background) on
    ``mesh`` (default: a 1x1 mesh on the card); ``kw`` adds engine
    arguments, ``batch`` replaces the registry's batch."""
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device="cuda")
    if mesh is None:
        kw["device"] = "cuda"
    kw = dict(scn.sim_kwargs(*parts), **kw)
    return EnsembleSimulator(parts[0] if batch is None else batch,
                             stat_path=stat_path, mesh=mesh, **kw)


def small_gwb(batch):
    """An HD background on a small test array's grid (4 bins)."""
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.parallel.montecarlo import GWBConfig
    f = np.arange(1, 5) / float(batch.tspan_common)
    return GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                               gamma=13 / 3).numpy())


def counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    return {"binned_correlation": bc.launches,
            "binned_correlation_vpu": bc.vpu_launches,
            "chunk_stats": mk.launches,
            "chunk_stats_sharded": mk.sharded_launches}


def shape_tag(pl: int, pf: int, t: int, nb=None, k=None) -> str:
    """A kernel launch's shape: rows, columns and TOAs, and where it is not
    the plain run's (16 weight slots, the array's own K), its weight slots
    ``nb`` and, for chunk_stats, its GP columns ``k``."""
    tag = f"PL={pl} PF={pf} T={t}"
    if nb is not None:
        tag += f" NB={nb}"
    if k is not None:
        tag += f" K={k}"
    return tag


def lane_shapes(sim, path: str, shards: int, n_os: int) -> tuple:
    """(the main launch's shape, the null stream's) of a run with ``n_os``
    OS lanes on ``sim`` over ``shards`` psr shards: NB = nbins + n_os + 1
    and n_os + 1; on the mega path K of the full and the GWB-free stage
    sets."""
    from fakepta_tpu_torch.ops import megakernel as mk
    npsr, t = sim.batch.npsr, sim.batch.max_toa
    k = (mk.stage_k(sim._mega_tables[0]), mk.stage_k(sim._mega_stages_null)
         ) if path == "mega" else (None, None)
    return (shape_tag(npsr // shards, npsr, t, sim.nbins + n_os + 1, k[0]),
            shape_tag(npsr // shards, npsr, t, n_os + 1, k[1]))


def add_launches(report: dict, shape: str, moved: dict) -> None:
    """Add main-path launch counts ``{kernel: n}`` made at ``shape`` to
    ``report["launches_by_shape"][kernel][shape]``."""
    by = report.setdefault("launches_by_shape", {})
    for name, n in moved.items():
        if n:
            by.setdefault(name, {})
            by[name][shape] = by[name].get(shape, 0) + n


def reset_counts() -> None:
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    bc.launches = bc.vpu_launches = 0
    mk.launches = mk.sharded_launches = 0


def sass_counts(path, opcode: str = "HMMA") -> dict:
    """{kernel: number of ``opcode`` instructions} in a built library's
    SASS (``cuobjdump -sass``, from the toolkit beside nvcc)."""
    from fakepta_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    got, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            got[fn] = 0
        elif fn is not None and opcode in line:
            got[fn] += 1
    return got


def phase_build(report: dict) -> None:
    from fakepta_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {len(logs)} sources compiled in "
          f"{report['build_s']:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"  {name}: {line.strip()}")
    report["hmma"] = {}
    for name in _build.KERNELS:
        _build.load(name)
        counts = sass_counts(_build.library_path(name))
        report["hmma"][name] = counts
        for fn, n in counts.items():
            print(f"  {name}: {n:5d} HMMA in {fn}")
    for name, lib, kernel in (
            ("binned_correlation", "binned_corr", "mma_corr_kernel"),
            ("binned_correlation_vpu", "binned_corr", "vpu_corr_kernel"),
            ("chunk_stats", "megakernel", "project_kernel")):
        mma = {fn: n for fn, n in report["hmma"][lib].items()
               if kernel in fn}
        if not mma or min(mma.values()) == 0:
            raise AssertionError(f"{name}'s kernels run no tensor-core "
                                 f"instruction: {mma}")


def kernel_rows(rows: dict, name: str, tag: str, kernel, plain, library,
                nbytes, flops, iters: int, precs=("bf16", "f32")) -> None:
    """Hold ``kernel(prec)`` against ``plain(prec)`` at each precision and
    time kernel, plain version and ``library`` (one PyTorch call, or None)
    beside the bound from ``nbytes(prec)`` and ``flops(prec)`` ((fp32,
    bf16[, tf32]) FLOPs, each at that type's peak). Rows go to
    ``rows[(name, prec, tag)]``."""
    import torch
    kernel_ms = in_turns({p: (lambda p=p: kernel(p)) for p in precs}, iters)
    plain_ms = in_turns({p: (lambda p=p: plain(p)) for p in precs},
                        max(5, iters // 2))
    library_ms = time_ms(library, 10) if library is not None else None
    for prec in precs:
        got = kernel(prec)
        want = plain(prec)
        torch.cuda.synchronize()
        row = compare(got, want, prec, f"{name} {tag} vs plain")
        row.update(ms=kernel_ms[prec], plain_ms=plain_ms[prec],
                   library_ms=library_ms, shape=tag)
        row["bound_ms"], row["bound_by"] = bound(nbytes(prec),
                                                 *flops(prec))
        rows[(name, prec, tag)] = row
        lib = ("" if library_ms is None
               else f", library {library_ms:.4f} ms")
        print(f"  {name} {tag} [{prec}]: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms{lib}, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']})", flush=True)


def mega_route_flops(prec: str, corr: float, other: float, proj: float):
    """(fp32, bf16, tf32) FLOPs that chunk_stats' work needs: the
    projection's ``proj`` FLOPs on the TF32 tensor cores, three times over
    at 'f32' (3xTF32) and twice under bf16 storage (the coefficients are
    exact in TF32, so their lo part is 0), then :func:`corr_flops_split`
    for the rest."""
    fp32, bf16, tf32 = corr_flops_split(prec, corr, other)
    return fp32, bf16, tf32 + (3 if prec == "f32" else 2) * proj


def corr_flops_split(prec: str, corr: float, other: float):
    """(fp32, bf16, tf32) FLOPs of a correlation and its binning: the
    correlation on the tensor cores, at 'f32' three times over at the TF32
    rate (3xTF32), in the bf16 mode, whose operands are bf16, once at the
    bf16 rate; the binning at fp32."""
    return (other, 0.0, 3 * corr) if prec == "f32" else (other, corr, 0.0)


def mma_details(rows: dict, res_l, res_f, w, nbins: int, tag: str) -> None:
    """binned_correlation's tiling at this shape, and the 'f32' mode's
    3xTF32 arithmetic, emulated in plain torch on 16 realizations, against
    float64."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    tiling = bc.mma_tiling(res_l.shape[1], res_f.shape[1])
    print(f"  binned_correlation {tag}: tiling {tiling}", flush=True)
    a, b = res_l[:16], res_f[:16]
    f64 = torch.einsum("rpt,rqt,npq->rn", a.double(), b.double(), w.double())
    emu = compare(bc.binned_correlation_3xtf32(a, b, w, nbins),
                  (f64[:, :nbins], f64[:, nbins]), "f32",
                  f"3xTF32 emulation {tag} vs float64")
    for p in ("bf16", "f32"):
        rows[("binned_correlation", p, tag)].update(
            tiling=tiling._asdict(), emulation_vs_f64=emu)


def vpu_details(rows: dict, pl: int, pf: int, nb: int, tag: str) -> None:
    """binned_correlation_vpu's tiling and realizations per block at this
    shape, per precision."""
    from fakepta_tpu_torch.ops import binned_corr as bc
    for p in ("bf16", "f32"):
        t = bc.vpu_tiling(pl, pf, nb, p, shared=pl == pf)
        print(f"  binned_correlation_vpu {tag} [{p}]: tiling {t.mma}, "
              f"rb {t.rb}, ldc {t.ldc}, {t.smem} B shared memory",
              flush=True)
        rows[("binned_correlation_vpu", p, tag)].update(
            tiling=t.mma._asdict(), rb=t.rb, smem=t.smem)


def mega_details(rows: dict, name: str, tag: str, operands: dict,
                 times, scales, w_l, kw: dict, stages, nbins: int,
                 proj_rows: int) -> None:
    """chunk_stats' two passes at this shape, timed alone in turns at both
    precisions (pass 1: the projection, ``megakernel._launch_project``;
    pass 2: ``binned_correlation``'s kernel on its residuals), and the
    projection's yardstick: one full-f32 einsum against a prebuilt dense
    basis (its build not timed; chunk_stats never calls it); raises unless
    a rerun of the whole function is bit-identical."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    t = mk.project_tiling(operands["f32"][0].shape[0], times.shape[2],
                          proj_rows, scales.shape[0])
    print(f"  {name} {tag}: projection tiling {t}", flush=True)
    local = {p: tuple(kw[p].values()) or (None,) * 4 for p in operands}
    res = {p: mk._launch_project(*operands[p], times, scales, stages,
                                 local[p]) for p in operands}
    fns = {}
    for p in operands:
        fns[("pass1", p)] = (lambda p=p: mk._launch_project(
            *operands[p], times, scales, stages, local[p]))
        fns[("pass2", p)] = (lambda p=p: bc.binned_correlation(
            res[p][0], res[p][1], w_l, nbins, precision=p))
    ms = in_turns(fns, 10)
    basis = mk.dense_basis(times, scales, stages)
    coef = operands["f32"][1]
    yard = time_ms(lambda: torch.einsum("rpk,ptk->rpt", coef, basis), 10)
    for p in operands:
        runs = [mk.chunk_stats(*operands[p], times, scales, w_l,
                               stages=stages, nbins=nbins, precision=p,
                               **kw[p]) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{name} {tag} [{p}] rerun is not "
                                 f"bit-identical")
        row = rows[(name, p, tag)]
        row.update(pass1_ms=ms[("pass1", p)], pass2_ms=ms[("pass2", p)],
                   pass1_einsum_ms=yard, projection_tiling=t._asdict(),
                   rerun_identical=True)
        print(f"  {name} {tag} [{p}]: pass 1 {row['pass1_ms']:.4f} ms, "
              f"pass 2 {row['pass2_ms']:.4f} ms, whole {row['ms']:.4f} ms; "
              f"pass-1 yardstick (f32 einsum rpk,ptk->rpt, prebuilt "
              f"basis) {yard:.4f} ms", flush=True)


def phase_kernels(report: dict) -> None:
    """Every kernel at the flagship's shapes (the shared set, and a 2- and
    4-shard mesh's rows)."""
    measure_kernels(report, flagship_sim("fused"), SHARD_PL, "kernels")


def measure_kernels(report: dict, sim, shard_pls, what: str, spec=None,
                    null: bool = False) -> None:
    """Hold each kernel against its plain version and time it, on one
    chunk of ``sim``'s own residuals: the shared operand set, and a psr
    shard's first PL rows for each PL in ``shard_pls``. Rows go to
    ``report["kernels"]``; the launches made here are not counted. With
    ``spec`` (an OSSpec) the weights are its OS lane's: the main launch's
    (bins, OS slots, auto), or with ``null`` the null stream's (OS slots
    and a zero auto) on the 0xD7 stream's own residuals and, for
    chunk_stats, its GWB-free stage set; the shape tags then carry NB and
    K."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _NULL_TAG, _chunk_keys
    from fakepta_tpu_torch.utils import rng

    keys = _chunk_keys(rng.key(7, device="cuda"), 0, CHUNK)
    if null:
        keys = rng.fold_in(keys, _NULL_TAG)
    with torch.no_grad():
        res = sim._residuals(keys, null=null)
        base, coefs = sim._residuals(keys, split_gp=True, null=null)
    torch.cuda.synchronize()
    w = sim._stat_weights
    stages, times, scales = sim._mega_tables
    if spec is not None:
        main, w_null = sim._prepare_lanes(spec).weights[id(sim._full)]
        w = w_null if null else main
        stages = sim._mega_stages_null if null else stages
    nbins = w.shape[0] - 1
    R, P, T = res.shape
    NB = w.shape[0]
    K = mk.stage_k(stages)
    S = scales.shape[0]

    def tag(pl, mega=False):
        """This measurement's shape tag at pl rows."""
        if spec is None:
            return shape_tag(pl, P, T)
        return shape_tag(pl, P, T, NB, K if mega else None)

    valid = float(sim.batch.mask.float().mean())
    print(f"{what}: R={R} P={P} T={T} K={K} NB={NB}, {valid:.4f} of the "
          f"TOA slots valid", flush=True)
    rows = {}

    def local(x, pl):
        """A psr shard's first pl rows, as a tensor of their own."""
        return x[:, :pl].contiguous()

    # -- binned_correlation (#1) and its mxu_binning=False variant (#2) --
    # shared: the single-device path's one operand set (symmetric block);
    # PL < PF: a psr shard's rows against the gathered array, at each shard
    # width the mesh phase launches; both multiply on the TF32 tensor cores
    for name, fn in (("binned_correlation", bc.binned_correlation),
                     ("binned_correlation_vpu", bc.binned_correlation_vpu)):
        for pl in (P,) + tuple(shard_pls):
            shared = pl == P
            res_l, w_l = (res, w) if shared else (local(res, pl),
                                                  local(w, pl))
            corr, binf = stat_flops(R, pl, P, T, NB, shared=shared)
            nbytes = 4.0 * (R * (pl if shared else pl + P) * T
                            + NB * pl * P + R * NB)
            kernel_rows(
                rows, name, tag(pl),
                lambda p, fn=fn, a=res_l, ww=w_l: fn(a, res, ww, nbins,
                                                     precision=p),
                lambda p, a=res_l, ww=w_l: bc.binned_correlation_plain(
                    a, res, ww, nbins, precision=p),
                lambda a=res_l, ww=w_l: torch.einsum("rpt,rqt,npq->rn", a,
                                                     res, ww),
                lambda p, n=nbytes: n,
                lambda p, c=corr, b=binf: corr_flops_split(p, c, b),
                iters=20)
            if name == "binned_correlation":
                mma_details(rows, res_l, res, w_l, nbins, tag(pl))
            else:
                vpu_details(rows, pl, P, NB, tag(pl))

    # -- chunk_stats: shared set (#3), local+full set (#4) ----------------
    # two passes: the projection (3xTF32 tensor-core products, two passes
    # under bf16 storage), then binned_correlation's kernel; the bytes
    # are the function's own, inputs once and output once (the residuals'
    # round trip between the passes is the design's, not the work's).
    # The bf16 mode stores base and coefficients in bfloat16, as the engine
    operands = {"f32": (base, coefs),
                "bf16": (base.to(torch.bfloat16), coefs.to(torch.bfloat16))}
    for pl in (P,) + tuple(shard_pls):
        shared = pl == P
        name = "chunk_stats" if shared else "chunk_stats_sharded"
        if shared:
            kw = {p: {} for p in operands}
            w_l = w
        else:
            kw = {p: dict(base_local=local(operands[p][0], pl),
                          coef_local=local(operands[p][1], pl),
                          times_local=local(times, pl),
                          scales_local=local(scales, pl))
                  for p in operands}
            w_l = local(w, pl)
        rows_read = pl if shared else pl + P
        corr, binf = stat_flops(R, pl, P, T, NB, shared=shared)
        proj = 2.0 * R * rows_read * K * T
        kernel_rows(
            rows, name, tag(pl, mega=True),
            lambda p, kw=kw, ww=w_l: mk.chunk_stats(
                *operands[p], times, scales, ww, stages=stages, nbins=nbins,
                precision=p, **kw[p]),
            lambda p, kw=kw, ww=w_l: mk.chunk_stats_plain(
                *operands[p], times, scales, ww, stages=stages, nbins=nbins,
                precision=p, **kw[p]),
            None,
            lambda p, n=rows_read, pl=pl: (
                (4 if p == "f32" else 2) * R * n * (T + K)
                + 4.0 * ((2 + S) * n * T + NB * pl * P + R * NB)),
            lambda p, c=corr, b=binf, j=proj: mega_route_flops(p, c, b, j),
            iters=10, precs=("f32", "bf16"))
        mega_details(rows, name, tag(pl, mega=True), operands, times,
                     scales, w_l, kw, stages, nbins, rows_read)
    report.setdefault("kernels", {}).update(
        {"/".join(k): dict(v, valid_toa_share=valid)
         for k, v in rows.items()})
    # launches made to compare with the plain versions do not count
    reset_counts()


#: the kernel each engine path launches on one shard, and on a psr-sharded
#: mesh
PATH_KERNEL = {"fused": "binned_correlation",
               "fused-vpu": "binned_correlation_vpu", "mega": "chunk_stats"}
SHARDED_KERNEL = dict(PATH_KERNEL, mega="chunk_stats_sharded")


def timed_run(sim, nreal: int, precision: str, seed: int = 1, **run_kw):
    """(output, wall seconds) of one ``run(nreal, chunk=CHUNK)``, between
    two synchronizations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run(nreal, seed=seed, chunk=CHUNK, precision=precision,
                  **run_kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def yardstick(label: str, sim, nreal: int = NREAL, seed: int = 1,
              **run_kw) -> tuple:
    """The einsum path's f32 run after a one-chunk warm-up: the reference
    every kernel path is held to, and its realizations/s."""
    sim.run(CHUNK, seed=99, chunk=CHUNK, **run_kw)
    out, dt = timed_run(sim, nreal, "f32", seed, **run_kw)
    row = {"realizations_per_s": nreal / dt, "wall_s": dt}
    print(f"{label}: einsum [f32] {nreal / dt:.1f} realizations/s "
          f"({dt:.3f} s for {nreal})", flush=True)
    return out, row


def drive_paths(report: dict, label: str, sims: dict, ref, shape: str,
                nreal: int = NREAL, seed: int = 1, tol=None, shards: int = 1,
                warm: bool = True, precs=("f32", "bf16"), os=None,
                rtol=None) -> dict:
    """The main path: each ``sims[path]`` at each precision, with every
    kernel count zeroed just before and read just after. Each run (after a
    one-chunk warm-up when ``warm``) is timed, rerun and held to ``ref``
    (default tolerance TOL[prec]; ``rtol``: :func:`compare`'s elementwise
    bound); the rerun must be bit-identical and the path's kernel launched
    ``shards`` times per chunk. Adds the launches to ``report`` at
    ``shape`` and returns one row per path and precision.

    ``os``: every run carries that OS lane (an ORF name or an OSSpec), its
    amp2 lanes are held to ``ref``'s (:func:`os_compare`), and with the
    null stream the kernel launches twice per chunk, at the two shapes of
    :func:`lane_shapes` (``shape`` is then only the einsum rows' label)."""
    from fakepta_tpu_torch.detect import as_spec
    spec = None if os is None else as_spec(os)
    run_kw = {} if os is None else {"os": os}
    per_chunk = 2 if spec is not None and spec.null else 1
    nchunks = -(-nreal // CHUNK)
    reset_counts()
    runs = {}
    for path, sim in sims.items():
        for prec in precs:
            before = counts()
            if warm:
                sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec,
                        **run_kw)
            out, dt = timed_run(sim, nreal, prec, seed, **run_kw)
            again = sim.run(nreal, seed=seed, chunk=CHUNK, precision=prec,
                            **run_kw)
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
            runs[(path, prec)] = (out, again, dt, moved)
            if spec is None:
                add_launches(report, shape, moved)
            else:
                main, null = lane_shapes(sim, path, shards, len(spec.orfs))
                add_launches(report, main,
                             {k: v // per_chunk for k, v in moved.items()})
                if per_chunk == 2:
                    add_launches(report, null,
                                 {k: v // 2 for k, v in moved.items()})
    rows = {}
    kernels = PATH_KERNEL if shards == 1 else SHARDED_KERNEL
    for (path, prec), (out, again, dt, moved) in runs.items():
        sim = sims[path]
        want = {kernels[path]: shards * per_chunk * (int(warm) + 2 * nchunks)
                } if path in kernels else {}
        if moved != want:
            raise AssertionError(f"{label} {path} [{prec}] launched "
                                 f"{moved}, expected {want}")
        row = compare((out["curves"], out["autos"]),
                      (ref["curves"], ref["autos"]), prec,
                      f"{label} {path} vs einsum",
                      tol=None if tol is None else tol[prec], rtol=rtol,
                      ntoa=sim.batch.max_toa)
        identical = (np.array_equal(out["curves"], again["curves"])
                     and np.array_equal(out["autos"], again["autos"]))
        if spec is not None:
            row.update(os_compare(out, ref, prec, f"{label} {path} vs "
                                                   f"einsum"))
            identical = identical and all(
                np.array_equal(out["os"]["stats"][o][k],
                               again["os"]["stats"][o][k])
                for o in out["os"]["orfs"]
                for k in ("amp2", "null_amp2") if k in out["os"]["stats"][o])
        if not identical:
            raise AssertionError(f"{label} {path} [{prec}] rerun is not "
                                 f"bit-identical")
        if out["curves"].shape != (nreal, sim.nbins):
            raise AssertionError(f"{label} {path}: curves shape "
                                 f"{out['curves'].shape}")
        peak = again["report"].memory.get("peak_hbm_bytes")
        row.update(realizations_per_s=nreal / dt, wall_s=dt,
                   kernel_launches=moved, rerun_identical=identical,
                   peak_hbm_bytes=peak)
        rows[f"{path}/{prec}"] = row
        print(f"{label}: {path} [{prec}] {nreal / dt:.1f} realizations/s "
              f"({dt:.3f} s), launches {moved}, rerun bit-identical, "
              f"peak_hbm_bytes {peak}", flush=True)
    return rows


def phase_engine(report: dict) -> None:
    sims = {p: flagship_sim(p.split("-")[0],
                            pallas_mxu_binning=p != "fused-vpu")
            for p in ("einsum", "fused", "fused-vpu", "mega")}
    ref, row = yardstick("engine", sims.pop("einsum"))
    npsr, ntoa = sims["fused"].batch.npsr, sims["fused"].batch.max_toa
    eng = {"einsum/f32": row}
    eng.update(drive_paths(report, "engine", sims, ref,
                           shape_tag(npsr, npsr, ntoa)))
    report["engine"] = eng

    # a small array against the CPU engine (the plain versions)
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
    small = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    gwb = small_gwb(small)
    cpu = EnsembleSimulator(small, gwb=gwb, stat_path="einsum",
                            device="cpu").run(64, seed=3, chunk=32)
    for path in ("fused", "fused-vpu", "mega"):
        gpu = EnsembleSimulator(small, gwb=gwb, stat_path=path.split("-")[0],
                                pallas_mxu_binning=path != "fused-vpu",
                                device="cuda").run(64, seed=3, chunk=32,
                                                   precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"small array: cuda {path} vs cpu einsum")


def phase_mesh(report: dict, cards: int = 1) -> None:
    """The flagship batch on ``make_mesh(["cuda:0"] * S, psr_shards=S)``
    for every statistic path at both precisions, held against the 1-shard
    einsum run, rerun bit-identically, with each path's kernel launched
    once per shard and chunk; then a small array at one pulsar per shard
    against the CPU engine on the same mesh shape. With ``cards`` > 1 the
    flagship meshes span that many cards instead (the rest of the factor
    goes to the real axis), so shards run on cards of their own."""
    import torch
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator

    nchunks = -(-MESH_NREAL // CHUNK)
    counters = {"einsum": (), "fused": ("binned_correlation",),
                "fused-vpu": ("binned_correlation_vpu",),
                "mega": ("chunk_stats_sharded",)}
    ref_sim = flagship_sim("einsum")
    refs = {p: ref_sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=p)
            for p in ("f32", "bf16")}

    def sim_for(path, shards):
        devices = (["cuda:0"] * shards if cards == 1
                   else [f"cuda:{i}" for i in range(cards)])
        return flagship_sim(path.split("-")[0],
                            mesh=make_mesh(devices, psr_shards=shards),
                            pallas_mxu_binning=path != "fused-vpu")

    where = ("shards run one after another on one card" if cards == 1
             else f"over {cards} cards")

    sims = {(path, s): sim_for(path, s)
            for s in MESH_SHARDS for path in counters}
    torch.cuda.synchronize()

    # the sharded path: launch counts zeroed just before, read just after
    reset_counts()
    rows = {}
    for (path, shards), sim in sims.items():
        for prec in ("f32", "bf16"):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=prec)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            again = sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=prec)
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
            # once per chunk, real shard and psr shard, in each of 2 runs
            n_real = sim.mesh.shape["real"]
            want = {k: 2 * nchunks * n_real * shards
                    for k in counters[path]}
            if moved != want:
                raise AssertionError(f"mesh {path} x{shards} [{prec}] "
                                     f"launched {moved}, expected {want}")
            npsr = sim.batch.npsr
            add_launches(report, shape_tag(npsr // shards, npsr,
                                           sim.batch.max_toa), moved)
            row = compare((out["curves"], out["autos"]),
                          (refs[prec]["curves"], refs[prec]["autos"]), prec,
                          f"mesh {path} psr_shards={shards} vs 1-shard "
                          f"einsum", tol=MESH_TOL[prec])
            identical = all(np.array_equal(out[k], again[k])
                            for k in ("curves", "autos"))
            if not identical:
                raise AssertionError(f"mesh {path} x{shards} [{prec}] "
                                     f"rerun is not bit-identical")
            row.update(realizations_per_s=MESH_NREAL / dt, wall_s=dt,
                       kernel_launches=moved, rerun_identical=identical)
            rows[f"{path}/x{shards}/{prec}/{cards} card(s)"] = row
            print(f"mesh: {path} psr_shards={shards} [{prec}] "
                  f"{MESH_NREAL / dt:.1f} realizations/s ({dt:.3f} s; "
                  f"{where}), launches {moved}, rerun bit-identical",
                  flush=True)

    # the run loop on a sharded mesh: depth 2 against depth 0, bit for bit
    sim = sims[("mega", 2)]
    npsr = sim.batch.npsr
    for prec in ("f32", "bf16"):
        outs = {}
        for d in (0, 2):
            outs[d], dt, n = counted(
                report, shape_tag(npsr // 2, npsr, sim.batch.max_toa),
                "chunk_stats_sharded", lambda: sim.run(
                    MESH_NREAL, seed=5, chunk=CHUNK, precision=prec,
                    pipeline_depth=d),
                want=nchunks * sim.mesh.shape["real"] * 2)
            rows[f"mega/x2/{prec}/depth{d}"] = {
                "realizations_per_s": MESH_NREAL / dt, "launches": n}
        assert_identical(outs[2], outs[0], f"mesh mega psr_shards=2 "
                                           f"[{prec}] depth 2 against depth 0")
        rates = [rows[f"mega/x2/{prec}/depth{d}"]["realizations_per_s"]
                 for d in (0, 2)]
        print(f"mesh: mega psr_shards=2 [{prec}] depth 2 bit-identical to "
              f"depth 0 ({rates[0]:.1f} / {rates[1]:.1f} realizations/s)",
              flush=True)

    # the resumed stream does not depend on the mesh: a 1-shard run cut
    # after its first chunk resumes on the 2-shard mega mesh, keeps the
    # stored chunk bit for bit and lands within the mesh bound of the
    # unbroken 1-shard run
    ckdir = os.path.join(HERE, "build", "mesh_resume")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    for prec in ("f32", "bf16"):
        ck = os.path.join(ckdir, f"mesh_{prec}.npz")
        try:
            ref_sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=prec,
                        pipeline_depth=2, checkpoint=ck,
                        progress=kill_after(1))
        except Kill:
            pass
        else:
            raise AssertionError(f"mesh resume [{prec}]: the cut run "
                                 f"finished")
        out, _, n = counted(
            report, shape_tag(npsr // 2, npsr, sim.batch.max_toa),
            "chunk_stats_sharded", lambda: sim.run(
                MESH_NREAL, seed=5, chunk=CHUNK, precision=prec,
                pipeline_depth=2, checkpoint=ck),
            want=(nchunks - 1) * sim.mesh.shape["real"] * 2)
        want = refs[prec]
        if not all(np.array_equal(out[k][:CHUNK], want[k][:CHUNK])
                   for k in ("curves", "autos")):
            raise AssertionError(f"mesh resume [{prec}]: the stored chunk "
                                 f"changed")
        if ckpt_family(ck):
            raise AssertionError(f"mesh resume [{prec}]: "
                                 f"{ckpt_family(ck)} left")
        row = compare((out["curves"], out["autos"]),
                      (want["curves"], want["autos"]), prec,
                      "mesh mega psr_shards=2 resumed from a 1-shard "
                      "checkpoint vs the unbroken 1-shard einsum run",
                      tol=MESH_TOL[prec])
        row["launches"] = n
        rows[f"mega/x2/{prec}/resumed_from_1_shard"] = row
    shutil.rmtree(ckdir, ignore_errors=True)
    rows.update(toa_rows(report, ref_sim, refs, cards))
    report["mesh"] = rows

    # one pulsar per shard, against the CPU engine on the same mesh shape
    from fakepta_tpu_torch.batch import PulsarBatch
    small = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    gwb = small_gwb(small)
    cpu = EnsembleSimulator(small, gwb=gwb, stat_path="einsum",
                            mesh=make_mesh(["cpu"] * 8, psr_shards=8)
                            ).run(64, seed=3, chunk=32)
    for path in counters:
        gpu = EnsembleSimulator(
            small, gwb=gwb, stat_path=path.split("-")[0],
            pallas_mxu_binning=path != "fused-vpu",
            mesh=make_mesh(["cuda:0"] * 8, psr_shards=8)).run(
                64, seed=3, chunk=32, precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"small array psr_shards=8: cuda {path} vs cpu einsum")


def toa_rows(report: dict, ref_sim, refs: dict, cards: int) -> dict:
    """TOA sharding (the einsum path only): the flagship at toa_shards 2
    and 4 and on a psr 2 x toa 2 mesh, ipta_dr3 at toa_shards 2 (448 TOA
    slots a window) and the flagship's OS lane with its null stream at
    toa_shards 2, each at both precisions against the 1-shard einsum run at
    the same precision (the JAX package's bound, rtol 5e-5; the OS lanes
    within OS_TOL), rerun bit-identically, launching no kernel. Over one
    card (cells in turn) or ``cards`` cards."""
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.parallel.mesh import make_mesh

    def mesh(psr, toa):
        n = psr * toa
        devices = (["cuda:0"] * n if cards == 1
                   else [f"cuda:{i}" for i in range(cards)])
        return make_mesh(devices, psr_shards=psr, toa_shards=toa)

    spec = OSSpec(orf=DETECT_ORFS, null=True)
    ipta_refs = {p: ipta_sim("einsum").run(MESH_NREAL, seed=5, chunk=CHUNK,
                                           precision=p)
                 for p in ("f32", "bf16")}
    os_refs = {p: ref_sim.run(MESH_NREAL, seed=5, chunk=CHUNK, precision=p,
                              os=spec) for p in ("f32", "bf16")}
    cases = {
        "flagship toa_shards=2": (lambda: flagship_sim("einsum",
                                                       mesh=mesh(1, 2)),
                                  refs, None),
        "flagship toa_shards=4": (lambda: flagship_sim("einsum",
                                                       mesh=mesh(1, 4)),
                                  refs, None),
        "flagship psr_shards=2 toa_shards=2": (
            lambda: flagship_sim("einsum", mesh=mesh(2, 2)), refs, None),
        "ipta_dr3 toa_shards=2": (lambda: ipta_sim("einsum", mesh=mesh(1, 2)),
                                  ipta_refs, None),
        "flagship os null toa_shards=2": (
            lambda: flagship_sim("einsum", mesh=mesh(1, 2)), os_refs, spec),
    }
    out = {}
    for label, (build, ref, os_spec) in cases.items():
        sim = build()
        npsr, t = sim.batch.npsr, sim.batch.max_toa
        toa = sim.mesh.shape["toa"]
        for prec in ("f32", "bf16"):
            got = drive_paths(
                report, f"mesh {label}", {"einsum": sim}, ref[prec],
                shape_tag(npsr // sim.mesh.shape["psr"], npsr, t // toa),
                nreal=MESH_NREAL, seed=5, warm=False, precs=(prec,),
                os=os_spec, rtol=TOA_RTOL)
            for k, v in got.items():
                out[f"{label} {k}"] = v
        del sim
    return out


def ng15_sim(path: str, mesh=None, **kw):
    """The registry's ``ng15``, uncut, through its own entry point, on the
    card (or ``mesh``) with statistic path ``path``."""
    from fakepta_tpu_torch.scenarios import registry
    return registry.get("ng15").build(
        mesh=mesh, device=None if mesh is not None else "cuda",
        stat_path=path.split("-")[0],
        pallas_mxu_binning=path != "fused-vpu", **kw)


def pinned_flagship(stat_path: str):
    """(fixed, pinned): the flagship with zero-width NoiseSampling ranges
    at its own red and GWB parameters, and the fixed-PSD flagship whose red
    PSD and GWB PSD hold the float32 values the sampler computes on the
    card (the same operations on the same device)."""
    import torch
    from fakepta_tpu_torch import spectrum as spectrum_lib
    from fakepta_tpu_torch.batch import PulsarBatch
    from fakepta_tpu_torch.parallel.montecarlo import (GWBConfig,
                                                       NoiseSampling)
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("flagship_100")
    batch = scn.batch_parts(device="cuda")[0]

    def full(ndim, v):
        return torch.full((1,) * ndim, v, dtype=torch.float32, device="cuda")

    f_red = torch.arange(1, scn.n_red + 1, dtype=torch.float32,
                         device="cuda") * batch.df_own[:, None]
    f_gwb = torch.arange(1, scn.gwb_ncomp + 1, dtype=torch.float32,
                         device="cuda") * (1.0 / batch.tspan_common)
    leaves = batch.numpy()
    leaves["red_psd"] = spectrum_lib.powerlaw(
        f_red, full(3, scn.red_log10_A), full(3, scn.red_gamma))[0].cpu() \
        .numpy()
    gwb_psd = spectrum_lib.powerlaw(
        f_gwb, full(2, scn.gwb_log10_A), full(2, scn.gwb_gamma))[0].cpu() \
        .numpy()
    fixed = flagship_sim(
        stat_path, batch=PulsarBatch.from_numpy(leaves, device="cuda"),
        gwb=GWBConfig(psd=gwb_psd))
    pin = [NoiseSampling("red", log10_A=(scn.red_log10_A,) * 2,
                         gamma=(scn.red_gamma,) * 2),
           NoiseSampling("gwb", log10_A=(scn.gwb_log10_A,) * 2,
                         gamma=(scn.gwb_gamma,) * 2)]
    return fixed, flagship_sim(stat_path, noise_sample=pin)


def phase_scenarios(report: dict) -> None:
    """The scenario registry's arrays on the card (module docstring, phase
    5): ng15 uncut through every path, its kernels at its shapes, the
    flagship with BASELINE configs 8 and 11's draws, and ng15 on a 2-shard
    mesh. Each main-path run zeroes the kernel counts just before it and
    reads them just after."""
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import (NoiseSampling,
                                                       WhiteSampling)
    out = {}

    # -- ng15, uncut: 68 pulsars padded to 512 TOAs, four backend bands ---
    ref, out["ng15 einsum/f32"] = yardstick("scenarios ng15",
                                            ng15_sim("einsum"))
    sims = {p: ng15_sim(p) for p in ("fused", "fused-vpu", "mega")}
    batch = sims["fused"].batch
    npsr, ntoa = batch.npsr, batch.max_toa
    print(f"scenarios ng15: {npsr} pulsars x {ntoa} TOA slots "
          f"({float(batch.mask.float().mean()):.4f} valid), "
          f"{batch.sys_mask.shape[1]} backend bands, white hyperprior "
          f"draws; stages {sims['mega'].include}", flush=True)
    measure_kernels(report, sims["fused"], (npsr // 2,), "scenarios ng15")
    for k, v in drive_paths(report, "scenarios ng15", sims, ref,
                            shape_tag(npsr, npsr, ntoa)).items():
        out[f"ng15 {k}"] = v

    # -- the flagship with BASELINE config 8's and config 11's draws ------
    flag_npsr = 100
    configs = {
        "config 8": dict(noise_sample=[
            NoiseSampling("red", log10_A=(-17.0, -13.0), gamma=(1.0, 5.0)),
            NoiseSampling("gwb", log10_A=(-15.0, -14.0),
                          gamma=(13 / 3, 13 / 3))]),
        "config 11": dict(white_sample=WhiteSampling(
            efac=(0.5, 2.5), log10_tnequad=(-8.0, -5.0)),
            # the flagship's raw squared TOA error, no efac or EQUAD baked in
            toaerr2=np.full((flag_npsr, 780), 1e-7 ** 2)),
    }
    for name, kw in configs.items():
        label = f"scenarios flagship {name}"
        ref, out[f"flagship {name} einsum/f32"] = yardstick(
            label, flagship_sim("einsum", **kw))
        rows = drive_paths(report, label, {"fused": flagship_sim("fused",
                                                                 **kw)},
                           ref, shape_tag(flag_npsr, flag_npsr, 780))
        for k, v in rows.items():
            out[f"flagship {name} {k}"] = v

    # a zero-width NoiseSampling run is the fixed-PSD run, bit for bit
    fixed, pinned = pinned_flagship("fused")
    reset_counts()
    for prec in ("f32", "bf16"):
        a = fixed.run(2 * CHUNK, seed=6, chunk=CHUNK, precision=prec)
        b = pinned.run(2 * CHUNK, seed=6, chunk=CHUNK, precision=prec)
        if not all(np.array_equal(a[k], b[k]) for k in ("curves", "autos")):
            raise AssertionError(f"zero-width NoiseSampling [{prec}] is not "
                                 f"the fixed-PSD run bit for bit")
    add_launches(report, shape_tag(flag_npsr, flag_npsr, 780), counts())
    out["flagship zero-width NoiseSampling"] = {"bit_identical": True}
    print("scenarios flagship: zero-width NoiseSampling equals the "
          "fixed-PSD run bit for bit (fused, f32 and bf16)", flush=True)

    # -- ng15 on two psr shards of the card (34 pulsars each) -------------
    ref = ng15_sim("einsum").run(MESH_NREAL, seed=5, chunk=CHUNK,
                                 precision="f32")
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    sims = {p: ng15_sim(p, mesh=mesh) for p in ("einsum", "fused",
                                                "fused-vpu", "mega")}
    rows = drive_paths(report, "scenarios ng15 psr_shards=2", sims, ref,
                       shape_tag(npsr // 2, npsr, ntoa), nreal=MESH_NREAL,
                       seed=5, tol=MESH_TOL, shards=2, warm=False)
    for k, v in rows.items():
        out[f"ng15 psr_shards=2 {k}"] = v

    # ng15 reduced: the card against the CPU engine (the plain versions)
    from fakepta_tpu_torch.scenarios import registry
    small = registry.get("ng15").reduced(max_psr=16, max_toa=128)
    cpu = small.build(device="cpu", stat_path="einsum").run(64, seed=3,
                                                           chunk=32)
    for path in ("fused", "mega"):
        gpu = small.build(device="cuda", stat_path=path).run(
            64, seed=3, chunk=32, precision="f32")
        compare((gpu["curves"], gpu["autos"]),
                (cpu["curves"], cpu["autos"]), "f32",
                f"ng15 reduced: cuda {path} vs cpu einsum")
    report["scenarios"] = out


def ipta_sim(path: str, mesh=None, **kw):
    """The registry's ``ipta_dr3``, uncut, through its own entry point, on
    the card (or ``mesh``) with statistic path ``path``."""
    from fakepta_tpu_torch.scenarios import registry
    return registry.get("ipta_dr3").build(
        mesh=mesh, device=None if mesh is not None else "cuda",
        stat_path=path.split("-")[0],
        pallas_mxu_binning=path != "fused-vpu", **kw)


def chunk_split(sim, path: str, label: str = "signals ipta_dr3",
                lanes=None) -> dict:
    """Device ms of one chunk step by the engine's spans (keys; residuals,
    which hold the sampled Roemer and CGW terms; the statistic) in one
    ``torch.profiler``-traced step. Each span appears on the device
    timeline as an annotation from its first kernel to its last: its
    ``busy`` is the time of the kernels inside it, its ``extent`` the
    annotation's length (idle gaps included). Draws = residuals - roemer -
    cgw. ``lanes`` (:meth:`EnsembleSimulator._prepare_lanes`): the step
    carries that OS lane; its null stream is the span ``null``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fakepta_tpu_torch.utils import rng

    prec = sim._resolve_precision(path, None)
    base = rng.key(11, device="cuda")
    with torch.no_grad():
        sim.step(base, 0, CHUNK, path, prec, lanes=lanes)         # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            sim.step(base, CHUNK, CHUNK, path, prec, lanes=lanes)
            torch.cuda.synchronize()
        step_ms = time_ms(lambda: sim.step(base, 2 * CHUNK, CHUNK, path,
                                           prec, lanes=lanes), 2, warmup=0)
    reset_counts()
    names = ("keys", "residuals", "roemer", "cgw", "statistic", "null")
    spans, kernels = {}, []
    for ev in p.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        if ev.name in names:
            spans.setdefault(ev.name, []).append((tr.start, tr.end))
        else:
            kernels.append((tr.start, tr.elapsed_us() / 1e3))
    if "residuals" not in spans:
        raise AssertionError(f"chunk split [{path}]: the traced step has no "
                             f"span on the device timeline: {sorted(spans)}")
    row = {"path": path, "precision": prec, "step_ms": step_ms,
           "device_busy_ms": sum(d for _, d in kernels),
           "kernel_launches": len(kernels)}
    for name, ivs in spans.items():
        inside = [(t, d) for t, d in kernels
                  if any(lo <= t < hi for lo, hi in ivs)]
        row[f"{name}_ms"] = sum(d for _, d in inside)
        row[f"{name}_launches"] = len(inside)
        row[f"{name}_extent_ms"] = sum(hi - lo for lo, hi in ivs) / 1e3
    for key in ("ms", "launches", "extent_ms"):
        row[f"draws_{key}"] = row[f"residuals_{key}"] - sum(
            row.get(f"{n}_{key}", 0) for n in ("roemer", "cgw"))
    print(f"{label} chunk split [{path}, {prec}], kernel ms "
          f"(launches; span extent ms): " + ", ".join(
              f"{n} {row.get(n + '_ms', 0):.3f} "
              f"({row.get(n + '_launches', 0)}; "
              f"{row.get(n + '_extent_ms', 0):.3f})"
              for n in ("keys", "draws", "roemer", "cgw", "statistic",
                        "null"))
          + f"; traced step device busy {row['device_busy_ms']:.3f} ms over "
          f"{len(kernels)} kernel launches; untraced step {step_ms:.3f} ms",
          flush=True)
    return row


def roemer_shortcut(sim) -> dict:
    """The sampled Roemer term of one chunk, mass-only draws through the
    engine's shortcut and through the full difference form (every orbit
    perturbation its (R, 1, 1) zero draw, as the engine would pass them
    without the shortcut): the two must agree bit for bit; each is timed
    between CUDA events."""
    import torch
    from fakepta_tpu_torch.models.roemer import roemer_delay_dev
    from fakepta_tpu_torch.parallel import montecarlo as tmc
    from fakepta_tpu_torch.utils import rng

    sh = sim._full
    state, scales, zero = sh.signals.roemer[0]
    keys = tmc._chunk_keys(rng.key(11, device="cuda"), 0, CHUNK)
    # the engine's per-realization draws, (R, 1, 1) each; the orbit
    # perturbations' scales are zero, so theirs are signed zeros
    d = rng.normal(rng.fold_in(rng.fold_in(keys, tmc._ROEMER_TAG), 0), 7) \
        * scales
    full = {name: d[:, i].reshape(-1, 1, 1)
            for i, name in enumerate(tmc._ROEMER_PARAMS)}
    if not all(zero[1:]):
        raise AssertionError(f"ipta_dr3's Roemer draws are not mass-only: "
                             f"{zero}")
    with torch.no_grad():
        got = roemer_delay_dev(state, sh.batch.pos, d_mass=full["d_mass"])
        want = roemer_delay_dev(state, sh.batch.pos, **full)
        if not torch.equal(got, want):
            raise AssertionError("the mass-only Roemer shortcut differs from "
                                 "the full difference form")
        row = {"shortcut_ms": time_ms(lambda: roemer_delay_dev(
            state, sh.batch.pos, d_mass=full["d_mass"]), 3, warmup=1),
            "difference_form_ms": time_ms(lambda: roemer_delay_dev(
                state, sh.batch.pos, **full), 3, warmup=1),
            "bit_identical": True}
    print(f"signals ipta_dr3 Roemer term, mass-only draws: shortcut "
          f"{row['shortcut_ms']:.3f} ms, full difference form "
          f"{row['difference_form_ms']:.3f} ms, bit-identical", flush=True)
    return row


def phase_signals(report: dict) -> None:
    """CGW and BayesEphem signals on the card (module docstring, phase
    ``signals``): ipta_dr3 uncut through every path, its kernels at its
    shapes, its 2-shard mesh, a checkpointed round on mega, the per-stage
    chunk split, and the flagship with BASELINE configs 6 and 9. Each
    main-path run zeroes the kernel counts just before it and reads them
    just after."""
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.parallel.montecarlo import (CGWSampling,
                                                       RoemerConfig)
    from fakepta_tpu_torch.scenarios import registry
    out = {}

    # -- ipta_dr3, uncut --------------------------------------------------
    yard = ipta_sim("einsum")
    ref, out["ipta_dr3 einsum/f32"] = yardstick("signals ipta_dr3", yard)
    sims = {p: ipta_sim(p) for p in ("fused", "fused-vpu", "mega")}
    batch = sims["fused"].batch
    npsr, ntoa = batch.npsr, batch.max_toa
    sig = sims["fused"]._full.signals
    shape_row = {
        "spec_hash": registry.get("ipta_dr3").spec_hash(), "pulsars": npsr,
        "toa_slots": ntoa, "valid_share": float(batch.mask.float().mean()),
        "backend_bands": int(batch.sys_mask.shape[1]),
        "K": mk.stage_k(sims["mega"]._mega_tables[0]),
        "roemer_bodies": len(sig.roemer), "cgw_sources": len(sig.cgw),
        "stages": list(sims["mega"].include)}
    out["ipta_dr3 shape"] = shape_row
    print(f"signals ipta_dr3 ({shape_row['spec_hash']}): {npsr} pulsars x "
          f"{ntoa} TOA slots ({shape_row['valid_share']:.4f} valid), "
          f"{shape_row['backend_bands']} backend bands, K = "
          f"{shape_row['K']}, {len(sig.roemer)} sampled body, "
          f"{len(sig.cgw)} sampled source; stages {sims['mega'].include}",
          flush=True)
    measure_kernels(report, sims["fused"], (npsr // 2,), "signals ipta_dr3")
    for k, v in drive_paths(report, "signals ipta_dr3", sims, ref,
                            shape_tag(npsr, npsr, ntoa)).items():
        out[f"ipta_dr3 {k}"] = v
    out["ipta_dr3 chunk split"] = {
        p: chunk_split(s, p) for p, s in (("einsum", yard),
                                          ("fused", sims["fused"]),
                                          ("mega", sims["mega"]))}
    out["ipta_dr3 roemer shortcut"] = roemer_shortcut(sims["fused"])

    # -- a checkpointed cut-and-resume round on mega ----------------------
    ckdir = os.path.join(HERE, "build", "signals_phase")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    shape = shape_tag(npsr, npsr, ntoa)
    for prec in ("f32", "bf16"):
        want, _, _ = counted(report, shape, "chunk_stats",
                             lambda: sims["mega"].run(
                                 NREAL, seed=21, chunk=CHUNK, precision=prec,
                                 pipeline_depth=2), want=NREAL // CHUNK)
        out[f"ipta_dr3 mega/{prec} resume"] = resume_round(
            report, "signals ipta_dr3 mega", sims["mega"], prec,
            "chunk_stats", shape, ckdir, want, NREAL, torn=False)
    shutil.rmtree(ckdir, ignore_errors=True)

    # -- ipta_dr3 on two psr shards of the card (60 pulsars each) ---------
    ref = yard.run(MESH_NREAL, seed=5, chunk=CHUNK, precision="f32")
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    msims = {p: ipta_sim(p, mesh=mesh) for p in ("einsum", "fused",
                                                 "fused-vpu", "mega")}
    rows = drive_paths(report, "signals ipta_dr3 psr_shards=2", msims, ref,
                       shape_tag(npsr // 2, npsr, ntoa), nreal=MESH_NREAL,
                       seed=5, tol=MESH_TOL, shards=2, warm=False)
    for k, v in rows.items():
        out[f"ipta_dr3 psr_shards=2 {k}"] = v
    del msims, sims, yard

    # -- the flagship with BASELINE config 6 and config 9 -----------------
    toas_abs = registry.get("flagship_100").batch_parts(device="cpu")[1]
    tref = float(toas_abs.mean())
    configs = {
        "config 6": dict(roemer=RoemerConfig("jupiter",
                                             d_mass=1e-4 * 1.899e27)),
        "config 9": dict(cgw_sample=CGWSampling(tref=tref)),
        # config 9 with the pulsar term and sampled distances (1 +- 0.2 kpc):
        # each chunk's retarded-phase bulks are staged on the host
        "config 9 psrterm": dict(
            cgw_sample=CGWSampling(tref=tref, psrterm=True,
                                   sample_pdist=True),
            pdist=np.tile([1.0, 0.2], (100, 1))),
    }
    for name, kw in configs.items():
        label = f"signals flagship {name}"
        ref, out[f"flagship {name} einsum/f32"] = yardstick(
            label, flagship_sim("einsum", toas_abs=toas_abs, **kw))
        sim = flagship_sim("fused", toas_abs=toas_abs, **kw)
        rows = drive_paths(report, label, {"fused": sim}, ref,
                           shape_tag(100, 100, 780))
        for k, v in rows.items():
            out[f"flagship {name} {k}"] = v
    # the host's bulk staging in the last run: chunk 0's before the loop,
    # each later chunk's right after the previous dispatch
    staged = [e["dur"] for e in sim.last_report.timeline
              if e["name"] in ("stage_inputs", "precompute")]
    if len(staged) != NREAL // CHUNK:
        raise AssertionError(f"psrterm bulks staged {len(staged)} times for "
                             f"{NREAL // CHUNK} chunks")
    out["flagship config 9 psrterm bulk staging ms"] = [
        1e3 * d for d in staged]
    print(f"signals flagship config 9 psrterm: host bulk staging per chunk "
          f"{', '.join(f'{1e3 * d:.3f}' for d in staged)} ms", flush=True)
    report["signals"] = out


class Kill(Exception):
    """Raised by a progress callback to cut a checkpointed run."""


def kill_after(n_chunks: int):
    """A progress callback that ends the run once ``n_chunks`` chunks have
    drained (each of them checkpointed first)."""
    def boom(done, nreal):
        if done >= n_chunks * CHUNK:
            raise Kill
    return boom


def counted(report: dict, shape: str, kernel: str, fn, want=None):
    """Run ``fn`` (one main-path run) with every kernel count zeroed just
    before and read just after; adds the launches to ``report`` at
    ``shape``. Raises unless only ``kernel`` was launched, ``want`` times
    when given. Returns (fn's result or the exception it raised, wall
    seconds between two synchronizations, launches)."""
    import torch
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = fn()
    except Kill as exc:
        # without its traceback: that holds this frame, and a cycle
        # through it would keep the cut run's simulator on the card
        result = exc.with_traceback(None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: v for k, v in counts().items() if v}
    add_launches(report, shape, moved)
    if set(moved) != {kernel} or (want is not None
                                  and moved[kernel] != want):
        raise AssertionError(f"launched {moved}, expected {kernel} x "
                             f"{want if want is not None else 'some'}")
    return result, dt, moved[kernel]


def assert_identical(a: dict, b: dict, what: str) -> None:
    if not all(np.array_equal(a[k], b[k]) for k in ("curves", "autos")):
        raise AssertionError(f"{what} is not bit-identical")


def ckpt_family(ck: str) -> list:
    """The checkpoint's files (the flight-recorder dump of a cut run
    aside)."""
    d, name = os.path.split(ck)
    return sorted(p for p in os.listdir(d) if p.startswith(name))


def step_working_set(sim, prec: str, steps: int = 3) -> int:
    """Peak allocated bytes of a bare chunk step (with its key), the
    simulator's resident tensors included: the largest over ``steps``
    steps at successive offsets, each alone, once the allocator's cache is
    warm (a cached block may be up to 1 MB larger than the request, so a
    first step on a cold cache reads low). Their launches are not
    counted."""
    import torch
    peaks = []
    for i in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            packed, _ = sim.step(sim._base_key(21), i * CHUNK, CHUNK,
                                 sim.stat_path, prec)
        torch.cuda.synchronize()
        del packed
        peaks.append(torch.cuda.max_memory_allocated())
    reset_counts()
    return max(peaks)


def resume_round(report: dict, label: str, sim, prec: str, kernel: str,
                 shape: str, ckdir: str, want: dict, nreal: int,
                 torn: bool) -> dict:
    """A depth-2 checkpointed run cut after 3 chunks, then resumed; with
    ``torn`` the second chunk file is truncated before the resume and must
    roll back. Holds the result to ``want`` bit for bit and checks that the
    checkpoint's files are gone. Returns the round's row."""
    ck = os.path.join(ckdir, f"{label.replace(' ', '_')}_{prec}.npz")
    cut, _, n_cut = counted(report, shape, kernel, lambda: sim.run(
        nreal, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2,
        checkpoint=ck, progress=kill_after(3)))
    if not isinstance(cut, Kill):
        raise AssertionError(f"{label} [{prec}]: the cut run finished")
    saved = [p for p in ckpt_family(ck) if ".c0" in p]
    if len(saved) < 3:
        raise AssertionError(f"{label} [{prec}]: {saved} after the cut")
    if torn:
        path = ck + ".c000001.npz"
        with open(path, "rb") as fh:
            data = fh.read()
        with open(path, "wb") as fh:
            fh.write(data[:len(data) // 2])
    n_chunks = -(-nreal // CHUNK)
    resumed_chunks = n_chunks - (1 if torn else len(saved))
    out, _, n_res = counted(report, shape, kernel, lambda: sim.run(
        nreal, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2,
        checkpoint=ck), want=resumed_chunks)
    assert_identical(out, want, f"{label} [{prec}] resumed run")
    rolled = out["report"].counters.get("faults.rollbacks", 0)
    if rolled != (len(saved) - 1 if torn else 0):
        raise AssertionError(f"{label} [{prec}]: {rolled} chunks rolled "
                             f"back")
    if ckpt_family(ck):
        raise AssertionError(f"{label} [{prec}]: {ckpt_family(ck)} left")
    what = "torn chunk rolled back" if torn else "resumed"
    print(f"{label} [{prec}]: cut after {len(saved)} checkpointed chunks "
          f"({n_cut} launches), {what}: {n_res} chunks, {rolled} rolled "
          f"back, bit-identical, checkpoint files gone", flush=True)
    return {"cut_launches": n_cut, "resumed_launches": n_res,
            "chunks_saved_at_cut": len(saved), "rolled_back": rolled,
            "bit_identical": True}


def run_round(report: dict, label: str, sim, prec: str, kernel: str,
              shape: str, ckdir: str) -> dict:
    """The run loop on one path and precision (module docstring, phase
    ``run``): depths 0-3, the checkpointed run and its cut/resume and
    torn-chunk rounds, the lane cohort, the report and its peak memory."""
    import torch
    row = {}
    sim.run(CHUNK, seed=99, chunk=CHUNK, precision=prec)      # warm-up
    working = step_working_set(sim, prec)
    nchunks = RUN_NREAL // CHUNK
    outs = {}
    for d in RUN_DEPTHS:
        outs[d], dt, n = counted(report, shape, kernel, lambda: sim.run(
            RUN_NREAL, seed=21, chunk=CHUNK, precision=prec,
            pipeline_depth=d), want=nchunks)
        rep = outs[d]["report"]
        summ = rep.summary()
        # the packed buffers the loop may hold: the ring's bound when
        # pipelined; the serial loop keeps every chunk's until the end
        ring = rep.memory.get("packed_depth_bound_bytes",
                              nchunks * rep.memory["packed_buffer_bytes"])
        peak = rep.memory["peak_hbm_bytes"]
        # what the allocator may add: one granule per live large block
        # (the run reset the peak counts when it started)
        blocks = torch.cuda.memory_stats()["active.large_pool.peak"]
        slack = ALLOCATOR_GRANULE * blocks
        if peak > working + ring + slack:
            raise AssertionError(
                f"{label} [{prec}] depth {d}: peak {peak} B over the step's "
                f"working set {working} B + the packed buffers {ring} B + "
                f"{blocks} large blocks' allocator slack {slack} B")
        assert_identical(outs[d], outs[RUN_DEPTHS[0]],
                         f"{label} [{prec}] depth {d} against depth 0")
        row[f"depth{d}"] = {
            "realizations_per_s": RUN_NREAL / dt, "wall_s": dt,
            "launches": n, "pipeline_stall_s": summ["pipeline_stall_s"],
            "peak_hbm_bytes": peak, "packed_ring_bytes": ring,
            "step_working_set_bytes": working,
            "live_large_blocks_peak": blocks, "allocator_slack_bytes": slack,
            "execute_s": [c.get("execute_s") for c in rep.chunks]}
        print(f"{label} [{prec}] depth {d}: {RUN_NREAL / dt:.1f} "
              f"realizations/s ({dt:.3f} s), stall "
              f"{summ['pipeline_stall_s']:.4f} s, peak {peak} B <= step "
              f"working set {working} B + packed buffers {ring} B + "
              f"slack {slack} B ({blocks} large blocks; "
              f"{working + ring - peak} B under the bound without it), "
              f"bit-identical to depth 0", flush=True)
    print(f"{label} [{prec}] depth 3 report: "
          f"{json.dumps(outs[3]['report'].summary())}", flush=True)

    # the checkpointed depth-2 run, unbroken, beside the plain one
    ck = os.path.join(ckdir, f"full_{label.replace(' ', '_')}_{prec}.npz")
    full, dt, n = counted(report, shape, kernel, lambda: sim.run(
        RUN_NREAL, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2,
        checkpoint=ck), want=nchunks)
    assert_identical(full, outs[2], f"{label} [{prec}] checkpointed run")
    if ckpt_family(ck):
        raise AssertionError(f"{label} [{prec}]: {ckpt_family(ck)} left")
    summ = full["report"].summary()
    row["checkpointed"] = {
        "realizations_per_s": RUN_NREAL / dt, "wall_s": dt, "launches": n,
        "ckpt_wait_s": summ["ckpt_wait_s"],
        "pipeline_stall_s": summ["pipeline_stall_s"],
        "uncheckpointed_realizations_per_s":
            row["depth2"]["realizations_per_s"]}
    print(f"{label} [{prec}] checkpointed depth 2: {RUN_NREAL / dt:.1f} "
          f"realizations/s beside {row['depth2']['realizations_per_s']:.1f} "
          f"without; ckpt_wait_s {summ['ckpt_wait_s']:.4f}, "
          f"pipeline_stall_s {summ['pipeline_stall_s']:.4f}", flush=True)
    row["resume"] = resume_round(report, label, sim, prec, kernel, shape,
                                 ckdir, outs[2], RUN_NREAL, torn=False)
    row["torn"] = resume_round(report, label, sim, prec, kernel, shape,
                               ckdir, outs[2], RUN_NREAL, torn=True)

    # a 1024-slot cohort of lanes: each lane bit for bit its lane alone at
    # the same chunk, and within tolerance of its solo run
    cohort, _, _ = counted(report, shape, kernel, lambda: sim.run(
        CHUNK, chunk=CHUNK, precision=prec, lanes=RUN_LANES), want=1)
    lanes, pos = {}, 0
    for s, n in RUN_LANES:
        alone, _, _ = counted(report, shape, kernel, lambda: sim.run(
            CHUNK, chunk=CHUNK, precision=prec, lanes=[(s, n)]), want=1)
        mine = {k: cohort[k][pos:pos + n] for k in ("curves", "autos")}
        assert_identical(mine, {k: alone[k][:n] for k in ("curves",
                                                          "autos")},
                         f"{label} [{prec}] lane ({s}, {n}) against it alone")
        solo, _, _ = counted(report, shape, kernel,
                             lambda: sim.run(n, seed=s, chunk=n,
                                             precision=prec), want=1)
        lanes[f"{s}x{n}"] = compare(
            (mine["curves"], mine["autos"]), (solo["curves"], solo["autos"]),
            prec, f"{label} lane ({s}, {n}) vs run({n}, seed={s})")
        pos += n
    row["lanes"] = lanes
    print(f"{label} [{prec}]: lanes {list(RUN_LANES)} each bit-identical to "
          f"the lane alone at chunk {CHUNK}", flush=True)
    return row


def phase_run(report: dict) -> None:
    """The run loop on the card (module docstring, phase 6): every path at
    the flagship's full width through :func:`run_round`, then one
    pipelined checkpoint-resume round of ng15 on ``"mega"``."""
    import torch
    ckdir = os.path.join(HERE, "build", "run_phase")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    out = {}
    for path in ("fused", "fused-vpu", "mega"):
        sim = flagship_sim(path.split("-")[0],
                           pallas_mxu_binning=path != "fused-vpu")
        shape = shape_tag(sim.batch.npsr, sim.batch.npsr, sim.batch.max_toa)
        for prec in ("f32", "bf16"):
            out[f"{path}/{prec}"] = run_round(report, f"run {path}", sim,
                                              prec, PATH_KERNEL[path],
                                              shape, ckdir)
        del sim
        torch.cuda.empty_cache()
    sim = ng15_sim("mega")
    shape = shape_tag(sim.batch.npsr, sim.batch.npsr, sim.batch.max_toa)
    for prec in ("f32", "bf16"):
        want, _, _ = counted(report, shape, "chunk_stats", lambda: sim.run(
            NREAL, seed=21, chunk=CHUNK, precision=prec, pipeline_depth=2),
            want=NREAL // CHUNK)
        out[f"ng15 mega/{prec}"] = resume_round(
            report, "run ng15 mega", sim, prec, "chunk_stats", shape, ckdir,
            want, NREAL, torn=False)
    shutil.rmtree(ckdir, ignore_errors=True)
    report["run"] = out


def lane_launches(report: dict, sim, path: str, n_os: int,
                  moved: dict) -> None:
    """Add an OS-lane run's launches, half at the main launch's shape and
    half at the null stream's (:func:`lane_shapes`, one shard)."""
    main, null = lane_shapes(sim, path, 1, n_os)
    add_launches(report, main, {k: v // 2 for k, v in moved.items()})
    add_launches(report, null, {k: v // 2 for k, v in moved.items()})


def phase_detect(report: dict) -> None:
    """The detection lane on the card (module docstring, phase
    ``detect``): every kernel at the OS lane's slot counts and the null
    stream's stage set, the flagship through every path with three ORF
    lanes and the null stream, ``os="hd"`` alone, a 2-shard mesh,
    ``DetectionRun`` and the CLI, and ipta_dr3 uncut on ``"fused"``. Each
    main-path run zeroes the kernel counts just before it and reads them
    just after."""
    import torch
    from fakepta_tpu_torch.detect import DetectionRun, OSSpec
    from fakepta_tpu_torch.obs.report import RunReport
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.scenarios import registry
    out = {}
    spec = OSSpec(orf=DETECT_ORFS, null=True)
    n_os = len(DETECT_ORFS)
    paths = ("einsum", "fused", "fused-vpu", "mega")
    sims = {p: flagship_sim(p.split("-")[0],
                            pallas_mxu_binning=p != "fused-vpu")
            for p in paths}

    # -- the kernels at the lane's shapes: the main launch (NB = 19; K =
    # 320 on chunk_stats) and the null stream's (NB = 4, K = 260), on the
    # shared set and a 2-shard mesh's rows; os="hd"'s main launch (NB = 17)
    for null in (False, True):
        measure_kernels(report, sims["mega"], (50,),
                        f"detect {'null' if null else 'main'} launch",
                        spec=spec, null=null)
    measure_kernels(report, sims["mega"], (), "detect os=hd launch",
                    spec=OSSpec(orf="hd"))

    # -- the flagship, three ORF lanes with the null stream, every path ---
    yard = sims.pop("einsum")
    ref, out["flagship os+null einsum/f32"] = yardstick(
        "detect flagship os+null", yard, os=spec)
    for k, v in drive_paths(report, "detect flagship os+null", sims, ref,
                            shape_tag(100, 100, 780), os=spec).items():
        out[f"flagship os+null {k}"] = v
    out["flagship os+null chunk split"] = {
        p: chunk_split(s, p, "detect flagship os+null",
                       s._prepare_lanes(spec))
        for p, s in (("einsum", yard), ("fused", sims["fused"]),
                     ("mega", sims["mega"]))}
    # os="hd" alone, without the null stream (the hd lane of the same
    # keys is the reference run's)
    for k, v in drive_paths(report, "detect flagship os=hd",
                            {"einsum": yard, **sims}, ref,
                            shape_tag(100, 100, 780), os="hd").items():
        out[f"flagship os=hd {k}"] = v

    # -- every path on a 2-shard psr mesh, shards in turn on the card -----
    mref = yard.run(MESH_NREAL, seed=5, chunk=CHUNK, precision="f32",
                    os=spec)
    mesh = make_mesh(["cuda:0"] * 2, psr_shards=2)
    msims = {p: flagship_sim(p.split("-")[0], mesh=mesh,
                             pallas_mxu_binning=p != "fused-vpu")
             for p in paths}
    for k, v in drive_paths(report, "detect flagship os+null psr_shards=2",
                            msims, mref, shape_tag(50, 100, 780),
                            nreal=MESH_NREAL, seed=5, tol=MESH_TOL,
                            shards=2, warm=False, os=spec).items():
        out[f"flagship os+null psr_shards=2 {k}"] = v
    del msims, sims, yard
    torch.cuda.empty_cache()

    # -- DetectionRun on the flagship batch (the engine's default path:
    # "fused", bf16 operands), its artifact, and the CLI in a subprocess --
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device="cuda")
    study = DetectionRun(parts[0], gwb=scn.sim_kwargs(*parts)["gwb"],
                         os=DETECT_ORFS, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = study.run(NREAL, seed=2, chunk=CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: v for k, v in counts().items() if v}
    if moved != {"binned_correlation": 2 * (NREAL // CHUNK)}:
        raise AssertionError(f"DetectionRun launched {moved}")
    lane_launches(report, study.sim, "fused", n_os, moved)
    art = study.save(os.path.join(HERE, "build", "detect_study.jsonl"))
    loaded = RunReport.load(art).summary()
    if any(loaded.get(k) != v for k, v in res["summary"].items()):
        raise AssertionError("DetectionRun's artifact does not load with "
                             "its summary")
    out["DetectionRun flagship"] = dict(
        res["summary"], realizations_per_s=NREAL / dt, launches=moved,
        os_real_per_s_per_chip=loaded["os_real_per_s_per_chip"])
    print(f"detect DetectionRun flagship: {NREAL / dt:.1f} realizations/s, "
          f"launches {moved}, summary {json.dumps(res['summary'])}",
          flush=True)
    del study, res
    cli_out = os.path.join(HERE, "build", "detect.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fakepta_tpu_torch.detect", "run", "--npsr",
         "100", "--ntoa", "780", "--nreal", "4096", "--chunk", "1024",
         "--out", cli_out], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the detection CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    rep = RunReport.load(cli_out)
    if rep.meta.get("platform") != "gpu" or not rep.meta["os"]["null"]:
        raise AssertionError(f"the CLI's artifact: {rep.meta}")
    out["CLI"] = dict(row, wall_s=time.perf_counter() - t0,
                      device_kind=rep.meta["device_kind"])
    print(f"detect CLI: exit 0 in {out['CLI']['wall_s']:.1f} s, "
          f"{json.dumps(row)}; artifact loads", flush=True)

    # -- ipta_dr3 uncut on "fused", HD and its own anisotropic template ---
    ipta = registry.get("ipta_dr3")
    ispec = OSSpec(orf=("hd", "anisotropic"), h_map=ipta.gwb_h_map(),
                   null=True)
    iref, out["ipta_dr3 os+null einsum/f32"] = yardstick(
        "detect ipta_dr3 os+null", ipta_sim("einsum"), os=ispec)
    fused = ipta_sim("fused")
    for null in (False, True):
        measure_kernels(report, fused, (),
                        f"detect ipta_dr3 {'null' if null else 'main'} "
                        f"launch", spec=ispec, null=null)
    for k, v in drive_paths(report, "detect ipta_dr3 os+null",
                            {"fused": fused}, iref,
                            shape_tag(120, 120, 896), os=ispec).items():
        out[f"ipta_dr3 os+null {k}"] = v
    report["detect"] = out


def phase_profile(report: dict, cards: int = 1) -> None:
    """Where one flagship chunk's device time goes, per statistic path:
    CUDA-event times of the key derivation, the draws + residual assembly
    and the statistic, then torch.profiler's busiest kernels; then the host
    and device time of one sharded chunk (:func:`profile_sharded_step`)."""
    import torch
    from fakepta_tpu_torch.ops import binned_corr as bc
    from fakepta_tpu_torch.ops import megakernel as mk
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng

    prof = {}
    base_key = rng.key(11, device="cuda")
    for path in ("einsum", "fused", "mega"):
        sim = flagship_sim(path)
        prec = sim._resolve_precision(path, None)
        stages, times, scales = sim._mega_tables
        w = sim._stat_weights
        with torch.no_grad():
            keys = _chunk_keys(base_key, 0, CHUNK)
            split = path == "mega"
            resid = sim._residuals(keys, split_gp=split)

            def statistic():
                if path == "einsum":
                    return torch.einsum(
                        "rpq,npq->rn",
                        torch.einsum("rpt,rqt->rpq", resid, resid), w)
                if path == "fused":
                    return bc.binned_correlation(resid, resid, w, sim.nbins,
                                                 precision=prec)
                return mk.chunk_stats(resid[0], resid[1], times, scales, w,
                                      stages=stages, nbins=sim.nbins,
                                      precision=prec)

            row = {"precision": prec,
                   "keys_ms": time_ms(lambda: _chunk_keys(
                       base_key, 0, CHUNK), 5, warmup=1),
                   "residuals_ms": time_ms(lambda: sim._residuals(
                       keys, split_gp=split), 3, warmup=1),
                   "statistic_ms": time_ms(statistic, 3, warmup=1),
                   "step_ms": time_ms(lambda: sim.step(
                       base_key, 0, CHUNK, path, prec), 3, warmup=1)}
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                sim.step(base_key, 0, CHUNK, path, prec)
                torch.cuda.synchronize()
            row["profiled_wall_ms"] = 1e3 * (time.perf_counter() - t0)
            kern = []
            for ev in p.key_averages():
                # kernel rows only: the aten rows repeat their kernels' time
                if ev.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
                if dev_us:
                    kern.append((dev_us / 1e3, ev.count, ev.key[:90]))
            kern.sort(reverse=True)
            row["device_busy_ms"] = sum(k[0] for k in kern)
            row["n_kernel_launches"] = sum(k[1] for k in kern)
            row["top_kernels"] = kern[:6]
        reset_counts()
        prof[path] = row
        print(f"profile {path} [{prec}] per {CHUNK}-realization chunk: "
              f"keys {row['keys_ms']:.3f} ms, draws+residuals "
              f"{row['residuals_ms']:.3f} ms, statistic "
              f"{row['statistic_ms']:.3f} ms, step {row['step_ms']:.3f} ms; "
              f"profiled step: device busy {row['device_busy_ms']:.3f} ms "
              f"of {row['profiled_wall_ms']:.3f} ms wall, "
              f"{row['n_kernel_launches']} kernel launches", flush=True)
        for ms, count, name in row["top_kernels"]:
            print(f"    {ms:9.3f} ms  x{count:<5d} {name}")
    report["profile"] = prof
    report["profile_mesh"] = profile_sharded_step(cards)


def sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def profile_sharded_step(cards: int, shards: int = 4) -> dict:
    """Host against device time of one sharded flagship chunk (einsum path,
    ``psr_shards=shards``; its shards on cuda:0 in turn, or spread over
    ``cards`` cards as the mesh phase spreads them): the host time until
    ``step`` returns (the enqueue), the time until every card is done, and
    each card's kernel busy time in one torch.profiler-traced step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fakepta_tpu_torch.parallel.mesh import make_mesh
    from fakepta_tpu_torch.utils import rng

    devices = (["cuda:0"] * shards if cards == 1
               else [f"cuda:{i}" for i in range(cards)])
    sim = flagship_sim("einsum", mesh=make_mesh(devices, psr_shards=shards))
    key = rng.key(13, device="cuda")
    enq, full = [], []
    with torch.no_grad():
        sim.step(key, 0, CHUNK, "einsum", "f32")                # warm-up
        for i in range(3):
            sync_all()
            t0 = time.perf_counter()
            sim.step(key, (i + 1) * CHUNK, CHUNK, "einsum", "f32")
            enq.append(1e3 * (time.perf_counter() - t0))
            sync_all()
            full.append(1e3 * (time.perf_counter() - t0))
        sync_all()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            sim.step(key, 0, CHUNK, "einsum", "f32")
            sync_all()
    busy, launches = {}, {}
    for ev in p.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = f"cuda:{ev.device_index}"
        busy[dev] = busy.get(dev, 0.0) + ev.time_range.elapsed_us() / 1e3
        launches[dev] = launches.get(dev, 0) + 1
    row = {"path": "einsum", "precision": "f32", "psr_shards": shards,
           "cards": cards, "mesh_shape": dict(sim.mesh.shape),
           "enqueue_ms": sum(enq) / len(enq),
           "step_ms": sum(full) / len(full),
           "device_busy_ms": busy, "kernel_launches": launches}
    print(f"profile sharded step (einsum [f32], psr_shards={shards}, "
          f"{cards} card(s), mesh {row['mesh_shape']}) per {CHUNK}-"
          f"realization chunk: host enqueue {row['enqueue_ms']:.3f} ms, "
          f"step to every card done {row['step_ms']:.3f} ms; traced step "
          f"device busy {', '.join(f'{d} {ms:.3f} ms' for d, ms in sorted(busy.items()))}; "
          f"kernel launches {launches}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+",
                    default=["build", "kernels", "engine", "mesh",
                             "scenarios", "signals", "run", "detect"],
                    choices=["build", "kernels", "engine", "mesh",
                             "scenarios", "signals", "run", "detect",
                             "profile"])
    ap.add_argument("--mesh-cards", type=int, default=1,
                    help="cards the mesh and profile phases' flagship "
                         "meshes span (default 1: every shard on cuda:0)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import fakepta_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()
    report = {"card": card, "phases": args.phases, "phase_s": {}}
    phases = {"build": phase_build, "kernels": phase_kernels,
              "engine": phase_engine,
              "mesh": lambda r: phase_mesh(r, args.mesh_cards),
              "scenarios": phase_scenarios, "signals": phase_signals,
              "run": phase_run, "detect": phase_detect,
              "profile": lambda r: phase_profile(r, args.mesh_cards)}
    for name, phase in phases.items():
        if name in args.phases:
            t0 = time.perf_counter()
            phase(report)
            report["phase_s"][name] = time.perf_counter() - t0
            print(f"phase {name}: {report['phase_s'][name]:.1f} s",
                  flush=True)
    report["total_s"] = time.perf_counter() - t_start

    # one entry per kernel and shape that the main path launched it at or
    # the phases measured it at (the flagship's shared operand set and its
    # 2- and 4-shard meshes' PL = 50 and 25; ng15's PL = 68 and its 2-shard
    # mesh's PL = 34; ipta_dr3's PL = 120 and 60; the detection lane's
    # weight-slot counts NB and chunk_stats' K where they are not the plain
    # run's), each with the launches made at that shape in the main-path
    # runs (0 where none was made)
    table = []
    specs = (("binned_correlation", "bf16",
              "fakepta_tpu_torch/csrc/binned_corr.cu",
              "fakepta_tpu/ops/pallas_kernels.py:160"),
             ("binned_correlation_vpu", "bf16",
              "fakepta_tpu_torch/csrc/binned_corr.cu",
              "fakepta_tpu/ops/pallas_kernels.py:223"),
             ("chunk_stats", "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:281"),
             ("chunk_stats_sharded", "f32",
              "fakepta_tpu_torch/csrc/megakernel.cu",
              "fakepta_tpu/ops/megakernel.py:384"))
    kernels = report.get("kernels", {})
    by_shape = report.get("launches_by_shape", {})
    for name, prec, source, replaces in specs:
        shapes = dict(by_shape.get(name, {}))
        for k in kernels:
            if k.startswith(name + "/"):
                shapes.setdefault(k.split("/")[2], 0)
        for shape, n in shapes.items():
            row = kernels.get(f"{name}/{prec}/{shape}", {})
            table.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "precision": prec, "shape": shape,
                "launches": n, "max_abs_err": row.get("max_abs_err"),
                "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
                "bound_ms": row.get("bound_ms"),
                "bound_by": row.get("bound_by"),
                "library_ms": row.get("library_ms")})
    report["table"] = table
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(f"total {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": table}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
