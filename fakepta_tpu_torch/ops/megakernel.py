"""Whole-chunk statistic (port of fakepta_tpu.ops.megakernel).

The draws assemble only the cheap per-realization operands: the residual
**base** (R, P, T) (white + ECORR + system noise, TOA-masked) and the GP
**coefficients** (R, P, K) (draws times spectrum weights, the GWB Cholesky
coupling). :func:`chunk_stats` turns them into the binned statistic in two
hand-written CUDA passes on one stream, which replace the TPU kernel
``chunk_stats`` (its ``_mega_kernel``) together:

1. the projection kernel (``csrc/megakernel.cu``, ``fpt_project``)
   rebuilds the sine-cosine Fourier bases on chip from the small ``(time,
   scale)`` tables and computes ``res = base + coef @ B`` per pulsar as a
   GEMM on the TF32 tensor cores (3xTF32: the projection is f32 in both
   precisions; two passes under bf16 storage, whose coefficients are exact
   in TF32), 128 realizations x 128 TOAs per block, so each basis value is
   built once per 128 realizations. Bound by its products, then by its
   bytes (the source's header has the numbers).
2. :mod:`.binned_corr`'s kernel (``fpt_binned_corr``) correlates and bins
   the projected residuals, bound by their read.

The dense (P, T, K) basis never exists in device memory; the residuals make
one round trip (R (PL + PF) T 4 bytes written by pass 1 and read by pass 2),
where the TPU kernel, on an HBM-bound chip, kept them in VMEM. On an H100
that round trip costs ~0.2 ms per flagship chunk, while keeping the
residuals on chip beside the correlation blocks capped a block at two
realizations and rebuilt each basis value hundreds of times.
:func:`chunk_stats_plain` is the same function in plain torch, with the
dense basis.

Two operand sets, as in the JAX kernel: the shared set (all pulsars in one
shard, ``base_local=None``) correlates the array with itself; the
local+full set (a psr shard) correlates the shard's rows against the
gathered array, and pass 1 projects both sides itself (each shard
recomputes the full rows from the gathered coefficients). Wrapper rules as
in :mod:`.binned_corr`; ``launches`` counts :func:`chunk_stats`' calls on
the shared set and ``sharded_launches`` on the local+full set (one each for
both passes).

On a float64 batch (float64 time and scale tables) the route follows the TPU
kernel's dtypes, whose ``cdtype`` is the base's: float64 base and
coefficients (``'f32'``) run pass 1 as ``fpt_project_f64``'s float64 DMMA
projection (a pipelined mainloop: a ``cp.async`` coefficient ring, the basis
built a stage ahead between the k-steps, one barrier a stage;
:data:`PROJ_TILE_F64`) and pass 2
as ``fpt_binned_corr_f64``, float64 throughout, with
float64 curves and autos; bf16 storage runs at float32 as on a float32 batch,
but its basis is built from the float64 tables at float64 and rounded once to
float32 (the TPU kernel's float64 tables promote the phase and the basis,
and its float32 product rounds the basis), and pass 2 bins against the
weights rounded to float32; its curves and autos are float32.
``f64_launches`` and ``f64_sharded_launches`` count these calls.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .binned_corr import (SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED,
                          _count, _launch as _correlate, round_bf16,
                          split_tf32)

#: number of times :func:`chunk_stats` launched its kernels on the shared
#: operand set
launches = 0
#: ... and on the local+full operand set (a psr shard)
sharded_launches = 0
#: :func:`chunk_stats`' calls on float64 tables, on the shared set and on
#: the local+full set
f64_launches = 0
f64_sharded_launches = 0

# time-table rows staged for the in-kernel basis recompute
T_OWN, T_COMMON = 0, 1
MAX_STAGES = 16     # megakernel.cu's stage table

#: megakernel.cu's projection kernel: the (BM, BN, WGM) block tile it is
#: instantiated for (FPT_PROJ_TILES; 128 realizations x 128 TOAs, the
#: fastest at every flagship shape in PERF.md's design steps), threads and
#: blocks per SM, harmonic slots per chunk (NH) and the coef tile's row
#: stride (LDA)
PROJ_TILE = (128, 128, 4)
PROJ_THREADS = 256
PROJ_BLOCKS = 2
NH = 16
PROJ_LDA = 2 * NH + 4
#: the float64 projection (FPT_PROJ_F64_TILES): its (BM, BN, WGM) block
#: tile (8 warps in a WGM x (8 / WGM) grid), the stages of its coef ring
#: (P64_STAGES; the basis ring has two) and blocks per SM (P64_BLOCKS); a
#: stage is 2 NH columns, the coef and basis rows PROJ_LDA doubles (P64_LD)
PROJ_TILE_F64 = (128, 64, 4)
PROJ_F64_STAGES = 2
PROJ_F64_BLOCKS = 2
#: 2 pi rounded to float32: the phase's factor where the TPU kernel's
#: compute type is float32
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


class MegaStage(NamedTuple):
    """One GP stage's static basis descriptor: ``nbin`` harmonics on time
    row ``tcol`` (T_OWN per-pulsar, T_COMMON the GWB grid), chromatic-scale
    row ``scol``. Scale rows hold the TOA mask (0 at padding)."""

    nbin: int
    tcol: int
    scol: int


def stage_k(stages: Tuple[MegaStage, ...]) -> int:
    """Total coefficient width: 2 (cos+sin) per harmonic per stage."""
    return sum(2 * s.nbin for s in stages)


def chunk_bytes_model(nreal: int, npsr: int, ntoa: int, k_coef: int,
                      mode: str = "xla", psr_shards: int = 1,
                      dtype_bytes: int = 4) -> int:
    """Analytic device-memory bytes per chunk of the statistic dataflow.

    Platform-neutral copy of the JAX package's model: ``'xla'`` (two-stage
    einsums), ``'fused'`` (binned-correlation kernel), ``'mega'`` (whole-
    chunk kernel) and ``'mega_bf16'`` (bf16 base/coefficient storage).
    Counts each materialized tensor's writes and reads. It models the JAX
    dataflow: the port's ``'mega'`` route also writes and reads the
    projected residuals once, R (PL + PF) T 4 bytes more (R P T 4 on the
    shared set).
    """
    if mode not in ("xla", "fused", "mega", "mega_bf16"):
        raise ValueError(f"unknown mode {mode!r}")
    b = dtype_bytes
    p_local = npsr // psr_shards
    rpt_l = nreal * p_local * ntoa
    rpt_f = nreal * npsr * ntoa
    rpk_l = nreal * p_local * k_coef
    rpk_f = nreal * npsr * k_coef
    rpp = nreal * p_local * npsr
    gathered = psr_shards > 1
    if mode in ("xla", "fused"):
        n = (rpt_l * b
             + rpt_l * b + p_local * ntoa * k_coef * b + rpk_l * b
             + rpt_l * b)
        if gathered:
            n += 2 * rpt_f * b
        n += (rpt_l + (rpt_f if gathered else rpt_l)) * b
        if mode == "xla":
            n += 3 * rpp * b
        return int(n)
    sb = 2 if mode == "mega_bf16" else b
    n = rpt_l * sb + rpk_l * sb
    if gathered:
        n += 2 * (rpt_f + rpk_f) * sb
        n += (rpt_l + rpk_l) * sb
    else:
        n += (rpt_l + rpk_l) * sb
    return int(n)


# -- the projection's launch shape ------------------------------------------

class ProjTiling(NamedTuple):
    """The projection's launch shape: BM realizations x BN TOAs of one
    pulsar row per block, 8 warps in a WGM x (8 / WGM) grid, the grid
    (ceil(R / BM), ceil(T / BN), rows) and the block's shared-memory
    bytes."""
    bm: int
    bn: int
    wgm: int
    grid: Tuple[int, int, int]
    smem: int


def project_smem(bm: int, bn: int, n_scales: int, route: str = "f32") -> int:
    """Shared-memory bytes of a (bm, bn) projection block with
    ``n_scales`` scale rows. ``'f32'`` (megakernel.cu's proj_floats): the
    hi/lo coef and basis tiles, or the epilogue's [bm][bn + 8] accumulator
    tile where that is larger, then the 2 time rows and the scale rows;
    ``'bf16_f64'``: the same with float64 rows; ``'f64'``
    (proj_f64_doubles): the float64 coef ring (:data:`PROJ_F64_STAGES`
    tiles, or the epilogue's [bm][bn + 8] accumulator tile where that is
    larger), the basis ring (two tiles) and the rows."""
    if route == "f64":
        ld = PROJ_LDA
        return 8 * (max(PROJ_F64_STAGES * bm * ld, bm * (bn + 8))
                    + 2 * bn * ld + (2 + n_scales) * bn)
    kc = 2 * NH
    staging = 2 * bm * PROJ_LDA + 2 * kc * (bn + 8)
    tb = 2 if route == "bf16_f64" else 1
    return 4 * (max(staging, bm * (bn + 8)) + (2 + n_scales) * bn * tb)


def project_tiling(R: int, T: int, rows: int, n_scales: int,
                   route: str = "f32") -> ProjTiling:
    """The projection's launch shape for ``rows`` pulsar rows (PF on the
    shared set, PL + PF on the local+full set) on ``route``
    (:func:`_route`): the source's :data:`PROJ_TILE` at
    :data:`PROJ_BLOCKS` blocks per SM (:data:`PROJ_TILE_F64` at
    :data:`PROJ_F64_BLOCKS` on ``'f64'``)."""
    f64 = route == "f64"
    bm, bn, wgm = PROJ_TILE_F64 if f64 else PROJ_TILE
    blocks = PROJ_F64_BLOCKS if f64 else PROJ_BLOCKS
    smem = project_smem(bm, bn, n_scales, route)
    if (smem > SMEM_PER_BLOCK
            or blocks * (smem + SMEM_RESERVED) > SMEM_PER_SM):
        raise ValueError(f"{n_scales} scale rows leave no room for "
                         f"{blocks} projection blocks per SM")
    return ProjTiling(bm, bn, wgm, (-(-R // bm), -(-T // bn), rows), smem)


# -- plain versions ----------------------------------------------------------

def dense_basis(times: torch.Tensor, scales: torch.Tensor,
                stages: Sequence[MegaStage],
                two_pi: float = 2.0 * np.pi) -> torch.Tensor:
    """(P, T, K) basis the kernel recomputes, at the tables' dtype: per
    stage cos rows then sin rows of ``(2 pi t) n``, times the stage's scale
    row. ``two_pi``: the phase's factor (:data:`TWO_PI_F32` where the TPU
    kernel rounds it to a float32 compute type; on float32 tables both
    round to it)."""
    blocks = []
    for st in stages:
        n = torch.arange(1, st.nbin + 1, dtype=times.dtype,
                         device=times.device)
        phase = two_pi * times[st.tcol][..., None] * n    # (P, T, N)
        s = scales[st.scol][..., None]
        blocks.append(torch.cat([torch.cos(phase) * s,
                                 torch.sin(phase) * s], dim=-1))
    p, t = times.shape[1:]
    if not blocks:
        return torch.zeros((p, t, 0), dtype=times.dtype, device=times.device)
    return torch.cat(blocks, dim=-1)


def kernel_columns(stages: Sequence[MegaStage]) -> List[List[int]]:
    """The projection kernel's contraction order: its k-steps of 8 basis
    columns each (-1 for a padding column). The harmonic slots of all stages
    in order go NH to a chunk (the last one zero-padded); a chunk's columns
    are its slots' cos columns, then their sin columns."""
    slots, k0 = [], 0
    for st in stages:
        slots += [(k0 + n, k0 + st.nbin + n) for n in range(st.nbin)]
        k0 += 2 * st.nbin
    steps = []
    for q0 in range(0, len(slots), NH):
        chunk = slots[q0:q0 + NH]
        chunk += [(-1, -1)] * (NH - len(chunk))
        cols = [c for c, _ in chunk] + [s for _, s in chunk]
        steps += [cols[i:i + 8] for i in range(0, len(cols), 8)]
    return steps


def _check_precision(precision: str) -> None:
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")


@contextlib.contextmanager
def full_f32():
    """float32 matmuls at full precision inside, whatever the process-wide
    setting, not TF32 (restored on exit; it is process-wide, so not for
    concurrent threads). The plain versions here and the engine's einsum
    binning run under it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def basis_f32(times, scales, stages) -> torch.Tensor:
    """The float32 projection's dense basis: built at the tables' dtype
    with 2 pi rounded to float32 and rounded once to float32 (float32
    tables: float32 throughout; float64 tables under bf16 storage: the TPU
    kernel's float64 phase and basis, which its float32 product rounds)."""
    return dense_basis(times, scales, stages, TWO_PI_F32).float()


def project_plain(base, coef, times, scales, stages):
    """Pass 1 in plain torch: res = base + coef @ B with the dense basis.
    float32 throughout (full-precision matmul), the basis
    :func:`basis_f32`'s, unless base is float64: then float64 throughout."""
    if base.dtype == torch.float64:
        res = base
        if stages:
            res = res + torch.einsum("rpk,ptk->rpt", coef,
                                     dense_basis(times, scales, stages))
        return res
    res = base.float()
    if stages:
        basis = basis_f32(times, scales, stages)
        with full_f32():
            res = res + torch.einsum("rpk,ptk->rpt", coef.float(), basis)
    return res


def project_3xtf32(base, coef, times, scales, stages):
    """The projection kernel's arithmetic in plain torch: coefficients and
    basis split by :func:`~.binned_corr.split_tf32`, and per k-step of
    :func:`kernel_columns` the three products hi.lo + lo.hi + hi.hi summed
    in float32, then added to the accumulator in the kernel's order. Under
    bf16 storage the coefficients are exact in TF32 and the kernel leaves
    out the lo.hi product, as here."""
    res = base.float()
    if not stages:
        return res
    basis = basis_f32(times, scales, stages)
    (ch, cl), (bh, bl) = split_tf32(coef.float()), split_tf32(basis)
    pairs = ((ch, bl), (ch, bh)) if coef.dtype == torch.bfloat16 else (
        (ch, bl), (cl, bh), (ch, bh))
    acc = torch.zeros_like(res)
    with full_f32():
        for cols in kernel_columns(stages):
            live = [c for c in cols if c >= 0]
            d = torch.zeros_like(res)
            for a, b in pairs:
                d = d + torch.einsum("rpk,ptk->rpt", a[..., live],
                                     b[..., live])
            acc = acc + d
    return res + acc


def chunk_stats_plain(base, coef, times, scales, weights, *,
                      stages: Tuple[MegaStage, ...], nbins: int,
                      precision: str = "f32", base_local=None,
                      coef_local=None, times_local=None, scales_local=None):
    """Plain torch version: dense-basis projection in f32, then einsums,
    every matmul at full float32 precision. A float64 base: float64
    throughout, float64 output; bf16 storage on float64 tables: the float32
    route with :func:`basis_f32`'s basis and float32 weights, float32
    output (module docstring)."""
    _check_precision(precision)
    _check_f64(base, times, precision)
    if base.dtype == torch.float64:
        res = project_plain(base, coef, times, scales, stages)
        res_l = res if base_local is None else project_plain(
            base_local, coef_local, times_local, scales_local, stages)
        corr = torch.einsum("rpt,rqt->rpq", res_l, res)
        out = torch.einsum("rpq,npq->rn", corr, weights.double())
        return out[:, :nbins], out[:, nbins]
    with full_f32():
        res = project_plain(base, coef, times, scales, stages)
        res_l = res if base_local is None else project_plain(
            base_local, coef_local, times_local, scales_local, stages)
        if precision == "bf16":
            res, res_l = round_bf16(res), round_bf16(res_l)
        corr = torch.einsum("rpt,rqt->rpq", res_l, res)
        out = torch.einsum("rpq,npq->rn", corr, weights.float())
    return out[:, :nbins], out[:, nbins]


# -- the kernels --------------------------------------------------------------

def _check_f64(base, times, precision: str) -> None:
    """A float64 base goes with float64 tables at ``'f32'`` (the engine's
    float64 mega path; its ``'bf16'`` is bf16 storage)."""
    if base.dtype == torch.float64 and (times.dtype != torch.float64
                                        or precision != "f32"):
        raise ValueError(f"a float64 base takes float64 tables at "
                         f"precision 'f32' (bf16 storage is the 'bf16' "
                         f"mode), got {times.dtype} tables at "
                         f"{precision!r}")


def _check_operands(base, coef, times, scales, stages, local):
    """Check one call's operands and return the local set's four (the full
    set's own on the shared set)."""
    shared = local[0] is None
    if any((x is None) != shared for x in local):
        raise ValueError("pass all four local operands or none")
    if shared:
        local = (base, coef, times, scales)
    if times.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"times must be float32 or float64, got "
                        f"{times.dtype}")
    if base.dtype not in (torch.bfloat16, times.dtype):
        raise TypeError(f"base must be bfloat16 or the tables' "
                        f"{times.dtype}, got {base.dtype}")
    names = ("base", "coef", "times", "scales")
    for tag, ops in (("", (base, coef, times, scales)), ("_local", local)):
        for name, x in zip(names, ops):
            name += tag
            if x.device != base.device:
                raise ValueError(f"{name} is on {x.device}, base on "
                                 f"{base.device}")
            if name.startswith(("base", "coef")):
                if x.dtype != base.dtype:
                    raise TypeError(f"{name} dtype {x.dtype} must match "
                                    f"base {base.dtype}")
            elif x.dtype != times.dtype:
                raise TypeError(f"{name} dtype {x.dtype} must match times "
                                f"{times.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.ndim != 3:
                raise ValueError(f"{name} must be 3-D, got "
                                 f"{tuple(x.shape)}")
    R, P, T = base.shape
    K, S = stage_k(stages), scales.shape[0]
    for tag, ops in (("", (base, coef, times, scales)), ("_local", local)):
        rows = ops[0].shape[1]
        want = ((R, rows, T), (R, rows, K), (2, rows, T), (S, rows, T))
        for name, x, shape in zip(names, ops, want):
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}{tag} shape {tuple(x.shape)} != "
                                 f"{shape}")
    if len(stages) > MAX_STAGES:
        raise ValueError(f"at most {MAX_STAGES} stages, got {len(stages)}")
    for st in stages:
        if not (0 <= st.tcol < 2 and 0 <= st.scol < S and st.nbin > 0):
            raise ValueError(f"bad stage {st}")
    return local


def bind(lib: ctypes.CDLL, entry: str = "fpt_project"):
    """The projection's C entry ``entry`` (``fpt_project``, or
    ``fpt_project_f64`` for float64 tables) of a library built from
    ``csrc/megakernel.cu``, with their one signature: (the local set's base,
    coef, times, scales, the full set's, res_l, res_f, R, PL, PF, T, K, S,
    n_stages, nbin, tcol, scol, bm, bn, wgm, store_bf16, shared, stream) ->
    CUDA error code."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int)] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return fn


def _route(base, times) -> str:
    """The projection's route for these operand types: ``'f32'`` (float32
    tables), ``'bf16_f64'`` (bf16 storage on float64 tables) or ``'f64'``
    (float64 throughout, the float64 kernel)."""
    if times.dtype != torch.float64:
        return "f32"
    return "f64" if base.dtype == torch.float64 else "bf16_f64"


def _launch_project(base, coef, times, scales, stages, local):
    """Pass 1 on the card, operands checked first: (res_local, res_full),
    float64 on the ``'f64'`` route, else float32; ``local`` is the local
    set's (base, coef, times, scales), all None on the shared set, where
    res_local is res_full."""
    local = _check_operands(base, coef, times, scales, stages, local)
    shared = local[0] is base
    route = _route(base, times)
    R, P, T = base.shape
    PL = local[0].shape[1]
    S = scales.shape[0]
    dt = torch.float64 if route == "f64" else torch.float32
    res = torch.empty((R, P, T), dtype=dt, device=base.device)
    res_l = res if shared else torch.empty((R, PL, T), dtype=dt,
                                           device=base.device)
    if R == 0 or T == 0:
        return res_l, res
    t = project_tiling(R, T, P if shared else PL + P, S, route)
    ints = ctypes.c_int * MAX_STAGES
    lib = _build.load("megakernel")
    stream = torch.cuda.current_stream(base.device).cuda_stream
    fn = bind(lib) if route == "f32" else bind(lib, "fpt_project_f64")
    with torch.cuda.device(base.device):
        rc = fn(*(x.data_ptr() for x in local),
                       base.data_ptr(), coef.data_ptr(), times.data_ptr(),
                       scales.data_ptr(), res_l.data_ptr(), res.data_ptr(),
                       R, PL, P, T, stage_k(stages), S, len(stages),
                       ints(*[s.nbin for s in stages]),
                       ints(*[s.tcol for s in stages]),
                       ints(*[s.scol for s in stages]), t.bm, t.bn, t.wgm,
                       int(base.dtype == torch.bfloat16), int(shared),
                       stream)
    _build.check(lib, rc, "chunk_stats projection")
    return res_l, res


def chunk_stats(base, coef, times, scales, weights, *,
                stages: Tuple[MegaStage, ...], nbins: int,
                precision: str = "f32", base_local=None, coef_local=None,
                times_local=None, scales_local=None):
    """Residual assembly + correlation + binning over one chunk.

    base: (R, P, T) residual base, float32 or bfloat16 (bf16 storage);
    coef: (R, P, K) GP coefficients in stage order, same dtype as ``base``;
    times: (2, P, T) float32 time tables (rows T_OWN, T_COMMON);
    scales: (S, P, T) float32 scale tables (TOA mask included);
    weights: (nbins+1, PL, P) float32 statistic weights, auto trace last.
    ``base_local`` (R, PL, T), ``coef_local`` (R, PL, K), ``times_local``
    (2, PL, T) and ``scales_local`` (S, PL, T) are a psr shard's own rows
    (all four or none; ``None`` is the shared set, PL = P): they are
    correlated against the full set above and the shard's partial sums
    returned. ``precision='bf16'`` rounds the correlation operands to
    bf16 (f32 accumulation); the projection always runs at f32. Returns
    (curves (R, nbins), autos (R,)). On float64 tables (a float64 batch):
    a float64 base and coefficients at ``'f32'`` run at float64 and return
    float64; a bfloat16 base and coefficients run the float32 route with
    the basis from the float64 tables (module docstring) and return
    float32; the weights are float64.
    """
    global launches, sharded_launches, f64_launches, f64_sharded_launches
    _check_precision(precision)
    _check_f64(base, times, precision)
    stages = tuple(MegaStage(*s) for s in stages)
    local = (base_local, coef_local, times_local, scales_local)
    if any((x is None) != (base_local is None) for x in local):
        raise ValueError("pass all four local operands or none")
    if base.device.type == "cpu":
        return chunk_stats_plain(base, coef, times, scales, weights,
                                 stages=stages, nbins=nbins,
                                 precision=precision, base_local=base_local,
                                 coef_local=coef_local,
                                 times_local=times_local,
                                 scales_local=scales_local)
    if base.device.type != "cuda":
        raise ValueError(f"chunk_stats runs on cuda or cpu tensors, got "
                         f"{base.device}")
    res_l, res = _launch_project(base, coef, times, scales, stages, local)
    # pass 2 checks the weights and nbins
    route = _route(base, times)
    if route == "f64":
        out, launched = _correlate("fpt_binned_corr_f64", "chunk_stats",
                                   res_l, res, weights, nbins, precision,
                                   out_f64=True)
    else:
        # float64 weights under bf16 storage: the TPU kernel's float32
        # binning product rounds them to float32
        out, launched = _correlate("fpt_binned_corr", "chunk_stats", res_l,
                                   res, weights.float(), nbins, precision)
    name = "chunk_stats" if base_local is None else "chunk_stats_sharded"
    if route != "f32":
        name += "_f64"
        if base_local is None:
            f64_launches += launched
        else:
            f64_sharded_launches += launched
    elif base_local is None:
        launches += launched
    else:
        sharded_launches += launched
    _count(name, launched)
    return out
