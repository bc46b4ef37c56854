"""Fused correlation + angular binning (port of fakepta_tpu.ops.pallas_kernels).

The ensemble statistic is a two-stage contraction per realization r:

    corr[r] = res_l[r] @ res_f[r].T                  (PL x PF pair sums)
    out[r, n] = sum_pq corr[r] * w[n]                (angular bins, OS slots,
                                                      the auto trace last)

:func:`binned_correlation` runs it as one hand-written CUDA kernel
(``csrc/binned_corr.cu``, C entry ``fpt_binned_corr``; its header has the
design and the H100 bound): TF32 tensor-core products (3xTF32 in the
``'f32'`` mode, see :func:`split_tf32`) on a PL x PF pair tile
(:func:`mma_tiling`), the correlation block kept in registers and binned
there, each weight read once for RB realizations, so device memory sees
only the residual read and the (R, NB) write: the port of the TPU kernel's
MXU-binning variant. :func:`binned_correlation_vpu` is the port of its
``mxu_binning=False`` variant (a second kernel in the same source, on the
same tensor-core mainloop and tiling): the correlation blocks of ``rb``
realizations formed in shared memory (:func:`vpu_tiling`), each slot one
block-wide, fixed-order reduction over them.
:func:`binned_correlation_plain` is the same function in plain torch, the
plain version of both.

On a float64 batch :func:`binned_correlation` launches ``fpt_binned_corr_f64``
(the same source), as the TPU kernel computes at float64 operands: at
``'f32'`` the pair sums on the FP64 tensor cores, rounded once to float32 (its
float32 correlation scratch), then binned against the float64 weights at
float64 and rounded once to float32 curves and autos (its float32 output); at
``'bf16'`` the float64 residuals rounded to bf16 through float32 (as the
TPU kernel's ``astype(bfloat16)`` rounds them) through #1's bf16 kernel,
the float32 pair sums binned the same way. :func:`binned_correlation_vpu` refuses float64 rows
(``ValueError``), as the TPU kernel's ``mxu_binning=False`` variant cannot
store its float64 per-slot sums into its float32 output.

Wrapper rules: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises (no fallback). ``launches`` and ``vpu_launches`` count
each kernel's launches in the process, ``f64_launches`` those of
``fpt_binned_corr_f64``; :func:`thread_launches` those made on the calling
thread.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from . import _build

#: number of times :func:`binned_correlation` launched its kernel
launches = 0
#: number of times :func:`binned_correlation_vpu` launched its kernel
vpu_launches = 0
#: number of times :func:`binned_correlation` launched its float64 kernel
f64_launches = 0
#: each thread's launches by kernel, beside the process counts
_tally = threading.local()


def _count(kernel: str, n: int) -> None:
    """Add ``n`` launches of ``kernel`` to the calling thread's tally."""
    if n:
        counts = _tally.__dict__.setdefault("counts", {})
        counts[kernel] = counts.get(kernel, 0) + n


def thread_launches() -> dict:
    """{kernel: launches} made on the calling thread, so a caller that
    shares its process with other launching threads (several serve pools
    in one process) reads only its own."""
    return dict(_tally.__dict__.get("counts", {}))

MMA_TILE = 128  # binned_correlation's pair tile is at most 128 x 128
MMA_WARPS = 8   # warps per block, each owning fm x fn m16n8 fragments
#: the (fm, fn) warp tiles binned_corr.cu instantiates (its
#: FPT_WARP_TILES); fpt_binned_corr chooses its realizations per block itself
WARP_TILES = ((1, 1), (1, 2), (1, 4), (1, 7), (2, 4), (2, 7), (2, 8))
TT = 32         # TOAs per staged tile (corr_common.cuh)

#: binned_correlation_vpu's blocks per SM (binned_corr.cu's VPU_BLOCKS, its
#: kernel's launch bounds) and the most realizations a block bins together
VPU_BLOCKS = 2
VPU_RB = 4
#: an H100 SM's shared memory, the most one block may take, and what the
#: system keeps of it per block (bytes)
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024


class MmaTiling(NamedTuple):
    """:func:`binned_correlation`'s launch shape: a bm x bn pair tile
    (row_tiles x col_tiles of them), 8 warps in a wgm x (8 / wgm) grid each
    holding fm x fn m16n8 fragments."""
    bm: int
    bn: int
    row_tiles: int
    col_tiles: int
    wgm: int
    fm: int
    fn: int

    def code(self) -> int:
        """The warp grid as ``fpt_binned_corr`` takes it."""
        return self.wgm | self.fm << 4 | self.fn << 8


def _check_precision(precision: str) -> None:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got "
                         f"{precision!r}")


def mma_tiling(p_rows: int, p_cols: int) -> MmaTiling:
    """The pair tiling of :func:`binned_correlation`'s kernel: bm = p_rows
    rounded up to 16 and bn = p_cols rounded up to 8, each at most 128; of
    the warp grids and :data:`WARP_TILES` that cover the bm/16 x bn/8
    fragments, the one whose busiest warp (the first) holds the fewest,
    then the fewest registers, then the fewest shared-memory bytes loaded
    per product (2 fm + fn)."""
    bm = min(MMA_TILE, -(-p_rows // 16) * 16)
    bn = min(MMA_TILE, -(-p_cols // 8) * 8)
    nfm, nfn = bm // 16, bn // 8
    best = None
    for fm, fn in WARP_TILES:
        for wgm in (1, 2, 4, 8):
            rows, cols = 16 * fm * wgm, 8 * fn * (MMA_WARPS // wgm)
            if not bm <= rows <= MMA_TILE or not bn <= cols <= MMA_TILE:
                continue
            key = (min(fm, nfm) * min(fn, nfn), fm * fn, 2 * fm + fn)
            if best is None or key < best[0]:
                best = (key, wgm, fm, fn)
    _, wgm, fm, fn = best
    return MmaTiling(bm, bn, -(-p_rows // bm), -(-p_cols // bn), wgm, fm, fn)


class VpuTiling(NamedTuple):
    """:func:`binned_correlation_vpu`'s launch shape: :func:`mma_tiling`'s
    pair tiles and warp grid, ``rb`` realizations binned per block, their
    correlation blocks ``ldc`` floats a row, and the block's shared-memory
    bytes."""
    mma: MmaTiling
    rb: int
    ldc: int
    smem: int

    def code(self) -> int:
        """The warp grid and rb as ``fpt_binned_corr_vpu`` takes them."""
        return self.mma.code() | self.rb << 12


def _staged_rows(fm, fn, wgm, dual, col):
    """binned_corr.cu's staged_rows: the rows a realization stages."""
    rows, cols = 16 * fm * wgm, 8 * fn * (MMA_WARPS // wgm)
    if col:
        return cols if dual else 0
    return rows if dual else max(rows, cols)


def _mma_ld(rows):
    return -(-rows // 32) * 32 + 8


def vpu_ldc(bn: int) -> int:
    """The correlation block's row stride for a pair tile bn pulsars wide:
    8 or 24 (mod 32), so the kernel's 8-byte fragment stores stay on 32
    banks (binned_corr.cu's vpu_ldc)."""
    return bn + 8 if bn % 32 in (0, 16) else bn


def vpu_smem(p_rows: int, nb: int, t: MmaTiling, rb: int, precision: str,
             dual: bool) -> int:
    """Shared-memory bytes of a :func:`binned_correlation_vpu` block on
    the tiling ``t`` of ``p_rows`` rows (binned_corr.cu's vpu_layout): rb - 1
    correlation blocks, the staging tiles (whose room the last block
    takes), the [rb][nb][8] warp sums."""
    cslot = min(MMA_TILE, p_rows) * vpu_ldc(t.bn)
    staging = (2 if precision == "f32" else 1) * TT * (
        _mma_ld(_staged_rows(t.fm, t.fn, t.wgm, dual, False))
        + (_mma_ld(_staged_rows(t.fm, t.fn, t.wgm, dual, True))
           if dual else 0))
    return 4 * ((rb - 1) * cslot + max(staging, cslot)
                + rb * nb * MMA_WARPS)


def vpu_tiling(p_rows: int, p_cols: int, nb: int, precision: str,
               shared: bool, blocks_per_sm: int = VPU_BLOCKS) -> VpuTiling:
    """:func:`binned_correlation_vpu`'s launch shape for ``nb`` weight
    slots: :func:`mma_tiling`'s tiles, and the most realizations per block,
    a power of two up to :data:`VPU_RB`, whose shared memory lets
    ``blocks_per_sm`` blocks share an SM. ``shared``: one operand set
    (res_local is res_full). This is the one place rb is chosen.

    A power of two, because an ensemble chunk is one (1024 on the
    flagship): its blocks then fill whole waves of 2 x 132 block slots,
    where rb = 3 leaves a second wave a quarter full (measured 1.33x
    slower than rb = 1 at PL = 50 'f32', PERF.md)."""
    t = mma_tiling(p_rows, p_cols)
    dual = not (shared and t.row_tiles * t.col_tiles == 1)
    budget = min(SMEM_PER_BLOCK,
                 SMEM_PER_SM // blocks_per_sm - SMEM_RESERVED)
    rb = VPU_RB
    while rb > 1 and vpu_smem(p_rows, nb, t, rb, precision, dual) > budget:
        rb //= 2
    return VpuTiling(t, rb, vpu_ldc(t.bn),
                     vpu_smem(p_rows, nb, t, rb, precision, dual))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest with ties
    away from zero: PTX ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """The 'f32' mode's 3xTF32 operand split, as the kernel does it:
    ``hi = tf32(x)``, ``lo = tf32(x - hi)``; a product a.b is then taken as
    ``a_hi.b_lo + a_lo.b_hi + a_hi.b_hi`` in fp32."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def binned_correlation_3xtf32(res_local, res_full, weights, nbins: int):
    """The 'f32' kernel's arithmetic in plain torch: the products of
    :func:`split_tf32` operands (exact in fp32), then the binning."""
    (ah, al), (bh, bl) = split_tf32(res_local), split_tf32(res_full)
    corr = sum(torch.einsum("rpt,rqt->rpq", a, b)
               for a, b in ((ah, bl), (al, bh), (ah, bh)))
    out = torch.einsum("rpq,npq->rn", corr, weights.float())
    return out[:, :nbins], out[:, nbins]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def binned_correlation_plain(res_local, res_full, weights, nbins: int,
                             precision: str = "bf16"):
    """Plain torch version: f32 einsums, bf16 mode rounds the operands.
    Float64 rows (float64 weights): the pair sums at float64 rounded once
    to float32 (``'bf16'``: on operands rounded to float32, then to bf16,
    as the TPU kernel rounds them, summed at float32), binned at float64
    and rounded once to float32."""
    _check_precision(precision)
    f64 = res_local.dtype == torch.float64
    if f64 and precision == "f32":
        corr = torch.einsum("rpt,rqt->rpq", res_local, res_full).float()
    else:
        a, b = res_local.float(), res_full.float()
        if precision == "bf16":
            a, b = round_bf16(a), round_bf16(b)
        corr = torch.einsum("rpt,rqt->rpq", a, b)
    if f64:
        out = torch.einsum("rpq,npq->rn", corr.double(),
                           weights.double()).float()
    else:
        out = torch.einsum("rpq,npq->rn", corr, weights.float())
    return out[:, :nbins], out[:, nbins]


def bind(lib: ctypes.CDLL, entry: str):
    """The C entry ``entry`` of a library built from ``csrc/binned_corr.cu``,
    with its signature: (res_local, res_full, weights, out, partial, R, PL,
    PF, T, NB, tiling, bf16, shared[, out_f64 for fpt_binned_corr_f64],
    stream) -> CUDA error code."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * (9 if entry == "fpt_binned_corr_f64" else 8) \
        + [ctypes.c_void_p]
    return fn


def _launch(entry: str, what: str, res_local, res_full, weights,
            nbins: int, precision: str, out_f64: bool = False):
    """Check the operands, launch the C entry ``entry`` of
    ``csrc/binned_corr.cu`` and return ((curves (R, nbins), autos (R,)),
    launched?): an empty ensemble or time axis launches nothing. The
    entries share one C signature (``fpt_binned_corr_f64`` adds
    ``out_f64``: float64 output, the megakernel's pass 2, at ``'f32'``
    only); its tiling argument is :func:`mma_tiling`'s code for
    ``fpt_binned_corr`` and ``fpt_binned_corr_f64`` and :func:`vpu_tiling`'s
    for ``fpt_binned_corr_vpu``. The float64 entry takes float64 operands
    and the others float32."""
    f64 = entry == "fpt_binned_corr_f64"
    want = torch.float64 if f64 else torch.float32
    for name, x in (("res_local", res_local), ("res_full", res_full),
                    ("weights", weights)):
        if x.device != res_local.device:
            raise ValueError(f"{name} is on {x.device}, res_local on "
                             f"{res_local.device}")
        if x.dtype != want:
            raise TypeError(f"{name} must be {str(want)[6:]}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if res_local.ndim != 3 or res_full.ndim != 3 or weights.ndim != 3:
        raise ValueError("res_local/res_full/weights must be 3-D")
    R, PL, T = res_local.shape
    NB = weights.shape[0]
    if res_full.shape[0] != R or res_full.shape[2] != T:
        raise ValueError(f"res_full shape {tuple(res_full.shape)} does not "
                         f"match res_local {tuple(res_local.shape)}")
    PF = res_full.shape[1]
    if tuple(weights.shape[1:]) != (PL, PF):
        raise ValueError(f"weights shape {tuple(weights.shape)} != "
                         f"(nbins+1, {PL}, {PF})")
    if not 0 <= nbins < NB:
        raise ValueError(f"nbins={nbins} needs nbins+1 <= {NB} weight slots")
    if out_f64 and (not f64 or precision != "f32"):
        raise ValueError("a float64 output is fpt_binned_corr_f64's at "
                         "'f32' only")
    shared = int(res_local.data_ptr() == res_full.data_ptr() and PL == PF)
    if entry == "fpt_binned_corr_vpu":
        v = vpu_tiling(PL, PF, NB, precision, bool(shared))
        t, arg = v.mma, v.code()
    else:
        t = mma_tiling(PL, PF)
        arg = t.code()
    ntiles = t.row_tiles * t.col_tiles
    dev = res_local.device
    out = torch.empty((R, NB), dtype=torch.float64 if out_f64
                      else torch.float32, device=dev)
    if R == 0 or T == 0:
        out.zero_()
        return (out[:, :nbins], out[:, nbins]), False
    partial = (torch.empty((R, ntiles, NB), dtype=want, device=dev)
               if ntiles > 1 else None)
    lib = _build.load("binned_corr")
    fn = bind(lib, entry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(res_local.data_ptr(), res_full.data_ptr(), weights.data_ptr(),
                out.data_ptr(), partial.data_ptr() if partial is not None
                else None, R, PL, PF, T, NB, arg,
                int(precision == "bf16"), shared,
                *((int(out_f64),) if f64 else ()), stream)
    _build.check(lib, rc, what)
    return (out[:, :nbins], out[:, nbins]), True


def _run(entry: str, what: str, res_local, res_full, weights,
         nbins: int, precision: str):
    """The wrapper rules: the plain version for CPU tensors, the kernel for
    CUDA tensors. Returns (outputs, launched?)."""
    _check_precision(precision)
    if entry == "fpt_binned_corr_vpu" and res_local.dtype == torch.float64:
        raise ValueError(
            "binned_correlation_vpu (mxu_binning=False) takes no float64 "
            "rows: the TPU kernel's per-slot sums are promoted to float64 "
            "and cannot be stored into its float32 output, so the JAX "
            "package raises; use binned_correlation")
    if res_local.device.type == "cpu":
        return binned_correlation_plain(res_local, res_full, weights, nbins,
                                        precision), False
    if res_local.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{res_local.device}")
    return _launch(entry, what, res_local, res_full, weights, nbins,
                   precision)


def binned_correlation(res_local, res_full, weights, nbins: int,
                       precision: str = "bf16"):
    """Fused correlation + binning.

    res_local: (R, PL, T) residual rows; res_full: (R, PF, T) the rows they
    correlate against (pass the same tensor for the single-device path);
    weights: (nbins+1, PL, PF) statistic weights, slot ``nbins`` the auto
    trace. All contiguous on a CUDA device: a psr shard passes its rows as
    a tensor of their own, never as a row slice of the gathered array.
    ``precision``: ``'bf16'`` (bf16 operands, f32 accumulation) or
    ``'f32'`` (3xTF32 products, ~2^-21 relative each). Returns (curves
    (R, nbins), autos (R,)), the shard's partial sums when PL < PF.
    Float64 rows and weights take the float64 kernel (module docstring);
    the curves and autos are float32 then too.
    """
    global launches, f64_launches
    if res_local.dtype == torch.float64:
        out, launched = _run("fpt_binned_corr_f64", "binned_correlation",
                             res_local, res_full, weights, nbins, precision)
        f64_launches += launched
        _count("binned_correlation_f64", launched)
        return out
    out, launched = _run("fpt_binned_corr", "binned_correlation", res_local,
                         res_full, weights, nbins, precision)
    launches += launched
    _count("binned_correlation", launched)
    return out


def binned_correlation_vpu(res_local, res_full, weights, nbins: int,
                           precision: str = "bf16"):
    """The same function as :func:`binned_correlation` (same arguments and
    result), through the per-slot-reduction kernel: the port of the TPU
    kernel's ``mxu_binning=False`` variant. The same TF32 tensor-core
    products (3xTF32 at ``'f32'``) and pair tiles; the correlation blocks
    of :func:`vpu_tiling`'s ``rb`` realizations go to shared memory and
    each weight slot is one block-wide, fixed-order reduction over them."""
    global vpu_launches
    out, launched = _run("fpt_binned_corr_vpu", "binned_correlation_vpu",
                         res_local, res_full, weights, nbins, precision)
    vpu_launches += launched
    _count("binned_correlation_vpu", launched)
    return out
