"""Fused correlation + angular binning (port of fakepta_tpu.ops.pallas_kernels).

The ensemble statistic is a two-stage contraction per realization r:

    corr[r] = res_l[r] @ res_f[r].T                  (PL x PF pair sums)
    out[r, n] = sum_pq corr[r] * w[n]                (angular bins, OS slots,
                                                      the auto trace last)

:func:`binned_correlation` runs it as one hand-written CUDA kernel
(``csrc/binned_corr.cu``; its header has the design and the H100 bound)
that keeps each realization's correlation block in registers and applies
the weight slots there, so device memory sees only the residual read and
the (R, NB) write: the port of the TPU kernel's MXU-binning variant.
:func:`binned_correlation_vpu` is the port of its ``mxu_binning=False``
variant (the same source, another epilogue): the block is formed in shared
memory and each slot runs as one block-wide reduction.
:func:`binned_correlation_plain` is the same function in plain torch, the
plain version of both.

Wrapper rules: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises (no fallback). ``launches`` and ``vpu_launches`` count
each kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: number of times :func:`binned_correlation` launched its kernel
launches = 0
#: number of times :func:`binned_correlation_vpu` launched its kernel
vpu_launches = 0

TDIM = 16       # threads per side of a realization group (corr_common.cuh)
MAX_MT = 8      # so a pair tile is at most 128 pulsars a side


def _check_precision(precision: str) -> None:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got "
                         f"{precision!r}")


def pair_tiling(p_rows: int, p_cols: int):
    """(mt, row tiles, column tiles) of the kernel's pair space: each thread
    holds an mt x mt register tile, a block 16*mt pulsars a side."""
    mt = max(1, min(MAX_MT, -(-max(p_rows, p_cols) // TDIM)))
    tile = TDIM * mt
    return mt, -(-p_rows // tile), -(-p_cols // tile)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def binned_correlation_plain(res_local, res_full, weights, nbins: int,
                             precision: str = "bf16"):
    """Plain torch version: f32 einsums, bf16 mode rounds the operands."""
    _check_precision(precision)
    a, b = res_local.float(), res_full.float()
    if precision == "bf16":
        a, b = round_bf16(a), round_bf16(b)
    corr = torch.einsum("rpt,rqt->rpq", a, b)
    out = torch.einsum("rpq,npq->rn", corr, weights.float())
    return out[:, :nbins], out[:, nbins]


def _launch(entry: str, what: str, res_local, res_full, weights,
            nbins: int, precision: str):
    """Check the operands, launch the C entry ``entry`` of
    ``csrc/binned_corr.cu`` and return (curves (R, nbins), autos (R,)).
    Both entries share one C signature."""
    for name, x in (("res_local", res_local), ("res_full", res_full),
                    ("weights", weights)):
        if x.device != res_local.device:
            raise ValueError(f"{name} is on {x.device}, res_local on "
                             f"{res_local.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
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
    shared = int(res_local.data_ptr() == res_full.data_ptr() and PL == PF)
    mt, ntl, ntf = pair_tiling(PL, PF)
    dev = res_local.device
    out = torch.empty((R, NB), dtype=torch.float32, device=dev)
    if R == 0 or T == 0:
        out.zero_()
        return out[:, :nbins], out[:, nbins]
    partial = (torch.empty((R, ntl * ntf, NB), dtype=torch.float32,
                           device=dev) if ntl * ntf > 1 else None)
    lib = _build.load("binned_corr")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(res_local.data_ptr(), res_full.data_ptr(), weights.data_ptr(),
                out.data_ptr(), partial.data_ptr() if partial is not None
                else None, R, PL, PF, T, NB, mt,
                int(precision == "bf16"), shared, stream)
    _build.check(lib, rc, what)
    return out[:, :nbins], out[:, nbins]


def _run(entry: str, what: str, res_local, res_full, weights,
         nbins: int, precision: str):
    """The wrapper rules: the plain version for CPU tensors, the kernel for
    CUDA tensors. Returns (outputs, launched?)."""
    _check_precision(precision)
    if res_local.device.type == "cpu":
        return binned_correlation_plain(res_local, res_full, weights, nbins,
                                        precision), False
    if res_local.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{res_local.device}")
    return _launch(entry, what, res_local, res_full, weights, nbins,
                   precision), True


def binned_correlation(res_local, res_full, weights, nbins: int,
                       precision: str = "bf16"):
    """Fused correlation + binning.

    res_local: (R, PL, T) residual rows; res_full: (R, PF, T) the rows they
    correlate against (pass the same tensor for the single-device path);
    weights: (nbins+1, PL, PF) statistic weights, slot ``nbins`` the auto
    trace. All contiguous on a CUDA device: a psr shard passes its rows as
    a tensor of their own, never as a row slice of the gathered array.
    ``precision``: ``'bf16'`` (bf16 operands, f32 accumulation) or
    ``'f32'`` (plain fp32 FMAs). Returns (curves (R, nbins), autos (R,)),
    the shard's partial sums when PL < PF.
    """
    global launches
    out, launched = _run("fpt_binned_corr", "binned_correlation", res_local,
                         res_full, weights, nbins, precision)
    launches += launched
    return out


def binned_correlation_vpu(res_local, res_full, weights, nbins: int,
                           precision: str = "bf16"):
    """The same function as :func:`binned_correlation` (same arguments and
    result), through the per-slot-reduction kernel: the port of the TPU
    kernel's ``mxu_binning=False`` variant."""
    global vpu_launches
    out, launched = _run("fpt_binned_corr_vpu", "binned_correlation_vpu",
                         res_local, res_full, weights, nbins, precision)
    vpu_launches += launched
    return out
