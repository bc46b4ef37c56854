"""Whole-chunk statistic kernel (port of fakepta_tpu.ops.megakernel).

The draws assemble only the cheap per-realization operands: the residual
**base** (R, P, T) (white + ECORR + system noise, TOA-masked) and the GP
**coefficients** (R, P, K) (draws times spectrum weights, the GWB Cholesky
coupling). :func:`chunk_stats` then recomputes the sine-cosine Fourier bases
on chip from the small ``(time, scale)`` tables, assembles
``res = base + coef @ B`` tile by tile, correlates and bins, all in one
hand-written CUDA kernel (``csrc/megakernel.cu``; its header has the design
and the H100 bound). The dense (P, T, K) basis and the projected residuals
never exist in device memory. :func:`chunk_stats_plain` is the same function
in plain torch, with the dense basis.

Two operand sets, as in the JAX kernel: the shared set (all pulsars in one
shard, ``base_local=None``) correlates the array with itself; the
local+full set (a psr shard) correlates the shard's rows against the
gathered array, and the kernel projects both sides itself (each shard
recomputes the full rows from the gathered coefficients). Wrapper rules as
in :mod:`.binned_corr`; ``launches`` counts the shared set's launches and
``sharded_launches`` the local+full set's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .binned_corr import pair_tiling, round_bf16

#: number of times :func:`chunk_stats` launched its kernel on the shared
#: operand set
launches = 0
#: ... and on the local+full operand set (a psr shard)
sharded_launches = 0

# time-table rows staged for the in-kernel basis recompute
T_OWN, T_COMMON = 0, 1
MAX_STAGES = 16     # megakernel.cu's stage table


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
    Counts each materialized tensor's writes and reads.
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


def dense_basis(times: torch.Tensor, scales: torch.Tensor,
                stages: Sequence[MegaStage]) -> torch.Tensor:
    """(P, T, K) basis the kernel recomputes: per stage cos rows then sin
    rows of ``(2 pi t) n``, times the stage's scale row."""
    blocks = []
    for st in stages:
        n = torch.arange(1, st.nbin + 1, dtype=times.dtype,
                         device=times.device)
        phase = (2.0 * np.pi) * times[st.tcol][..., None] * n    # (P, T, N)
        s = scales[st.scol][..., None]
        blocks.append(torch.cat([torch.cos(phase) * s,
                                 torch.sin(phase) * s], dim=-1))
    p, t = times.shape[1:]
    if not blocks:
        return torch.zeros((p, t, 0), dtype=times.dtype, device=times.device)
    return torch.cat(blocks, dim=-1)


def _check_precision(precision: str) -> None:
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")


def _project(base, coef, times, scales, stages):
    res = base.float()
    if stages:
        basis = dense_basis(times.float(), scales.float(), stages)
        res = res + torch.einsum("rpk,ptk->rpt", coef.float(), basis)
    return res


def chunk_stats_plain(base, coef, times, scales, weights, *,
                      stages: Tuple[MegaStage, ...], nbins: int,
                      precision: str = "f32", base_local=None,
                      coef_local=None, times_local=None, scales_local=None):
    """Plain torch version: dense-basis projection in f32, then einsums."""
    _check_precision(precision)
    res = _project(base, coef, times, scales, stages)
    res_l = res if base_local is None else _project(
        base_local, coef_local, times_local, scales_local, stages)
    if precision == "bf16":
        res, res_l = round_bf16(res), round_bf16(res_l)
    corr = torch.einsum("rpt,rqt->rpq", res_l, res)
    out = torch.einsum("rpq,npq->rn", corr, weights.float())
    return out[:, :nbins], out[:, nbins]


def chunk_stats(base, coef, times, scales, weights, *,
                stages: Tuple[MegaStage, ...], nbins: int,
                precision: str = "f32", base_local=None, coef_local=None,
                times_local=None, scales_local=None):
    """Fused residual assembly + correlation + binning over one chunk.

    base: (R, P, T) residual base, float32 or bfloat16 (bf16 storage);
    coef: (R, P, K) GP coefficients in stage order, same dtype as ``base``;
    times: (2, P, T) float32 time tables (rows T_OWN, T_COMMON);
    scales: (S, P, T) float32 scale tables (TOA mask included);
    weights: (nbins+1, PL, P) float32 statistic weights, auto trace last.
    ``base_local`` (R, PL, T), ``coef_local`` (R, PL, K), ``times_local``
    (2, PL, T) and ``scales_local`` (S, PL, T) are a psr shard's own rows
    (all four or none; ``None`` is the shared set, PL = P): the kernel
    correlates them against the full set above and returns the shard's
    partial sums. ``precision='bf16'`` rounds the correlation operands to
    bf16 (f32 accumulation); the projection always runs at f32. Returns
    (curves (R, nbins), autos (R,)).
    """
    global launches, sharded_launches
    _check_precision(precision)
    stages = tuple(MegaStage(*s) for s in stages)
    local = (base_local, coef_local, times_local, scales_local)
    shared = base_local is None
    if any((x is None) != shared for x in local):
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
    if shared:
        base_local, coef_local, times_local, scales_local = \
            base, coef, times, scales
    if base.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"base must be float32 or bfloat16, got {base.dtype}")
    for name, x in (("base", base), ("coef", coef), ("times", times),
                    ("scales", scales), ("weights", weights),
                    ("base_local", base_local), ("coef_local", coef_local),
                    ("times_local", times_local),
                    ("scales_local", scales_local)):
        if x.device != base.device:
            raise ValueError(f"{name} is on {x.device}, base on "
                             f"{base.device}")
        if name.startswith(("base", "coef")):
            if x.dtype != base.dtype:
                raise TypeError(f"{name} dtype {x.dtype} must match base "
                                f"{base.dtype}")
        elif x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.ndim != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(x.shape)}")
    R, P, T = base.shape
    PL = base_local.shape[1]
    K = stage_k(stages)
    NB, S = weights.shape[0], scales.shape[0]
    for tag, rows, ops in (("", P, (base, coef, times, scales)),
                           ("_local", PL, (base_local, coef_local,
                                           times_local, scales_local))):
        want = ((R, rows, T), (R, rows, K), (2, rows, T), (S, rows, T))
        for name, x, shape in zip(("base", "coef", "times", "scales"), ops,
                                  want):
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}{tag} shape {tuple(x.shape)} != "
                                 f"{shape}")
    if tuple(weights.shape[1:]) != (PL, P):
        raise ValueError(f"weights shape {tuple(weights.shape)} != "
                         f"(nbins+1, {PL}, {P})")
    if not 0 <= nbins < NB:
        raise ValueError(f"nbins={nbins} needs nbins+1 <= {NB} weight slots")
    if len(stages) > MAX_STAGES:
        raise ValueError(f"at most {MAX_STAGES} stages, got {len(stages)}")
    for st in stages:
        if not (0 <= st.tcol < 2 and 0 <= st.scol < scales.shape[0]
                and st.nbin > 0):
            raise ValueError(f"bad stage {st}")
    mt, ntl, ntf = pair_tiling(PL, P)
    dev = base.device
    out = torch.empty((R, NB), dtype=torch.float32, device=dev)
    if R == 0 or T == 0:
        out.zero_()
        return out[:, :nbins], out[:, nbins]
    partial = (torch.empty((R, ntl * ntf, NB), dtype=torch.float32,
                           device=dev) if ntl * ntf > 1 else None)
    ints = ctypes.c_int * MAX_STAGES
    nbin = ints(*[s.nbin for s in stages])
    tcol = ints(*[s.tcol for s in stages])
    scol = ints(*[s.scol for s in stages])
    lib = _build.load("megakernel")
    fn = lib.fpt_chunk_stats
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int)] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(base_local.data_ptr(), coef_local.data_ptr(),
                times_local.data_ptr(), scales_local.data_ptr(),
                base.data_ptr(), coef.data_ptr(), times.data_ptr(),
                scales.data_ptr(), weights.data_ptr(), out.data_ptr(),
                partial.data_ptr() if partial is not None else None,
                R, PL, P, T, K, NB, len(stages), nbin, tcol, scol, mt,
                int(base.dtype == torch.bfloat16), int(precision == "bf16"),
                int(shared), stream)
    _build.check(lib, rc, "chunk_stats")
    if shared:
        launches += 1
    else:
        sharded_launches += 1
    return out[:, :nbins], out[:, nbins]
