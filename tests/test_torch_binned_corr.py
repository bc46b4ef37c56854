"""The tensor-core binned_correlation kernels' CPU-side pieces.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
Here: their pair tiling (tile sides by PL and PF, tile counts, the 128
cap, the warp grid), the per-slot-reduction kernel's realizations per
block and shared memory, and the 'f32' mode's 3xTF32 operand split,
emulated in plain torch and held against a float64 einsum and the JAX
package's Pallas kernels (interpret mode) on the same seeded residuals;
and the 1-shard engine through ``pallas_mxu_binning=False`` against the
JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.ops.pallas_kernels import binned_correlation as jax_binned
from fakepta_tpu.parallel.mesh import make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from test_torch_engine import KW, TOL, _assert_stats, _noisy_leaves, _psd


@pytest.mark.parametrize("pl,pf,bm,bn,tiles", [
    (100, 100, 112, 104, (1, 1)), (50, 100, 64, 104, (1, 1)),
    (25, 100, 32, 104, (1, 1)), (1, 100, 16, 104, (1, 1)),
    (12, 40, 16, 40, (1, 1)), (20, 20, 32, 24, (1, 1)),
    (128, 128, 128, 128, (1, 1)), (130, 130, 128, 128, (2, 2)),
    (25, 130, 32, 128, (1, 2)), (300, 7, 128, 8, (3, 1))])
def test_mma_tiling_sides_and_tile_counts(pl, pf, bm, bn, tiles):
    t = bc.mma_tiling(pl, pf)
    assert (t.bm, t.bn) == (bm, bn)
    assert (t.row_tiles, t.col_tiles) == tiles
    # every pulsar lies in one tile, and no tile is empty
    assert t.row_tiles * bc.MMA_TILE >= pl > (t.row_tiles - 1) * t.bm
    assert t.col_tiles * bc.MMA_TILE >= pf > (t.col_tiles - 1) * t.bn


@pytest.mark.parametrize("pl", list(range(1, 129, 7)) + [128])
@pytest.mark.parametrize("pf", [1, 8, 9, 40, 100, 104, 127, 128])
def test_mma_tiling_warp_grid_covers_the_tile(pl, pf):
    """The 8 warps' fragments cover the tile, the warp tile is one the
    source instantiates, and the packed code round-trips."""
    t = bc.mma_tiling(pl, pf)
    assert t.wgm in (1, 2, 4, 8)
    assert (t.fm, t.fn) in bc.WARP_TILES
    rows, cols = 16 * t.fm * t.wgm, 8 * t.fn * (bc.MMA_WARPS // t.wgm)
    assert t.bm <= rows <= bc.MMA_TILE and t.bn <= cols <= bc.MMA_TILE
    code = t.code()
    assert (code & 15, code >> 4 & 15, code >> 8) == (t.wgm, t.fm, t.fn)


@pytest.mark.parametrize("pl,pf,want", [
    (100, 100, (4, 2, 7)), (50, 100, (4, 1, 7)), (25, 100, (2, 1, 4))])
def test_mma_tiling_flagship_warp_tiles(pl, pf, want):
    """The flagship shapes: the whole array and a 2- and 4-shard mesh's
    rows against it; the busiest warp holds 14, 7 and 4 fragments."""
    t = bc.mma_tiling(pl, pf)
    assert (t.wgm, t.fm, t.fn) == want


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    return torch.tensor(x.astype(np.float32))


def test_round_tf32_keeps_ten_mantissa_bits_rounding_ties_away():
    x = _values(0)
    hi = bc.round_tf32(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    # round to nearest: within half a TF32 ulp (2^-11 relative)
    assert torch.all((hi - x).abs() <= x.abs() * 2.0 ** -11)
    # a tie (exactly half an ulp) goes away from zero
    one_and_half_ulp = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert bc.round_tf32(one_and_half_ulp).tolist() == [1 + 2.0 ** -10,
                                                        -(1 + 2.0 ** -10)]


def test_split_tf32_of_bf16_values_has_no_low_part():
    x = bc.round_bf16(_values(1))
    hi, lo = bc.split_tf32(x)
    assert torch.equal(hi, x)
    assert torch.all(lo == 0)


def test_split_tf32_recovers_21_bits():
    x = _values(2).double()
    hi, lo = bc.split_tf32(x.float())
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    err = (hi.double() + lo.double() - x).abs()
    assert torch.all(err <= x.abs() * 2.0 ** -21)


@pytest.mark.parametrize("R,PL,PF,T", [(16, 16, 16, 128), (5, 4, 16, 100),
                                       (3, 1, 12, 33)])
def test_three_pass_statistic_matches_f64_and_pallas(R, PL, PF, T):
    """Seeded residuals at scales a PTA gives (1e-6 s): the emulated 3xTF32
    statistic within 1e-5 of the curve scale of the float64 einsum (autos
    relative), and of the JAX package's 'f32' (Precision.HIGHEST) kernel."""
    rng = np.random.default_rng(R * 1000 + PL)
    res_f = (rng.standard_normal((R, PF, T)) * 1e-6).astype(np.float32)
    res_l = res_f[:, PF - PL:].copy()
    nbins = 4
    w = rng.standard_normal((nbins + 1, PL, PF)).astype(np.float32)
    # the auto slot: the trace over the local rows, as the engine weights it
    w[nbins] = 0.0
    w[nbins, np.arange(PL), np.arange(PF - PL, PF)] = 1.0 / PL
    got = bc.binned_correlation_3xtf32(torch.tensor(res_l),
                                       torch.tensor(res_f), torch.tensor(w),
                                       nbins)
    f64 = np.einsum("npq,rpt,rqt->rn", w.astype(np.float64),
                    res_l.astype(np.float64), res_f.astype(np.float64))
    pallas = jax_binned(jnp.asarray(res_l), jnp.asarray(res_f),
                        jnp.asarray(w), nbins=nbins, rt=1, interpret=True,
                        precision="f32")
    for want in ((f64[:, :nbins], f64[:, nbins]), pallas):
        wc, wa = (np.asarray(x, np.float64) for x in want)
        gc, ga = (x.double().numpy() for x in got)
        assert np.abs(gc - wc).max() <= 1e-5 * np.abs(wc).max()
        assert np.all(np.abs(ga - wa) <= 1e-5 * np.abs(wa))


# -- binned_correlation_vpu (the mxu_binning=False variant) -----------------

@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("pf", [1, 8, 40, 100, 128, 130])
def test_vpu_tiling_covers_and_fits(pf, prec):
    """For every PL up to 128: mma_tiling's tiles and warp grid, rb the
    most realizations (a power of two up to VPU_RB) that let two blocks
    share an SM,
    the block's shared memory within an H100 block's 227 KB, and a
    correlation-block stride of 8 or 24 (mod 32)."""
    budget = bc.SMEM_PER_SM // bc.VPU_BLOCKS - bc.SMEM_RESERVED
    for pl in range(1, 129):
        for shared in ((False, True) if pl == pf else (False,)):
            v = bc.vpu_tiling(pl, pf, 16, prec, shared)
            t = v.mma
            assert t == bc.mma_tiling(pl, pf)
            rows, cols = 16 * t.fm * t.wgm, 8 * t.fn * (bc.MMA_WARPS // t.wgm)
            assert t.bm <= rows <= bc.MMA_TILE and t.bn <= cols <= bc.MMA_TILE
            assert v.rb in (1, 2, 4) and v.rb <= bc.VPU_RB
            assert v.smem <= bc.SMEM_PER_BLOCK
            assert v.rb == 1 or v.smem <= budget
            dual = not (shared and t.row_tiles * t.col_tiles == 1)
            assert v.rb == bc.VPU_RB or bc.vpu_smem(
                pl, 16, t, 2 * v.rb, prec, dual) > budget
            assert v.ldc >= t.bn and v.ldc % 32 in (8, 24)
            assert (v.code() & 0xFFF, v.code() >> 12) == (t.code(), v.rb)


@pytest.mark.parametrize("pl,prec,warp_grid,rb", [
    (100, "bf16", (4, 2, 7), 2), (100, "f32", (4, 2, 7), 2),
    (50, "bf16", (4, 1, 7), 4), (50, "f32", (4, 1, 7), 2),
    (25, "bf16", (2, 1, 4), 4), (25, "f32", (2, 1, 4), 4)])
def test_vpu_tiling_flagship(pl, prec, warp_grid, rb):
    """The flagship shapes (16 slots: 15 bins and the autos): the whole
    array shared, and a 2- and 4-shard mesh's rows against it."""
    v = bc.vpu_tiling(pl, 100, 16, prec, shared=pl == 100)
    assert (v.mma.wgm, v.mma.fm, v.mma.fn) == warp_grid
    assert (v.mma.bm, v.mma.bn, v.ldc) == (-(-pl // 16) * 16, 104, 104)
    assert v.rb == rb


def _vpu_emulation(res_local, res_full, weights, nbins, precision):
    """binned_correlation_vpu's arithmetic in plain torch: the products
    (3xTF32 from split_tf32 at 'f32', bf16-rounded operands in one pass at
    'bf16', both exact in fp32), then one full sum per weight slot."""
    if precision == "f32":
        (ah, al), (bh, bl) = (bc.split_tf32(res_local),
                              bc.split_tf32(res_full))
        corr = sum(torch.einsum("rpt,rqt->rpq", a, b)
                   for a, b in ((ah, bl), (al, bh), (ah, bh)))
    else:
        corr = torch.einsum("rpt,rqt->rpq", bc.round_bf16(res_local),
                            bc.round_bf16(res_full))
    out = torch.stack([(corr * w).sum((1, 2)) for w in weights.float()], 1)
    return out[:, :nbins], out[:, nbins]


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T", [(4, 16, 16, 128), (3, 5, 16, 100),
                                       (2, 1, 12, 33)])
def test_vpu_arithmetic_matches_pallas_vpu_kernel(prec, R, PL, PF, T):
    """The emulated per-slot-reduction statistic against the JAX package's
    mxu_binning=False kernel (interpret mode, float32 inputs), within 1e-5
    (f32) or 1e-2 (bf16) of the curve scale, autos relative."""
    rng = np.random.default_rng(R * 100 + PL)
    res_f = (rng.standard_normal((R, PF, T)) * 1e-6).astype(np.float32)
    res_l = res_f if PL == PF else res_f[:, :PL].copy()
    nbins = 4
    w = rng.standard_normal((nbins + 1, PL, PF)).astype(np.float32)
    w[nbins] = 0.0
    w[nbins, np.arange(PL), np.arange(PL)] = 1.0 / PL
    got = _vpu_emulation(torch.tensor(res_l), torch.tensor(res_f),
                         torch.tensor(w), nbins, prec)
    want = jax_binned(jnp.asarray(res_l), jnp.asarray(res_f), jnp.asarray(w),
                      nbins=nbins, rt=1, interpret=True, precision=prec,
                      mxu_binning=False)
    wc, wa = (np.asarray(x, np.float64) for x in want)
    gc, ga = (x.double().numpy() for x in got)
    assert np.abs(gc - wc).max() <= TOL[prec] * np.abs(wc).max()
    assert np.all(np.abs(ga - wa) <= TOL[prec] * np.abs(wa))


@pytest.fixture(scope="module")
def vpu_batches():
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            PulsarBatch.from_numpy(leaves, device="cpu"))


@pytest.fixture(scope="module")
def jax_fused_vpu_1shard(vpu_batches):
    """The JAX engine's fused path through its mxu_binning=False kernel on
    one device (the Pallas kernel in interpret mode on the CPU)."""
    jb = vpu_batches[0]
    sim = JaxSim(jb, gwb=JaxGWB(psd=_psd(float(jb.tspan_common)), orf="hd"),
                 mesh=make_mesh(jax.devices()[:1]), use_pallas=True,
                 pallas_mxu_binning=False)
    return {prec: sim.run(8, seed=3, chunk=8, precision=prec)
            for prec in ("f32", "bf16")}


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_fused_vpu_engine_matches_jax_one_shard(vpu_batches,
                                                jax_fused_vpu_1shard, prec):
    """EnsembleSimulator(stat_path='fused', pallas_mxu_binning=False) on one
    device against the JAX engine with the same flags, same batch and
    seed; on CPU tensors the wrapper runs the plain version and launches
    nothing."""
    tb = vpu_batches[1]
    before = (bc.launches, bc.vpu_launches)
    out = EnsembleSimulator(tb, gwb=GWBConfig(psd=_psd(float(tb.tspan_common)),
                                              orf="hd"),
                            stat_path="fused", pallas_mxu_binning=False,
                            device="cpu").run(8, seed=3, chunk=8,
                                              precision=prec)
    assert (bc.launches, bc.vpu_launches) == before
    assert out["statistic_path"] == "fused" and out["precision"] == prec
    assert out["curves"].shape == (8, 15) and out["autos"].shape == (8,)
    _assert_stats(out, jax_fused_vpu_1shard[prec], prec)


def test_thread_launches_count_only_the_calling_thread():
    """Each thread reads its own launch tally: launches counted on one
    thread (a serve pool's dispatcher) do not show on another's, and a
    CPU call, which runs the plain version, counts none."""
    import threading

    seen = {}

    def worker():
        before = bc.thread_launches()
        bc._count("binned_correlation", 2)
        bc._count("chunk_stats", 0)
        seen["worker"] = (before, bc.thread_launches())

    before = bc.thread_launches()
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen["worker"] == ({}, {"binned_correlation": 2})
    rng = np.random.default_rng(5)
    res = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 4, 4)).astype(np.float32))
    bc.binned_correlation(res, res, w, 4, precision="f32")
    assert bc.thread_launches() == before
