"""The tensor-core binned_correlation kernel's CPU-side pieces.

The kernel itself runs only on a card (tests/test_torch_cuda.py). Here:
its pair tiling (tile sides by PL and PF, tile counts, the 128 cap, the
warp grid) and the 'f32' mode's 3xTF32 operand split, emulated in plain
torch and held against a float64 einsum and the JAX package's Pallas
kernel (interpret mode) on the same seeded residuals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.ops.pallas_kernels import binned_correlation as jax_binned
from fakepta_tpu_torch.ops import binned_corr as bc


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
