"""The projection pass of the port's chunk_stats, at the flagship's K = 320.

The projection kernel runs only on a card (tests/test_torch_cuda.py). Here:
its launch shape (block tiles, grid, shared memory), its contraction order,
the basis it rebuilds (held against the JAX package's ``_basis_rows``), and
its 3xTF32 arithmetic emulated in plain torch, which with the correlation
kernel's emulated 3xTF32 stays within the JAX package's 'f32' tolerance of
a float64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.ops.megakernel import MegaStage as JaxStage
from fakepta_tpu.ops.megakernel import _basis_rows
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.ops import megakernel as mk
from fakepta_tpu_torch.ops.megakernel import T_COMMON, T_OWN, MegaStage

#: the flagship's stages: red (30 bins), DM (100, on scale row 1) and the
#: GWB (30, on the common time grid): K = 320
STAGES = (MegaStage(30, T_OWN, 0), MegaStage(100, T_OWN, 1),
          MegaStage(30, T_COMMON, 0))


def _tables(seed, P, T):
    """(2, P, T) time rows (each pulsar's own sorted TOAs, and the common
    grid) and (2, P, T) scale rows (the TOA mask, and a chromatic scale)."""
    rng = np.random.default_rng(seed)
    t_own = np.sort(rng.uniform(0.0, 1.0, (P, T)), axis=1)
    t_common = np.tile(np.linspace(0.0, 1.05, T), (P, 1))
    mask = np.ones((P, T))
    mask[:, T - 7:] = 0.0
    chrom = (1.4 / rng.uniform(0.5, 3.0, (P, 1))) ** 2
    return (np.stack([t_own, t_common]).astype(np.float32),
            np.stack([mask, mask * chrom]).astype(np.float32))


# the old pair tiling's shapes, (PL, PF): the shared set at PL = PF, a psr
# shard's rows against the array below it
@pytest.mark.parametrize("pl,pf", [(8, 8), (16, 16), (100, 100),
                                   (128, 128), (130, 130), (300, 300),
                                   (25, 100), (1, 100), (50, 100),
                                   (25, 130)])
def test_project_tiling_covers_and_fits(pl, pf):
    """Every (realization, TOA, row) lies in one block, no block is empty,
    the warp grid covers the tile, and the shared memory lets PROJ_BLOCKS
    blocks share an SM, at the flagship and at a ragged R and T."""
    rows = pf if pl == pf else pl + pf
    for R, T in ((1024, 780), (5, 33), (129, 64)):
        t = mk.project_tiling(R, T, rows, n_scales=3)
        (gx, gy, gz) = t.grid
        assert (t.bm, t.bn, t.wgm) == mk.PROJ_TILE
        assert gx * t.bm >= R > (gx - 1) * t.bm
        assert gy * t.bn >= T > (gy - 1) * t.bn
        assert gz == rows
        warps_n = mk.PROJ_THREADS // 32 // t.wgm
        assert t.bm % (16 * t.wgm) == 0 and t.bn % (8 * warps_n) == 0
        assert mk.PROJ_THREADS % t.bn == 0
        assert t.smem <= bc.SMEM_PER_BLOCK
        assert mk.PROJ_BLOCKS * (t.smem + bc.SMEM_RESERVED) \
            <= bc.SMEM_PER_SM
    with pytest.raises(ValueError):
        mk.project_tiling(1024, 780, rows, n_scales=400)


@pytest.mark.parametrize("pl,pf", [(8, 8), (16, 16), (100, 100),
                                   (128, 128), (130, 130), (300, 300),
                                   (25, 100), (1, 100), (50, 100),
                                   (25, 130)])
def test_project_f64_tiling_covers_and_fits(pl, pf):
    """The float64 projection's tile: every (realization, TOA, row) in one
    block, no block empty, the warp grid over the tile, each thread's share
    of a stage's coefficient copies and basis values whole, and its coef
    ring, basis ring and rows in one block's shared memory at
    PROJ_F64_BLOCKS blocks an SM, at the flagship, at a ragged R and T, and
    at ng15's three scale rows."""
    rows = pf if pl == pf else pl + pf
    bm, bn, wgm = mk.PROJ_TILE_F64
    threads, kc, stages = mk.PROJ_THREADS, 2 * mk.NH, mk.PROJ_F64_STAGES
    ld = mk.PROJ_LDA
    assert ld == kc + 4 and stages >= 2
    assert bm % (16 * wgm) == 0 and bn % (8 * (threads // 32 // wgm)) == 0
    assert threads % kc == 0 and (bm * kc) % threads == 0
    assert threads % (kc // 2) == 0 and (bn * kc // 2) % threads == 0
    assert ld % 16 == 4
    for R, T, S in ((1024, 780, 2), (5, 33, 2), (129, 257, 3),
                    (1024, 512, 3)):
        t = mk.project_tiling(R, T, rows, n_scales=S, route="f64")
        (gx, gy, gz) = t.grid
        assert (t.bm, t.bn, t.wgm) == mk.PROJ_TILE_F64
        assert gx * t.bm >= R > (gx - 1) * t.bm
        assert gy * t.bn >= T > (gy - 1) * t.bn
        assert gz == rows
        assert t.smem == 8 * (max(stages * bm * ld, bm * (bn + 8))
                              + 2 * bn * ld + (2 + S) * bn)
        assert t.smem <= bc.SMEM_PER_BLOCK
        assert mk.PROJ_F64_BLOCKS * (t.smem + bc.SMEM_RESERVED) \
            <= bc.SMEM_PER_SM
    with pytest.raises(ValueError):
        mk.project_tiling(1024, 780, rows, n_scales=400, route="f64")


@pytest.mark.parametrize("stages", [
    STAGES, (MegaStage(3, T_OWN, 0),),
    (MegaStage(16, T_OWN, 0), MegaStage(17, T_COMMON, 1),
     MegaStage(1, T_OWN, 0))])
def test_kernel_columns_cover_each_column_once(stages):
    """The contraction order takes every basis column once, cos and sin of
    a harmonic in the same place of their half-chunk, and pads only the
    last chunk."""
    steps = mk.kernel_columns(stages)
    cols = [c for step in steps for c in step]
    assert all(len(step) == 8 for step in steps)
    assert sorted(c for c in cols if c >= 0) == list(range(mk.stage_k(
        stages)))
    chunks = [cols[i:i + 2 * mk.NH] for i in range(0, len(cols), 2 * mk.NH)]
    assert all(-1 not in chunk for chunk in chunks[:-1])
    spans, k = [], 0
    for st in stages:
        spans.append((k, st.nbin))
        k += 2 * st.nbin
    for chunk in chunks:
        for c, s in zip(chunk[:mk.NH], chunk[mk.NH:]):
            assert (c < 0) == (s < 0)
            if c >= 0:
                nbin = next(n for k0, n in spans if k0 <= c < k0 + n)
                assert s == c + nbin


@pytest.mark.parametrize("stage", STAGES)
def test_dense_basis_matches_jax_basis_rows(stage):
    """The basis the kernel rebuilds (the port's dense_basis) against the
    JAX kernel's _basis_rows, pulsar by pulsar: within 2 ULP elementwise."""
    P, T = 12, 128
    times, scales = _tables(3, P, T)
    got = mk.dense_basis(torch.tensor(times), torch.tensor(scales),
                         (stage,)).numpy()                      # (P, T, 2N)
    want = np.stack([np.asarray(_basis_rows(
        JaxStage(*stage), jnp.asarray(times[stage.tcol, p]),
        jnp.asarray(scales[stage.scol, p]), jnp.float32)).T
        for p in range(P)])
    assert got.shape == want.shape == (P, T, 2 * stage.nbin)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= 2 * ulp)


def _dense_oracle(base, coef, times, scales, w):
    """float64 basis, projection, correlation and binning."""
    P, T = times.shape[1:]
    blocks = []
    for st in STAGES:
        n = np.arange(1, st.nbin + 1)
        ph = 2.0 * np.pi * times[st.tcol][:, :, None] * n
        s = scales[st.scol][:, :, None]
        blocks.append(np.concatenate([np.cos(ph) * s, np.sin(ph) * s], -1))
    basis = np.concatenate(blocks, axis=-1)                # (P, T, K)
    res = base + np.einsum("ptk,rpk->rpt", basis, coef)
    out = np.einsum("npq,rpt,rqt->rn", w, res, res)
    return out[:, :-1], out[:, -1]


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("R,P,T", [(4, 6, 48), (3, 16, 128), (5, 9, 100)])
def test_projection_3xtf32_matches_f64_oracle(storage, R, P, T):
    """Seeded operands at a PTA's scales (residuals ~1e-6 s): the emulated
    pass 1 (project_3xtf32) and pass 2 (binned_correlation_3xtf32) within
    1e-5 of the curve scale of the float64 oracle on the stored values,
    autos within 1e-5 relative. bf16 storage: base and coefficients
    stored in bfloat16 (exact in TF32, so their low parts vanish)."""
    rng = np.random.default_rng(R * 100 + P)
    times, scales = _tables(R + P, P, T)
    dt = torch.float32 if storage == "f32" else torch.bfloat16
    base = torch.tensor(rng.standard_normal((R, P, T)) * 1e-6
                        * scales[0][None]).to(dt)
    coef = torch.tensor(rng.standard_normal((R, P, mk.stage_k(STAGES)))
                        * 1e-7).to(dt)
    nbins = 5
    w = rng.standard_normal((nbins + 1, P, P)).astype(np.float32)
    w[nbins] = np.eye(P, dtype=np.float32) / P
    res = mk.project_3xtf32(base, coef, torch.tensor(times),
                            torch.tensor(scales), STAGES)
    got = bc.binned_correlation_3xtf32(res, res, torch.tensor(w), nbins)
    want = _dense_oracle(base.double().numpy(), coef.double().numpy(),
                         times.astype(np.float64), scales.astype(np.float64),
                         w.astype(np.float64))
    gc, ga = (x.double().numpy() for x in got)
    assert np.abs(gc - want[0]).max() <= 1e-5 * np.abs(want[0]).max()
    assert np.all(np.abs(ga - want[1]) <= 1e-5 * np.abs(want[1]))


@pytest.mark.parametrize("local", [False, True])
def test_chunk_stats_takes_the_plain_path_on_cpu(local):
    """On CPU tensors chunk_stats() is chunk_stats_plain() and launches
    nothing; the plain statistic is binned_correlation_plain() on
    project_plain()'s residuals of each set."""
    R, P, T = 3, 8, 40
    times, scales = (torch.tensor(x) for x in _tables(4, P, T))
    g = torch.Generator().manual_seed(5)
    base = torch.randn(R, P, T, generator=g)
    coef = torch.randn(R, P, mk.stage_k(STAGES), generator=g)
    kw = {}
    if local:
        kw = dict(base_local=base[:, 5:].contiguous(),
                  coef_local=coef[:, 5:].contiguous(),
                  times_local=times[:, 5:].contiguous(),
                  scales_local=scales[:, 5:].contiguous())
    res = mk.project_plain(base, coef, times, scales, STAGES)
    res_l = mk.project_plain(*kw.values(), STAGES) if local else res
    w = torch.randn(6, res_l.shape[1], P, generator=g)
    before = (mk.launches, mk.sharded_launches)
    got = mk.chunk_stats(base, coef, times, scales, w, stages=STAGES,
                         nbins=5, **kw)
    assert (mk.launches, mk.sharded_launches) == before
    want = mk.chunk_stats_plain(base, coef, times, scales, w, stages=STAGES,
                                nbins=5, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    direct = bc.binned_correlation_plain(res_l, res, w, 5, precision="f32")
    assert all(torch.equal(a, b) for a, b in zip(direct, want))


@pytest.mark.parametrize("scale", [1e-7, 1.0, 1e37, 1e-39])
def test_bf16_coef_is_exact_in_tf32(scale):
    """Under bf16 storage the projection kernel leaves out the coef.lo
    product: a bfloat16 value (8 significant bits) splits into a TF32 hi
    part equal to it and a lo part of 0, normal or subnormal."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal(4096) * scale,
                     dtype=torch.float32).to(torch.bfloat16).float()
    hi, lo = bc.split_tf32(x)
    assert torch.equal(hi, x)
    assert not lo.any()
