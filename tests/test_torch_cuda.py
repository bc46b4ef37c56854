"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one (a CUDA kernel has no CPU mode). The file imports neither JAX
nor fakepta_tpu, so it runs on a machine that has only the port's
dependencies; tests/conftest.py imports JAX, so on such a machine run

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import ctypes

import numpy as np
import pytest
import torch

from fakepta_tpu_torch import spectrum as spectrum_lib
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.ops import _build
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.ops import megakernel as mk
from fakepta_tpu_torch.ops.megakernel import T_COMMON, T_OWN, MegaStage
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)

TOL = {"f32": 1e-5, "bf16": 1e-2}
STAGES = (MegaStage(4, T_OWN, 0), MegaStage(3, T_OWN, 1),
          MegaStage(4, T_COMMON, 0))


@pytest.fixture
def cuda():
    """The card, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, prec):
    (gc, ga), (wc, wa) = ([np.asarray(torch.as_tensor(x).cpu(), np.float64)
                           for x in pair] for pair in (got, want))
    scale = np.abs(np.concatenate([wc.ravel(), wa.ravel()])).max()
    np.testing.assert_allclose(gc, wc, rtol=0, atol=TOL[prec] * scale)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=TOL[prec] * scale)


def _mega_inputs(seed, R, P, T, nbins=5):
    rng = np.random.default_rng(seed)
    K = mk.stage_k(STAGES)
    t_own = np.tile(np.linspace(0.0, 1.0, T), (P, 1))
    mask = np.ones((P, T))
    mask[:, -5:] = 0.0
    return (rng.standard_normal((R, P, T)) * mask[None],
            rng.standard_normal((R, P, K)), np.stack([t_own, 0.9 * t_own]),
            np.stack([mask, mask * 1.7]),
            rng.standard_normal((nbins + 1, P, P)))


def _check_binned_correlation(res_l, res_f, w, nbins, prec, vpu=False):
    """One launch of the MXU-binning kernel, or with ``vpu`` of the
    per-slot-reduction kernel (none for an empty ensemble), held against
    the plain version, and a bit-identical rerun."""
    fn = bc.binned_correlation_vpu if vpu else bc.binned_correlation
    before = (bc.launches, bc.vpu_launches)
    mine = bc.thread_launches()
    got = fn(res_l, res_f, w, nbins, precision=prec)
    torch.cuda.synchronize()
    n = int(res_l.shape[0] > 0)
    assert (bc.launches, bc.vpu_launches) == (before[0] + n * (not vpu),
                                              before[1] + n * vpu)
    name = "binned_correlation_vpu" if vpu else "binned_correlation"
    assert bc.thread_launches().get(name, 0) == mine.get(name, 0) + n
    assert got[0].shape == (res_l.shape[0], nbins)
    want = bc.binned_correlation_plain(res_l, res_f, w, nbins,
                                       precision=prec)
    if res_l.shape[0]:
        _assert_close(got, want, prec)
    again = fn(res_l, res_f, w, nbins, precision=prec)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# (R, PL, PF, T): PL not a multiple of 16 and PF not of 8, T not of 8 or
# 32, pair spaces past one 128 tile, PL = 1, R not a multiple of the
# kernel's realizations per block (RB = 2 at 25 x 100 and 1 x 1) and R = 0
@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T", [(6, 20, 20, 100), (3, 130, 130, 50),
                                       (2, 12, 40, 33), (5, 100, 100, 780),
                                       (5, 25, 100, 33), (7, 1, 1, 8),
                                       (0, 20, 20, 33)])
def test_binned_correlation_kernel_matches_plain(cuda, prec, R, PL, PF, T):
    g = torch.Generator(device=cuda).manual_seed(1)
    res_f = torch.randn(R, PF, T, device=cuda, generator=g)
    res_l = res_f if PL == PF else torch.randn(R, PL, T, device=cuda,
                                               generator=g)
    w = torch.randn(7, PL, PF, device=cuda, generator=g)
    _check_binned_correlation(res_l, res_f, w, 6, prec)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,P,T", [(5, 6, 48), (3, 130, 40)])
def test_chunk_stats_kernel_matches_plain(cuda, prec, R, P, T):
    base, coef, times, scales, w = _mega_inputs(7, R, P, T)
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    args = [torch.tensor(base).to(dt).to(cuda),
            torch.tensor(coef).to(dt).to(cuda)] + \
        [torch.tensor(x).float().to(cuda) for x in (times, scales, w)]
    before = mk.launches
    got = mk.chunk_stats(*args, stages=STAGES, nbins=5, precision=prec)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    want = mk.chunk_stats_plain(*args, stages=STAGES, nbins=5,
                                precision=prec)
    _assert_close(got, want, prec)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    res = torch.randn(2, 8, 16, device=cuda)
    w = torch.randn(3, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        bc.binned_correlation(res.double(), res.double(), w, 2)
    with pytest.raises(ValueError):
        bc.binned_correlation(res.transpose(1, 2), res, w, 2)
    with pytest.raises(ValueError):
        bc.binned_correlation(res, res, w[:, :4], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "mega"])
def test_engine_on_the_card_matches_the_cpu(cuda, path):
    batch = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                              gamma=13 / 3).numpy())
    want = EnsembleSimulator(batch, gwb=gwb, stat_path="einsum",
                             device="cpu").run(16, seed=3, chunk=8)
    sim = EnsembleSimulator(batch, gwb=gwb, stat_path=path, device=cuda)
    got = sim.run(16, seed=3, chunk=8, precision="f32")
    _assert_close((got["curves"], got["autos"]),
                  (want["curves"], want["autos"]), "f32")
    again = sim.run(16, seed=3, chunk=4, precision="f32")
    np.testing.assert_array_equal(got["curves"], again["curves"])


# (R, PL, PF, T): one pulsar per shard, a quarter and the whole array
# against a 100-pulsar array, and a pair space wider than one 128 tile
SHARD_SHAPES = [(4, 1, 100, 64), (4, 25, 100, 64), (3, 100, 100, 64),
                (2, 25, 130, 40)]


def _sharded_residuals(cuda, R, PL, PF, T, shared=False):
    g = torch.Generator(device=cuda).manual_seed(2)
    res_f = torch.randn(R, PF, T, device=cuda, generator=g)
    # a shard's rows are a tensor of their own (contiguous), as the engine
    # passes them; shared: the single-device path's one operand
    res_l = res_f if shared else res_f[:, PF - PL:].contiguous()
    w = torch.randn(6, PL, PF, device=cuda, generator=g)
    return res_l, res_f, w


# (R, PL, PF, T) of the per-slot-reduction kernel besides SHARD_SHAPES: a
# 2- and 4-shard mesh's rows at the flagship width and the shared
# PL = PF = 100 block at T = 780, R not a multiple of the realizations per
# block (a ragged last block), T not a multiple of 4 or 32, a 2 x 2 grid of
# pair tiles, PL = PF = 1 and R = 0
VPU_SHAPES = SHARD_SHAPES + [(5, 25, 100, 780), (5, 50, 100, 780),
                             (3, 12, 40, 33), (9, 1, 100, 33),
                             (0, 25, 100, 64), (5, 100, 100, 780),
                             (3, 130, 130, 50), (7, 1, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T", VPU_SHAPES)
def test_binned_correlation_vpu_kernel_matches_plain(cuda, prec, R, PL, PF,
                                                     T):
    for shared in ((False, True) if PL == PF else (False,)):
        res_l, res_f, w = _sharded_residuals(cuda, R, PL, PF, T, shared)
        _check_binned_correlation(res_l, res_f, w, 5, prec, vpu=True)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_vpu_tiling_shared_memory_matches_the_source(cuda, prec):
    """binned_corr.py::vpu_smem mirrors what fpt_binned_corr_vpu requests."""
    smem = _build.load("binned_corr").fpt_binned_corr_vpu_smem
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int] * 6
    for pl, pf, shared in ((100, 100, True), (50, 100, False),
                           (25, 100, False), (1, 1, True), (130, 130, True),
                           (12, 40, False), (25, 130, False)):
        t = bc.vpu_tiling(pl, pf, 16, prec, shared)
        assert smem(pl, pf, 16, t.code(), int(prec == "bf16"),
                    int(shared)) == t.smem


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T", SHARD_SHAPES[:2] + [
    (5, 25, 100, 780), (5, 50, 100, 780), (3, 12, 40, 33),
    (2, 25, 130, 40), (9, 1, 100, 33), (0, 25, 100, 64)])
def test_binned_correlation_kernel_local_rows(cuda, prec, R, PL, PF, T):
    """The MXU-binning kernel with PL < PF, as the sharded fused path
    launches it: a shard's rows (a 2- and 4-shard mesh's at the flagship
    width), ragged tiles, a second column tile, one pulsar per shard, R
    not a multiple of RB and R = 0."""
    res_l, res_f, w = _sharded_residuals(cuda, R, PL, PF, T)
    _check_binned_correlation(res_l, res_f, w, 5, prec)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T", SHARD_SHAPES)
def test_chunk_stats_local_full_matches_plain(cuda, prec, R, PL, PF, T):
    base, coef, times, scales, _ = _mega_inputs(9, R, PF, T)
    w = np.random.default_rng(10).standard_normal((6, PL, PF))
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    full = [torch.tensor(base).to(dt).to(cuda),
            torch.tensor(coef).to(dt).to(cuda)] + \
        [torch.tensor(x).float().to(cuda) for x in (times, scales)]
    lo = PF - PL
    loc = [x[:, lo:].contiguous() for x in full]
    kw = dict(stages=STAGES, nbins=5, precision=prec, base_local=loc[0],
              coef_local=loc[1], times_local=loc[2], scales_local=loc[3])
    wt = torch.tensor(w).float().to(cuda)
    before = (mk.launches, mk.sharded_launches)
    got = mk.chunk_stats(*full, wt, **kw)
    torch.cuda.synchronize()
    assert (mk.launches, mk.sharded_launches) == (before[0], before[1] + 1)
    want = mk.chunk_stats_plain(*full, wt, **kw)
    _assert_close(got, want, prec)
    again = mk.chunk_stats(*full, wt, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("path,mxu", [("einsum", True), ("fused", True),
                                      ("fused", False), ("mega", True)])
def test_sharded_engine_on_the_card_matches_one_shard(cuda, path, mxu):
    """A psr-sharded mesh that names the card twice against the 1-shard
    run; the sharded path launches its own kernel, and reruns are
    bit-identical."""
    batch = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                              gamma=13 / 3).numpy())
    want = EnsembleSimulator(batch, gwb=gwb, stat_path="einsum",
                             device=cuda).run(16, seed=3, chunk=8,
                                              precision="f32")
    sim = EnsembleSimulator(batch, gwb=gwb, stat_path=path,
                            pallas_mxu_binning=mxu,
                            mesh=make_mesh(["cuda:0"] * 2, psr_shards=2))
    counters = {("fused", True): lambda: bc.launches,
                ("fused", False): lambda: bc.vpu_launches,
                ("mega", True): lambda: mk.sharded_launches,
                ("einsum", True): lambda: 0}[(path, mxu)]
    before = counters()
    got = sim.run(16, seed=3, chunk=8, precision="f32")
    # two chunks, two shards: one launch per shard and chunk
    assert counters() - before == (0 if path == "einsum" else 4)
    _assert_close((got["curves"], got["autos"]),
                  (want["curves"], want["autos"]), "f32")
    again = sim.run(16, seed=3, chunk=8, precision="f32")
    np.testing.assert_array_equal(got["curves"], again["curves"])
    np.testing.assert_array_equal(got["autos"], again["autos"])


# -- the projection pass of chunk_stats (pass 1) ----------------------------

#: the flagship's stages (K = 320): nbin 30 is not a multiple of the
#: kernel's 16-harmonic chunks, so chunks straddle stages
FLAGSHIP_STAGES = (MegaStage(30, T_OWN, 0), MegaStage(100, T_OWN, 1),
                   MegaStage(30, T_COMMON, 0))


def _proj_inputs(cuda, seed, R, P, T, stages, dt):
    """base (R, P, T) ~1e-6 and coef (R, P, K) ~1e-7 in ``dt``, and float32
    time rows (own sorted TOAs, a common grid) and scale rows (the TOA mask
    with 7 padding TOAs, then chromatic scales, as many as the stages
    read), on the card."""
    rng = np.random.default_rng(seed)
    t_own = np.sort(rng.uniform(0.0, 1.0, (P, T)), axis=1)
    mask = np.ones((P, T))
    mask[:, max(0, T - 7):] = 0.0
    chrom = (1.4 / rng.uniform(0.5, 3.0, (P, 1))) ** 2
    base = rng.standard_normal((R, P, T)) * 1e-6 * mask[None]
    coef = rng.standard_normal((R, P, mk.stage_k(stages))) * 1e-7
    times = np.stack([t_own, np.tile(np.linspace(0.0, 1.05, T), (P, 1))])
    # a chromatic scale row per power of chrom the stages read (two at least)
    n_scales = max([2] + [st.scol + 1 for st in stages])
    scales = np.stack([mask * chrom ** k for k in range(n_scales)])
    return ([torch.tensor(x).to(dt).to(cuda) for x in (base, coef)]
            + [torch.tensor(x).float().to(cuda) for x in (times, scales)])


# (R, PL, PF, T, stages): R not a multiple of BM = 128, T not a multiple
# of BN = 128 (nor of 4), the flagship's K = 320 and the
# small stages (nbin 4 and 3, below one chunk), T_COMMON and scale row 1 in
# both, one pulsar, and a psr shard's rows against a wider array
PROJ_SHAPES = [(5, 6, 6, 48, STAGES), (130, 9, 9, 100, FLAGSHIP_STAGES),
               (3, 4, 16, 780, FLAGSHIP_STAGES), (1, 1, 1, 8, STAGES),
               (67, 25, 100, 33, STAGES)]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T,stages", PROJ_SHAPES)
def test_project_kernel_matches_plain(cuda, storage, R, PL, PF, T, stages):
    """Pass 1 alone against its plain version (dense basis, full-f32
    einsum): within 1e-5 of the residual scale (3xTF32 products, ~2^-21
    relative each, and the accurate sincosf against torch's cos/sin); a
    rerun is bit-identical."""
    dt = torch.float32 if storage == "f32" else torch.bfloat16
    full = _proj_inputs(cuda, 11, R, PF, T, stages, dt)
    local = (None,) * 4
    if PL < PF:
        local = tuple(x[:, PF - PL:].contiguous() for x in full)
    want = [mk.project_plain(*full, stages)]
    if PL < PF:
        want.insert(0, mk.project_plain(*local, stages))
    got = mk._launch_project(*full, stages, local)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.float32
    for g, w in zip(got[2 - len(want):], want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= 1e-5 * scale, (err, scale)
    again = mk._launch_project(*full, stages, local)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_stats_without_stages_on_the_card(cuda, prec):
    """stages=() (K = 0): pass 1 only converts base to float32; both sets
    against the plain version, with a bit-identical rerun."""
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    base, coef, times, scales = _proj_inputs(cuda, 12, 6, 20, 100, (), dt)
    w = torch.randn(6, 20, 20, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    res_l, res = mk._launch_project(base, coef, times, scales, (),
                                    (None,) * 4)
    assert torch.equal(res, base.float())
    for kw, ww in (({}, w), (dict(base_local=base[:, 15:].contiguous(),
                                  coef_local=coef[:, 15:].contiguous(),
                                  times_local=times[:, 15:].contiguous(),
                                  scales_local=scales[:, 15:].contiguous()),
                             w[:, 15:].contiguous())):
        got = mk.chunk_stats(base, coef, times, scales, ww, stages=(),
                             nbins=5, precision=prec, **kw)
        want = mk.chunk_stats_plain(base, coef, times, scales, ww, stages=(),
                                    nbins=5, precision=prec, **kw)
        _assert_close(got, want, prec)
        again = mk.chunk_stats(base, coef, times, scales, ww, stages=(),
                               nbins=5, precision=prec, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("pl", [40, 10])
def test_chunk_stats_flagship_stages_rerun_bit_identical(cuda, prec, pl):
    """Both operand sets at K = 320 with R and T ragged against the tiles:
    against the plain version, one counted launch per call, and reruns
    bit-identical."""
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    P = 40
    full = _proj_inputs(cuda, 13, 130, P, 100, FLAGSHIP_STAGES, dt)
    w = torch.randn(8, pl, P, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    kw = {}
    if pl < P:
        kw = dict(zip(("base_local", "coef_local", "times_local",
                       "scales_local"), (x[:, :pl].contiguous()
                                         for x in full)))
    before = (mk.launches, mk.sharded_launches)
    got = mk.chunk_stats(*full, w, stages=FLAGSHIP_STAGES, nbins=7,
                         precision=prec, **kw)
    torch.cuda.synchronize()
    assert (mk.launches, mk.sharded_launches) == (
        before[0] + (pl == P), before[1] + (pl < P))
    want = mk.chunk_stats_plain(*full, w, stages=FLAGSHIP_STAGES, nbins=7,
                                precision=prec, **kw)
    _assert_close(got, want, prec)
    for _ in range(2):
        again = mk.chunk_stats(*full, w, stages=FLAGSHIP_STAGES, nbins=7,
                               precision=prec, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_project_smem_matches_the_source(cuda):
    """megakernel.py::project_smem mirrors what fpt_project requests."""
    smem = _build.load("megakernel").fpt_project_smem
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int] * 3
    bm, bn, _ = mk.PROJ_TILE
    for n_scales in (1, 2, 5):
        assert smem(bm, bn, n_scales) == mk.project_smem(bm, bn, n_scales)


# -- the ng15 scenario's shapes: masked padding, PL = PF = 68 ---------------

def _ng15(cuda, **engine_kw):
    """The registry's ng15, uncut (68 pulsars padded to 512 TOAs, four
    backend bands, white hyperprior draws), on the card."""
    from fakepta_tpu_torch.scenarios import registry
    return registry.get("ng15").build(device=cuda, **engine_kw)


@pytest.fixture(scope="module")
def ng15_residuals():
    """64 realizations of ng15's residuals (projected, and split into base
    and GP coefficients) with the engine's statistic weights and megakernel
    tables; None without a card."""
    if not torch.cuda.is_available():
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng
    sim = _ng15(torch.device("cuda"))
    keys = _chunk_keys(rng.key(21, device="cuda"), 0, 64)
    with torch.no_grad():
        res = sim._residuals(keys)
        base, coef = sim._residuals(keys, split_gp=True)
    return sim, res, base, coef


@pytest.mark.cuda
@pytest.mark.parametrize("vpu", [False, True])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_binned_correlation_at_the_ng15_shape(cuda, ng15_residuals, prec,
                                              vpu):
    """#1 and #2 on ng15's own residuals: PL = PF = 68 (no tile multiple),
    T = 512 with each pulsar's padding TOAs zero."""
    sim, res, _, _ = ng15_residuals
    assert res.shape == (64, 68, 512)
    mask = sim.batch.mask
    assert not mask.all() and not res[:, ~mask].any()
    _check_binned_correlation(res, res, sim._stat_weights, sim.nbins, prec,
                              vpu=vpu)


#: ng15's GP stages as the engine builds them (red 30, DM 30, chromatic 15
#: on own time, the GWB's 30 on the common grid: K = 210; its four system
#: bands ride the residual base), and the same with the four bands' 10
#: harmonics as GP columns too (K = 290)
NG15_K290 = (MegaStage(30, T_OWN, 0), MegaStage(30, T_OWN, 1),
             MegaStage(15, T_OWN, 2), MegaStage(40, T_OWN, 0),
             MegaStage(30, T_COMMON, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [210, 290])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_stats_at_the_ng15_shape(cuda, ng15_residuals, prec, k):
    """#3 on ng15's base and coefficients (K = 210) and on random
    coefficients at K = 290: the projection rebuilds the bases on chip and
    must leave the padding TOAs zero (the scale rows carry the mask), as
    chunk_stats_plain does; a rerun is bit-identical."""
    sim, res, base, coef = ng15_residuals
    stages, times, scales = sim._mega_tables
    if k == 290:
        stages = NG15_K290
        coef = torch.randn(64, 68, 290, device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(5)) * coef.abs().max()
    assert mk.stage_k(stages) == coef.shape[2] == k
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    ops = (base.to(dt), coef.to(dt).contiguous(), times, scales,
           sim._stat_weights)
    proj = mk._launch_project(*ops[:4], stages, (None,) * 4)[1]
    assert not proj[:, ~sim.batch.mask].any()
    if k == 210 and prec == "f32":
        assert float((proj - res).abs().max()) <= 1e-5 * float(
            res.abs().max())
    before = mk.launches
    got = mk.chunk_stats(*ops, stages=stages, nbins=sim.nbins,
                         precision=prec)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    want = mk.chunk_stats_plain(*ops, stages=stages, nbins=sim.nbins,
                                precision=prec)
    _assert_close(got, want, prec)
    again = mk.chunk_stats(*ops, stages=stages, nbins=sim.nbins,
                           precision=prec)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_ng15_two_shard_mesh_matches_one_shard(cuda, path):
    """ng15 on two psr shards of the card (34 pulsars each: #1 and #4 at
    PL = 34, PF = 68) against the 1-shard einsum run: the white hyperprior
    draws are the same on both mesh shapes; reruns bit-identical."""
    want = _ng15(cuda, stat_path="einsum").run(32, seed=4, chunk=16,
                                                  precision="f32")
    from fakepta_tpu_torch.scenarios import registry
    sim = registry.get("ng15").build(
        mesh=make_mesh(["cuda:0"] * 2, psr_shards=2), stat_path=path)
    got = sim.run(32, seed=4, chunk=16, precision="f32")
    _assert_close((got["curves"], got["autos"]),
                  (want["curves"], want["autos"]), "f32")
    again = sim.run(32, seed=4, chunk=16, precision="f32")
    np.testing.assert_array_equal(got["curves"], again["curves"])
    np.testing.assert_array_equal(got["autos"], again["autos"])


# -- the run loop on the card: pinned copies, the ring, lanes, peak memory --

def _flagship(cuda, stat_path, **engine_kw):
    """The registry's flagship_100 at full width (100 pulsars x 780 TOAs,
    K = 320) on the card."""
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device=cuda)
    return EnsembleSimulator(parts[0], stat_path=stat_path, device=cuda,
                             **dict(scn.sim_kwargs(*parts), **engine_kw))


def _same(a, b):
    np.testing.assert_array_equal(a["curves"], b["curves"])
    np.testing.assert_array_equal(a["autos"], b["autos"])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "mega"])
def test_pinned_copy_pipeline_is_bit_identical(cuda, path):
    """8 full-width chunks through the pinned-copy ring at depths 1-3 equal
    the serial loop bit for bit; every chunk has a device execute span."""
    sim = _flagship(cuda, path)
    want = sim.run(8192, seed=2, chunk=1024, pipeline_depth=0)
    for d in (1, 2, 3):
        got = sim.run(8192, seed=2, chunk=1024, pipeline_depth=d)
        _same(got, want)
        rep = got["report"]
        assert rep.counters["pipeline.d2h_async"] == 8
        assert 1 <= rep.memory["packed_buffers_live_peak"] <= d
        assert all(c["execute_s"] > 0 for c in rep.chunks)
        assert rep.meta["platform"] == "gpu"
        assert rep.meta["device_kind"] == torch.cuda.get_device_name(cuda)


@pytest.mark.cuda
def test_copies_wait_for_the_step_under_a_slowed_drain(cuda, monkeypatch):
    """The copy stream waits for the event behind each step's last write
    and a ring slot is reused only after its drain: with the device held
    up before the packed write (a spin kernel) and every drain slowed on
    the host, a depth-2 run still equals the serial one bit for bit and
    the loop records its waits as stall."""
    import time

    sim = _flagship(cuda, "fused")
    want = sim.run(4096, seed=3, chunk=1024, pipeline_depth=0)
    shared = sim._step_shared

    def late_step(*a, **kw):
        out = shared(*a, **kw)
        torch.cuda._sleep(20_000_000)       # ~10 ms before the packed write
        return out

    monkeypatch.setattr(sim, "_step_shared", late_step)
    seen = []

    def slow_drain(done, nreal):
        time.sleep(0.3)
        seen.append(done)

    got = sim.run(4096, seed=3, chunk=1024, pipeline_depth=2,
                  progress=slow_drain)
    _same(got, want)
    assert seen == [1024, 2048, 3072, 4096]
    rep = got["report"]
    assert rep.summary()["pipeline_stall_s"] > 0.2
    assert rep.memory["packed_buffers_live_peak"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_lane_cohort_on_the_vpu_kernel(cuda, prec):
    """#2 (pallas_mxu_binning=False) at full width: each lane of a
    1024-slot cohort equals the lane alone at the same chunk bit for bit
    (vpu_tiling picks the same rb for both)."""
    sim = _flagship(cuda, "fused", pallas_mxu_binning=False)
    lanes = [(11, 300), (22, 500), (33, 224)]
    before = bc.vpu_launches
    cohort = sim.run(1024, chunk=1024, lanes=lanes, precision=prec)
    assert bc.vpu_launches == before + 1
    pos = 0
    for s, n in lanes:
        alone = sim.run(1024, chunk=1024, lanes=[(s, n)], precision=prec)
        np.testing.assert_array_equal(cohort["curves"][pos:pos + n],
                                      alone["curves"][:n])
        np.testing.assert_array_equal(cohort["autos"][pos:pos + n],
                                      alone["autos"][:n])
        pos += n


# the most a live large-pool block of the caching allocator can exceed its
# request by, with room: a reused block is split only when more than 1 MiB
# would be left over
ALLOCATOR_GRANULE = 2 << 20


@pytest.mark.cuda
def test_peak_memory_is_bounded_as_the_depth_grows(cuda):
    """The allocator's peak grows by at most the extra ring slots between
    depth 1 and depth 3, give or take one allocator granule per live large
    block (the run resets the peak counts when it starts)."""
    sim = _flagship(cuda, "mega")
    sim.run(1024, seed=1, chunk=1024)
    peaks, blocks = {}, {}
    for d in (1, 2, 3):
        rep = sim.run(6144, seed=1, chunk=1024, pipeline_depth=d)["report"]
        assert rep.memory["peak_hbm_source"] == "allocator"
        peaks[d] = rep.memory["peak_hbm_bytes"]
        blocks[d] = torch.cuda.memory_stats(cuda)["active.large_pool.peak"]
        slot = rep.memory["packed_buffer_bytes"]
    slack = ALLOCATOR_GRANULE * max(blocks.values())
    assert peaks[3] <= peaks[1] + 2 * slot + slack
    assert peaks[2] <= peaks[1] + slot + slack


@pytest.mark.cuda
def test_keep_corr_pipeline_on_the_card(cuda):
    """keep_corr drains the (R, P, P) correlations on the writer thread,
    after the step's event: depth 2 equals the serial loop bit for bit."""
    sim = _flagship(cuda, "einsum")
    want = sim.run(2048, seed=4, chunk=1024, keep_corr=True,
                   pipeline_depth=0)
    got = sim.run(2048, seed=4, chunk=1024, keep_corr=True,
                  pipeline_depth=2)
    _same(got, want)
    assert got["corr"].shape == (2048, 100, 100)
    np.testing.assert_array_equal(got["corr"], want["corr"])


@pytest.mark.cuda
def test_bf16_bases_cost_no_memory_on_the_card(cuda):
    """bases_dtype='bf16' rounds the basis once, at construction: a run's
    allocator peak stays at the f32-basis run's (give or take one granule
    per live large block), and the curves within the CPU test's 2e-2 of
    the f32-basis run."""
    import gc

    runs = {}
    for dtype in ("f32", "bf16"):
        sim = _flagship(cuda, "fused", bases_dtype=dtype)
        sim.run(1024, seed=1, chunk=1024)
        out = sim.run(2048, seed=6, chunk=1024)
        runs[dtype] = (out, out["report"].memory["peak_hbm_bytes"],
                       torch.cuda.memory_stats(cuda)["active.large_pool.peak"])
        del sim, out
        gc.collect()
    (a, peak_a, blocks_a), (b, peak_b, blocks_b) = runs["f32"], runs["bf16"]
    assert peak_b <= peak_a + ALLOCATOR_GRANULE * max(blocks_a, blocks_b)
    assert not np.array_equal(a["curves"], b["curves"])
    scale = np.abs(a["curves"]).max()
    np.testing.assert_allclose(b["curves"], a["curves"], rtol=0,
                               atol=2e-2 * scale)


# -- CGW and BayesEphem signals on the card (ipta_dr3) --------------------

def _ipta(device, **engine_kw):
    """The registry's ipta_dr3 reduced to 16 pulsars x 128 TOAs (its CGW
    source population and BayesEphem mass draws kept)."""
    from fakepta_tpu_torch.scenarios import registry
    return registry.get("ipta_dr3").reduced(max_psr=16, max_toa=128).build(
        device=device, **engine_kw)


def _sampled_bounds(got, want):
    """The sampled-signal bound: rtol 1e-5 and 1e-4 of the curve scale."""
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=1e-5,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=1e-5)


@pytest.fixture(scope="module")
def ipta_cpu():
    return _ipta("cpu", stat_path="einsum").run(64, seed=3, chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_ipta_dr3_reduced_on_the_card(cuda, ipta_cpu, path):
    """ipta_dr3 (reduced) through every path on the card against the port
    on the CPU; reruns bit-identical."""
    sim = _ipta(cuda, stat_path=path)
    got = sim.run(64, seed=3, chunk=32, precision="f32")
    _sampled_bounds(got, ipta_cpu)
    _same(got, sim.run(64, seed=3, chunk=32, precision="f32"))


def _signal_sims(device):
    """A small array with a sampled Jupiter (mass and orbit), a sampled
    source without and one with the pulsar term (sampled distances)."""
    from fakepta_tpu_torch.parallel.montecarlo import (CGWSampling,
                                                       RoemerSampling)
    batch = PulsarBatch.synthetic(npsr=8, ntoa=96, tspan_years=12.0,
                                  n_red=4, n_dm=4, seed=2, device="cpu")
    toas = 4.6e9 + np.tile(np.linspace(0.0, 12 * 3.15e7, 96), (8, 1))
    pdist = np.column_stack([np.linspace(0.5, 2.0, 8), np.full(8, 0.2)])
    return EnsembleSimulator(
        batch, device=device, include=("white",), toas_abs=toas,
        pdist=pdist, roemer_sample=RoemerSampling(
            "jupiter", s_mass=1.5e23, s_Om=2e-4, s_e=3e-7),
        cgw_sample=[CGWSampling(), CGWSampling(psrterm=True,
                                               sample_pdist=True)])


@pytest.mark.cuda
def test_sampled_terms_on_the_card_match_the_cpu(cuda):
    """Each sampled term (R, P, T) on the card within 2e-4 of its scale of
    the CPU port's, the float32 waveform bound; a rerun bit-identical."""
    from fakepta_tpu_torch.parallel import montecarlo as tmc
    from fakepta_tpu_torch.utils import rng
    sims = {d: _signal_sims(d) for d in ("cpu", cuda)}
    keys = {d: tmc._chunk_keys(rng.key(9, device=d), 0, 64) for d in sims}
    bulks = sims["cpu"]._host_cgw_bulks(keys["cpu"])
    terms = {}
    for d, sim in sims.items():
        sig, pos = sim._full.signals, sim.batch.pos
        gidx = torch.arange(8, device=d)
        state, scales, zero = sig.roemer[0]
        out = [tmc._sampled_roemer(keys[d], state, scales, zero, pos, 0)]
        for j, (static, ranges, t_rel) in enumerate(sig.cgw):
            bulk = bulks[0].to(d) if static[0] else None
            out.append(tmc._sampled_cgw(keys[d], t_rel, pos, sig.pdist,
                                        ranges, static, j, gidx, bulk=bulk))
        terms[d] = [t.cpu().numpy() for t in out]
    for got, want in zip(terms[cuda], terms["cpu"]):
        assert got.shape == (64, 8, 96)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())
    a = sims[cuda].run(128, seed=5, chunk=64)
    _same(a, sims[cuda].run(128, seed=5, chunk=64))
    _sampled_bounds(a, sims["cpu"].run(128, seed=5, chunk=64))


# -- the detection lane and TOA sharding on the card (new slot counts, the
# -- null stream's stage set) -----------------------------------------------

#: the OS lane's weight-slot counts at the flagship's 15 bins: the null
#: stream's n_os + 1 with one and three ORFs, the main launch's
#: 15 + n_os + 1 with one and three
OS_NB = (2, 4, 17, 19)


@pytest.mark.cuda
@pytest.mark.parametrize("vpu", [False, True])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("nb", OS_NB)
@pytest.mark.parametrize("R,PL,PF,T", [(9, 100, 100, 780),
                                       (5, 50, 100, 780),
                                       (5, 25, 100, 780)])
def test_binned_correlation_at_the_os_slot_counts(cuda, R, PL, PF, T, nb,
                                                  prec, vpu):
    """#1 and #2 at every weight-slot count the OS lane launches them at,
    on the flagship's shared set and a 2- and 4-shard mesh's rows; for #2
    rb comes from vpu_tiling at that count."""
    res_l, res_f, _ = _sharded_residuals(cuda, R, PL, PF, T,
                                         shared=PL == PF)
    w = torch.randn(nb, PL, PF, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(nb))
    _check_binned_correlation(res_l, res_f, w, nb - 1, prec, vpu=vpu)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("nb", OS_NB)
@pytest.mark.parametrize("pl", [100, 50, 25])
def test_chunk_stats_at_the_os_slot_counts(cuda, pl, nb, prec):
    """#3 (pl = 100) and #4 (a shard's pl rows) on the flagship's own
    residual base and coefficients (K = 320) at each slot count, and
    bit-identical reruns."""
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng
    sim = _flagship(cuda, "mega")
    keys = _chunk_keys(rng.key(4, device=cuda), 0, 16)
    with torch.no_grad():
        base, coef = sim._residuals(keys, split_gp=True)
    stages, times, scales = sim._mega_tables
    assert mk.stage_k(stages) == 320
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    base, coef = base.to(dt), coef.to(dt)
    w = torch.randn(nb, pl, 100, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(nb))
    kw = {} if pl == 100 else dict(
        base_local=base[:, :pl].contiguous(),
        coef_local=coef[:, :pl].contiguous(),
        times_local=times[:, :pl].contiguous(),
        scales_local=scales[:, :pl].contiguous())
    got = mk.chunk_stats(base, coef, times, scales, w, stages=stages,
                         nbins=nb - 1, precision=prec, **kw)
    want = mk.chunk_stats_plain(base, coef, times, scales, w, stages=stages,
                                nbins=nb - 1, precision=prec, **kw)
    _assert_close(got, want, prec)
    again = mk.chunk_stats(base, coef, times, scales, w, stages=stages,
                           nbins=nb - 1, precision=prec, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("pl", [100, 50])
def test_chunk_stats_on_the_null_stage_set(cuda, pl, prec):
    """#3 / #4 on the null stream's own operands: the 0xD7 residual base
    and its GWB-free coefficients (K = 260) on the stage set without the
    GWB, with the OS weights and a zero auto slot (NB = 4)."""
    from fakepta_tpu_torch.detect import OSSpec
    from fakepta_tpu_torch.parallel.montecarlo import _NULL_TAG, _chunk_keys
    from fakepta_tpu_torch.utils import rng
    sim = _flagship(cuda, "mega")
    keys = rng.fold_in(_chunk_keys(rng.key(4, device=cuda), 0, 16),
                       _NULL_TAG)
    with torch.no_grad():
        base, coef = sim._residuals(keys, split_gp=True, null=True)
    stages = sim._mega_stages_null
    _, times, scales = sim._mega_tables
    assert mk.stage_k(stages) == coef.shape[2] == 260
    lanes = sim._prepare_lanes(OSSpec(orf=("hd", "monopole", "dipole"),
                                      null=True))
    w = lanes.weights[id(sim._full)][1][:, :pl].contiguous()
    assert w.shape == (4, pl, 100) and not w[3].any()
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    base, coef = base.to(dt), coef.to(dt)
    kw = {} if pl == 100 else dict(
        base_local=base[:, :pl].contiguous(),
        coef_local=coef[:, :pl].contiguous(),
        times_local=times[:, :pl].contiguous(),
        scales_local=scales[:, :pl].contiguous())
    got = mk.chunk_stats(base, coef, times, scales, w, stages=stages,
                         nbins=3, precision=prec, **kw)
    want = mk.chunk_stats_plain(base, coef, times, scales, w, stages=stages,
                                nbins=3, precision=prec, **kw)
    _assert_close(got, want, prec)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("path,mxu", [("einsum", True), ("fused", True),
                                      ("fused", False), ("mega", True)])
def test_os_lane_on_the_card_matches_the_cpu(cuda, path, mxu, shards):
    """run(os=...) with the null stream on the card, every path on one and
    two psr shards, against the CPU port's einsum run: amp2 and null amp2
    within 1e-4 of max|amp2| (f32), reruns bit-identical."""
    from fakepta_tpu_torch.detect import OSSpec
    batch = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                              gamma=13 / 3).numpy())
    spec = OSSpec(orf=("hd", "monopole", "dipole"), null=True)
    want = EnsembleSimulator(batch, gwb=gwb, stat_path="einsum",
                             device="cpu").run(16, seed=3, chunk=8, os=spec)
    mesh = make_mesh([cuda] * shards, psr_shards=shards)
    sim = EnsembleSimulator(batch, gwb=gwb, stat_path=path,
                            pallas_mxu_binning=mxu, mesh=mesh)
    got = sim.run(16, seed=3, chunk=8, precision="f32", os=spec)
    for orf in spec.orfs:
        scale = np.abs(want["os"]["stats"][orf]["amp2"]).max()
        for k in ("amp2", "null_amp2"):
            np.testing.assert_allclose(got["os"]["stats"][orf][k],
                                       want["os"]["stats"][orf][k], rtol=0,
                                       atol=1e-4 * scale)
    again = sim.run(16, seed=3, chunk=8, precision="f32", os=spec)
    _same(got, again)
    for orf in spec.orfs:
        np.testing.assert_array_equal(got["os"]["stats"][orf]["null_amp2"],
                                      again["os"]["stats"][orf]["null_amp2"])


@pytest.mark.cuda
@pytest.mark.parametrize("psr,toa", [(1, 2), (1, 4), (2, 2)])
def test_toa_sharding_on_the_card_matches_the_cpu(cuda, psr, toa):
    """toa_shards > 1 on one card (the cells in turn) against the CPU
    port's unsharded einsum run at the JAX package's bound (rtol 5e-5),
    and a bit-identical rerun."""
    batch = PulsarBatch.synthetic(npsr=8, ntoa=128, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                              gamma=13 / 3).numpy())
    want = EnsembleSimulator(batch, gwb=gwb, stat_path="einsum",
                             device="cpu").run(16, seed=3, chunk=8)
    sim = EnsembleSimulator(batch, gwb=gwb, stat_path="einsum",
                            mesh=make_mesh([cuda] * (psr * toa),
                                           psr_shards=psr, toa_shards=toa))
    got = sim.run(16, seed=3, chunk=8)
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=5e-5,
                               atol=1e-7 * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=5e-5)
    _same(got, sim.run(16, seed=3, chunk=8))


# -- a facade-built batch: ragged TOAs under a mask, per-pulsar Tspan and
# -- df_own, drawn radio frequencies; and the same batch at T % 4 != 0 ------

#: per-TOA leaves of a batch (the TOA axis last)
TOA_LEAVES = ("t_own", "t_common", "mask", "freqs", "sigma2", "epoch_idx",
              "ecorr_amp", "sys_mask")


def _trim_toas(batch, t):
    """``batch`` cut to its first ``t`` TOA slots (every valid TOA must fit
    them): a facade batch at a width from_pulsars' 128-slot padding never
    gives."""
    leaves = batch.numpy()
    assert leaves["mask"][:, t:].sum() == 0
    for k in TOA_LEAVES:
        leaves[k] = leaves[k][..., :t]
    return PulsarBatch.from_numpy(leaves, device=batch.device)


def _facade_sim(cuda, width=None, **engine_kw):
    """20 pulsars of make_fake_array on the card (ragged after gaps,
    drawn frequencies, 100 epochs over 10 yr) packed by from_pulsars, with
    an HD background of 4 bins; ``width`` trims the TOA slots."""
    from fakepta_tpu_torch.fake_pta import make_fake_array
    psrs = make_fake_array(npsrs=20, Tobs=10.0, ntoas=100, isotropic=True,
                           gaps=True, toaerr=1e-7, pdist=1.0,
                           backends=["NUPPI"], seed=5, device=cuda)
    batch = PulsarBatch.from_pulsars(psrs, n_red=10, n_dm=20, n_chrom=1,
                                     device=cuda)
    if width is not None:
        batch = _trim_toas(batch, width)
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, -13.5, 13 / 3).numpy())
    if "mesh" not in engine_kw:
        engine_kw["device"] = cuda
    return EnsembleSimulator(batch, gwb=gwb, **engine_kw)


@pytest.fixture(scope="module", params=[None, 101])
def facade_residuals(request):
    """32 realizations of the facade batch's residuals (projected, and
    split into base and GP coefficients), at its own 128 TOA slots and cut
    to 101 (T % 4 == 1); None without a card."""
    if not torch.cuda.is_available():
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng
    sim = _facade_sim(torch.device("cuda"), width=request.param)
    keys = _chunk_keys(rng.key(23, device="cuda"), 0, 32)
    with torch.no_grad():
        res = sim._residuals(keys)
        base, coef = sim._residuals(keys, split_gp=True)
    return sim, res, base, coef


@pytest.mark.cuda
@pytest.mark.parametrize("pl", [20, 10])
@pytest.mark.parametrize("vpu", [False, True])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_binned_correlation_at_a_facade_batch(cuda, facade_residuals, prec,
                                              vpu, pl):
    """#1 and #2 on a facade batch's residuals, the shared set (PL = 20)
    and a 2-shard mesh's rows (PL = 10): ragged valid TOAs, padding zero,
    T = 128 and T = 101 (the scalar staging of the mainloop)."""
    sim, res, _, _ = facade_residuals
    mask = sim.batch.mask
    assert not mask.all() and not res[:, ~mask].any()
    w = sim._stat_weights
    res_l, w_l = (res, w) if pl == 20 else (res[:, :pl].contiguous(),
                                             w[:, :pl].contiguous())
    _check_binned_correlation(res_l, res, w_l, sim.nbins, prec, vpu=vpu)


@pytest.mark.cuda
@pytest.mark.parametrize("pl", [20, 10])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_stats_at_a_facade_batch(cuda, facade_residuals, prec, pl):
    """#3 (PL = 20) and #4 (a 2-shard mesh's PL = 10) on a facade batch:
    t_own rows on each pulsar's own Tspan, masks in the scale rows, at T =
    128 and 101; the projection equals the engine's residuals and leaves
    the padding zero; a rerun is bit-identical."""
    sim, res, base, coef = facade_residuals
    stages, times, scales = sim._mega_tables
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    full = [base.to(dt), coef.to(dt).contiguous(), times, scales]
    w = sim._stat_weights
    kw = dict(stages=stages, nbins=sim.nbins, precision=prec)
    if pl < 20:
        loc = [x[:, :pl].contiguous() for x in full]
        kw.update(base_local=loc[0], coef_local=loc[1], times_local=loc[2],
                  scales_local=loc[3])
        w = w[:, :pl].contiguous()
    else:
        proj = mk._launch_project(*full, stages, (None,) * 4)[1]
        assert not proj[:, ~sim.batch.mask].any()
        if prec == "f32":
            assert float((proj - res).abs().max()) <= 1e-5 * float(
                res.abs().max())
    before = (mk.launches, mk.sharded_launches)
    got = mk.chunk_stats(*full, w, **kw)
    torch.cuda.synchronize()
    assert (mk.launches, mk.sharded_launches) == (
        before[0] + (pl == 20), before[1] + (pl < 20))
    want = mk.chunk_stats_plain(*full, w, **kw)
    _assert_close(got, want, prec)
    again = mk.chunk_stats(*full, w, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 101])
@pytest.mark.parametrize("path", ["fused", "fused-vpu", "mega"])
def test_facade_batch_engine_on_the_card(cuda, path, width):
    """The engine on the facade batch, each kernel path against the card's
    einsum run within the f32 bound, reruns bit-identical; on the
    2-shard mesh within the mesh bound."""
    kw = dict(stat_path=path.split("-")[0],
              pallas_mxu_binning=path != "fused-vpu")
    want = _facade_sim(cuda, width, stat_path="einsum").run(
        64, seed=2, chunk=32, precision="f32")
    sim = _facade_sim(cuda, width, **kw)
    out = sim.run(64, seed=2, chunk=32, precision="f32")
    _assert_close((out["curves"], out["autos"]),
                  (want["curves"], want["autos"]), "f32")
    again = sim.run(64, seed=2, chunk=32, precision="f32")
    assert np.array_equal(out["curves"], again["curves"])
    mesh = _facade_sim(cuda, width, mesh=make_mesh(
        ["cuda:0"] * 2, psr_shards=2), **kw).run(64, seed=2, chunk=32,
                                                 precision="f32")
    _assert_close((mesh["curves"], mesh["autos"]),
                  (want["curves"], want["autos"]), "f32")


@pytest.mark.cuda
def test_facade_on_the_card_matches_the_cpu(cuda):
    """make_fake_array and the array injectors on the card against the
    same calls on the CPU: the same host draws, residuals within 1e-5 of
    their scale (the card's float32 transcendentals)."""
    from fakepta_tpu_torch import fake_pta as fp
    kw = dict(npsrs=4, Tobs=8.0, ntoas=120, isotropic=True, toaerr=1e-7,
              seed=9)
    out = {}
    for dev in ("cpu", "cuda"):
        psrs = fp.make_fake_array(**kw, device=dev)
        fp.add_noise_array(psrs, signal="red_noise", log10_A=-14.0,
                           gamma=3.0, seed=2)
        fp.add_white_noise_array(psrs, seed=3)
        psrs[0].add_system_noise(backend=psrs[0].backends[0], components=5,
                                 log10_A=-14.0, gamma=2.0)
        out[dev] = psrs
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.name == b.name and a.noisedict == b.noisedict
        np.testing.assert_array_equal(a.toas, b.toas)
        assert a._res_dev is not None and a._res_dev.is_cuda
        r, want = a.residuals, b.residuals
        np.testing.assert_allclose(r, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_facade_entry_points_default_to_the_card(cuda, tmp_path):
    """Pulsar, make_fake_array, copy_array and load_array put their
    residuals on the card when no device is given."""
    from fakepta_tpu_torch.fake_pta import Pulsar, copy_array, make_fake_array
    from fakepta_tpu_torch.utils.io import load_array, save_array
    psr = Pulsar(np.linspace(0.0, 3e8, 32), 1e-6, 1.0, 1.0, seed=1)
    psrs = make_fake_array(npsrs=2, Tobs=3.0, ntoas=20, seed=1)
    copies = copy_array(psrs)
    loaded = load_array(save_array(psrs, tmp_path / "a.pkl"))
    for p in [psr] + psrs + copies + loaded:
        assert p._device.type == "cuda"
        p.add_white_noise(seed=2)
        assert p._res_dev.is_cuda


# -- the likelihood lane (run(lnlike=...)) beside each kernel ---------------

def _lane_batch():
    """8 pulsars of 64 TOAs with ECORR epochs of 4 TOAs (amplitude 1e-7)."""
    batch = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=1, device="cpu")
    leaves = batch.numpy()
    leaves["epoch_idx"] = np.tile(np.arange(64) // 4, (8, 1))
    leaves["ecorr_amp"] = np.full((8, 64), 1e-7, np.float32)
    return PulsarBatch.from_numpy(leaves, device="cpu")


def _lane_spec():
    from fakepta_tpu_torch import infer
    model = infer.LikelihoodSpec(components=(
        infer.ComponentSpec("red", spectrum="batch"),
        infer.ComponentSpec("dm", spectrum="batch"),
        infer.ComponentSpec("curn", nbin=4, free=(
            infer.FreeParam("log10_A", (-14.5, -12.5)),
            infer.FreeParam("gamma", (2.0, 6.0))))))
    return infer.InferSpec(model=model, theta=infer.theta_grid(model, (2, 2)),
                           mode="grad")


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("path,mxu,kernel", [
    ("fused", True, "binned_correlation"),
    ("fused", False, "binned_correlation_vpu"),
    ("mega", True, "chunk_stats")])
def test_lnlike_lane_beside_each_kernel_matches_the_cpu(cuda, path, mxu,
                                                        kernel, shards):
    """run(lnlike=...) on the card beside each kernel (#1, #2, #3; #4 on the
    2-shard mega mesh), with ECORR epochs: the kernel launched once per
    shard and chunk, curves and autos within the f32 bound of the CPU
    port's einsum run (the plain versions), the lanes within the lane
    bound (tests/lane_bound.py), and a rerun bit for bit, lanes included."""
    from lane_bound import assert_lanes, lane_unit
    batch = _lane_batch()
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, log10_A=-13.5,
                                              gamma=13 / 3).numpy())
    kw = dict(gwb=gwb, include=("white", "ecorr", "red", "dm", "gwb"))
    spec = _lane_spec()
    cpu = EnsembleSimulator(batch, stat_path="einsum", device="cpu", **kw)
    want = cpu.run(16, seed=3, chunk=8, lnlike=spec)
    sim = EnsembleSimulator(batch, stat_path=path, pallas_mxu_binning=mxu,
                            mesh=make_mesh([cuda] * shards,
                                           psr_shards=shards), **kw)
    counts = {"binned_correlation": lambda: bc.launches,
              "binned_correlation_vpu": lambda: bc.vpu_launches,
              "chunk_stats": lambda: (mk.launches if shards == 1
                                      else mk.sharded_launches)}[kernel]
    before = counts()
    got = sim.run(16, seed=3, chunk=8, precision="f32", lnlike=spec)
    assert counts() - before == 2 * shards
    _assert_close((got["curves"], got["autos"]),
                  (want["curves"], want["autos"]), "f32")
    assert_lanes(got["lnlike"], want["lnlike"],
                 lane_unit(cpu, spec, 3, 8), ("lnl", "grad"), path)
    again = sim.run(16, seed=3, chunk=8, precision="f32", lnlike=spec)
    _same(got, again)
    for k in ("lnl", "grad"):
        np.testing.assert_array_equal(got["lnlike"][k], again["lnlike"][k])


@pytest.mark.cuda
def test_ecorr_epoch_sums_have_no_atomics(cuda):
    """The lane's per-epoch ECORR sums (a one-hot contraction, no
    scatter-add) give the same bits on every rerun on the card, and the
    CPU's float64 sums within float32 rounding."""
    from fakepta_tpu_torch.ops import woodbury
    rng = np.random.default_rng(4)
    P, T, K, R, E = 8, 512, 40, 64, 128
    tmat = rng.standard_normal((P, T, K))
    sigma2 = rng.uniform(0.5, 2.0, (P, T))
    mask = rng.uniform(size=(P, T)) > 0.1
    epoch = np.tile(np.arange(T) // 4, (P, 1))
    amp = rng.uniform(0.1, 1.0, (P, T))
    r = rng.standard_normal((R, P, T))

    def parts(dev, dtype):
        t = [torch.as_tensor(x, dtype=dtype, device=dev)
             for x in (tmat, sigma2, amp, r)]
        m = torch.as_tensor(mask, device=dev)
        e = torch.as_tensor(epoch, device=dev)
        fixed = woodbury.fixed_parts(t[0], t[1], m, e, t[2], num_epochs=E)
        res = woodbury.res_parts(t[3], t[0], t[1], m, e, t[2], num_epochs=E)
        M, lndetN, nv, corr = woodbury.finish_fixed(fixed)
        return {**fixed, **res, "M_ds": M,
                "d0_ds": woodbury.finish_res(res, corr)[0]}

    first = parts(cuda, torch.float32)
    for _ in range(3):
        again = parts(cuda, torch.float32)
        for k, v in first.items():
            assert torch.equal(v, again[k]), k
    want = parts("cpu", torch.float64)
    for k, v in first.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.double().cpu().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


@pytest.mark.cuda
def test_infer_cli_runs_on_the_card_and_exits_2_without_one(cuda, tmp_path):
    """``python -m fakepta_tpu_torch.infer run`` runs on the card by
    default (its artifact says so) and exits 2 when no card is visible."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    from fakepta_tpu_torch.obs.report import RunReport
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    args = [sys.executable, "-m", "fakepta_tpu_torch.infer", "run",
            "--npsr", "8", "--ntoa", "64", "--nreal", "16", "--chunk", "8"]
    out = tmp_path / "infer.jsonl"
    proc = subprocess.run(args + ["--out", str(out)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["lnlike_grid_k"] == 25
    assert RunReport.load(out).meta["platform"] == "gpu"
    proc = subprocess.run(args, cwd=root, capture_output=True, text=True,
                          env=dict(env, CUDA_VISIBLE_DEVICES=""),
                          timeout=300)
    assert proc.returncode == 2
    assert "device='cpu'" in proc.stderr


# ---------------------------------------------------------------- recovery

def _ladder_sim(cuda, path="mega", mesh=None, **kw):
    batch = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=10.0,
                                  n_red=4, n_dm=4, seed=2, device=cuda)
    f = np.arange(1, 5) / float(batch.tspan_common)
    gwb = GWBConfig(psd=spectrum_lib.powerlaw(f, -13.5, 13 / 3).numpy())
    if mesh is None:
        kw["device"] = cuda
    return EnsembleSimulator(batch, gwb=gwb, nbins=5, stat_path=path,
                             pallas_precision="f32", mesh=mesh, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shards,mxu", [(1, True), (1, False), (2, True)],
                         ids=["shared", "fused-vpu", "psr2"])
def test_recovery_ladder_through_the_kernels(cuda, shards, mxu):
    """An injected kernel failure steps mega -> fused on the card: chunk 0
    on #3 (#4 on a psr mesh), chunks 1-3 on #1 (#2 with
    pallas_mxu_binning=False); each rung's kernel is launched (counted) and
    the curves stay within 1e-5 of the unfaulted einsum run's scale; a
    second kernel failure, on the fused rung, propagates (no fallback to
    the plain einsum path); without a fault nothing degrades."""
    from fakepta_tpu_torch import faults
    mesh = (None if shards == 1
            else make_mesh(["cuda:0"] * shards, psr_shards=shards))
    sim = _ladder_sim(cuda, mesh=mesh, pallas_mxu_binning=mxu)
    want = _ladder_sim(cuda, "einsum", mesh=mesh).run(32, seed=3, chunk=8)
    clean = sim.run(32, seed=3, chunk=8)
    assert clean["statistic_path"] == "mega"
    assert not clean["report"].counters.get("faults.degradations")
    before = (mk.launches, mk.sharded_launches, bc.launches,
              bc.vpu_launches)
    fast = faults.RecoveryPolicy(backoff_s=0.001)
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "degrade", at=(1,))])
    with faults.inject(plan):
        out = sim.run(32, seed=3, chunk=8, recovery=fast)
    torch.cuda.synchronize()
    moved = np.subtract((mk.launches, mk.sharded_launches, bc.launches,
                         bc.vpu_launches), before)
    mega = [1, 0] if shards == 1 else [0, shards]
    fused = [3 * shards, 0] if mxu else [0, 3 * shards]
    assert moved.tolist() == mega + fused
    assert out["statistic_path"] == "fused"
    assert out["report"].counters["faults.degradations"] == 1
    assert out["report"].meta["degraded_path"] == "fused"
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(out["curves"], want["curves"], rtol=0,
                               atol=1e-5 * scale)
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "degrade", at=(1, 3))])
    with faults.inject(plan):
        with pytest.raises(faults.DegradeFault):
            sim.run(32, seed=3, chunk=8, recovery=fast)


@pytest.mark.cuda
def test_recovery_retry_bit_identical_on_the_card(cuda):
    """A transient failure and a CUDA out-of-memory error at a chunk's
    dispatch are retried on the same keys: bit-identical outputs."""
    from fakepta_tpu_torch import faults
    sim = _ladder_sim(cuda)
    want = sim.run(32, seed=3, chunk=8)
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "transient", at=(2,))])
    with faults.inject(plan):
        got = sim.run(32, seed=3, chunk=8)
    assert np.array_equal(got["curves"], want["curves"])
    real, calls = sim.step, []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB")
        return real(*a, **kw)

    sim.step = step
    try:
        got = sim.run(32, seed=3, chunk=8)
    finally:
        del sim.step
    assert got["report"].counters["faults.retries"] == 1
    assert np.array_equal(got["curves"], want["curves"])


# ------------------------------------------------------------------ sampler

def _sampler(cuda, mesh=None):
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
    batch = PulsarBatch.synthetic(npsr=4, ntoa=48, tspan_years=15.0,
                                  toaerr=1e-7, n_red=3, n_dm=3,
                                  red_log10_A=-14.5, dm_log10_A=-14.5,
                                  seed=0, device=cuda)
    model = LikelihoodSpec(components=(
        ComponentSpec("red", spectrum="batch"),
        ComponentSpec("dm", spectrum="batch"),
        ComponentSpec("curn", nbin=3, free=(
            FreeParam("log10_A", (-14.0, -12.4)),
            FreeParam("gamma", (2.0, 6.0))))))
    spec = SampleSpec(model=model, n_chains=8, n_temps=2, warmup=8, thin=2,
                      n_leapfrog=3)
    return SamplingRun(batch, spec, mesh=mesh,
                       device=None if mesh is not None else cuda,
                       data_seed=1, truth=np.array([-13.2, 13 / 3]))


@pytest.mark.cuda
def test_sampler_reruns_meshes_and_depths_bit_identical(cuda):
    """float32 chains on the card: reruns, pipeline depths 0 and 2, and the
    real-2 / psr-2 meshes on one card give the same thinned draws bit for
    bit (the row groups of one fixed size and the fixed-order sums)."""
    ref = _sampler(cuda).run(16, seed=3, segment=8, pipeline_depth=0)
    assert ref["theta"].dtype == np.float32
    assert np.isfinite(ref["theta"]).all()
    assert ref["report"].meta["platform"] == "gpu"
    runs = [_sampler(cuda).run(16, seed=3, segment=8, pipeline_depth=2)]
    for real, psr in ((2, 1), (1, 2)):
        mesh = make_mesh(["cuda:0"] * (real * psr), psr_shards=psr)
        runs.append(_sampler(cuda, mesh).run(16, seed=3, segment=8))
    for out in runs:
        assert np.array_equal(out["theta"], ref["theta"])
        assert out["diag"]["accept_rate_by_temp"] == \
            ref["diag"]["accept_rate_by_temp"]


def _stream_blocks(npsr, tspan, seed=5):
    """Three ragged ECORR blocks of absolute-second TOAs (host float64)."""
    rng = np.random.default_rng(seed)
    t_all = np.sort(rng.uniform(0.0, 0.95 * tspan, (npsr, 30)), axis=1)
    out = []
    for lo, w in ((0, 12), (12, 10), (22, 8)):
        out.append(dict(
            toas=t_all[:, lo:lo + w],
            residuals=rng.normal(0.0, 1e-7, (npsr, w)),
            sigma2=(1e-7 + rng.uniform(0.0, 5e-8, (npsr, w))) ** 2,
            ecorr_amp=np.abs(rng.normal(3e-7, 1e-7, (npsr, w))),
            counts=rng.integers(w // 2, w + 1, npsr)))
    return out


@pytest.mark.cuda
def test_stream_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A float64 stream on the card (its default device): moments within
    1e-10 of the CPU port's on the same blocks (relative to each array's
    max), the rolling OS within 1e-9, append against restage within 1e-8,
    steady appends building nothing with flat live bytes, a rerun
    and a checkpoint resume bit-identical, and the memory sampler
    publishing its peak."""
    from fakepta_tpu_torch import constants as const
    from fakepta_tpu_torch.obs import memwatch, telemetry
    from fakepta_tpu_torch.stream import StreamState, default_stream_model

    tspan = 3.0 * const.yr
    template = PulsarBatch.synthetic(npsr=8, ntoa=64, tspan_years=3.0,
                                     n_red=6, n_dm=6, seed=0,
                                     dtype=torch.float64, device="cpu")
    model = default_stream_model(nbin=4)
    blocks = _stream_blocks(8, tspan)
    kw = dict(ecorr_dt=2.0e6, watch="hd")

    def drive(stream, upto=None):
        return [stream.append(**b) for b in blocks[:upto]]

    card = StreamState(template, model, **kw)
    assert card.device.type == "cuda"
    infos = drive(card)
    cpu = StreamState(template, model, device="cpu", **kw)
    cinfos = drive(cpu)

    def rel(a, b):
        a, b = a.cpu(), b.cpu()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    for a, b in zip(card.moments(), cpu.moments()):
        assert a.device.type == "cuda" and rel(a, b) <= 1e-10
    for a, b in zip(card.moments(), card.restage_moments()):
        assert rel(a, b) <= 1e-8
    for a, b in zip(infos, cinfos):
        for key in ("amp2", "snr"):
            assert abs(a[key] - b[key]) <= 1e-9 * abs(b[key])
    # a steady append (the last block again, at rungs already built)
    # builds no kernel and leaves the bytes live on the card flat (as
    # requested: the allocator's rounded block sizes vary with its cache)
    steady = StreamState(template, model, **kw)
    drive(steady)
    built, alloc = steady.compiles, []
    for _ in range(3):
        steady.append(**blocks[-1])
        alloc.append(torch.cuda.memory_stats(cuda)[
            "requested_bytes.all.current"])
    assert steady.compiles == built and len(set(alloc)) == 1
    again = StreamState(template, model, **kw)
    drive(again)
    assert all(torch.equal(a, b)
               for a, b in zip(again.moments(), card.moments()))
    path = tmp_path / "stream.ckpt"
    first = StreamState(template, model, checkpoint=path, **kw)
    drive(first, 2)
    resumed = StreamState(template, model, checkpoint=path, **kw)
    assert resumed.appends == 2
    assert all(torch.equal(a, b)
               for a, b in zip(resumed.moments(), first.moments()))
    telemetry.clear_live_gauges()
    try:
        sampler = memwatch.HbmSampler([cuda])
        sampler.start()
        peak = sampler.stop()["peak_bytes_in_use"]
        assert telemetry.live_gauges()["obs.peak_hbm_bytes"] == peak > 0
    finally:
        telemetry.clear_live_gauges()


@pytest.mark.cuda
def test_stream_refreshers_on_the_card(cuda):
    """One PosteriorRefresher cycle (float64 chains) and one
    FactorizedRefresher cycle on the card: finite, promoted through an
    open gate, no rebuilds."""
    from fakepta_tpu_torch import constants as const
    from fakepta_tpu_torch.infer import (ComponentSpec, FreeParam,
                                         LikelihoodSpec)
    from fakepta_tpu_torch.sample import SampleSpec
    from fakepta_tpu_torch.stream import (FactorizedRefresher,
                                          PosteriorRefresher, StreamState,
                                          default_stream_model)

    tspan = 3.0 * const.yr
    template = PulsarBatch.synthetic(npsr=4, ntoa=48, tspan_years=3.0,
                                     n_red=3, n_dm=3, seed=3,
                                     dtype=torch.float64, device="cpu")
    model = default_stream_model(nbin=3)
    stream = StreamState(template, model, ecorr_dt=2.0e6, watch="hd")
    for b in _stream_blocks(4, tspan):
        stream.append(**b)
    ref = PosteriorRefresher(stream, SampleSpec(model=model, n_chains=2,
                                                warmup=4, n_leapfrog=2),
                             rhat_gate=1e9)
    info = ref.refresh(8, seed=1, segment=4)
    assert info["promoted"] and np.isfinite(ref.posterior["theta"]).all()
    assert ref.posterior["report"].meta["platform"] == "gpu"
    fs_model = LikelihoodSpec(components=(
        ComponentSpec(target="red", spectrum="batch"),
        ComponentSpec(target="curn", nbin=2, spectrum="free_spectrum",
                      free=(FreeParam("log10_rho", (-9.0, -5.0),
                                      per_bin=True),))))
    fstream = StreamState(template, fs_model)
    rng = np.random.default_rng(0)
    t0 = np.sort(rng.uniform(0, 0.9 * tspan, (4, 12)), axis=1)
    fstream.append(t0, rng.normal(0, 1e-7, (4, 12)),
                   sigma2=np.full((4, 12), 1e-14))
    fref = FactorizedRefresher(fstream, SampleSpec(
        model=fs_model, n_chains=2, warmup=4, n_leapfrog=2), lane_bins=1,
        rhat_gate=1e9)
    out = fref.refresh(8, seed=1, segment=4)
    assert out["promoted"] and out["fs_lanes_touched"] == 2
    assert out["fs_recompiles"] == 0
    assert np.isfinite(fref.posterior["theta"]).all()


# ---------------------------------------------------------------------------
# multi-process meshes on the card
# ---------------------------------------------------------------------------

#: one rank of a card test: joins a group through a FileStore, runs the
#: flagship on a real 1 x psr N mesh whose pulsar gather crosses ranks and
#: prints the digest of its curves and autos (argv: dir rank ranks card
#: backend, card -1 meaning cuda:<rank>)
RANK_SCRIPT = r"""
import hashlib, json, sys
import numpy as np
import torch
from fakepta_tpu_torch.parallel import mesh as mesh_lib
from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
from fakepta_tpu_torch.scenarios import registry
d, rank, n, card, backend = sys.argv[1:6]
rank, n, card = int(rank), int(n), int(card)
dev = torch.device("cuda", rank if card < 0 else card)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
try:
    mesh_lib.initialize_multihost(
        f"file://{d}/store", n, rank, local_devices=[dev],
        backend=None if backend == "auto" else backend, timeout_s=120.0)
except ValueError as exc:
    print(json.dumps({"refused": str(exc)}), flush=True)
    sys.exit(0)
scn = registry.get("flagship_100")
parts = scn.batch_parts(device=str(dev))
mesh = mesh_lib.make_mesh(mesh_lib.global_devices(), psr_shards=n)
sim = EnsembleSimulator(parts[0], stat_path=sys.argv[6], mesh=mesh,
                        **scn.sim_kwargs(*parts))
out = sim.run(2048, seed=5, chunk=1024, precision="f32")
h = hashlib.sha256(np.ascontiguousarray(out["curves"]).tobytes()
                   + np.ascontiguousarray(out["autos"]).tobytes())
print(json.dumps({"digest": h.hexdigest(),
                  "backend": out["report"].meta["backend"],
                  "process_index": out["report"].meta["process_index"]}),
      flush=True)
mesh_lib.shutdown_multihost()
"""


def _run_ranks(tmp_path, n, card, backend, path="fused"):
    import json
    import pathlib
    import subprocess
    import sys
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(tmp_path), str(r), str(n),
         str(card), backend, path], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=pathlib.Path(__file__).resolve().parents[1]) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _digest(out):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(out["curves"]).tobytes()
                          + np.ascontiguousarray(out["autos"]).tobytes()
                          ).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "mega"])
def test_two_ranks_on_one_card_equal_the_one_process_mesh(cuda, tmp_path,
                                                          path):
    """Two gloo ranks sharing cuda:0, the pulsar gather crossing them, give
    the one-process ["cuda:0"] * 2 mesh's bits on the flagship."""
    outs = _run_ranks(tmp_path, 2, 0, "auto", path)
    want = _digest(_flagship_on(cuda, path, make_mesh(
        ["cuda:0"] * 2, psr_shards=2)).run(2048, seed=5, chunk=1024,
                                           precision="f32"))
    assert [o["digest"] for o in outs] == [want, want]
    assert [o["backend"] for o in outs] == ["gloo", "gloo"]
    assert [o["process_index"] for o in outs] == [0, 1]


@pytest.mark.cuda
def test_two_ranks_on_two_cards_under_nccl(cuda, tmp_path):
    """One rank per card picks NCCL and gives the one-process mesh's bits."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    outs = _run_ranks(tmp_path, 2, -1, "auto")
    want = _digest(_flagship_on(cuda, "fused", make_mesh(
        ["cuda:0"] * 2, psr_shards=2)).run(2048, seed=5, chunk=1024,
                                           precision="f32"))
    assert [o["digest"] for o in outs] == [want, want]
    assert [o["backend"] for o in outs] == ["nccl", "nccl"]


@pytest.mark.cuda
def test_nccl_on_a_shared_card_raises(cuda, tmp_path):
    """Asking for NCCL with two ranks on one card raises on both ranks
    before the group starts (no gloo retry)."""
    outs = _run_ranks(tmp_path, 2, 0, "nccl")
    assert all("refuses two ranks on one card" in o.get("refused", "")
               for o in outs), outs


def _flagship_on(cuda, stat_path, mesh):
    from fakepta_tpu_torch.scenarios import registry
    scn = registry.get("flagship_100")
    parts = scn.batch_parts(device=cuda)
    return EnsembleSimulator(parts[0], stat_path=stat_path, mesh=mesh,
                             **scn.sim_kwargs(*parts))


# ---------------------------------------------------------------------------
# the tuner on the card (run alone with -k tune)
# ---------------------------------------------------------------------------

def _tune_gwb(batch):
    """_ladder_sim's background."""
    f = np.arange(1, 5) / float(batch.tspan_common)
    return GWBConfig(psd=spectrum_lib.powerlaw(f, -13.5, 13 / 3).numpy())


@pytest.mark.cuda
def test_tune_fingerprint_reads_the_card(cuda):
    from fakepta_tpu_torch import tune
    fp = tune.fingerprint()
    assert fp.platform == "gpu"
    assert fp.device_kind == torch.cuda.get_device_name(0)
    assert fp.hbm_bytes == torch.cuda.get_device_properties(0).total_memory
    assert fp.n_devices == torch.cuda.device_count()
    assert fp.cuda_version == torch.version.cuda
    assert tune.fingerprint(["cuda:0"] * 4).n_devices == 1


@pytest.mark.cuda
def test_tune_search_probes_fused_and_mega_through_their_kernels(cuda,
                                                                 tmp_path):
    from fakepta_tpu_torch import tune
    sim = _ladder_sim(cuda, "fused")
    bc.launches = mk.launches = 0
    cfg, info = tune.search(sim.batch, gwb=_tune_gwb(sim.batch), nbins=5,
                            mesh_devices=["cuda:0"], nreal_hint=256,
                            budget_s=120.0, max_candidates=8,
                            store=tmp_path / "tuned.json")
    paths = {r["knobs"]["path"] for r in info["records"]}
    assert {"einsum", "fused", "mega"} <= paths
    assert bc.launches > 0 and mk.launches > 0
    assert cfg.metrics["real_per_s_per_chip"] >= \
        cfg.metrics["hand_set_real_per_s_per_chip"]
    assert cfg.fingerprint["platform"] == "gpu"


@pytest.mark.cuda
def test_tune_warm_start_builds_nothing_after_and_runs_bit_identical(
        cuda, monkeypatch):
    cold = _ladder_sim(cuda, "mega").run(256, seed=4, chunk=128)
    sim = _ladder_sim(cuda, "mega")
    built = []
    real_build = _build.build
    monkeypatch.setattr(_build, "build",
                        lambda names=None: built.append(tuple(names))
                        or real_build(names))
    assert sim.warm_start(128) >= 0.0
    assert built == [("megakernel", "binned_corr")]

    def no_nvcc(*a, **kw):
        raise AssertionError("a run after warm_start started nvcc")

    monkeypatch.setattr(_build, "start_nvcc", no_nvcc)
    before = mk.launches
    warm = sim.run(256, seed=4, chunk=128)
    assert warm["report"].compile_s == 0.0
    assert mk.launches == before + 2
    sim.clear_executables()
    again = sim.run(256, seed=4, chunk=128)
    for out in (warm, again):
        for k in ("curves", "autos"):
            assert np.array_equal(out[k], cold[k])


@pytest.mark.cuda
def test_tune_run_tuned_true_equals_the_explicit_knobs(cuda, tmp_path,
                                                       monkeypatch):
    from fakepta_tpu_torch import tune
    from fakepta_tpu_torch.tune.store import TunedConfig, TuneStore
    sim = _ladder_sim(cuda, "fused")
    knobs = {"chunk": 128, "pipeline_depth": 0, "path": "mega",
             "precision": "bf16", "psr_shards": 1}
    fp = tune.fingerprint(["cuda:0"])
    family = tune.family_for_surface(sim.dispatch_surface())
    TuneStore(tmp_path / "tuned.json").put(TunedConfig(
        fingerprint=fp.as_dict(), family=family, knobs=knobs))
    monkeypatch.setenv("FAKEPTA_TPU_TUNE_DIR", str(tmp_path))
    before = mk.launches
    out = sim.run(256, seed=4, tuned=True)
    assert mk.launches == before + 2
    assert out["statistic_path"] == "mega" and out["precision"] == "bf16"
    assert out["report"].meta["tuned"]["knobs"] == {
        k: knobs[k] for k in ("chunk", "pipeline_depth", "path",
                              "precision")}
    explicit = _ladder_sim(cuda, "mega").run(256, seed=4, chunk=128,
                                           pipeline_depth=0,
                                           precision="bf16")
    for k in ("curves", "autos"):
        assert np.array_equal(out[k], explicit[k])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "mega"])
def test_tune_a_broken_kernel_raises_out_of_search(cuda, tmp_path,
                                                   monkeypatch, path):
    """A launch failure in a fused or mega probe raises out of search():
    the probes run with the recovery ladders off, so mega never steps down
    to fused."""
    from fakepta_tpu_torch import tune

    def broken(*a, **kw):
        raise RuntimeError(f"{path} kernel failed to launch: CUDA error 98 "
                           f"(invalid device function)")

    if path == "fused":
        monkeypatch.setattr(bc, "binned_correlation", broken)
    else:
        monkeypatch.setattr(mk, "chunk_stats", broken)
    sim = _ladder_sim(cuda, "fused")
    with pytest.raises(RuntimeError, match="failed to launch"):
        tune.search(sim.batch, gwb=_tune_gwb(sim.batch), nbins=5,
                    mesh_devices=["cuda:0"],
                    nreal_hint=256, budget_s=120.0, max_candidates=8,
                    store=tmp_path / "tuned.json")
    assert not (tmp_path / "tuned.json").exists()


@pytest.mark.cuda
def test_serve_a_flagship_width_cohort_on_the_card(cuda):
    """The pool on the card at the flagship's widths (100 pulsars x 780
    TOAs, K = 320): a coalesced cohort launches #1 through run(lanes=...),
    each response equals the request served alone at its bucket bit for
    bit and the einsum path's run within the bf16 bound; after warm-up no
    dispatch builds a kernel."""
    from fakepta_tpu_torch.serve import (ArraySpec, ServeConfig, ServePool,
                                         SimRequest)

    spec = ArraySpec(npsr=100, ntoa=780, n_red=30, n_dm=100, gwb_ncomp=30)
    pool = ServePool(config=ServeConfig(buckets=(16, 32),
                                        coalesce_window_s=0.05))
    try:
        pool.serve(SimRequest(spec=spec, n=16, seed=0), timeout=600)
        pool.serve(SimRequest(spec=spec, n=32, seed=0), timeout=600)
        pool.reset_stats()
        before = bc.launches
        futs = [pool.submit(SimRequest(spec=spec, n=n, seed=s))
                for n, s in ((5, 11), (9, 22), (7, 33))]
        res = [f.result(timeout=600) for f in futs]
        slo = pool.slo_summary()
        assert bc.launches > before
        assert slo["serve_steady_compiles"] == 0 and slo["serve_failed"] == 0
        assert {r.bucket for r in res} == {32}
        sim = pool._pool.get(spec.spec_hash(), spec).sim
        batch, gwb = spec.parts(device="cuda")
        ref = EnsembleSimulator(batch, gwb=gwb, nbins=spec.nbins,
                                stat_path="einsum", device="cuda")
        for (n, s), r in zip(((5, 11), (9, 22), (7, 33)), res):
            alone = sim.run(32, chunk=32, lanes=[(s, n)], pipeline_depth=0)
            assert np.array_equal(alone["curves"][:n], r.curves)
            assert np.array_equal(alone["autos"][:n], r.autos)
            want = ref.run(32, chunk=32, lanes=[(s, n)], pipeline_depth=0)
            _assert_close((r.curves, r.autos),
                          (want["curves"][:n], want["autos"][:n]), "bf16")
    finally:
        pool.close()


@pytest.mark.cuda
def test_fleet_of_two_replicas_on_the_card(cuda):
    """Two in-process replicas on the card behind the router: each spec
    routes to its ring owner, launches #1 there, and every response equals
    the same request served alone at its bucket on a fresh simulator bit
    for bit; no dispatch builds a kernel after warm-up."""
    import dataclasses

    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         ServeConfig, ServeFleet, SimRequest)

    spec0 = ArraySpec(npsr=16, ntoa=128, n_red=8, n_dm=8, gwb_ncomp=8,
                      data_seed=100)
    spec1 = dataclasses.replace(spec0, data_seed=101)
    cfg = ServeConfig(buckets=(16,), coalesce_window_s=0.01)
    flt = ServeFleet([LocalReplica(f"r{i}", config=cfg, index=i)
                      for i in range(2)])
    try:
        before = bc.launches
        res = {s.data_seed: flt.serve(SimRequest(spec=s, n=5, seed=11),
                                      timeout=600) for s in (spec0, spec1)}
        assert bc.launches > before
        # each pool counts its own dispatches' launches, not its sibling's
        by_pool = [sum(r.pool.kernel_summary()["launches_by_bucket"].get(
            "binned_correlation", {}).values())
            for r in flt.replicas.values()]
        assert all(by_pool) and sum(by_pool) == bc.launches - before
        for s in (spec0, spec1):
            r = res[s.data_seed]
            assert r.replica == flt.ring.owner(s.spec_hash())
            alone = s.build().run(16, chunk=16, lanes=[(11, 5)],
                                  pipeline_depth=0)
            assert np.array_equal(alone["curves"][:5], r.curves)
            assert np.array_equal(alone["autos"][:5], r.autos)
        slo = flt.slo_summary()
        assert slo["fleet_steady_compiles"] == 0 and slo["fleet_failed"] == 0
        assert flt.n_chips == 1
    finally:
        flt.close()


@pytest.mark.cuda
def test_fleet_failover_is_bit_identical_on_the_card(cuda):
    """A replica killed under its request (the serve.dispatch kill): the
    router fails the request over to the sibling on the same card, whose
    response equals the owner's first answer bit for bit."""
    from fakepta_tpu_torch import faults
    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         ServeConfig, ServeFleet, SimRequest)

    spec = ArraySpec(npsr=16, ntoa=128, n_red=8, n_dm=8, gwb_ncomp=8)
    cfg = ServeConfig(buckets=(16,), coalesce_window_s=0.01)
    flt = ServeFleet([LocalReplica(f"r{i}", config=cfg, index=i)
                      for i in range(2)])
    try:
        first = flt.serve(SimRequest(spec=spec, n=7, seed=5), timeout=600)
        plan = faults.FaultPlan(
            [faults.FaultSpec("serve.dispatch", "kill", at=(0,))])
        with faults.inject(plan):
            again = flt.serve(SimRequest(spec=spec, n=7, seed=5),
                              timeout=600)
        assert again.failovers == 1 and again.replica != first.replica
        assert np.array_equal(again.curves, first.curves)
        assert np.array_equal(again.autos, first.autos)
        assert flt.slo_summary()["fleet_replica_deaths"] == 1
    finally:
        flt.close()


@pytest.mark.cuda
def test_gateway_hit_is_bit_identical_on_the_card(cuda, tmp_path):
    """A gateway in front of two in-process replicas on the card: a miss
    launches #1, its store hit and a cold gateway's hit over the same
    store directory launch nothing, and all three equal the same request
    served alone at its bucket on a fresh simulator bit for bit."""
    from fakepta_tpu_torch.gateway import Gateway, ResultStore, Tenant
    from fakepta_tpu_torch.serve import (ArraySpec, LocalReplica,
                                         ServeConfig, ServeFleet, SimRequest)

    spec = ArraySpec(npsr=16, ntoa=128, n_red=8, n_dm=8, gwb_ncomp=8)
    cfg = ServeConfig(buckets=(16,), coalesce_window_s=0.01)
    tenants = [Tenant("a", "tok-a")]
    req = SimRequest(spec=spec, n=5, seed=11)
    flt = ServeFleet([LocalReplica(f"r{i}", config=cfg, index=i)
                      for i in range(2)])
    try:
        gw = Gateway(flt, tenants, store=ResultStore(tmp_path / "gw"))
        assert gw.fp.platform == "gpu" and gw.fp.n_devices == 1
        before = bc.launches
        miss = gw.serve(req, token="tok-a", timeout=600)
        assert bc.launches > before and miss.replica != "gateway-cache"
        before = bc.launches
        hit = gw.serve(req, token="tok-a", timeout=600)
        cold_gw = Gateway(flt, tenants, store=ResultStore(tmp_path / "gw"))
        cold = cold_gw.serve(req, token="tok-a", timeout=600)
        assert bc.launches == before
        assert hit.replica == cold.replica == "gateway-cache"
        assert cold_gw.gateway_summary()["hits"] == 1
        alone = spec.build().run(miss.bucket, chunk=miss.bucket,
                                 lanes=[(11, 5)], pipeline_depth=0)
        for res in (miss, hit, cold):
            assert np.array_equal(alone["curves"][:5], res.curves)
            assert np.array_equal(alone["autos"][:5], res.autos)
    finally:
        flt.close()


@pytest.mark.cuda
def test_memory_lane_on_the_card(cuda):
    """ska_10k's memory lane at smoke sizes on the card: every point's
    allocator peak is a real watermark within the declared bound of the
    engine's chunk model, and each point launched #1."""
    from fakepta_tpu_torch.scenarios import golden

    before = bc.launches
    out = golden.memory_lane("ska_10k", chunk=8, sweep=(8, 16),
                             devices=["cuda:0"])
    assert bc.launches == before + 2
    assert out["ok"] and out["platform"] == "gpu", out["points"]
    assert out["psr_shards"] == 1
    assert [p["npsr"] for p in out["points"]] == [8, 16]
    for p in out["points"]:
        assert p["ok"] and p["peak_hbm_bytes"] > 0
        assert 0 < p["ratio"] <= golden.MEM_BOUND_FACTOR
        assert p["model_bytes_per_chunk"] > 0 and p["build_s"] > 0


@pytest.mark.cuda
def test_golden_run_on_the_card(cuda):
    """A small golden run on the card (the reduced ng15 with every lane):
    the card's platform and allocator peak in the row, #1 launched, the
    stream oracle and the verified serve answers held inside the run."""
    from fakepta_tpu_torch.scenarios import golden

    before = bc.launches
    row = golden.golden_run("ng15", reduced=True, nreal=8, chunk=8,
                            sample_steps=4, sample_warmup=2,
                            sample_chains=4, serve_requests=4,
                            max_append_blocks=2)
    assert bc.launches > before
    assert row["platform"] == "gpu"
    assert row["peak_hbm_bytes"] > 0
    assert row["scn_peak_hbm_bytes"] == row["peak_hbm_bytes"]
    assert row["stream_recompiles"] == 0
    assert row["serve_steady_compiles"] == 0
    assert row["faults_degradations"] == 0
    assert np.isfinite(row["value"]) and row["value"] > 0


def _f64_engine(device, npsr=8, ntoa=64, **kw):
    """A float64 simulator with every noise stage, the noise and white
    samplers, the HD GWB and the sampled Roemer and CGW terms (the
    float64 path's whole program), on ``device``; ``kw`` adds engine
    arguments."""
    from fakepta_tpu_torch.parallel import montecarlo as tmc

    base = PulsarBatch.synthetic(npsr=npsr, ntoa=ntoa, tspan_years=10.0,
                                 n_red=4, n_dm=4, n_chrom=3,
                                 chrom_log10_A=-14.0, seed=1,
                                 dtype=torch.float64, device="cpu")
    leaves = base.numpy()
    p, t = leaves["t_own"].shape
    leaves["epoch_idx"] = np.tile(np.arange(t) // 2, (p, 1))
    leaves["ecorr_amp"] = np.full((p, t), 3e-7)
    sys_mask = np.zeros((p, 2, t), bool)
    sys_mask[:, 0, : t // 2] = True
    sys_mask[:, 1, t // 2:] = True
    leaves["sys_mask"] = sys_mask
    tspan = float(leaves["tspan_common"])
    band = spectrum_lib.powerlaw(np.arange(1, 4) / tspan, -14.5, 2.5).numpy()
    leaves["sys_psd"] = np.stack([band, 0.5 * band])[None].repeat(p, 0)
    batch = PulsarBatch.from_numpy(leaves, device=device)
    f = np.arange(1, 5) / tspan
    toas_abs = 53000 * 86400.0 + np.linspace(0.0, tspan, t)[None].repeat(
        p, 0)
    return tmc.EnsembleSimulator(
        batch, gwb=GWBConfig(psd=spectrum_lib.powerlaw(f, -13.5,
                                                       13 / 3).numpy()),
        noise_sample=[tmc.NoiseSampling("red", log10_A=(-15.0, -13.0),
                                        gamma=(2.0, 5.0)),
                      tmc.NoiseSampling("gwb", log10_A=(-15.0, -14.0),
                                        gamma=(4.0, 5.0))],
        white_sample=tmc.WhiteSampling(efac=(0.5, 2.5),
                                       log10_tnequad=(-8.0, -6.0),
                                       log10_ecorr=(-7.5, -6.5)),
        toaerr2=leaves["sigma2"],
        roemer_sample=tmc.RoemerSampling("jupiter", s_mass=1.5e23,
                                         s_Om=2e-4),
        cgw_sample=tmc.CGWSampling(psrterm=True, sample_pdist=True,
                                   tref=53000 * 86400.0),
        toas_abs=toas_abs,
        pdist=np.column_stack([np.linspace(0.6, 1.8, p), np.full(p, 0.1)]),
        device=device, **kw)


@pytest.mark.cuda
def test_float64_einsum_on_the_card_matches_the_cpu(cuda):
    """The float64 path on the card: its default einsum path, every stage
    and sampler, within 1e-12 of the CPU run's curve scale (float64
    residuals whose pair sums both round to float32), correlations too;
    the kernel paths take the batch."""
    card, host = _f64_engine("cuda"), _f64_engine("cpu")
    assert card.stat_path == "einsum" and card.include == (True,) * 7
    got = card.run(16, seed=5, chunk=8, keep_corr=True)
    want = host.run(16, seed=5, chunk=8, keep_corr=True)
    assert got["curves"].dtype == np.float64
    for key in ("curves", "corr"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-12 * np.abs(want[key]).max())
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=1e-12)
    for path in ("fused", "mega"):
        sim = EnsembleSimulator(card.batch, stat_path=path, device="cuda")
        assert sim.stat_path == path


@pytest.mark.cuda
def test_float64_facade_array_on_the_card_matches_the_cpu(cuda):
    """A float64 array fabricated on the card (white, red, DM, the
    correlated GWB) against the same seeds on the CPU, within 1e-12 of
    each pulsar's residual scale."""
    from fakepta_tpu_torch import correlated_noises as cn
    from fakepta_tpu_torch import fake_pta

    kw = dict(npsrs=6, Tobs=10, ntoas=120, gaps=False, toaerr=1e-6,
              pdist=1.0, backends="NUPPI", seed=21, dtype=torch.float64,
              custom_model={"RN": 10, "DM": 20, "Sv": None})
    arrays = {}
    for dev in ("cuda", "cpu"):
        psrs = fake_pta.make_fake_array(**kw, device=dev)
        cn.add_common_correlated_noise(psrs, orf="hd", log10_A=-14.0,
                                       gamma=13 / 3, components=8, seed=3)
        arrays[dev] = [p.residuals for p in psrs]
    for got, want in zip(arrays["cuda"], arrays["cpu"]):
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.cuda
def test_static_reservation_reported_on_the_card(cuda):
    """The engine's fixed term on the card: the library workspaces present
    (at least the set this thread's stream holds), in chunk_cost and in
    the run's memory fields, and inside the run's allocator peak; a run
    on a new thread adds at most that thread's workspaces."""
    import threading

    from fakepta_tpu_torch.obs.memwatch import workspace_sizes

    sim = EnsembleSimulator(
        PulsarBatch.synthetic(npsr=8, ntoa=64, n_red=4, n_dm=4, seed=2,
                              device="cuda"), stat_path="einsum",
        device="cuda")
    rep = sim.run(8, seed=1, chunk=8)["report"]   # measures the sizes
    sizes = workspace_sizes("cuda")            # {cuBLAS, cuBLASLt}
    assert sizes and min(sizes) > 0
    static = sim.static_reservation_bytes
    assert static >= sum(sizes)
    assert sim.chunk_cost(8)["static_reservation_bytes"] == static
    assert rep.memory["static_reservation_bytes"] == static
    assert rep.memory["peak_hbm_bytes"] >= static
    worker = threading.Thread(target=lambda: sim.run(8, seed=1, chunk=8))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    # a new thread's handle takes its own cuBLAS workspace (unless it
    # reuses a finished thread's handle, whose workspace it then reuses)
    assert sim.static_reservation_bytes - static in (0, max(sizes),
                                                     sum(sizes))


# -- the kernels on a float64 batch --------------------------------------------

#: float64 outputs against their plain version (PERF.md's card-against-CPU
#: float64 bound), and the fused kernel's float32 ones at 'f32' (pair sums
#: and slots each rounded once to float32) and at 'bf16' (float32 sums of
#: the same bf16 products in another order)
F64_TOL = {"f64": 1e-12, "f32": 1e-6, "bf16": 1e-5}

# (R, PL, PF, T): the flagship's shared set and a 2-shard mesh's rows at
# T = 780, pair spaces past one 128 tile, PL not a multiple of 8, T odd (no
# 16-byte copies), one pulsar, R = 0
F64_SHAPES = [(5, 100, 100, 780), (4, 50, 100, 780), (3, 130, 130, 50),
              (2, 12, 40, 33), (3, 25, 100, 64), (7, 1, 1, 8),
              (0, 20, 20, 33)]


def _close_over_scale(got, want, tol):
    (gc, ga), (wc, wa) = ([np.asarray(torch.as_tensor(x).cpu(), np.float64)
                           for x in pair] for pair in (got, want))
    scale = np.abs(np.concatenate([wc.ravel(), wa.ravel()])).max()
    np.testing.assert_allclose(gc, wc, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T", F64_SHAPES)
def test_binned_correlation_f64_kernel_matches_plain(cuda, prec, R, PL, PF,
                                                     T):
    """#1 on float64 rows (fpt_binned_corr_f64): float32 curves and autos
    against the plain version, one counted launch per call on its own
    counter, and a bit-identical rerun."""
    g = torch.Generator(device=cuda).manual_seed(21)
    res_f = torch.randn(R, PF, T, device=cuda, generator=g,
                        dtype=torch.float64)
    res_l = res_f if PL == PF else res_f[:, PF - PL:].contiguous()
    w = torch.randn(7, PL, PF, device=cuda, generator=g, dtype=torch.float64)
    before = (bc.launches, bc.f64_launches)
    got = bc.binned_correlation(res_l, res_f, w, 6, precision=prec)
    torch.cuda.synchronize()
    assert (bc.launches, bc.f64_launches) == (before[0],
                                              before[1] + int(R > 0))
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[0].shape == (R, 6)
    if R:
        want = bc.binned_correlation_plain(res_l, res_f, w, 6,
                                           precision=prec)
        _close_over_scale(got, want, F64_TOL[prec])
    again = bc.binned_correlation(res_l, res_f, w, 6, precision=prec)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("R,PL,PF,T", F64_SHAPES[:4])
def test_binned_correlation_f64_float64_output(cuda, R, PL, PF, T):
    """The megakernel's pass-2 flavour of fpt_binned_corr_f64: float64
    pair sums, binning and output, within 1e-12 of a float64 einsum's
    scale; the bf16 mode has no float64 output."""
    g = torch.Generator(device=cuda).manual_seed(22)
    res_f = torch.randn(R, PF, T, device=cuda, generator=g,
                        dtype=torch.float64)
    res_l = res_f if PL == PF else res_f[:, PF - PL:].contiguous()
    w = torch.randn(5, PL, PF, device=cuda, generator=g, dtype=torch.float64)
    (got, launched) = bc._launch("fpt_binned_corr_f64", "pass 2", res_l,
                                 res_f, w, 4, "f32", out_f64=True)
    torch.cuda.synchronize()
    assert launched and got[0].dtype == torch.float64
    out = torch.einsum("rpt,rqt,npq->rn", res_l, res_f, w)
    _close_over_scale(got, (out[:, :4], out[:, 4]), F64_TOL["f64"])
    with pytest.raises(ValueError):
        bc._launch("fpt_binned_corr_f64", "pass 2", res_l, res_f, w, 4,
                   "bf16", out_f64=True)


def _tie_adjacent(rng, shape):
    """float64 values ~1e-6, nine in ten of them a bf16 tie times 1 +-
    2^-30: float32 holds each as the tie, so rounding through float32 and
    rounding straight to bf16 differ on about half of them
    (tests/test_torch_f64_rounding.py holds the plain version to the JAX
    kernel on such rows)."""
    v = rng.standard_normal(shape) * 1e-6
    ulp = 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)
    tie = np.trunc(v / ulp) * ulp + np.sign(v) * ulp / 2
    near = tie * (1 + rng.choice([-2.0 ** -30, 2.0 ** -30], shape))
    return np.where(rng.uniform(size=shape) < 0.9, near, v)


@pytest.mark.cuda
@pytest.mark.parametrize("PL", [8, 3])
def test_binned_correlation_f64_bf16_rounds_ties_as_plain(cuda, PL):
    """fpt_binned_corr_f64 at 'bf16' on float64 rows next to bf16 ties
    against its plain version (both round through float32, as the JAX
    kernel): within the 'bf16' bound, where one rounding straight to bf16
    moves the curves by ~1e-3 of their scale; a rerun is bit-identical."""
    rng = np.random.default_rng(26)
    res_f = torch.from_numpy(_tie_adjacent(rng, (4, 8, 64))).to(cuda)
    w = torch.from_numpy(rng.standard_normal((7, PL, 8))).to(cuda)
    res_l = res_f[:, :PL].contiguous()
    before = bc.f64_launches
    got = bc.binned_correlation(res_l, res_f, w, 6, precision="bf16")
    torch.cuda.synchronize()
    assert bc.f64_launches == before + 1
    want = bc.binned_correlation_plain(res_l, res_f, w, 6, precision="bf16")
    _close_over_scale(got, want, F64_TOL["bf16"])
    again = bc.binned_correlation(res_l, res_f, w, 6, precision="bf16")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_binned_correlation_vpu_refuses_float64(cuda):
    res = torch.randn(2, 8, 16, device=cuda, dtype=torch.float64)
    w = torch.randn(3, 8, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        bc.binned_correlation_vpu(res, res, w, 2)


#: the GP stage sets the float64 engine launches pass 1 at beyond the
#: flagship's K = 320: the null stream's GWB-free set (K = 260), ng15's
#: (K = 210, a third scale row) and ipta_dr3's (K = 180); one whose first
#: 16-slot chunk straddles three stages
NULL_STAGES = FLAGSHIP_STAGES[:2]
NG15_STAGES = (MegaStage(30, T_OWN, 0), MegaStage(30, T_OWN, 1),
               MegaStage(15, T_OWN, 2), MegaStage(30, T_COMMON, 0))
IPTA_STAGES = (MegaStage(30, T_OWN, 0), MegaStage(30, T_OWN, 1),
               MegaStage(30, T_COMMON, 0))
STRADDLE_STAGES = (MegaStage(10, T_OWN, 0), MegaStage(3, T_COMMON, 1),
                   MegaStage(20, T_OWN, 1))
#: K = 660: 21 stages of 32 columns
WIDE_STAGES = (MegaStage(100, T_OWN, 0), MegaStage(100, T_OWN, 1),
               MegaStage(100, T_COMMON, 0), MegaStage(30, T_COMMON, 1))

# PROJ_SHAPES and, for the float64 kernel's 128 x 64 tile: R and T not
# multiples of the tile at each stage set above, on both operand sets, and
# K = 660
PROJ_F64_SHAPES = PROJ_SHAPES + [
    (200, 5, 5, 300, NULL_STAGES), (67, 3, 9, 200, NULL_STAGES),
    (130, 7, 7, 130, NG15_STAGES), (129, 2, 6, 257, NG15_STAGES),
    (257, 4, 4, 140, IPTA_STAGES), (129, 4, 4, 257, STRADDLE_STAGES),
    (70, 2, 3, 90, WIDE_STAGES)]


def _f64_tables(full):
    """_proj_inputs' time and scale rows at float64."""
    return [x.double() for x in full[2:]]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f64", "bf16"])
@pytest.mark.parametrize("R,PL,PF,T,stages", PROJ_F64_SHAPES)
def test_project_f64_kernel_matches_plain(cuda, storage, R, PL, PF, T,
                                          stages):
    """Pass 1 on float64 tables (fpt_project_f64) against its plain
    version: float64 storage within 1e-12 of the residual scale (DMMA
    products, CUDA's sincos against torch's cos and sin), bf16 storage
    within 1e-5 (3xTF32 products of the float32-rounded float64 basis); a
    rerun is bit-identical."""
    dt = torch.float64 if storage == "f64" else torch.bfloat16
    full = _proj_inputs(cuda, 23, R, PF, T, stages, dt)
    full[2:] = _f64_tables(full)
    local = (None,) * 4
    if PL < PF:
        local = tuple(x[:, PF - PL:].contiguous() for x in full)
    want = [mk.project_plain(*full, stages)]
    if PL < PF:
        want.insert(0, mk.project_plain(*local, stages))
    got = mk._launch_project(*full, stages, local)
    torch.cuda.synchronize()
    assert got[1].dtype == (torch.float64 if storage == "f64"
                            else torch.float32)
    tol = 1e-12 if storage == "f64" else 1e-5
    for g_, w_ in zip(got[2 - len(want):], want):
        scale = float(w_.abs().max())
        err = float((g_ - w_).abs().max())
        assert err <= tol * scale, (err, scale)
    again = mk._launch_project(*full, stages, local)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f64", "bf16"])
@pytest.mark.parametrize("pl", [40, 20])
def test_chunk_stats_f64_matches_plain(cuda, storage, pl):
    """Both passes on float64 tables at K = 320, both operand sets: float64
    storage ('f32') against the plain version within 1e-12 of the scale,
    float64 out; bf16 storage within the bf16 bound, float32 out; one
    launch per call on the float64 counters, reruns bit-identical."""
    dt = torch.float64 if storage == "f64" else torch.bfloat16
    prec = "f32" if storage == "f64" else "bf16"
    P = 40
    full = _proj_inputs(cuda, 24, 130, P, 100, FLAGSHIP_STAGES, dt)
    full[2:] = _f64_tables(full)
    w = torch.randn(8, pl, P, device=cuda, dtype=torch.float64,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    kw = {}
    if pl < P:
        kw = dict(zip(("base_local", "coef_local", "times_local",
                       "scales_local"), (x[:, :pl].contiguous()
                                         for x in full)))
    before = (mk.launches, mk.sharded_launches, mk.f64_launches,
              mk.f64_sharded_launches)
    got = mk.chunk_stats(*full, w, stages=FLAGSHIP_STAGES, nbins=7,
                         precision=prec, **kw)
    torch.cuda.synchronize()
    assert (mk.launches, mk.sharded_launches, mk.f64_launches,
            mk.f64_sharded_launches) == (before[0], before[1],
                                         before[2] + (pl == P),
                                         before[3] + (pl < P))
    assert got[0].dtype == (torch.float64 if storage == "f64"
                            else torch.float32)
    want = mk.chunk_stats_plain(*full, w, stages=FLAGSHIP_STAGES, nbins=7,
                                precision=prec, **kw)
    if storage == "f64":
        _close_over_scale(got, want, F64_TOL["f64"])
    else:
        _assert_close(got, want, "bf16")
    again = mk.chunk_stats(*full, w, stages=FLAGSHIP_STAGES, nbins=7,
                           precision=prec, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_project_f64_smem_matches_the_source(cuda):
    """megakernel.py::project_smem mirrors what fpt_project_f64 requests
    on both of its routes."""
    smem = _build.load("megakernel").fpt_project_f64_smem
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int] * 4
    assert smem(0, *mk.PROJ_TILE_F64[:2], 2) == mk.project_tiling(
        1024, 780, 100, 2, "f64").smem
    for route, tile, bf16 in (("f64", mk.PROJ_TILE_F64, 0),
                              ("bf16_f64", mk.PROJ_TILE, 1)):
        bm, bn, _ = tile
        for n_scales in (1, 2, 5):
            assert smem(bf16, bm, bn, n_scales) == mk.project_smem(
                bm, bn, n_scales, route)


@pytest.mark.cuda
@pytest.mark.parametrize("path,prec", [("fused", "f32"), ("fused", "bf16"),
                                       ("mega", "f32"), ("mega", "bf16")])
def test_float64_kernel_paths_on_the_card_match_the_cpu(cuda, path, prec):
    """The float64 engine on a kernel path, every stage and sampler, on
    the card against the same run on the CPU: float64 mega curves within
    1e-12 of the scale, the float32 ones within the fused kernel's 'f32'
    bound (a pair sum may round to the other float32 neighbour) or the bf16
    bound; the path's float64 kernel launched, a rerun bit-identical."""
    card = _f64_engine("cuda", stat_path=path)
    host = _f64_engine("cpu", stat_path=path)
    before = (bc.f64_launches, mk.f64_launches)
    got = card.run(16, seed=5, chunk=8, precision=prec)
    want = host.run(16, seed=5, chunk=8, precision=prec)
    moved = (bc.f64_launches - before[0], mk.f64_launches - before[1])
    assert moved == ((2, 0) if path == "fused" else (0, 2))
    f32_out = path == "fused"
    assert got["curves"].dtype == (np.float32 if f32_out else np.float64)
    tol = (TOL["bf16"] if prec == "bf16"
           else F64_TOL["f32"] if f32_out else F64_TOL["f64"])
    _close_over_scale((got["curves"], got["autos"]),
                      (want["curves"], want["autos"]), tol)
    again = card.run(16, seed=5, chunk=8, precision=prec)
    np.testing.assert_array_equal(got["curves"], again["curves"])
