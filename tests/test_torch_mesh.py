"""The PyTorch port's device mesh and pulsar-sharded engine, on the CPU.

The port's one-process mesh over ``["cpu"] * 8`` is held against the JAX
engine on ``make_mesh(jax.devices(), psr_shards=...)`` over the conftest's
eight virtual CPU devices, on the same batch and seed: every statistic path
lands on the JAX XLA path within 1e-5 of the curve scale at f32 (autos 1e-5
relative) and 1e-2 under bf16 operand rounding. Mesh invariance of the port
itself is held to the JAX package's own bounds (1e-5 f32, 5e-3 bf16,
tests/test_megakernel.py::test_mega_mesh_invariance and
::test_mega_bf16_mesh_invariance). At kernel level the plain versions of
the two sharded kernels (chunk_stats' local+full operand set and the
``mxu_binning=False`` binned correlation) are held against the JAX Pallas
kernels in interpret mode, with float32 inputs, and a numpy float64 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.ops.megakernel import chunk_stats as jax_chunk_stats
from fakepta_tpu.ops.pallas_kernels import binned_correlation as jax_binned
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.ops import megakernel as mk
from fakepta_tpu_torch.ops.megakernel import T_COMMON, T_OWN, MegaStage
from fakepta_tpu_torch.parallel import mesh as mesh_lib
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from test_torch_engine import KW, _noisy_leaves

TOL = {"f32": 1e-5, "bf16": 1e-2}
MESH_TOL = {"f32": 1e-5, "bf16": 5e-3}
# (stat_path, pallas_mxu_binning)
PATHS = (("einsum", True), ("fused", True), ("fused", False), ("mega", True))
PATH_IDS = ("einsum", "fused", "fused-vpu", "mega")
CPU8 = ["cpu"] * 8
STAGES = (MegaStage(4, T_OWN, 0), MegaStage(3, T_OWN, 1),
          MegaStage(4, T_COMMON, 0))


def _psd(tspan, ncomp=4):
    f = np.arange(1, ncomp + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-13.5, gamma=13 / 3))


def _assert_stats(got, want, tol):
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=tol)


@pytest.fixture(scope="module")
def noisy():
    """The small batch with every stage on (ECORR, chromatic and two system
    bands besides white, red, DM and the GWB), in both packages."""
    leaves = _noisy_leaves(JaxBatch.synthetic(**KW))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            PulsarBatch.from_numpy(leaves, device="cpu"))


def _jax_sim(jb, psr_shards, **kw):
    return JaxSim(jb, gwb=JaxGWB(psd=_psd(float(jb.tspan_common)),
                                 orf="hd"),
                  mesh=jax_make_mesh(jax.devices(), psr_shards=psr_shards),
                  **kw)


def _port_sim(tb, mesh=None, path=("fused", True), **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return EnsembleSimulator(tb, gwb=GWBConfig(
        psd=_psd(float(tb.tspan_common)), orf="hd"), mesh=mesh,
        stat_path=path[0], pallas_mxu_binning=path[1], **kw)


@pytest.fixture(scope="module")
def jax_xla(noisy):
    """The JAX XLA engine on 4x2 and 1x8 meshes (keep_corr=True also
    returns curves and autos)."""
    return {s: _jax_sim(noisy[0], s).run(8, seed=3, chunk=8, keep_corr=True)
            for s in (2, 8)}


@pytest.fixture(scope="module")
def jax_fused_vpu(noisy):
    sim = _jax_sim(noisy[0], 2, use_pallas=True, pallas_mxu_binning=False)
    return {prec: sim.run(8, seed=3, chunk=8, precision=prec)
            for prec in ("f32", "bf16")}


# -- the mesh ---------------------------------------------------------------

def test_mesh_entries_know_their_rank():
    """Without a process group every entry is rank 0's: a one-process mesh
    with no process groups, whose collectives are the local ones; an entry
    of another rank makes a mesh that this process owns none of refused."""
    m = make_mesh(CPU8, psr_shards=2, toa_shards=2)
    assert mesh_lib.process_index() == 0 and mesh_lib.process_count() == 1
    assert mesh_lib.backend() is None
    assert not m.multiprocess and (m.ranks == 0).all()
    assert m.owns((1, 1, 1)) and m.local_device == torch.device("cpu")
    assert len(m.local_devices) == 8
    comm = m.comm([(0, s, 0) for s in range(2)])
    assert comm.local and comm.member
    blocks = [torch.ones(2, 3), 2 * torch.ones(2, 2)]
    assert torch.equal(comm.all_gather(blocks)[1],
                       torch.cat(blocks, dim=1))
    parts = [torch.full((2,), 0.1), torch.full((2,), 0.2)]
    assert torch.equal(comm.psum(parts), parts[0] + parts[1])
    np.testing.assert_array_equal(mesh_lib.to_host(parts[0]),
                                  parts[0].numpy())
    with pytest.raises(ValueError, match="owns no entry"):
        make_mesh([mesh_lib.MeshDevice(1, "cpu")])
    mixed = make_mesh([mesh_lib.MeshDevice(0, "cpu"), "cpu"])
    assert not mixed.multiprocess


def test_make_mesh_shapes_and_errors():
    m = make_mesh(CPU8, psr_shards=2)
    assert m.shape == {"real": 4, "psr": 2, "toa": 1}
    assert m.devices.shape == (4, 2, 1)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_mesh(CPU8, psr_shards=8).shape == {"real": 1, "psr": 8,
                                                   "toa": 1}
    assert make_mesh(CPU8, psr_shards=2, toa_shards=2).shape == {
        "real": 2, "psr": 2, "toa": 2}
    assert make_mesh(["cpu"]).shape == {"real": 1, "psr": 1, "toa": 1}
    with pytest.raises(ValueError, match="must divide 8 devices"):
        make_mesh(CPU8, psr_shards=3)
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(CPU8, psr_shards=4, toa_shards=4)
    with pytest.raises(ValueError):
        make_mesh([], psr_shards=1)
    with pytest.raises(ValueError):
        make_mesh(CPU8, psr_shards=0)


def test_make_mesh_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: make_mesh() has devices to use")
    with pytest.raises(RuntimeError, match="list CPU devices"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(["cuda:0"] * 2, psr_shards=2)


def test_collectives_keep_shard_order():
    blocks = [torch.full((2, 1, 3), float(s)) for s in range(4)]
    gathered = mesh_lib.all_gather(blocks)
    assert len(gathered) == 4
    for g in gathered:
        assert g.shape == (2, 4, 3)
        assert torch.equal(g[0, :, 0], torch.arange(4.0))
    # shards on one device share one concatenation
    assert all(g is gathered[0] for g in gathered)
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    # (1e8 + 1) - 1e8 in float32 is 0: the order is the shard order
    assert float(mesh_lib.psum(parts)) == 0.0
    assert float(mesh_lib.psum(parts[::-1])) == 0.0
    assert float(mesh_lib.psum([parts[0], parts[2], parts[1]])) == 1.0


def test_engine_checks_the_mesh():
    tb = PulsarBatch.synthetic(**KW, device="cpu")
    with pytest.raises(ValueError, match="divisible by the psr mesh axis"):
        _port_sim(tb, mesh=make_mesh(["cpu"] * 3, psr_shards=3))
    with pytest.raises(ValueError, match="divisible by the toa mesh axis"):
        _port_sim(tb, mesh=make_mesh(["cpu"] * 3, toa_shards=3))
    # toa sharding runs on the einsum path only; the kernel paths refuse it
    for path in (("fused", True), ("mega", True)):
        with pytest.raises(ValueError, match="toa sharding"):
            _port_sim(tb, mesh=make_mesh(["cpu"] * 2, toa_shards=2),
                      path=path)
    _port_sim(tb, mesh=make_mesh(["cpu"] * 2, toa_shards=2),
              path=("einsum", True))
    with pytest.raises(ValueError, match="mesh= or device="):
        EnsembleSimulator(tb, mesh=make_mesh(["cpu"]), device="cpu")
    sim = _port_sim(tb, mesh=make_mesh(CPU8, psr_shards=2))
    assert sim.mesh.shape["real"] == 4 and sim.device == torch.device("cpu")
    # each psr shard holds its own rows (contiguous, as the CUDA kernels
    # take them) and the full pair counts
    for s, sh in enumerate(sim._shards[0]):
        assert sh.p_offset == 4 * s and sh.batch.npsr == 4
        assert sh.weights.shape == (16, 4, 8) and sh.weights.is_contiguous()
        assert torch.equal(sh.weights, sim._stat_weights[:, 4 * s:4 * s + 4])
        assert sh.times.shape == (2, 4, 64) and sh.times.is_contiguous()
        assert sh.times_full.shape == (2, 8, 64)
    # a (psr index, device) pair is built once for all real rows
    assert all(row[1] is sim._shards[0][1] for row in sim._shards)
    # a chunk that does not divide by the real axis rounds down to one
    # that does
    out = sim.run(6, seed=3, chunk=6)
    assert out["curves"].shape == (6, 15)


# -- the sharded engine against the JAX engine -----------------------------

@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_paths_match_jax_xla(noisy, jax_xla, shards, path, prec):
    sim = _port_sim(noisy[1], mesh=make_mesh(CPU8, psr_shards=shards),
                    path=path)
    assert sim.include == (True,) * 7
    out = sim.run(8, seed=3, chunk=8, precision=prec)
    assert out["statistic_path"] == path[0] and out["precision"] == prec
    assert out["curves"].shape == (8, 15) and out["autos"].shape == (8,)
    _assert_stats(out, jax_xla[shards], TOL[prec])


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_vpu_binning_matches_jax_fused(noisy, jax_fused_vpu, prec):
    sim = _port_sim(noisy[1], mesh=make_mesh(CPU8, psr_shards=2),
                    path=("fused", False), pallas_precision=prec)
    _assert_stats(sim.run(8, seed=3, chunk=8), jax_fused_vpu[prec],
                  TOL[prec])


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_keep_corr_matches_jax(noisy, jax_xla, shards):
    out = _port_sim(noisy[1], mesh=make_mesh(CPU8, psr_shards=shards),
                    path=("mega", True)).run(8, seed=3, chunk=8,
                                             keep_corr=True)
    want = jax_xla[shards]["corr"]
    assert out["statistic_path"] == "einsum"
    assert out["corr"].shape == want.shape == (8, 8, 8)
    np.testing.assert_allclose(out["corr"], want, rtol=0,
                               atol=TOL["f32"] * np.abs(want).max())


# -- mesh invariance of the port --------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("path", PATHS, ids=PATH_IDS)
def test_mesh_invariance_and_bit_identical_reruns(noisy, path, prec):
    one = _port_sim(noisy[1], path=path).run(8, seed=3, chunk=8,
                                             precision=prec)
    for shape in ((8, 2), (8, 8), (4, 4)):
        sim = _port_sim(noisy[1], path=path, mesh=make_mesh(
            ["cpu"] * shape[0], psr_shards=shape[1]))
        a = sim.run(8, seed=3, chunk=8, precision=prec)
        b = sim.run(8, seed=3, chunk=8, precision=prec)
        _assert_stats(a, one, MESH_TOL[prec])
        for key in ("curves", "autos"):
            np.testing.assert_array_equal(a[key], b[key])


def test_draws_do_not_depend_on_the_mesh(noisy):
    """Each shard's residual rows equal the 1-shard rows bit for bit where
    no contraction differs (no GP projection or GWB coupling), and to f32
    rounding otherwise: keys fold the global pulsar index, and the GWB z is
    drawn whole on every shard."""
    from fakepta_tpu_torch.parallel.montecarlo import _chunk_keys
    from fakepta_tpu_torch.utils import rng

    one = _port_sim(noisy[1])
    sharded = _port_sim(noisy[1], mesh=make_mesh(CPU8, psr_shards=8))
    keys = _chunk_keys(rng.key(5, device="cpu"), 0, 4)
    with torch.no_grad():
        base, coef = one._residuals(keys, split_gp=True)
        full = one._residuals(keys)
        for s, sh in enumerate(sharded._shards[0]):
            b, c = sharded._residuals(keys, split_gp=True, shard=sh)
            assert torch.equal(b, base[:, s:s + 1])
            torch.testing.assert_close(c, coef[:, s:s + 1], rtol=1e-6,
                                       atol=1e-6 * float(coef.abs().max()))
            r = sharded._residuals(keys, shard=sh)
            torch.testing.assert_close(r, full[:, s:s + 1], rtol=0,
                                       atol=1e-6 * float(full.abs().max()))


# -- the sharded kernels' plain versions ------------------------------------

def _mega_inputs(seed=5, R=4, P=8, T=48, nbins=5, p_local=3):
    rng = np.random.default_rng(seed)
    K = mk.stage_k(STAGES)
    t_own = np.tile(np.linspace(0.0, 1.0, T), (P, 1))
    times = np.stack([t_own, 0.9 * t_own])
    mask = np.ones((P, T))
    mask[:, -5:] = 0.0
    scales = np.stack([mask, mask * 1.7])
    base = rng.standard_normal((R, P, T)) * mask[None]
    coef = rng.standard_normal((R, P, K))
    w = rng.standard_normal((nbins + 1, p_local, P))
    return base, coef, times, scales, w


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("lo,hi", [(3, 6), (7, 8), (0, 8)])
def test_chunk_stats_local_full_plain_matches_dense_f64_oracle(prec, lo, hi):
    """Local rows lo..hi-1 against the full array, with GP stages; f32: the
    f32 rounding of the inputs is the whole difference; bf16: base and
    coefficients stored in bfloat16 (the oracle sees the stored values)."""
    base, coef, times, scales, w = _mega_inputs(p_local=hi - lo)
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    tb, tc = torch.tensor(base).to(dt), torch.tensor(coef).to(dt)
    tt, ts = torch.tensor(times).float(), torch.tensor(scales).float()
    got = mk.chunk_stats_plain(
        tb, tc, tt, ts, torch.tensor(w).float(), stages=STAGES, nbins=5,
        precision=prec, base_local=tb[:, lo:hi], coef_local=tc[:, lo:hi],
        times_local=tt[:, lo:hi], scales_local=ts[:, lo:hi])
    # the dense f64 oracle on the stored values
    bs, cs = tb.double().numpy(), tc.double().numpy()
    P, T = times.shape[1:]
    blocks = []
    for st in STAGES:
        n = np.arange(1, st.nbin + 1)
        ph = 2.0 * np.pi * times[st.tcol][:, :, None] * n
        b = np.stack([np.cos(ph), np.sin(ph)], axis=2)
        blocks.append((b * scales[st.scol][:, :, None, None])
                      .reshape(P, T, 2 * st.nbin))
    res = bs + np.einsum("ptk,rpk->rpt", np.concatenate(blocks, -1), cs)
    want = np.einsum("rpq,npq->rn",
                     np.einsum("rpt,rqt->rpq", res[:, lo:hi], res), w)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[0].numpy(), want[:, :-1], rtol=0,
                               atol=TOL[prec] * scale)
    np.testing.assert_allclose(got[1].numpy(), want[:, -1], rtol=0,
                               atol=TOL[prec] * scale)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_stats_local_full_plain_matches_pallas(prec):
    """The JAX megakernel's local+full operand set without GP stages (the
    configuration it still traces: base-only residuals)."""
    base, _, times, scales, w = (x.astype(np.float32)
                                 for x in _mega_inputs(seed=6, p_local=3))
    lo, hi = 2, 5
    want = jax_chunk_stats(
        jnp.asarray(base[:, lo:hi]), jnp.asarray(base), None, None,
        jnp.asarray(times[:, lo:hi]), jnp.asarray(times),
        jnp.asarray(scales[:, lo:hi]), jnp.asarray(scales), jnp.asarray(w),
        stages=(), nbins=5, rt=2, interpret=True, precision=prec)
    tb, tt, ts = (torch.tensor(x) for x in (base, times, scales))
    got = mk.chunk_stats_plain(
        tb, None, tt, ts, torch.tensor(w), stages=(), nbins=5,
        precision=prec, base_local=tb[:, lo:hi], coef_local=None,
        times_local=tt[:, lo:hi], scales_local=ts[:, lo:hi])
    scale = np.abs(np.asarray(want[0])).max()
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0,
                                   atol=TOL[prec] * scale)


@pytest.mark.parametrize("p_local", [1, 3, 8])
def test_vpu_binning_plain_matches_pallas(p_local):
    """binned_correlation_plain is the plain version of the mxu_binning=
    False kernel too: held against the JAX VPU-binning Pallas kernel at
    float32 (that kernel fails on float64 inputs)."""
    rng = np.random.default_rng(11)
    res = rng.standard_normal((4, 8, 64)).astype(np.float32)
    w = rng.standard_normal((7, p_local, 8)).astype(np.float32)
    res_l = res[:, 8 - p_local:]
    want = jax_binned(jnp.asarray(res_l), jnp.asarray(res), jnp.asarray(w),
                      nbins=6, rt=2, interpret=True, precision="f32",
                      mxu_binning=False)
    before = (bc.launches, bc.vpu_launches)
    got = bc.binned_correlation_vpu(torch.tensor(res_l), torch.tensor(res),
                                    torch.tensor(w), 6, precision="f32")
    assert (bc.launches, bc.vpu_launches) == before
    plain = bc.binned_correlation_plain(torch.tensor(res_l),
                                        torch.tensor(res), torch.tensor(w),
                                        6, precision="f32")
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    scale = np.abs(np.asarray(want[0])).max()
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0,
                                   atol=TOL["f32"] * scale)


def test_chunk_stats_wrapper_local_set_on_cpu():
    base, coef, times, scales, w = (torch.tensor(x).float()
                                    for x in _mega_inputs(p_local=3))
    kw = dict(stages=STAGES, nbins=5, base_local=base[:, 2:5],
              coef_local=coef[:, 2:5], times_local=times[:, 2:5],
              scales_local=scales[:, 2:5])
    before = (mk.launches, mk.sharded_launches)
    got = mk.chunk_stats(base, coef, times, scales, w, **kw)
    want = mk.chunk_stats_plain(base, coef, times, scales, w, **kw)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert (mk.launches, mk.sharded_launches) == before
    with pytest.raises(ValueError, match="all four local operands"):
        mk.chunk_stats(base, coef, times, scales, w, stages=STAGES, nbins=5,
                       base_local=base[:, 2:5])
