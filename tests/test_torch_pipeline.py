"""The port's run loop against the JAX engine's, on the CPU: pipeline
depths, RNG lanes and the dtype knobs.

Same batch, same seed: the port's draws equal the JAX engine's to a few
float32 ULP (tests/test_torch_rng.py), so runs agree within 1e-5 of the
curve scale at f32 and 1e-2 under bf16 rounding (tests/test_torch_engine.py
holds the paths to the same bounds). Within the port, what the JAX tests
hold bit for bit is held bit for bit: every pipeline depth, and a lane
against the same lane alone at the same chunk size.
"""

import gc
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel import montecarlo as jax_mc
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs import memwatch
from fakepta_tpu_torch.parallel import montecarlo as mc
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.utils import io as io_utils

KW = dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=4, n_dm=4,
          seed=1)
LANES = [(11, 5), (22, 3)]
# (stat_path, pallas_mxu_binning): every statistic path of the port
PATHS = [("einsum", True), ("fused", True), ("fused", False),
         ("mega", True)]


def _psd(tspan, ncomp=4):
    f = np.arange(1, ncomp + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-13.5, gamma=13 / 3))


@pytest.fixture(scope="module")
def jb():
    return JaxBatch.synthetic(**KW)


@pytest.fixture(scope="module")
def tb():
    return PulsarBatch.synthetic(**KW, device="cpu")


def _jax_sim(jb, **kw):
    return jax_mc.EnsembleSimulator(
        jb, gwb=jax_mc.GWBConfig(psd=_psd(float(jb.tspan_common))),
        mesh=jax_mesh(jax.devices()[:1]), **kw)


def _sim(tb, path="fused", mxu=True, **kw):
    kw.setdefault("mesh", None)
    if kw["mesh"] is None:
        kw["device"] = "cpu"
    return mc.EnsembleSimulator(
        tb, gwb=mc.GWBConfig(psd=_psd(float(tb.tspan_common))),
        stat_path=path, pallas_mxu_binning=mxu, pallas_precision="f32", **kw)


def _close(got, want, tol=1e-5):
    scale = np.abs(want["curves"]).max()
    np.testing.assert_allclose(got["curves"], want["curves"], rtol=0,
                               atol=tol * scale)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=tol)


def _same(a, b):
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------------- depths

@pytest.mark.parametrize("path,mxu", PATHS)
def test_every_depth_is_bit_identical(tb, path, mxu):
    sim = _sim(tb, path, mxu)
    runs = [sim.run(32, seed=3, chunk=8, pipeline_depth=d)
            for d in range(4)]
    for d, out in enumerate(runs):
        _same(out, runs[0])
        assert out["report"].meta["pipeline_depth"] == d
    # the default is depth 2, the JAX package's
    default = sim.run(32, seed=3, chunk=8)
    _same(default, runs[0])
    assert default["report"].meta["pipeline_depth"] == 2


@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_every_depth_is_bit_identical_on_a_mesh(tb, path):
    """4 devices as 2 real x 2 psr shards."""
    sim = _sim(tb, path, mesh=make_mesh(["cpu"] * 4, psr_shards=2))
    runs = [sim.run(32, seed=3, chunk=8, pipeline_depth=d)
            for d in range(4)]
    for out in runs[1:]:
        _same(out, runs[0])
    _close(runs[0], _sim(tb, path).run(32, seed=3, chunk=8))


def test_ring_reuses_depth_buffers(tb, monkeypatch):
    """At most ``depth`` packed tensors are alive at a dispatch, counted by
    the ledger from weak references. Each chunk's drain is held until
    chunk ``k + depth - 1`` has been dispatched, so the count reaches the
    bound exactly: ``min(i + 1, depth)`` at chunk ``i``."""
    tracked = [0]
    cond = threading.Condition()
    track = memwatch.PackedLedger.track

    def counting_track(self, packed):
        live = track(self, packed)
        with cond:
            tracked[0] += 1
            cond.notify_all()
        return live

    monkeypatch.setattr(memwatch.PackedLedger, "track", counting_track)
    sim = _sim(tb)
    for d in (1, 2, 3):
        tracked[0] = 0

        def held(done, nreal, d=d):
            with cond:
                assert cond.wait_for(
                    lambda: tracked[0] >= min(done // 8 - 1 + d, 6),
                    timeout=60)

        rep = sim.run(48, seed=3, chunk=8, pipeline_depth=d,
                      progress=held)["report"]
        assert rep.memory["packed_buffers_live_peak"] == d
        assert rep.memory["packed_depth_bound_bytes"] == d * 8 * 16 * 4
        assert rep.counters["pipeline.d2h_async"] == 6
        names = {e["name"] for e in rep.timeline}
        assert {"dispatch", "drain", "execute", "recycle"} <= names
        assert [c["live_packed"] for c in rep.chunks] == \
            [min(i + 1, d) for i in range(6)]


def test_a_leaked_packed_buffer_breaks_the_depth_bound(tb, monkeypatch):
    """A step whose packed outputs stay referenced past their drains (here
    a list that keeps them all) fails the pipelined run; the serial loop,
    which keeps every chunk's output anyway, claims no bound."""
    sim = _sim(tb)
    kept = []
    step = sim.step

    def leaky_step(*a, **kw):
        packed, corr = step(*a, **kw)
        kept.append(packed)
        return packed, corr

    monkeypatch.setattr(sim, "step", leaky_step)
    with pytest.raises(RuntimeError, match="depth bound violated: 4 packed"):
        sim.run(32, seed=3, chunk=8, pipeline_depth=2)
    rep = sim.run(32, seed=3, chunk=8, pipeline_depth=0)["report"]
    assert rep.memory["packed_buffers_live_peak"] == 4


def test_a_failed_pipelined_run_frees_the_simulator(tb):
    """A drain's exception re-raised by the writer leaves no reference
    cycle behind: once the caller drops the simulator it is freed at once,
    with the garbage collector off, as after a failed serial run."""
    def boom(done, nreal):
        raise OSError("stop")

    gc.disable()
    try:
        for d in (0, 2):
            sim = _sim(tb)
            ref = weakref.ref(sim)
            with pytest.raises(OSError, match="stop"):
                sim.run(24, seed=5, chunk=8, progress=boom, pipeline_depth=d)
            del sim
            assert ref() is None, d
    finally:
        gc.enable()


def test_writer_exception_reaches_the_caller(tb, tmp_path, monkeypatch):
    """An I/O failure inside the background checkpoint append surfaces to
    the run() caller, at every depth."""
    def failing(self, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(io_utils.EnsembleCheckpoint, "save", failing)
    sim = _sim(tb)
    for d in (0, 2):
        with pytest.raises(OSError, match="disk full"):
            sim.run(24, seed=5, chunk=8, checkpoint=tmp_path / f"{d}.npz",
                    pipeline_depth=d)


def test_progress_runs_in_order_at_every_depth(tb):
    sim = _sim(tb)
    for d in range(4):
        calls = []
        sim.run(30, seed=5, chunk=8, pipeline_depth=d,
                progress=lambda done, n: calls.append((done, n)))
        assert calls == [(8, 30), (16, 30), (24, 30), (30, 30)]


# ------------------------------------------------------------------ lanes

def _jax_keys(seeds, within):
    keys = jax_mc._chunk_keys(jnp.asarray(seeds), jnp.asarray(within),
                              len(seeds))
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def test_lane_keys_equal_jax_bit_for_bit():
    seeds, within = mc._lane_arrays([(11, 5), (2 ** 31 - 1, 3), (0, 4)], 16)
    got = mc._chunk_keys(torch.from_numpy(seeds.astype(np.int64)),
                         torch.from_numpy(within.astype(np.int64)), 16)
    np.testing.assert_array_equal(got.numpy(), _jax_keys(seeds, within))
    # a lane key is the key run(n, seed=s) gives its realization i
    solo = mc._chunk_keys(torch.tensor([0, 11]), 0, 5)
    np.testing.assert_array_equal(got[:5].numpy(), solo.numpy())


@pytest.mark.parametrize("lanes,nreal", [
    (LANES, 8), (LANES, 12), ([(7, 1)], 4), ([(0, 3), (5, 2), (9, 1)], 6)])
def test_lane_arrays_equal_jax(lanes, nreal):
    for got, want in zip(mc._lane_arrays(lanes, nreal),
                         jax_mc._lane_arrays(lanes, nreal)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes,nreal,match", [
    ([(1, 0)], 4, "count must be > 0"), ([(-1, 2)], 4, "seed must be"),
    ([(2 ** 31, 2)], 4, "seed must be"), ([(1, 3), (2, 2)], 4, "slots")])
def test_lane_arrays_reject_like_jax(lanes, nreal, match):
    for fn in (mc._lane_arrays, jax_mc._lane_arrays):
        with pytest.raises(ValueError, match=match):
            fn(lanes, nreal)


@pytest.fixture(scope="module")
def jax_lanes(jb):
    """The JAX engine's lane run: the XLA path and the fused kernel (its
    interpret mode) at f32."""
    return {path: _jax_sim(jb, use_pallas=path == "fused",
                           pallas_precision="f32").run(
                16, chunk=16, lanes=LANES, pipeline_depth=0)
            for path in ("einsum", "fused")}


@pytest.mark.parametrize("path", ["einsum", "fused"])
def test_lane_run_matches_jax(tb, jax_lanes, path):
    out = _sim(tb, path).run(16, chunk=16, lanes=LANES)
    assert out["report"].meta["serve_lanes"] == 2
    _close(out, jax_lanes[path])


@pytest.mark.parametrize("path,mxu", PATHS)
def test_lane_equals_lane_alone_bit_for_bit(tb, path, mxu):
    sim = _sim(tb, path, mxu)
    cohort = sim.run(16, chunk=16, lanes=LANES)
    pos = 0
    for s, n in LANES:
        alone = sim.run(16, chunk=16, lanes=[(s, n)])
        for k in ("curves", "autos"):
            np.testing.assert_array_equal(cohort[k][pos:pos + n],
                                          alone[k][:n])
        _close({k: cohort[k][pos:pos + n] for k in ("curves", "autos")},
               sim.run(n, seed=s, chunk=n))
        pos += n


def test_lanes_refuse_a_checkpoint_and_overflow(tb, tmp_path):
    sim = _sim(tb)
    with pytest.raises(ValueError, match="cannot checkpoint"):
        sim.run(8, lanes=LANES, checkpoint=tmp_path / "mc.npz")
    with pytest.raises(ValueError, match="slots"):
        sim.run(6, lanes=LANES)


def test_run_refuses_what_is_not_ported(tb, tmp_path):
    sim = _sim(tb)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.run(8, tuned=True)
    # the event log is ported: one shard per process, the report it returns
    sim.run(8, eventlog=tmp_path / "ev")
    from fakepta_tpu_torch.obs.report import RunReport
    shard = RunReport.load(tmp_path / "ev" / "events-p000.jsonl")
    assert shard.meta == sim.last_report.meta
    # the likelihood lane is ported: what is not an InferSpec is refused
    with pytest.raises(TypeError, match="InferSpec"):
        sim.run(8, lnlike=object())
    # the recovery policy is ported: a RecoveryPolicy, None (the default
    # policy) or False (disabled); anything else is the JAX TypeError
    from fakepta_tpu_torch import faults
    with pytest.raises(TypeError, match="recovery must be None, False or "
                                        "a RecoveryPolicy, got object"):
        sim.run(8, recovery=object())
    for recovery in (None, False, faults.RecoveryPolicy(max_retries=1)):
        sim.run(8, recovery=recovery, tuned=False)


# ------------------------------------------------------------ dtype knobs

@pytest.fixture(scope="module")
def jax_bf16_bases(jb):
    return _jax_sim(jb, bases_dtype="bf16").run(32, seed=5, chunk=16)


@pytest.mark.parametrize("path", ["einsum", "fused"])
def test_bf16_bases_parity(tb, jax_bf16_bases, path):
    """Within the JAX test's 2e-2 bound of the f32-basis run (same draws),
    and of the JAX engine's own bf16-basis run. The basis is rounded to
    bf16 values once, at construction, and kept in float32."""
    a = _sim(tb, path).run(32, seed=5, chunk=16)
    sim = _sim(tb, path, bases_dtype="bf16")
    basis = sim._terms.gp_basis
    assert sim._terms.bases_bf16 and basis.dtype == torch.float32
    assert torch.equal(basis, basis.to(torch.bfloat16).float())
    assert not torch.equal(basis, _sim(tb, path)._terms.gp_basis)
    b = sim.run(32, seed=5, chunk=16)
    assert not np.array_equal(a["curves"], b["curves"])
    _close(b, a, tol=2e-2)
    _close(b, jax_bf16_bases, tol=1e-2)


def test_bf16_stats_is_the_einsum_default_precision(tb, jb):
    sim = _sim(tb, "einsum", stats_dtype="bf16")
    out = sim.run(32, seed=5, chunk=16)
    assert out["precision"] == "bf16"
    _same(out, _sim(tb, "einsum").run(32, seed=5, chunk=16,
                                       precision="bf16"))
    want = _jax_sim(jb, stats_dtype="bf16").run(32, seed=5, chunk=16)
    _close(out, want, tol=1e-2)


def test_dtype_knobs_reject_like_jax(tb):
    with pytest.raises(ValueError, match="bases_dtype"):
        _sim(tb, bases_dtype="fp8")
    with pytest.raises(ValueError, match="stats_dtype"):
        _sim(tb, "einsum", stats_dtype="fp8")
    with pytest.raises(ValueError, match="bases_dtype='bf16' is inert"):
        _sim(tb, "mega", bases_dtype="bf16")
    for path in ("fused", "mega"):
        with pytest.raises(ValueError, match="einsum statistic path only"):
            _sim(tb, path, stats_dtype="bf16")


def test_model_bytes_per_chunk_is_the_jax_model(tb, jb):
    """The byte model over the same stage table as the JAX engine's."""
    for path, use_pallas in (("einsum", False), ("fused", True)):
        want = _jax_sim(jb, use_pallas=use_pallas).model_bytes_per_chunk(16)
        assert _sim(tb, path).model_bytes_per_chunk(16) == want
    sim = _sim(tb, "mega")
    assert sim.run(16, seed=1, chunk=16)["report"].cost == {
        "model_bytes_per_chunk": sim.model_bytes_per_chunk(16)}
    assert sim.model_bytes_per_chunk(16, precision="bf16") < \
        sim.model_bytes_per_chunk(16)


@pytest.mark.parametrize("ckpt", [False, True])
@pytest.mark.parametrize("column,raises", [
    ("curve", True), ("auto", True), ("extra", False)])
def test_poisoned_output_checks_curves_and_autos(tb, tmp_path, column,
                                                 raises, ckpt):
    """As in the JAX engine, a non-finite curve or auto fails the run (per
    chunk before the checkpoint, and at the final fetch), while a NaN in an
    extra lane (an OS amp2 or the null stream's) reaches the caller."""
    sim = mc.EnsembleSimulator(tb, gwb=mc.GWBConfig(
        psd=_psd(float(tb.tspan_common))), stat_path="einsum", device="cpu")
    nb = sim.nbins
    col = {"curve": 3, "auto": nb, "extra": nb + 1}[column]
    step = sim.step

    def poisoned(*args, **kw):
        packed, corr = step(*args, **kw)
        packed = packed.clone()
        packed[:, col] = float("nan")
        return packed, corr

    sim.step = poisoned
    kw = dict(seed=3, chunk=4, os="hd", pipeline_depth=0)
    if ckpt:
        kw["checkpoint"] = tmp_path / "mc.npz"
    if raises:
        with pytest.raises(FloatingPointError):
            sim.run(8, **kw)
    else:
        out = sim.run(8, **kw)
        assert np.isnan(out["os"]["stats"]["hd"]["amp2"]).all()
        assert np.isfinite(out["curves"]).all()
