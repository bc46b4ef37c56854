"""The port's resumable checkpoints, on the CPU, against the JAX package's.

A run killed mid-flight resumes bit-identical to the unbroken run (the
FIFO drain order of tests/test_pipeline.py), a torn chunk file rolls back,
a checkpoint cut on one device resumes on a sharded mesh within the
mesh-invariance bound, and the two packages' checkpoint files are
interchangeable: the same file names and keys, each package's files load
in the other, and a port run resumed from a JAX checkpoint lands within
1e-5 of the JAX unbroken run.
"""

import os
import zlib

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.parallel.montecarlo import EnsembleSimulator as JaxSim
from fakepta_tpu.parallel.montecarlo import GWBConfig as JaxGWB
from fakepta_tpu.utils import io as jax_io
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.parallel.montecarlo import (EnsembleSimulator,
                                                   GWBConfig)
from fakepta_tpu_torch.utils import io as io_utils

KW = dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=4, n_dm=4,
          seed=1)


class Kill(Exception):
    pass


def _psd(tspan, ncomp=4):
    f = np.arange(1, ncomp + 1) / tspan
    return np.asarray(jspec.powerlaw(f, log10_A=-13.5, gamma=13 / 3))


@pytest.fixture(scope="module")
def tb():
    return PulsarBatch.synthetic(**KW, device="cpu")


def _sim(tb, path="fused"):
    return EnsembleSimulator(tb, gwb=GWBConfig(psd=_psd(
        float(tb.tspan_common))), stat_path=path, pallas_precision="f32",
        device="cpu")


def _killer(at, calls):
    def boom(done, nreal):
        calls.append(done)
        if done >= at:
            raise Kill
    return boom


def _family(path):
    """The checkpoint's files (the flight-recorder dump aside)."""
    return sorted(p for p in os.listdir(path.parent)
                  if p.startswith(path.name))


def _same(a, b):
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
@pytest.mark.parametrize("depth", [0, 2])
def test_kill_and_resume_is_bit_identical(tb, tmp_path, path, depth):
    sim = _sim(tb, path)
    ck = tmp_path / "mc.npz"
    full = sim.run(32, seed=5, chunk=8)
    calls = []
    with pytest.raises(Kill):
        sim.run(32, seed=5, chunk=8, checkpoint=ck, progress=_killer(16,
                                                                     calls),
                pipeline_depth=depth)
    assert calls == [8, 16]       # FIFO drains; nothing ran past the kill
    assert _family(ck) == ["mc.npz", "mc.npz.c000000.npz",
                           "mc.npz.c000001.npz"]
    # the run that raised dumped its flight recorder beside the checkpoint
    assert any(p.startswith("flightrec-") for p in os.listdir(tmp_path))
    resumed = sim.run(32, seed=5, chunk=8, checkpoint=ck,
                      pipeline_depth=depth)
    _same(resumed, full)
    assert _family(ck) == []
    rep = resumed["report"]
    assert rep.nchunks == 2 and "faults.rollbacks" not in rep.counters
    assert all(c["ckpt_wait_s"] > 0 for c in rep.chunks)


@pytest.mark.parametrize("path", ["einsum", "fused", "mega"])
def test_a_one_shard_checkpoint_resumes_on_a_sharded_mesh(tb, tmp_path,
                                                          path):
    """The resumed stream does not depend on the mesh: a run cut on one
    device resumes on 2 real x 2 psr shards, keeps the stored chunks bit
    for bit and lands within the mesh-invariance bound (1e-5 of the curve
    scale at f32) of the unbroken one-device run."""
    sim = _sim(tb, path)
    ck = tmp_path / "mc.npz"
    full = sim.run(32, seed=5, chunk=8)
    with pytest.raises(Kill):
        sim.run(32, seed=5, chunk=8, checkpoint=ck, progress=_killer(16, []))
    sharded = EnsembleSimulator(
        tb, gwb=GWBConfig(psd=_psd(float(tb.tspan_common))), stat_path=path,
        pallas_precision="f32", mesh=make_mesh(["cpu"] * 4, psr_shards=2))
    resumed = sharded.run(32, seed=5, chunk=8, checkpoint=ck,
                          pipeline_depth=2)
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(resumed[k][:16], full[k][:16])
    scale = np.abs(full["curves"]).max()
    np.testing.assert_allclose(resumed["curves"], full["curves"], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(resumed["autos"], full["autos"], rtol=1e-5)
    assert resumed["report"].nchunks == 2
    assert resumed["report"].meta["mesh_shape"] == {"real": 2, "psr": 2,
                                                    "toa": 1}
    assert _family(ck) == []


def test_torn_chunk_rolls_back(tb, tmp_path):
    sim = _sim(tb)
    ck = tmp_path / "mc.npz"
    full = sim.run(32, seed=5, chunk=8)
    with pytest.raises(Kill):
        sim.run(32, seed=5, chunk=8, checkpoint=ck,
                progress=_killer(24, []))
    torn = tmp_path / "mc.npz.c000001.npz"
    data = torn.read_bytes()
    torn.write_bytes(data[:len(data) // 2])
    resumed = sim.run(32, seed=5, chunk=8, checkpoint=ck)
    _same(resumed, full)
    rep = resumed["report"]
    assert rep.counters["faults.rollbacks"] == 2     # chunks 1 and 2
    assert rep.nchunks == 3
    assert _family(ck) == []


def test_resume_validation(tb, tmp_path):
    sim = _sim(tb)
    ck = tmp_path / "mc.npz"
    with pytest.raises(Kill):
        sim.run(32, seed=5, chunk=8, checkpoint=ck, progress=_killer(8, []))
    for kw in (dict(nreal=32, seed=6, chunk=8), dict(nreal=40, seed=5,
                                                     chunk=8),
               dict(nreal=32, seed=5, chunk=16)):
        with pytest.raises(ValueError, match="different run"):
            sim.run(checkpoint=ck, **kw)
    with pytest.raises(ValueError, match="without keep_corr"):
        sim.run(32, seed=5, chunk=8, checkpoint=ck, keep_corr=True)
    with pytest.raises(TypeError, match="integer seed"):
        sim.run(32, seed=torch.tensor([0, 5]), chunk=8, checkpoint=ck)
    # an unreadable manifest is no checkpoint: the run starts over
    ck.write_bytes(b"not an npz")
    _same(sim.run(32, seed=5, chunk=8, checkpoint=ck),
          sim.run(32, seed=5, chunk=8))
    assert _family(ck) == []


def test_keep_corr_resumes_with_its_correlations(tb, tmp_path):
    sim = _sim(tb, "einsum")
    ck = tmp_path / "mc.npz"
    full = sim.run(16, seed=2, chunk=8, keep_corr=True)
    with pytest.raises(Kill):
        sim.run(16, seed=2, chunk=8, keep_corr=True, checkpoint=ck,
                progress=_killer(8, []))
    resumed = sim.run(16, seed=2, chunk=8, keep_corr=True, checkpoint=ck)
    for k in ("curves", "autos", "corr"):
        np.testing.assert_array_equal(resumed[k], full[k])


def test_write_atomic_and_npz_bytes(tmp_path):
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.int64(7)}
    blob = io_utils.npz_bytes(**arrays)
    assert blob == jax_io.npz_bytes(**arrays)
    target = tmp_path / "x.npz"
    assert io_utils.write_atomic(target, blob) == zlib.crc32(blob)
    assert target.read_bytes() == blob
    assert not (tmp_path / "x.npz.tmp").exists()


# ------------------------------------------------------ across the packages

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's unbroken run, and a checkpoint it wrote when killed
    after 16 of 32 realizations (same seed, nreal and chunk)."""
    jb = JaxBatch.synthetic(**KW)
    sim = JaxSim(jb, gwb=JaxGWB(psd=_psd(float(jb.tspan_common))),
                 mesh=jax_mesh(jax.devices()[:1]))
    full = sim.run(32, seed=5, chunk=8)
    ck = tmp_path_factory.mktemp("jax_ckpt") / "mc.npz"
    with pytest.raises(Kill):
        sim.run(32, seed=5, chunk=8, checkpoint=ck, progress=_killer(16, []))
    return full, ck


def _keys(path):
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files}


def test_files_have_the_jax_names_and_keys(tb, tmp_path, jax_run):
    ck = tmp_path / "mc.npz"
    with pytest.raises(Kill):
        _sim(tb, "einsum").run(32, seed=5, chunk=8, checkpoint=ck,
                               progress=_killer(16, []))
    jck = jax_run[1]
    assert _family(ck) == _family(jck)
    for name in _family(ck):
        assert _keys(ck.parent / name) == _keys(jck.parent / name), name
    with np.load(ck) as mine, np.load(jck) as theirs:
        for k in ("seed", "nreal", "chunk", "done", "n_extra"):
            assert int(mine[k]) == int(theirs[k])
    # and the JAX package reads the port's files
    state = jax_io.EnsembleCheckpoint(ck).load(5, 32, 8, keep_corr=False)
    assert state["done"] == 16 and state["rolled_back"] == 0


def test_a_jax_checkpoint_resumes_in_the_port(tb, tmp_path, jax_run):
    full, jck = jax_run
    # copy the family: the resumed run deletes what it resumed from
    ck = tmp_path / "mc.npz"
    for name in _family(jck):
        (tmp_path / name).write_bytes((jck.parent / name).read_bytes())
    want = jax_io.EnsembleCheckpoint(jck).load(5, 32, 8, keep_corr=False)
    got = io_utils.EnsembleCheckpoint(ck).load(5, 32, 8, keep_corr=False)
    assert got["done"] == want["done"] == 16
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(got[k], want[k])
    resumed = _sim(tb, "einsum").run(32, seed=5, chunk=8, checkpoint=ck)
    for k in ("curves", "autos"):
        np.testing.assert_array_equal(resumed[k][:16], want[k])
    scale = np.abs(full["curves"]).max()
    np.testing.assert_allclose(resumed["curves"], full["curves"], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(resumed["autos"], full["autos"], rtol=1e-5)
    assert _family(ck) == []
