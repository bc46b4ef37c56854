"""The port's streaming ingestion (``fakepta_tpu_torch.stream``) and its
rolling optimal statistic (``detect.StreamingOS``) against the JAX
package's, on the CPU at float64.

The fixture is tests/test_stream.py's: 4 pulsars, three ragged ECORR
blocks, ``watch="hd"``, appended to a JAX stream and to the port's (one
module-scoped run each). Bounds: the port's moments and lnL within 1e-10
relative of JAX's (each array's max: ``M`` entries scale like 1/sigma^2 ~
1e14), append against restage within 1e-8 (the JAX oracle's bound), a
psr 2 x toa 2 mesh within 1e-10, the OS amp2 and snr within 1e-9 with the
same detection count; the ladder counters and info keys equal to JAX's;
checkpoint resumes bit-identical, JAX-written checkpoints included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fakepta_tpu import obs as jobs
from fakepta_tpu.stream import StreamState as JStream
from fakepta_tpu.stream import default_stream_model as jmodel
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.detect import StreamingOS
from fakepta_tpu_torch.obs import metrics
from fakepta_tpu_torch.parallel.mesh import make_mesh
from fakepta_tpu_torch.stream import (STREAM_SCHEMA, StreamCheckpoint,
                                      StreamState, default_stream_model)
from fakepta_tpu_torch.stream import state as state_mod
from test_stream import (COUNTS, ECORR_DT, NPSR, _blocks, _bulk,
                         _rel_err, _template)

NAMES = ("M", "lndetN", "n_valid", "d0", "dT")


def _port_template(jt):
    return PulsarBatch.from_numpy(
        {f.name: np.asarray(getattr(jt, f.name))
         for f in dataclasses.fields(jt)}, device="cpu")


def _append(stream, b):
    return stream.append(b["t"], b["r"], sigma2=b["s2"], ecorr_amp=b["ec"],
                         counts=b["counts"])


def _dispatched(stream, b):
    """The aten ops one append dispatches, with its tensors' shapes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            flat, _ = tree_flatten((args, kwargs))
            ops.append((str(func), [tuple(a.shape) for a in flat
                                    if isinstance(a, torch.Tensor)]))
            return func(*args, **kwargs)

    with Record():
        _append(stream, b)
    assert ops
    return ops


def _np(moments):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else x.numpy() for x in moments]


@pytest.fixture(scope="module")
def jax_run():
    jt = _template()
    stream = JStream(jt, jmodel(nbin=4), ecorr_dt=ECORR_DT, watch="hd")
    blocks = _blocks()
    infos = [_append(stream, b) for b in blocks]
    return {"template": jt, "stream": stream, "blocks": blocks,
            "infos": infos, "moments": _np(stream.moments()),
            "lnl": stream.lnlike(stream.theta_ref)}


@pytest.fixture(scope="module")
def port(jax_run):
    tpl = _port_template(jax_run["template"])
    model = default_stream_model(nbin=4)
    stream = StreamState(tpl, model, ecorr_dt=ECORR_DT, watch="hd",
                         device="cpu")
    infos = [_append(stream, b) for b in jax_run["blocks"]]
    return {"template": tpl, "model": model, "stream": stream,
            "infos": infos, "moments": _np(stream.moments()),
            "restaged": _np(stream.restage_moments())}


def _stream(port, **kw):
    kw.setdefault("device", "cpu")
    return StreamState(port["template"], port["model"], ecorr_dt=ECORR_DT,
                       **kw)


# ---------------------------------------------------------------------------
# moments and lnL against JAX; the oracle; block-size and mesh invariance
# ---------------------------------------------------------------------------

def test_constants_equal_jax():
    from fakepta_tpu.stream import STREAM_SCHEMA as JSCHEMA
    from fakepta_tpu.stream import state as jstate
    assert STREAM_SCHEMA == JSCHEMA

    def fields(model):
        return [(c.target, c.spectrum, c.nbin,
                 [(f.name, f.bounds) for f in c.free])
                for c in model.components]
    assert fields(default_stream_model(nbin=7)) == fields(jmodel(nbin=7))
    for n in (1, 7, 8, 9, 1024, 1025, 5000):
        assert state_mod._snap(n, (8, 16, 1024), 2) == \
            jstate._snap(n, (8, 16, 1024), 2)


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_moments_equal_jax(jax_run, port, i):
    assert _rel_err(port["moments"][i], jax_run["moments"][i]) <= 1e-10


def test_lnlike_equal_jax(jax_run, port):
    lnl = port["stream"].lnlike(port["stream"].theta_ref)
    np.testing.assert_allclose(port["stream"].theta_ref,
                               jax_run["stream"].theta_ref, rtol=0, atol=0)
    assert abs(lnl - jax_run["lnl"]) <= 1e-10 * abs(jax_run["lnl"])


@pytest.mark.parametrize("i", range(5), ids=NAMES)
def test_append_matches_restage_f64_oracle(port, i):
    assert _rel_err(port["moments"][i], port["restaged"][i]) <= 1e-8
    if NAMES[i] == "n_valid":
        np.testing.assert_array_equal(port["moments"][i],
                                      np.sum(COUNTS, axis=0))


def test_block_size_invariance_bulk_vs_incremental(jax_run, port):
    bulk = _bulk(jax_run["blocks"])
    other = _stream(port)
    _append(other, bulk)
    for got, want in zip(_np(other.moments()), port["moments"]):
        assert _rel_err(got, want) <= 1e-8
    lnl_a = port["stream"].lnlike(port["stream"].theta_ref)
    lnl_b = other.lnlike(other.theta_ref)
    assert abs(lnl_a - lnl_b) <= 1e-8 * max(abs(lnl_b), 1.0)


def test_mesh_invariance(jax_run, port):
    """A psr 2 x toa 2 mesh of eight CPU entries (the pulsars split over
    'psr', gathered in pulsar order) gives the one-shard moments."""
    mesh = make_mesh(["cpu"] * 8, psr_shards=2, toa_shards=2)
    s = _stream(port, device=None, mesh=mesh)
    for b in jax_run["blocks"]:
        _append(s, b)
    assert len(s._cells) == 2
    for got, want in zip(_np(s.moments()), port["moments"]):
        assert _rel_err(got, want) <= 1e-10
    with pytest.raises(ValueError, match="not both"):
        _stream(port, mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        _stream(port, device=None,
                mesh=make_mesh(["cpu"] * 3, psr_shards=3))


# ---------------------------------------------------------------------------
# the bucket ladder: counters and info keys as JAX's
# ---------------------------------------------------------------------------

def test_ladder_counters_and_info_equal_jax(jax_run, port):
    """The same append sequence gives JAX's compiles / recompiles /
    rebuckets, kernel keys, and append info dicts (latency aside; the
    rolling OS numbers are held in their own test)."""
    skip = {"latency_ms", "amp2", "snr", "significance_sigma"}
    for got, want in zip(port["infos"], jax_run["infos"]):
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in skip} == \
            {k: v for k, v in want.items() if k not in skip}
    # the JAX stream traced its finish kernel for moments(); the port's
    # fixture also restaged, which built the store-rung kernel
    jt = dict(jax_run["stream"]._trace_counts)
    pt = dict(port["stream"]._trace_counts)
    assert set(jt) <= set(pt) and all(n == 1 for n in pt.values())
    assert port["stream"].compiles > 0
    # ``recompiles`` is 0 by construction (a built key is never built
    # again); what can fail is a build on a steady append: the same
    # blocks again, at kernel rungs already built, build nothing (the
    # host store may still grow a rung)
    s = _stream(port)
    for b in jax_run["blocks"]:
        _append(s, b)
    built, keys = s.compiles, set(s._kernels)
    again = [_dispatched(s, b) for b in jax_run["blocks"]]
    assert s.compiles == built and set(s._kernels) == keys
    # and runs the same work: a third time, the same aten ops at the
    # same shapes (what the smoke holds on the card's steady appends)
    assert [_dispatched(s, b) for b in jax_run["blocks"]] == again
    assert port["infos"][0]["rebucketed"] is False
    assert port["stream"].rebuckets > 0
    assert port["infos"][-1]["block_bucket"] == 8
    assert port["infos"][-1]["schema"] == STREAM_SCHEMA


@pytest.mark.parametrize("case", ["rows", "shape", "counts", "origin",
                                  "ecorr"])
def test_stream_rejects_bad_blocks_as_jax(jax_run, port, case):
    z = np.zeros
    bad = {"rows": (z((NPSR + 1, 3)), z((NPSR + 1, 3)), {}),
           "shape": (z((NPSR, 3)), z((NPSR, 2)), {}),
           "counts": (z((NPSR, 3)), z((NPSR, 3)),
                      {"counts": np.array([4, 1, 1, 1])}),
           "origin": (np.full((NPSR, 2), -5e6), z((NPSR, 2)), {}),
           "ecorr": (np.ones((NPSR, 2)), z((NPSR, 2)),
                     {"ecorr_amp": np.full((NPSR, 2), 1e-7)})}[case]
    if case == "ecorr":
        jstream = JStream(jax_run["template"], jmodel(nbin=4))
        pstream = StreamState(port["template"], port["model"], device="cpu")
    else:
        jstream, pstream = jax_run["stream"], port["stream"]
    with pytest.raises(ValueError) as jerr:
        jstream.append(bad[0], bad[1], **bad[2])
    with pytest.raises(ValueError) as perr:
        pstream.append(bad[0], bad[1], **bad[2])
    assert str(perr.value) == str(jerr.value)
    assert pstream.appends == (0 if case == "ecorr" else 3)


# ---------------------------------------------------------------------------
# the rolling detection statistic
# ---------------------------------------------------------------------------

def test_streaming_os_equal_jax(jax_run, port):
    for got, want in zip(port["infos"], jax_run["infos"]):
        for key in ("amp2", "snr", "significance_sigma"):
            assert np.isfinite(got[key])
            assert abs(got[key] - want[key]) <= 1e-9 * abs(want[key]), key
    watcher = port["stream"]._watcher()
    from_restage = watcher.update(tuple(
        torch.as_tensor(x) for x in port["restaged"]))
    for key in ("amp2", "snr"):
        np.testing.assert_allclose(from_restage[key],
                                   port["infos"][-1][key], rtol=1e-8)


def test_streaming_os_detections_edge_triggered_as_jax(jax_run, port):
    """The same update sequence with a threshold between its values
    counts the same upward crossings (``stream.detections``) in both."""
    from fakepta_tpu.detect.streaming import StreamingOS as JOS
    js, ps = jax_run["stream"], port["stream"]
    base = ps._watcher().last["snr"]
    thr = 4.0 * base
    jw = JOS(js._compiled, js._nsb, np.asarray(js.template.pos),
             theta_ref=js.theta_ref, threshold_sigma=thr)
    pw = StreamingOS(ps._compiled, ps._nsb,
                     port["template"].pos.numpy(), theta_ref=ps.theta_ref,
                     threshold_sigma=thr)
    jm, pm = js.moments(), ps.moments()
    counts = []
    for w, mom, mod in ((jw, jm, jobs), (pw, pm, metrics)):
        with mod.collect() as col:
            for k in (1.0, 3.0, 1.0, 3.0, 3.0, 1.0, 3.0):
                w.update(mom[:4] + (mom[4] * k,))
        counts.append(col.counters.get("stream.detections", 0))
    assert counts[0] == counts[1] >= 1
    assert pw.count == 7 and pw.last["snr"] == pytest.approx(
        jw.last["snr"], rel=1e-9)


def test_streaming_os_rejects_what_jax_rejects(port):
    ps = port["stream"]
    pos = port["template"].pos.numpy()
    with pytest.raises(ValueError, match="curn"):
        StreamingOS(ps._compiled, ps._nsb, pos, orf="curn")
    with pytest.raises(ValueError, match=">= 2 pulsars"):
        StreamingOS(ps._compiled, ps._nsb, pos[:1])
    from fakepta_tpu_torch.infer import build
    from fakepta_tpu_torch.infer import model as im
    no_curn = build(im.LikelihoodSpec(components=(im.ComponentSpec(
        target="red", spectrum="batch"),)), port["template"])
    with pytest.raises(ValueError, match="exactly one 'curn'"):
        StreamingOS(no_curn, ps._nsb, pos)


# ---------------------------------------------------------------------------
# checkpoint / torn-append recovery (chaos site ingest.append)
# ---------------------------------------------------------------------------

def _ckpt(port, path):
    return _stream(port, checkpoint=path)


def test_checkpoint_resume_bitwise_across_append_boundary(jax_run, port,
                                                          tmp_path):
    path = tmp_path / "stream.ckpt"
    first = _ckpt(port, path)
    for b in jax_run["blocks"][:2]:
        _append(first, b)
    want = _np(first.moments())
    resumed = _ckpt(port, path)
    assert (resumed.appends, resumed.rolled_back) == (2, 0)
    for got, ref in zip(_np(resumed.moments()), want):
        np.testing.assert_array_equal(got, ref)
    blk = jax_run["blocks"][2]
    _append(first, blk)
    _append(resumed, blk)
    for got, ref in zip(_np(resumed.moments()), _np(first.moments())):
        np.testing.assert_array_equal(got, ref)


def test_torn_append_rolls_back_to_last_consistent_state(jax_run, port,
                                                         tmp_path):
    path = tmp_path / "torn.ckpt"
    stream = _ckpt(port, path)
    for b in jax_run["blocks"][:2]:
        _append(stream, b)
    want = _np(stream.moments())
    plan = faults.FaultPlan([faults.FaultSpec("ingest.append", "torn",
                                              at=(0,))])
    with faults.inject(plan):
        with pytest.raises(faults.KillFault):
            _append(stream, jax_run["blocks"][2])
    assert plan.fired == [("ingest.append", "torn", 0)]
    with metrics.collect() as col:
        resumed = _ckpt(port, path)
    assert col.counters["faults.rollbacks"] == 1
    assert (resumed.rolled_back, resumed.appends) == (1, 2)
    for got, ref in zip(_np(resumed.moments()), want):
        np.testing.assert_array_equal(got, ref)


def test_checkpoint_read_without_repair_leaves_a_torn_tail(jax_run, port,
                                                            tmp_path):
    """What a rank that does not write reads of a torn checkpoint: the
    consistent prefix, with the files, the counters and the flight
    recorder left alone; the writer's read then rolls the tail back."""
    path = tmp_path / "reader.ckpt"
    stream = _ckpt(port, path)
    for b in jax_run["blocks"]:
        _append(stream, b)
    ckpt = StreamCheckpoint(path)
    ckpt.corrupt_block(2)
    files = sorted(p.name for p in tmp_path.iterdir())
    ident = stream._ident()
    with metrics.collect() as col:
        blocks, rolled = StreamCheckpoint(path).load_blocks(ident,
                                                            repair=False)
    assert (len(blocks), rolled) == (2, 1)
    assert "faults.rollbacks" not in col.counters
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    blocks, rolled = StreamCheckpoint(path).load_blocks(ident)
    assert (len(blocks), rolled) == (2, 1)
    assert "reader.ckpt.b000002.npz" not in {p.name
                                             for p in tmp_path.iterdir()}


def test_transient_fault_leaves_stream_untouched(jax_run, port):
    stream = _stream(port)
    blocks = jax_run["blocks"]
    _append(stream, blocks[0])
    plan = faults.FaultPlan([faults.FaultSpec("ingest.append", "transient",
                                              at=(0,))])
    with faults.inject(plan):
        with pytest.raises(faults.TransientFault):
            _append(stream, blocks[1])
    assert stream.appends == 1
    for b in blocks[1:]:
        _append(stream, b)
    ref = _stream(port)
    for b in blocks:
        _append(ref, b)
    for got, want in zip(_np(stream.moments()), _np(ref.moments())):
        np.testing.assert_array_equal(got, want)


def test_checkpoint_identity_mismatch_is_a_hard_error(jax_run, port,
                                                      tmp_path):
    path = tmp_path / "ident.ckpt"
    _append(_ckpt(port, path), jax_run["blocks"][0])
    with pytest.raises(ValueError, match="ecorr_dt"):
        StreamState(port["template"], port["model"], ecorr_dt=ECORR_DT * 2,
                    checkpoint=path, device="cpu")
    with pytest.raises(ValueError, match="different stream"):
        StreamState(port["template"], default_stream_model(nbin=3),
                    ecorr_dt=ECORR_DT, checkpoint=path, device="cpu")


def test_jax_checkpoint_resumes_in_the_port(jax_run, port, tmp_path):
    """A JAX-written stream checkpoint (the same ``.b<k>.npz`` blocks and
    CRC32 manifest) resumes in the port, equal bit for bit to the port's
    own appends of the same blocks."""
    path = tmp_path / "jax.ckpt"
    jstream = JStream(jax_run["template"], jmodel(nbin=4),
                      ecorr_dt=ECORR_DT, checkpoint=path)
    for b in jax_run["blocks"][:2]:
        _append(jstream, b)
    resumed = _ckpt(port, path)
    assert (resumed.appends, resumed.rolled_back) == (2, 0)
    own = _stream(port)
    for b in jax_run["blocks"][:2]:
        _append(own, b)
    for got, want in zip(_np(resumed.moments()), _np(own.moments())):
        np.testing.assert_array_equal(got, want)
    assert StreamCheckpoint(path)._block_path(1).name == \
        jstream._ckpt._block_path(1).name


def test_views_and_stats(jax_run, port):
    """The refresh views and the stats payload match JAX's."""
    js, ps = jax_run["stream"], port["stream"]
    assert ps.tspan == js.tspan
    for key, want in js.raw_data().items():
        np.testing.assert_array_equal(ps.raw_data()[key], want)
    np.testing.assert_array_equal(ps.residuals_view(), js.residuals_view())
    jb, pb = js.batch_view(), ps.batch_view()
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(getattr(pb, f.name).numpy(),
                                      np.asarray(getattr(jb, f.name)),
                                      err_msg=f.name)
    # the port's fixture also restaged (one more kernel build)
    skip = {"latency_ms", "amp2", "snr", "significance_sigma", "compiles"}
    assert {k: v for k, v in ps.stats().items() if k not in skip} == \
        {k: v for k, v in js.stats().items() if k not in skip}
    assert ps.stats()["compiles"] == js.stats()["compiles"] + 1
    with pytest.raises(ValueError, match="no data"):
        _stream(port).batch_view()
