"""The port's golden-run harness (``fakepta_tpu_torch.scenarios.golden``)
against the JAX package's, on the CPU.

One module-scoped run each of ``golden_run("ng15", nreal=8, chunk=8,
skip=("sample", "serve"), max_append_blocks=2)`` on one CPU device (the
reduced spec), with the stream each lane built kept, and one run of the
JAX memory lane on its 8 virtual devices. Held: the row's key set (the
JAX row's, less the allocator keys a card fills), its deterministic keys
equal, its chunk model equal to the JAX XLA path's on the port's einsum
path; the stream lane's moments within 1e-10 relative of the JAX stream
fed the same blocks; the gate's same-scenario banding on the port's
``gate_row``; the memory lane's sweep rule and chunk model equal to JAX's
on ``["cpu"] * 8``, and the lane refusing a host mesh (it has no
watermark there). The statistic weights built slot by slot equal the
one-hot construction bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import fakepta_tpu.stream.state as jstate
import fakepta_tpu_torch.stream.state as tstate
from fakepta_tpu.scenarios import golden as jgolden
from fakepta_tpu_torch.parallel import montecarlo as tmc
from fakepta_tpu_torch.parallel.mesh import make_mesh as tmesh
from fakepta_tpu_torch.scenarios import golden as tgolden
from fakepta_tpu_torch.scenarios import registry as treg

KNOBS = dict(nreal=8, chunk=8, skip=("sample", "serve"),
             max_append_blocks=2)
#: the allocator keys: the JAX CPU engine fills them from its static
#: reservation, the port only on a card
CARD_KEYS = {"peak_hbm_bytes", "scn_peak_hbm_bytes"}
MOMENTS = ("M", "lndetN", "n_valid", "d0", "dT")


def _kept_streams(module, kept):
    """A StreamState subclass of ``module``'s that keeps its instances."""
    base = module.StreamState

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    return Kept


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def jax_run():
    import jax

    from fakepta_tpu.parallel.mesh import make_mesh as jmesh

    kept = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstate, "StreamState", _kept_streams(jstate, kept))
        row = jgolden.golden_run("ng15", mesh=jmesh(jax.devices()[:1]),
                                 **KNOBS)
    lane = jgolden.memory_lane("ska_10k", chunk=8)
    return {"row": row, "stream": kept[0], "lane": lane,
            "n_devices": len(jax.devices())}


@pytest.fixture(scope="module")
def port_run():
    kept = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstate, "StreamState", _kept_streams(tstate, kept))
        row = tgolden.golden_run("ng15", device="cpu", **KNOBS)
    return {"row": row, "stream": kept[0]}


# ---------------------------------------------------------------- the row

def test_constants_equal_jax():
    assert tgolden.MEM_BOUND_FACTOR == jgolden.MEM_BOUND_FACTOR == 3.0
    assert tgolden.ORACLE_RTOL == jgolden.ORACLE_RTOL == 1e-7
    from fakepta_tpu.scenarios import registry as jreg
    assert treg.REDUCED_MAX_PSR_MEM == jreg.REDUCED_MAX_PSR_MEM == 64


def test_row_has_the_jax_key_set(jax_run, port_run):
    """The JAX test's keys (tests/test_scenarios.py) less the card's, and
    exactly the JAX row's keys less the card's."""
    row = port_run["row"]
    for key in ("metric", "value", "unit", "platform", "scenario",
                "spec_hash", "steady_real_per_s_per_chip",
                "scn_real_per_s_per_chip", "append_latency_ms",
                "scn_append_p99_ms", "stream_appends"):
        assert key in row, key
    assert set(row) == set(jax_run["row"]) - CARD_KEYS
    assert not CARD_KEYS & set(row)
    assert row["platform"] == "cpu"
    assert row["value"] > 0 and np.isfinite(row["value"])
    assert row["stream_appends"] >= 2


@pytest.mark.parametrize("key", ["scenario", "spec_hash", "metric", "unit",
                                 "stream_appends", "stream_toas",
                                 "stream_rebuckets", "stream_recompiles",
                                 "platform", "retraces"])
def test_deterministic_keys_equal_jax(jax_run, port_run, key):
    assert port_run["row"][key] == jax_run["row"][key]


def test_chunk_model_equals_the_jax_xla_path(jax_run, port_run):
    """The row's ``model_bytes_per_chunk`` is the engine's default path's
    (fused); the same engine's einsum path prices the JAX XLA path's."""
    sim = treg.get("ng15").reduced().build(device="cpu")
    chunk = KNOBS["chunk"]
    assert sim.stat_path == "fused"
    assert port_run["row"]["model_bytes_per_chunk"] == \
        sim.model_bytes_per_chunk(chunk)
    assert sim.model_bytes_per_chunk(chunk, path="einsum") == \
        jax_run["row"]["model_bytes_per_chunk"]


@pytest.mark.parametrize("i", range(5), ids=MOMENTS)
def test_stream_lane_moments_equal_jax(jax_run, port_run, i):
    """The port's cadence stream against the JAX lane's stream, fed the
    same history and cadence blocks: within 1e-10 of each array's max."""
    got = _host(port_run["stream"].moments()[i])
    want = _host(jax_run["stream"].moments()[i])
    assert got.shape == want.shape
    scale = np.max(np.abs(want)) or 1.0
    assert np.max(np.abs(got - want)) <= 1e-10 * scale


def test_stream_lane_counts_equal_jax(jax_run, port_run):
    ps, js = port_run["stream"], jax_run["stream"]
    np.testing.assert_array_equal(ps._n, np.asarray(js._n))
    assert ps.appends == js.appends and ps.rebuckets == js.rebuckets
    assert ps.device.type == "cpu"


def test_gate_consumes_golden_rows_and_bands_same_scenario_only(port_run):
    """The JAX test's banding on the port's gate: a golden row bands only
    against its own scenario's history; a reduced ska_10k row on the same
    machine never gates an ng15 row, and scenario-less rows see only the
    scenario-less history."""
    from fakepta_tpu_torch.obs.gate import gate_row

    base = dict(port_run["row"], value=100.0,
                steady_real_per_s_per_chip=100.0)
    history = []
    for jitter in (0.98, 1.0, 1.02):
        history.append({**base, "value": 100.0 * jitter,
                        "steady_real_per_s_per_chip": 100.0 * jitter})
    history.append({**base, "scenario": "ska_10k", "value": 10_000.0,
                    "steady_real_per_s_per_chip": 10_000.0})
    history.append({k: v for k, v in base.items() if k != "scenario"})

    regressed = dict(base, value=50.0, steady_real_per_s_per_chip=50.0)
    flagged = {r.metric for r in gate_row(regressed, history)
               if r.verdict == "regression"}
    assert "value" in flagged and "steady_real_per_s_per_chip" in flagged

    ska_head = dict(base, scenario="ska_10k", value=5_000.0)
    assert not [r for r in gate_row(ska_head, history)
                if r.verdict == "regression"]

    plain_head = {k: v for k, v in regressed.items() if k != "scenario"}
    assert not [r for r in gate_row(plain_head, history)
                if r.verdict == "regression"]


def test_save_row_is_what_the_gate_loads(port_run, tmp_path):
    from fakepta_tpu_torch.obs import gate

    path = tmp_path / "row.json"
    tgolden.save_row(port_run["row"], path)
    assert gate.load_row(str(path)) == port_run["row"]


def test_golden_run_takes_a_mesh_or_a_device():
    with pytest.raises(ValueError, match="not both"):
        tgolden.golden_run("ng15", mesh=tmesh(["cpu"]), device="cpu")
    with pytest.raises(KeyError, match="not_a_scenario"):
        tgolden.golden_run("not_a_scenario", device="cpu")


# ------------------------------------------------------- the memory lane

@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 8])
def test_memory_lane_refuses_a_host_mesh(devices):
    """The port has no host watermark: a host lane would read a ratio of 0
    and pass its bound without measuring anything, so it raises."""
    with pytest.raises(ValueError, match="watermark"):
        tgolden.memory_lane("ska_10k", chunk=8, sweep=(8, 16),
                            devices=devices)


def test_memory_sweep_and_chunk_model_equal_jax(jax_run):
    """The sweep rule on the JAX lane's 8 devices gives its shard count and
    points, and the port's engine on ``make_mesh(["cpu"] * 8,
    psr_shards=...)`` prices each point's chunk as the JAX lane's run did
    (the einsum path against XLA)."""
    lane = jax_run["lane"]
    base = treg.get("ska_10k").reduced(max_psr=treg.REDUCED_MAX_PSR_MEM)
    shards, sweep = tgolden.sweep_plan(base.npsr, jax_run["n_devices"])
    assert shards == lane["psr_shards"] == 8
    assert list(sweep) == [p["npsr"] for p in lane["points"]]
    assert sweep == (8, 16, 32, 64)
    mesh = tmesh(["cpu"] * jax_run["n_devices"], psr_shards=shards)
    for p in lane["points"]:
        sim = dataclasses.replace(base, npsr=p["npsr"]).build(
            mesh=mesh, stat_path="einsum")
        assert sim.model_bytes_per_chunk(lane["chunk"]) == \
            p["model_bytes_per_chunk"], p


@pytest.mark.parametrize("n_devices,npsr,want", [
    (1, 10_000, (1, (1, 2, 4, 10_000))),
    (2, 10_000, (2, (2, 4, 8, 10_000))),
    (4, 10_000, (4, (4, 8, 16, 10_000))),
    (6, 64, (2, (2, 4, 8, 64))),
    (8, 16, (8, (8, 16))),
])
def test_sweep_plan_is_the_jax_rule(n_devices, npsr, want):
    assert tgolden.sweep_plan(npsr, n_devices) == want
    assert tgolden.sweep_plan(npsr, n_devices, psr_shards=1,
                              sweep=(3, 5)) == (1, (3, 5))


# ------------------------------------------ the engine's host constructions

def _onehot_stack(pos, counts_full, nbins, dtype):
    """The statistic weights as the engine built them through the
    (P, P, nbins) one-hot."""
    n = pos.shape[0]
    ang = np.arccos(np.clip(pos @ pos.T, -1, 1))
    edges = np.linspace(0.0, np.pi, nbins + 1)
    bin_idx = np.clip(np.digitize(ang, edges) - 1, 0, nbins - 1)
    offdiag = ~np.eye(n, dtype=bool)
    onehot = np.zeros((n, n, nbins))
    onehot[np.arange(n)[:, None], np.arange(n)[None, :], bin_idx] = 1.0
    onehot *= offdiag[:, :, None]
    bc = np.maximum(onehot.sum((0, 1)), 1.0)
    w_bins = onehot / counts_full[:, :, None] / bc
    w_auto = np.eye(n) / counts_full / n
    stack = np.concatenate([np.moveaxis(w_bins, 2, 0), w_auto[None]])
    return torch.tensor(stack).to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["flagship_100", "ng15", "ipta_dr3"])
def test_stat_weight_stack_bit_for_bit(name, dtype):
    """Three batches (uniform, ng15's and ipta_dr3's cadences, reduced):
    the slot-by-slot stack equals the one-hot construction bit for bit,
    and so do the engine's weights."""
    batch = treg.get(name).reduced().batch_parts(device="cpu")[0]
    host = batch.numpy()
    pos = np.asarray(host["pos"], dtype=np.float64)
    mask = np.asarray(host["mask"], dtype=np.float64)
    counts = np.maximum(mask @ mask.T, 1.0)
    for nbins in (15, 4):
        got = tmc.stat_weight_stack(pos, counts, nbins, dtype)
        want = _onehot_stack(pos, counts, nbins, dtype)
        assert got.dtype == want.dtype and got.is_contiguous()
        assert torch.equal(got, want)
    if dtype == batch.dtype:
        sim = tmc.EnsembleSimulator(batch, device="cpu")
        assert torch.equal(sim._stat_weights,
                           _onehot_stack(pos, counts, sim.nbins, dtype))
