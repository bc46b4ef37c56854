"""The memory lane's accounting (``scenarios.golden.lane_point``) and the
engine's fixed term (``static_reservation_bytes``), on the CPU.

A lane point holds the run's raw allocator peak against the chunk model
plus the fixed library workspaces the run reports, ``ratio = peak /
(model + static)``, and is ``ok`` only at ``0 < ratio <= bound``. The
numbers below are a stubbed report's: the 8-pulsar ska_10k point as the
card measured it (a 2.47 MB chunk model, the 32 MiB cuBLAS workspace and
the 1 MiB cuBLASLt one inside a 37 MB peak). The fixed term counts every
workspace present (torch keeps a set per (thread, stream) that ran a
product), per card, here from a stubbed allocator snapshot; a run pairs
its peak with the term of the peak's card, and takes a new snapshot only
when the term may have grown. On a host mesh there is no device
allocator: the engine reports no fixed term and the lane refuses to run.
"""

import pytest
import torch

from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs import memwatch
from fakepta_tpu_torch.obs.memwatch import (device_tensor_ptrs,
                                            library_workspace_bytes,
                                            workspace_block_bytes)
from fakepta_tpu_torch.parallel.montecarlo import EnsembleSimulator
from fakepta_tpu_torch.scenarios import golden

MODEL = 2_472_960
STATIC = 33 * 2**20


class _Report:
    """What ``lane_point`` reads of a RunReport."""

    def __init__(self, peak, model, static=None):
        self._summary = {"peak_hbm_bytes": peak,
                         "model_bytes_per_chunk": model}
        self.memory = ({} if static is None
                       else {"static_reservation_bytes": static})

    def summary(self):
        return dict(self._summary)


def test_point_holds_the_peak_against_model_plus_the_fixed_term():
    peak = 37_016_576
    p = golden.lane_point(_Report(peak, MODEL, STATIC), 8, 8)
    assert p["peak_hbm_bytes"] == peak              # raw, nothing hidden
    assert p["model_bytes_per_chunk"] == MODEL
    assert p["static_reservation_bytes"] == STATIC
    assert p["ratio"] == round(peak / (MODEL + STATIC), 3)
    assert p["ok"] and 0 < p["ratio"] <= golden.MEM_BOUND_FACTOR
    # without the fixed term the same peak reads as the card's old ratio
    bare = golden.lane_point(_Report(peak, MODEL), 8, 8)
    assert bare["static_reservation_bytes"] == 0
    assert bare["ratio"] == round(peak / MODEL, 3) and not bare["ok"]


@pytest.mark.parametrize("peak,model,ok", [
    (3.0 * (MODEL + STATIC), MODEL, True),          # at the bound
    (3.01 * (MODEL + STATIC), MODEL, False),        # over it
    (0.0, MODEL, False),                            # no watermark read
    (1e8, 0.0, False),                              # no model
])
def test_point_ok_is_the_documented_rule(peak, model, ok):
    p = golden.lane_point(_Report(peak, model, STATIC), 16, 8)
    assert p["ok"] is ok
    assert p["npsr"] == 16 and p["chunk"] == 8
    if not model:
        assert p["ratio"] == float("inf")


def _block(address, size, state="active_allocated"):
    return {"address": address, "size": size, "state": state}


def test_workspace_blocks_are_counted_from_the_snapshot():
    """Every live block of a measured workspace size counts, one set per
    (thread, stream); a block holding the caller's own tensor, a freed
    block, another size and another card's block do not."""
    gemm, lt = 32 * 2**20, 2**20
    own = 0x9000_0000
    segments = [
        {"device": 0, "blocks": [_block(0x1000_0000 + i * gemm, gemm)
                                 for i in range(4)]
         + [_block(0x2000_0000, lt), _block(own, lt),
            _block(0x3000_0000, gemm, state="inactive"),
            _block(0x4000_0000, gemm + 512)]},
        {"device": 1, "blocks": [_block(0x5000_0000, gemm)]},
    ]
    sizes = {0: {gemm, lt}}
    assert workspace_block_bytes(segments, sizes, exclude={own + 256}) == \
        {0: 4 * gemm + lt}
    assert workspace_block_bytes(segments, sizes) == {0: 4 * gemm + 2 * lt}
    assert workspace_block_bytes(segments, {}) == {}
    # each card's term is its own, to pair with that card's peak
    assert workspace_block_bytes(segments, {0: {lt}, 1: {gemm}}) == \
        {0: 2 * lt, 1: gemm}
    t = torch.zeros(3)
    assert device_tensor_ptrs((t, {"a": [t]})) == set()   # host tensors


class _Stream:
    def __init__(self, ptr):
        self.cuda_stream = ptr


def test_workspace_term_snapshots_only_when_it_may_have_grown(monkeypatch):
    """The term is read again only when the calling thread, its streams or
    the cards' device-allocation count changed; otherwise the last value
    stands, and the caller's tensors are walked only for a new read."""
    import threading

    reads, walks, streams = [], [], {"ptr": 7}
    monkeypatch.setattr(memwatch, "library_workspace_bytes",
                        lambda cards, exclude: reads.append(exclude)
                        or {0: 33 * 2**20 * len(reads)})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: _Stream(streams["ptr"]))
    term = memwatch.WorkspaceTerm([torch.device("cuda", 0)])
    own = lambda: walks.append(1) or {1}                  # noqa: E731
    assert term.read(own, {0: 5}) == {0: STATIC}
    assert term.read(own, {0: 5}) == {0: STATIC}           # kept
    assert len(reads) == len(walks) == 1 and reads[0] == {1}
    assert term.read(own, {0: 6}) == {0: 2 * STATIC}       # a new segment
    streams["ptr"] = 8
    assert term.read(own, {0: 6}) == {0: 3 * STATIC}       # a new stream
    got = []
    worker = threading.Thread(target=lambda: got.append(term.read(own,
                                                                  {0: 6})))
    worker.start()
    worker.join()
    assert got == [{0: 4 * STATIC}] and len(walks) == 4    # a new thread
    assert memwatch.WorkspaceTerm(["cpu"]).read(own) == {}


def test_sampler_names_the_card_of_the_peak(monkeypatch):
    per = {0: {"bytes_in_use": 1, "peak_bytes_in_use": 50,
               "bytes_limit": 99, "device_allocs": 3},
           1: {"bytes_in_use": 2, "peak_bytes_in_use": 80,
               "bytes_limit": 99, "device_allocs": 4}}
    monkeypatch.setattr(memwatch, "device_stats", lambda devs: per)
    sampler = memwatch.HbmSampler(["cpu"])
    out = sampler.stop()
    assert out["peak_bytes_in_use"] == 80 and sampler.peak_device == 1
    assert sampler.per_device == per


def test_run_pairs_the_peak_with_its_cards_term(monkeypatch):
    """On a mesh of several cards the run reports the term of the card
    whose peak it reports, not a sum or the largest: the lane divides
    that card's peak by the per-device model plus that card's term. The
    workspace probe runs before the peak is reset, so its set is inside
    the peak the term is held against."""
    from fakepta_tpu_torch.parallel import montecarlo

    order = []

    class TwoCards:
        def __init__(self, devices):
            self.per_device = {0: {"device_allocs": 1},
                               1: {"device_allocs": 2}}
            self.peak_device = None

        def start(self):
            order.append("reset the peak")
            return True

        def stop(self):
            self.peak_device = 1
            return {"peak_bytes_in_use": 10 * STATIC}

    seen = {}

    def terms(self, *extra, device_allocs=None):
        seen["allocs"] = device_allocs
        return {0: 3 * STATIC, 1: STATIC}

    sim = EnsembleSimulator(PulsarBatch.synthetic(npsr=4, ntoa=32, n_red=2,
                                                  n_dm=2, device="cpu"),
                            stat_path="einsum", device="cpu")
    monkeypatch.setattr(montecarlo, "HbmSampler", TwoCards)
    monkeypatch.setattr(EnsembleSimulator, "_workspace_terms", terms)
    monkeypatch.setattr(memwatch.WorkspaceTerm, "measure",
                        lambda self: order.append("probe"))
    rep = sim.run(4, seed=0, chunk=4)["report"]
    assert order == ["probe", "reset the peak"]
    assert rep.memory["peak_hbm_bytes"] == 10 * STATIC
    assert rep.memory["static_reservation_bytes"] == STATIC
    assert seen["allocs"] == {0: 1, 1: 2}


def test_host_mesh_reports_no_fixed_term():
    assert library_workspace_bytes(["cpu"]) == {}
    sim = EnsembleSimulator(PulsarBatch.synthetic(npsr=4, ntoa=32, n_red=2,
                                                  n_dm=2, device="cpu"),
                            stat_path="einsum", device="cpu")
    assert sim.static_reservation_bytes is None
    assert "static_reservation_bytes" not in sim.chunk_cost(4)
    rep = sim.run(4, seed=0, chunk=4)["report"]
    assert "static_reservation_bytes" not in rep.memory
    with pytest.raises(ValueError, match="host device"):
        golden.memory_lane("ska_10k", chunk=4, sweep=(4,),
                           devices=[torch.device("cpu")])
