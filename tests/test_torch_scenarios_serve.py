"""The scenario registry's serve identity and the cadence tail's append
schedule in the port, bit for bit against the JAX package on the CPU.

``Scenario.serve_spec`` must name the JAX spec (field for field, so the
same ``spec_hash``) for every registered scenario, reduced and uncut, and
the flagship's must be the serve cell's ``ArraySpec(npsr=100, ntoa=780,
n_red=30, n_dm=100, gwb_ncomp=30)``. ``history_block``,
``append_schedule`` and ``as_append_requests`` are host numpy: their
blocks, counts, band frequencies, start offsets and white residuals must
equal the JAX package's exactly on ``ng15`` reduced and uncut (and on
``ipta_dr3``'s seven-band cadence).
"""

import dataclasses

import numpy as np
import pytest

from fakepta_tpu.scenarios import cadence as jcad
from fakepta_tpu.scenarios import registry as jreg
from fakepta_tpu_torch.scenarios import cadence as tcad
from fakepta_tpu_torch.scenarios import registry as treg
from fakepta_tpu_torch.serve import ArraySpec

NAMES = ("flagship_100", "ng15", "ipta_dr3", "ska_10k")
CASES = [("ng15", False), ("ng15", True), ("ipta_dr3", True)]


def _scn(reg, name, reduced):
    scn = reg.get(name)
    return scn.reduced() if reduced else scn


def _blocks_equal(tb, jb):
    assert len(tb) == len(jb) and tb
    for t, j in zip(tb, jb):
        assert t.t_start_s == j.t_start_s
        for field in ("toas", "counts", "freqs"):
            a, b = getattr(t, field), getattr(j, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_serve_spec_is_the_jax_spec(name, reduced):
    got = treg.get(name).serve_spec(reduced=reduced)
    want = jreg.get(name).serve_spec(reduced=reduced)
    assert isinstance(got, ArraySpec)
    assert got.spec_dict() == want.spec_dict()
    assert got.spec_hash() == want.spec_hash()


def test_flagship_serve_spec_is_the_serve_cell():
    want = ArraySpec(npsr=100, ntoa=780, n_red=30, n_dm=100, gwb_ncomp=30)
    assert treg.get("flagship_100").serve_spec() == want


@pytest.mark.parametrize("name,reduced", CASES)
def test_history_block_is_the_jax_block(name, reduced):
    for frac in (0.85, 0.5):
        _blocks_equal([tcad.history_block(_scn(treg, name, reduced),
                                          history_frac=frac)],
                      [jcad.history_block(_scn(jreg, name, reduced),
                                          history_frac=frac)])


@pytest.mark.parametrize("name,reduced", CASES)
def test_append_schedule_is_the_jax_schedule(name, reduced):
    for kw in (dict(), dict(max_blocks=4), dict(window_days=7.0,
                                                 history_frac=0.95)):
        tb = tcad.append_schedule(_scn(treg, name, reduced), **kw)
        jb = jcad.append_schedule(_scn(jreg, name, reduced), **kw)
        _blocks_equal(tb, jb)
        # padding slots replay the window start; counts mask them out
        for blk in tb:
            assert blk.counts.max() == blk.toas.shape[1]


@pytest.mark.parametrize("name,reduced", CASES)
def test_as_append_requests_are_the_jax_requests(name, reduced):
    tscn, jscn = _scn(treg, name, reduced), _scn(jreg, name, reduced)
    tb = tcad.append_schedule(tscn, max_blocks=4)
    jb = jcad.append_schedule(jscn, max_blocks=4)
    for kw in (dict(), dict(toaerr=3e-7, seed=5, ecorr_dt=86400.0)):
        treqs = tcad.as_append_requests(tb, "gw-ng15",
                                        spec=tscn.serve_spec(), **kw)
        jreqs = jcad.as_append_requests(jb, "gw-ng15",
                                        spec=jscn.serve_spec(), **kw)
        assert len(treqs) == len(jreqs) == len(tb)
        for k, ((tt, tr), (jt, jr)) in enumerate(zip(treqs, jreqs)):
            assert tt == jt and tr.stream == jr.stream == "gw-ng15"
            for field in ("toas", "residuals", "counts", "freqs"):
                assert np.array_equal(getattr(tr, field),
                                      getattr(jr, field)), field
            assert tr.ecorr_dt == jr.ecorr_dt
            if k == 0:
                assert tr.spec.spec_hash() == jr.spec.spec_hash()
            else:
                assert tr.spec is None and jr.spec is None
        assert sum(int(r.counts.sum()) for _, r in treqs) == \
            sum(int(b.counts.sum()) for b in tb)


def test_append_schedule_walks_the_tail_only():
    scn = treg.get("ng15")
    hist = tcad.history_block(scn)
    tail = tcad.append_schedule(scn)
    cut = 0.85 * scn.tspan_years * 365.25 * 86400.0
    valid = [b.toas[i, :b.counts[i]] for b in tail
             for i in range(scn.npsr)]
    assert min(v.min() for v in valid if v.size) >= cut
    assert hist.toas[hist.toas > 0].max() < cut
    # the tail plus the history is every drawn epoch
    drawn = sum(c.t.size for c in tcad.draw_cadence(
        scn.cadence, scn.tspan_years, scn.npsr, scn.data_seed,
        thin=scn.cadence_thin))
    assert int(hist.counts.sum()) + sum(int(b.counts.sum())
                                        for b in tail) == drawn
    assert dataclasses.is_dataclass(tail[0])
