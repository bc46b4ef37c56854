"""The port's stream refreshers (``fakepta_tpu_torch.stream.refresh``)
against the JAX package's, on the CPU at float64.

``PosteriorRefresher``: two cycles over tests/test_stream.py's stream (a
one-TOA append between them), the JAX refresher's and the port's from the
same data and seeds. Cycle 1 (cold) is held to 1e-9: the Laplace mode and
the thinned draws, with the same Newton count. Cycle 2 starts both fits
warm from their cycle-1 modes. There both damped-Newton fits stop short
of the stationary point, under their ``1e-6`` move rule, because the last
step gains ~1e-16 of lnpost, below the float64 spacing of lnpost ~851
(1.1e-13): each line search compares two values equal to roundoff and
halves or takes the step by chance. On this fixture the port's mode stops
2.9e-8 and the JAX mode 4.4e-8 short, 1.5e-8 apart. So cycle 2 is held
to the same Newton count and flags, and the stationary point is held at
1e-9: one undamped Newton step from each mode, with each package's own
gradient, lands on the same point (measured 1.2e-13 apart).
The modes themselves are held within 1e-7 and the draws within 1e-8
relative (measured 1.5e-8 and 1.8e-9). The gate, ``maybe_refresh`` on
tests/test_lifecycle.py's duck-typed harness (side by side with JAX's)
follow; ``FactorizedRefresher`` is held to JAX's in
tests/test_torch_stream_factorized.py.
"""

import dataclasses

import numpy as np
import pytest

from fakepta_tpu.sample import SampleSpec as JSpec
from fakepta_tpu.stream import PosteriorRefresher as JRefresher
from fakepta_tpu.stream import RefreshPolicy as JPolicy
from fakepta_tpu.stream import StreamState as JStream
from fakepta_tpu.stream import default_stream_model as jmodel
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.obs import metrics
from fakepta_tpu_torch.sample import SampleSpec
from fakepta_tpu_torch.stream import (FactorizedRefresher,
                                      PosteriorRefresher, RefreshPolicy,
                                      StreamState, default_stream_model)
from fakepta_tpu_torch.tune import defaults as knobs
from test_stream import ECORR_DT, NPSR, TSPAN_S, _blocks, _template

SPEC = dict(n_chains=2, warmup=4, step_size=0.3, n_leapfrog=4)
RUN = dict(segment=4)
N_STEPS = 8


def _port(jb):
    return PulsarBatch.from_numpy(
        {f.name: np.asarray(getattr(jb, f.name))
         for f in dataclasses.fields(jb)}, device="cpu")


def _append(stream, b):
    return stream.append(b["t"], b["r"], sigma2=b["s2"], ecorr_amp=b["ec"],
                         counts=b["counts"])


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def cycles():
    """Both packages' streams, refreshers and two refresh cycles."""
    jt = _template()
    blocks = _blocks()
    js = JStream(jt, jmodel(nbin=4), ecorr_dt=ECORR_DT, watch="hd")
    ps = StreamState(_port(jt), default_stream_model(nbin=4),
                     ecorr_dt=ECORR_DT, watch="hd", device="cpu")
    for b in blocks:
        _append(js, b)
        _append(ps, b)
    jr = JRefresher(js, JSpec(model=js.model, **SPEC), rhat_gate=1e9)
    pr = PosteriorRefresher(ps, SampleSpec(model=ps.model, **SPEC),
                            rhat_gate=1e9, device="cpu")
    out = {"js": js, "ps": ps, "jr": jr, "pr": pr}
    for k, seed in ((1, 1), (2, 2)):
        if k == 2:
            t_new = np.full((NPSR, 1), 0.96 * TSPAN_S)
            js.append(t_new, np.full((NPSR, 1), 1e-8))
            ps.append(t_new, np.full((NPSR, 1), 1e-8))
        out[f"j{k}"] = jr.refresh(n_steps=N_STEPS, seed=seed, **RUN)
        out[f"p{k}"] = pr.refresh(n_steps=N_STEPS, seed=seed, **RUN)
        out[f"jwarm{k}"] = dict(jr._warm)
        out[f"pwarm{k}"] = dict(pr._warm)
        out[f"jtheta{k}"] = np.array(jr.posterior["theta"])
        out[f"ptheta{k}"] = np.array(pr.posterior["theta"])
    return out


FLAGS = ("refresh", "promoted", "warm_started", "chains_warm_started",
         "laplace_iters", "n_steps", "n_toas", "schema")


def test_cycle_one_equals_jax(cycles):
    j, p = cycles["j1"], cycles["p1"]
    assert {k: p[k] for k in FLAGS} == {k: j[k] for k in FLAGS}
    assert p["rhat_max"] == pytest.approx(j["rhat_max"], rel=1e-9)
    assert not p["warm_started"] and p["promoted"]
    assert np.max(np.abs(cycles["pwarm1"]["mode_v"]
                         - cycles["jwarm1"]["mode_v"])) <= 1e-9
    assert _rel(cycles["ptheta1"], cycles["jtheta1"]) <= 1e-9


def test_cycle_two_warm_equals_jax(cycles):
    j, p = cycles["j2"], cycles["p2"]
    assert {k: p[k] for k in FLAGS} == {k: j[k] for k in FLAGS}
    assert p["warm_started"] and p["chains_warm_started"]
    assert p["laplace_iters"] <= cycles["p1"]["laplace_iters"]
    assert p["n_toas"] == cycles["p1"]["n_toas"] + NPSR
    # both fits stop short of the same stationary point (module
    # docstring): one undamped Newton step from each mode, with each
    # package's own gradient, lands on it (the gradient sets the point;
    # the port's Hessian at each mode only scales a ~4e-8 step)
    from fakepta_tpu.sample import SamplingRun as JRun
    from fakepta_tpu_torch.sample import SamplingRun
    ps, js, jr = cycles["ps"], cycles["js"], cycles["jr"]
    probe = SamplingRun(ps.batch_view(), SampleSpec(model=ps.model, **SPEC),
                        residuals=ps.residuals_view(), device="cpu",
                        warm_from=cycles["pwarm2"])
    jprobe = JRun(js.batch_view(), JSpec(model=js.model, **SPEC),
                  residuals=js.residuals_view(), warm_from=cycles["jwarm2"])
    vp, vj = cycles["pwarm2"]["mode_v"], cycles["jwarm2"]["mode_v"]
    p_star = vp + np.linalg.solve(-probe._hessian(vp), probe.lnpost_grad(vp))
    j_star = vj + np.linalg.solve(-probe._hessian(vj),
                                  jprobe.lnpost_grad(vj))
    gaps = [float(np.max(np.abs(a - b)))
            for a, b in ((p_star, j_star), (vp, p_star), (vj, j_star),
                         (vp, vj))]
    print(f"warm cycle: Newton-refined modes {gaps[0]:.3e} apart; port "
          f"mode {gaps[1]:.3e} and JAX mode {gaps[2]:.3e} short of them, "
          f"{gaps[3]:.3e} apart; |grad| there port "
          f"{np.max(np.abs(probe.lnpost_grad(p_star))):.3e}")
    assert gaps[0] <= 1e-9
    assert max(gaps[1], gaps[2]) <= 1e-6
    assert np.max(np.abs(probe.lnpost_grad(p_star))) <= 1e-12
    assert gaps[3] <= 1e-7
    assert _rel(cycles["ptheta2"], cycles["jtheta2"]) <= 1e-8
    assert jr.refreshes == cycles["pr"].refreshes == 2


def test_strict_gate_rejects_while_warm_state_advances(cycles):
    """An impossible R-hat bound rejects promotion (flight-recorded) but
    still advances the warm state, as in the JAX package."""
    ps = cycles["ps"]
    strict = PosteriorRefresher(ps, SampleSpec(model=ps.model, **SPEC),
                                rhat_gate=1e-6, device="cpu")
    with metrics.collect() as col:
        info = strict.refresh(n_steps=4, seed=3, **RUN)
    assert info["promoted"] is False and strict.posterior is None
    assert strict._warm is not None and strict.promotions == 0
    assert "stream.promotions" not in col.counters
    assert col.counters["stream.refreshes"] == 1


def test_refresher_rejects_mismatches(cycles):
    ps = cycles["ps"]
    other = default_stream_model(nbin=3)
    with pytest.raises(ValueError, match="stream's model"):
        PosteriorRefresher(ps, SampleSpec(model=other, n_chains=2))
    with pytest.raises(ValueError, match="stream's model"):
        FactorizedRefresher(ps, SampleSpec(model=other, n_chains=2))
    for cls in (PosteriorRefresher, FactorizedRefresher):
        with pytest.raises(NotImplementedError, match="11b"):
            cls(ps, compile_cache_dir="cache_dir")
        with pytest.raises(ValueError, match="not both"):
            cls(ps, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# maybe_refresh on the duck-typed harness of tests/test_lifecycle.py
# ---------------------------------------------------------------------------

class _FakeStream:
    """The duck-typed surface RefreshPolicy scheduling reads: an appends
    counter, a stats() snapshot, and the (shared) model identity."""

    def __init__(self, model):
        self.model = model
        self.appends = 0
        self.snr = 0.0

    def stats(self):
        return {"snr": self.snr}


def _counting(base):
    class Counting(base):
        """maybe_refresh()'s unit harness: refresh() advances the markers
        the real one would, without sampling anything."""

        def refresh(self, n_steps=200, seed=0, **run_kwargs):
            self.refreshes += 1
            self._mark_appends = int(self.stream.appends)
            self._mark_snr = self._current_snr()
            return {"refresh": self.refreshes - 1}
    return Counting


def test_refresh_policy_gates_on_appends_and_snr_as_jax():
    streams = (_FakeStream(jmodel()), _FakeStream(default_stream_model()))
    refs = (_counting(JRefresher)(streams[0], policy=JPolicy(
                every_appends=3, min_snr_gain=2.0)),
            _counting(PosteriorRefresher)(streams[1], policy=RefreshPolicy(
                every_appends=3, min_snr_gain=2.0)))

    def step(**state):
        for s in streams:
            for k, v in state.items():
                setattr(s, k, v)
        outs = [r.maybe_refresh() for r in refs]
        assert outs[1] == outs[0]
        assert (refs[1].skips, refs[1].refreshes) == (refs[0].skips,
                                                      refs[0].refreshes)
        return outs[1]

    out = step()
    assert out["skipped"] and out["appends_since"] == 0
    assert refs[1].skips == 1 and refs[1].refreshes == 0
    assert step(appends=2)["skipped"]                  # under both gates
    out = step(appends=3)
    assert not out["skipped"] and out["trigger"] == "appends"
    assert step()["skipped"]                           # markers advanced
    # an |SNR| jump trips the refresh BEFORE the epoch counter does
    out = step(snr=-2.5)
    assert not out["skipped"] and out["trigger"] == "snr"
    assert refs[1].refreshes == 2 and refs[1].skips == 3
    assert RefreshPolicy() == RefreshPolicy(
        every_appends=knobs.REFRESH_EVERY_APPENDS,
        min_snr_gain=knobs.REFRESH_MIN_SNR_GAIN)
    assert dataclasses.asdict(RefreshPolicy()) == \
        dataclasses.asdict(JPolicy())
