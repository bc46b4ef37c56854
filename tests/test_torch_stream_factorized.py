"""The port's ``FactorizedRefresher`` (``fakepta_tpu_torch.stream``)
against the JAX package's, on the CPU at float64: the same touched lanes
and bins per cycle (an evenly-spaced epoch carrying one bin's sinusoid
touches exactly one lane), no rebuilds, the recombined posterior and the
lane modes within 1e-9, and the R-hat gate's veto keeping the last
promoted posterior (kept apart from tests/test_torch_stream_refresh.py so
that neither file's JAX reference runs outgrow its time budget).
"""

import numpy as np

from fakepta_tpu import constants as const
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.infer import ComponentSpec as JComp
from fakepta_tpu.infer import FreeParam as JFree
from fakepta_tpu.infer import LikelihoodSpec as JModel
from fakepta_tpu.sample import SampleSpec as JSpec
from fakepta_tpu.stream import FactorizedRefresher as JFactorized
from fakepta_tpu.stream import StreamState as JStream
from fakepta_tpu_torch.infer import ComponentSpec, FreeParam, LikelihoodSpec
from fakepta_tpu_torch.obs import metrics
from fakepta_tpu_torch.sample import SampleSpec
from fakepta_tpu_torch.stream import FactorizedRefresher, StreamState
from test_torch_stream_refresh import N_STEPS, RUN, _port, _rel


def _fs_model(nbin, comp=ComponentSpec, free=FreeParam, spec=LikelihoodSpec):
    return spec(components=(
        comp(target="red", spectrum="batch"),
        comp(target="dm", spectrum="batch"),
        comp(target="curn", nbin=nbin, spectrum="free_spectrum",
             free=(free("log10_rho", (-9.0, -5.0), per_bin=True),))))


def test_factorized_refresher_touches_the_lanes_jax_touches():
    """A 12-TOA base block, a cold refresh (every lane), then an
    evenly-spaced epoch carrying one bin's sinusoid: both packages
    re-sample the same single lane warm, with no rebuild, and their
    recombined posteriors agree within 1e-9; a vetoed cycle keeps the
    last promoted posterior."""
    npsr, nb = 3, 2
    tspan_s = 3.0 * const.yr
    jt = JaxBatch.synthetic(npsr=npsr, ntoa=32, tspan_years=3.0, n_red=3,
                            n_dm=3, seed=3, dtype=np.float64)
    js = JStream(jt, _fs_model(nb, JComp, JFree, JModel))
    ps = StreamState(_port(jt), _fs_model(nb), device="cpu")
    rng = np.random.default_rng(0)
    t0 = np.sort(rng.uniform(0, 0.9 * tspan_s, (npsr, 12)), axis=1)
    r0 = rng.normal(0, 1e-7, (npsr, 12))
    m = 16
    t1 = np.tile((np.arange(m) / m * tspan_s)[None], (npsr, 1))
    r1 = 1e-6 * np.sin(2 * np.pi * (2.0 / tspan_s) * t1)
    kw = dict(n_chains=2, warmup=4, n_leapfrog=2)
    jr = JFactorized(js, JSpec(model=js.model, **kw), lane_bins=1,
                     rhat_gate=1e9)
    pr = FactorizedRefresher(ps, SampleSpec(model=ps.model, **kw),
                             lane_bins=1, rhat_gate=1e9, device="cpu")
    keys = ("fs_lane_count", "fs_lanes_touched", "fs_bins_touched",
            "fs_recompiles", "promoted", "warm_started", "refresh")
    for t, r, seed in ((t0, r0, 1), (t1, r1, 2)):
        for s in (js, ps):
            s.append(t, r, sigma2=np.full(t.shape, 1e-14))
        j = jr.refresh(N_STEPS, seed=seed, **RUN)
        with metrics.collect() as col:
            p = pr.refresh(N_STEPS, seed=seed, **RUN)
        assert {k: p[k] for k in keys} == {k: j[k] for k in keys}
        assert col.counters["stream.fs_bins_touched"] == p["fs_bins_touched"]
        assert _rel(pr.posterior["theta"], jr.posterior["theta"]) <= 1e-9
        np.testing.assert_allclose(pr.posterior["mode_theta"],
                                   jr.posterior["mode_theta"], rtol=1e-9)
    assert p["fs_lanes_touched"] == 1 and p["fs_bins_touched"] == 1
    assert p["warm_started"] and p["fs_recompiles"] == 0
    assert pr.lane_count == nb
    kept = pr.posterior["theta"]
    pr.rhat_gate = 0.0
    vetoed = pr.refresh(4, seed=3, force_all=True, **RUN)
    assert not vetoed["promoted"] and vetoed["fs_lanes_touched"] == nb
    np.testing.assert_array_equal(pr.posterior["theta"], kept)
    assert pr.promotions == 2 and pr.refreshes == 3
