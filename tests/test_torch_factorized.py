"""The port's factorized free-spectrum sampler
(``fakepta_tpu_torch.sample.factorized``) against the JAX package's, on
the CPU: the JAX file's cases that need no serve fleet
(tests/test_factorized.py), with the port held to the JAX functions.

Tolerances: the plan is equal; the host float64 algebra (the nuisance
marginalization, its restriction, the exactness oracle) within 1e-12
relative of the JAX package's; a float64 FactorizedRun's recombined draws
within 1e-9 relative of the JAX FactorizedRun's, lane for lane, with equal
acceptance; within the port a lane's draws are bit-identical run alone.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.infer import ComponentSpec as JComp
from fakepta_tpu.infer import FreeParam as JFree
from fakepta_tpu.infer import LikelihoodSpec as JModel
from fakepta_tpu.infer import build as jbuild
from fakepta_tpu.sample import SampleSpec as JSpec
from fakepta_tpu.sample import factorized as jfac
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.infer import ComponentSpec, FreeParam, LikelihoodSpec
from fakepta_tpu_torch.infer import build
from fakepta_tpu_torch.sample import SampleSpec, SamplingRun
from fakepta_tpu_torch.sample import factorized as fac

NB = 4                 # parent free-spectrum bins
LANE_BINS = 2          # -> lanes (0,2) and (2,4)
N_STEPS = 8
SEED = 5


def _fs_model(nbin, comp=ComponentSpec, free=FreeParam, spec=LikelihoodSpec,
              nuisance=True):
    comps = [comp(target="red", spectrum="batch"),
             comp(target="dm", spectrum="batch")] if nuisance else []
    comps.append(comp(target="curn", nbin=nbin, spectrum="free_spectrum",
                      free=(free("log10_rho", (-9.0, -5.0), per_bin=True),)))
    return spec(components=tuple(comps))


def _jax_fs_model(nbin):
    return _fs_model(nbin, JComp, JFree, JModel)


def _pair(npsr=3, ntoa=32, regular=False, seed=1):
    """(JAX batch, port batch) at float64, optionally on the exact
    discrete-orthogonality grid t_k = k/T."""
    jb = JaxBatch.synthetic(npsr=npsr, ntoa=ntoa, tspan_years=10.0,
                            toaerr=1e-7, n_red=NB, n_dm=NB, seed=seed,
                            dtype=jnp.float64)
    if regular:
        t = np.tile(np.arange(ntoa, dtype=np.float64)[None] / ntoa,
                    (npsr, 1))
        jb = dataclasses.replace(jb, t_own=jnp.asarray(t),
                                 t_common=jnp.asarray(t))
    tb = PulsarBatch.from_numpy({f.name: np.asarray(getattr(jb, f.name))
                                 for f in dataclasses.fields(jb)},
                                device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def batches():
    return _pair()


def _close(got, want, rtol=1e-12):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1e-300))


# ---------------------------------------------------------------------------
# the plan (pure host)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbin,bins", [(8, 3), (4, 1), (6, (2, 1, 3)),
                                       (5, None)])
def test_lane_spans_equal_jax(nbin, bins):
    assert fac.lane_spans(nbin, bins) == jfac.lane_spans(nbin, bins)
    assert fac.lane_seed(SEED, 3) == jfac.lane_seed(SEED, 3)


def test_lane_spans_errors():
    with pytest.raises(ValueError, match="lane_bins must be >= 1"):
        fac.lane_spans(4, 0)
    with pytest.raises(ValueError, match="sum to"):
        fac.lane_spans(6, (2, 2))


def test_factor_plan_equals_jax_and_validates(batches):
    jb, tb = batches
    plan = fac.factor_plan(build(_fs_model(NB), tb), LANE_BINS)
    jplan = jfac.factor_plan(jbuild(_jax_fs_model(NB), jb), LANE_BINS)
    assert [(lp.lo, lp.hi) for lp in plan] == [(0, 2), (2, 4)]
    for lp, jlp in zip(plan, jplan):
        for f in ("index", "lo", "hi", "theta_idx", "free_cols",
                  "marg_cols", "nuisance_cols"):
            assert getattr(lp, f) == getattr(jlp, f), f
        comp = lp.model.components[0]
        assert len(lp.model.components) == 1
        assert (comp.bin_offset, comp.nbin) == (lp.lo, lp.hi - lp.lo)
    powerlaw = LikelihoodSpec(components=(
        ComponentSpec(target="curn", nbin=NB, free=(
            FreeParam("log10_A", (-16.0, -13.0)),
            FreeParam("gamma", (2.0, 6.0)))),))
    with pytest.raises(ValueError, match="per_bin"):
        fac.factor_plan(build(powerlaw, tb))
    two = LikelihoodSpec(components=(
        ComponentSpec(target="red", nbin=NB, spectrum="free_spectrum",
                      free=(FreeParam("log10_rho", (-9.0, -5.0),
                                      per_bin=True),)),
        ComponentSpec(target="curn", nbin=NB, spectrum="free_spectrum",
                      free=(FreeParam("log10_rho", (-9.0, -5.0),
                                      per_bin=True),)),))
    with pytest.raises(ValueError, match="exactly one free component"):
        fac.factor_plan(build(two, tb))


# ---------------------------------------------------------------------------
# the algebra (host f64)
# ---------------------------------------------------------------------------

def test_marginalize_nuisance_equals_jax_and_is_exact(rng):
    p, n_all = 3, 7
    keep, nuis = [0, 2, 5], [1, 3, 4, 6]
    f = rng.normal(size=(p, 12, n_all))
    m = np.einsum("ptk,ptl->pkl", f, f)
    dt = rng.normal(size=(p, n_all))
    d0 = np.abs(rng.normal(size=p)) + 50.0
    lndet = rng.normal(size=p)
    nv = np.full(p, 12.0)
    phi_n = 10.0 ** rng.uniform(-2, 1, size=(p, len(nuis)))
    mom = (m, lndet, nv, d0, dt)
    marg = fac.marginalize_nuisance_np(mom, keep, nuis, phi_n)
    _close(marg, jfac.marginalize_nuisance_np(mom, keep, nuis, phi_n))
    from fakepta_tpu_torch.ops import woodbury
    phi_k = 10.0 ** rng.uniform(-2, 1, size=(p, len(keep)))
    phi_full = np.zeros((p, n_all))
    phi_full[:, keep], phi_full[:, nuis] = phi_k, phi_n
    t = [torch.as_tensor(x) for x in mom]
    joint = woodbury.lnlike_from_moments(t[3], t[4], t[0], t[1], t[2],
                                         torch.as_tensor(phi_full))
    mt = [torch.as_tensor(x) for x in marg]
    lane = woodbury.lnlike_from_moments(mt[3], mt[4], mt[0], mt[1], mt[2],
                                        torch.as_tensor(phi_k))
    np.testing.assert_allclose(lane.numpy(), joint.numpy(), rtol=1e-12,
                               atol=1e-9)
    for a, b in zip(fac.marginalize_nuisance_np(mom, keep, [], None),
                    fac._restrict_np(mom, keep)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("regular", [True, False],
                         ids=["regular", "irregular"])
def test_oracle_equals_jax(regular):
    """The float64 dense proof: on the discrete-orthogonality grid the
    lane sum is the joint lnL to roundoff and the coupling vanishes; on an
    irregular grid both report the same real defect the JAX oracle
    reports."""
    jb, tb = _pair(npsr=3, ntoa=48, regular=regular)
    got = fac.factorized_oracle(tb, _fs_model(NB), lane_bins=LANE_BINS,
                                data_seed=3, n_probe=3)
    want = jfac.factorized_oracle(jb, _jax_fs_model(NB),
                                  lane_bins=LANE_BINS, data_seed=3,
                                  n_probe=3)
    assert got["lane_count"] == want["lane_count"] == 2
    assert got["lnl_scale"] == pytest.approx(want["lnl_scale"], rel=1e-12)
    if regular:
        assert got["additivity_max_err"] <= 1e-8 * max(got["lnl_scale"], 1)
        assert got["coupling"] < 1e-10
    else:
        assert got["additivity_max_err"] == pytest.approx(
            want["additivity_max_err"], rel=1e-6)
        assert got["coupling"] == pytest.approx(want["coupling"], rel=1e-9)
        assert got["coupling"] > 1e-6
    np.testing.assert_allclose(got["deltas"], want["deltas"], rtol=1e-12)


def test_recombine_draws_scatter_and_truncation(rng):
    spans = [(0, 1), (2, 3)]
    r0 = {"theta": rng.normal(size=(6, 2, 2))}
    r1 = {"theta": rng.normal(size=(4, 2, 2))}   # the shorter lane wins
    theta = fac.recombine_draws(spans, [r0, r1], 5)
    np.testing.assert_array_equal(
        theta, jfac.recombine_draws(spans, [r0, r1], 5))
    assert theta.shape == (4, 2, 5)
    np.testing.assert_array_equal(theta[:, :, 4], 0.0)
    with pytest.raises(ValueError, match="no lane results"):
        fac.recombine_draws([], [], 5)


# ---------------------------------------------------------------------------
# the driver against the JAX driver
# ---------------------------------------------------------------------------

SPEC = dict(n_chains=2, warmup=4, n_leapfrog=2)


@pytest.fixture(scope="module")
def runs(batches):
    jb, tb = batches
    jfr = jfac.FactorizedRun(
        jb, jfac.FactorizedSpec(JSpec(model=_jax_fs_model(NB), **SPEC),
                                LANE_BINS), data_seed=7)
    fr = fac.FactorizedRun(
        tb, fac.FactorizedSpec(SampleSpec(model=_fs_model(NB), **SPEC),
                               LANE_BINS), data_seed=7, device="cpu")
    return {"fr": fr, "res": fr.run(N_STEPS, seed=SEED),
            "jfr": jfr, "jres": jfr.run(N_STEPS, seed=SEED)}


def test_factorized_run_against_jax(runs):
    fr, res, jfr, jres = runs["fr"], runs["res"], runs["jfr"], runs["jres"]
    _close(fr.moments, jfr.moments)
    _close(fr.marg_moments, jfr.marg_moments, rtol=1e-10)
    assert res["theta"].shape == jres["theta"].shape
    assert res["theta"].shape[2] == fr.parent.D == NB
    np.testing.assert_allclose(res["theta"], jres["theta"], rtol=1e-9)
    np.testing.assert_allclose(res["mode_theta"], jres["mode_theta"],
                               rtol=1e-9)
    for lane, jlane in zip(res["lanes"], jres["lanes"]):
        assert lane["diag"]["accept_rate"] == jlane["diag"]["accept_rate"]
    assert set(res["summary"]) == set(jres["summary"])


def test_factorized_result_layout_and_aggregates(runs):
    fr, res = runs["fr"], runs["res"]
    assert fr.retraces == 0 and fr.lane_count == 2
    s = res["summary"]
    assert s["fs_lane_count"] == 2 and len(res["lanes"]) == 2
    assert s["fs_wall_s_critical"] <= s["fs_wall_s_total"]
    assert s["rhat_max"] == round(max(
        r["summary"]["rhat_max"] for r in res["lanes"]), 5)
    assert s["ess_min"] == round(min(
        r["summary"]["ess_min"] for r in res["lanes"]), 2)
    assert s["fs_ess_per_s_per_chip"] >= s["ess_per_s_per_chip"]
    for lp, lane in zip(fr.plan, fr.lanes):
        np.testing.assert_array_equal(res["mode_theta"][list(lp.theta_idx)],
                                      lane.mode_theta)


def test_lane_draws_bit_identical_solo(runs, batches):
    """A lane's draws are bit-identical run alone (a SamplingRun over the
    restricted marginalized moments, at the lane's seed), and the window
    staging helper is the same restriction."""
    fr, res = runs["fr"], runs["res"]
    tb = batches[1]
    lp = fr.plan[1]
    lane_theta = res["lanes"][1]["theta"]
    np.testing.assert_array_equal(res["theta"][:, :, list(lp.theta_idx)],
                                  lane_theta[:res["theta"].shape[0]])
    solo = SamplingRun(tb, dataclasses.replace(fr.spec, model=lp.model),
                       moments=fac._restrict_np(fr.marg_moments,
                                                lp.marg_cols),
                       device="cpu")
    out = solo.run(N_STEPS, seed=fac.lane_seed(SEED, 1))
    np.testing.assert_array_equal(out["theta"], lane_theta)
    mom = fac.marginalized_window_moments(fr.parent, tb, fr.moments,
                                          lp.lo, lp.hi)
    for a, b in zip(mom, fac._restrict_np(fr.marg_moments, lp.marg_cols)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="outside"):
        fac.marginalized_window_moments(fr.parent, tb, fr.moments, 3, 9)
