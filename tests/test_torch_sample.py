"""The port's sampler (``fakepta_tpu_torch.sample``) against the JAX
package's, on the CPU.

The two packages are held chain for chain at float64 (the conftest's x64,
a float64 batch in both, the port's float64 draws): the staged moments
within 1e-12, the Laplace mode and whitening factor within 1e-9 with the
same Newton iteration count, and a run's thinned draws within 1e-9
relative with equal accept and swap counters. At float32 an MH decision
flips on a one-ULP lnL difference, so float32 chains are held to the JAX
transitions in tests/test_torch_mcmc.py instead, and here a converged
float32 run's posterior moments to the JAX run's within their Monte-Carlo
standard error. Within the port, what the JAX tests hold bit for bit
(reruns, the real-2 and psr-2 CPU meshes, pipeline depths 0-2, checkpoint
kill and resume, and the retried segment of the chaos lanes of
tests/test_faults.py) is held in tests/test_torch_sample_runs.py, with the
CLI, on this file's fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.infer import ComponentSpec as JComp
from fakepta_tpu.infer import FreeParam as JFree
from fakepta_tpu.infer import LikelihoodSpec as JModel
from fakepta_tpu.parallel.mesh import make_mesh as jax_mesh
from fakepta_tpu.sample import SampleSpec as JSpec
from fakepta_tpu.sample import SamplingRun as JRun
from fakepta_tpu.sample import diagnostics as jdiagnostics
from fakepta_tpu.sample import run as jrun_mod
from fakepta_tpu_torch import faults
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.infer import ComponentSpec, FreeParam, LikelihoodSpec
from fakepta_tpu_torch.sample import (SAMPLE_SCHEMA, SampleSpec,
                                      SamplingRun, as_spec, diagnostics,
                                      run as run_mod)
from fakepta_tpu_torch.sample.model import SAMPLE_TAG, SWAP_TAG

TRUTH = np.array([-13.2, 13 / 3])
SPEC = dict(n_chains=8, n_temps=2, warmup=8, thin=2, n_leapfrog=3)
RUN = dict(seed=3, segment=8)
N_STEPS = 16
FAST = faults.RecoveryPolicy(backoff_s=0.001, max_backoff_s=0.01)
BATCH_KW = dict(npsr=4, ntoa=48, tspan_years=15.0, toaerr=1e-7, n_red=3,
                n_dm=3, red_log10_A=-14.5, dm_log10_A=-14.5, seed=0)


def _model(comp=ComponentSpec, free=FreeParam, spec=LikelihoodSpec):
    return spec(components=(
        comp(target="red", spectrum="batch"),
        comp(target="dm", spectrum="batch"),
        comp(target="curn", nbin=3, free=(
            free("log10_A", (-14.0, -12.4)), free("gamma", (2.0, 6.0))))))


@pytest.fixture(scope="module")
def jb():
    return JaxBatch.synthetic(**BATCH_KW, dtype=jnp.float64)


@pytest.fixture(scope="module")
def tb(jb):
    return PulsarBatch.from_numpy(
        {f.name: np.asarray(getattr(jb, f.name))
         for f in dataclasses.fields(jb)}, device="cpu")


def _study(tb, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return SamplingRun(tb, SampleSpec(model=_model(), **SPEC), mesh=mesh,
                       data_seed=1, truth=TRUTH, **kw)


@pytest.fixture(scope="module")
def jax_study(jb):
    return JRun(jb, JSpec(model=_model(JComp, JFree, JModel), **SPEC),
                mesh=jax_mesh(jax.devices()[:1]), data_seed=1, truth=TRUTH)


@pytest.fixture(scope="module")
def jax_out(jax_study):
    return jax_study.run(N_STEPS, pipeline_depth=0, **RUN)


@pytest.fixture(scope="module")
def study(tb):
    return _study(tb)


@pytest.fixture(scope="module")
def ref(study):
    """The port's 1-shard, depth-0 stream the invariance tests hold."""
    return study.run(N_STEPS, pipeline_depth=0, **RUN)


def _same(a, b):
    np.testing.assert_array_equal(a["theta"], b["theta"])
    for k in ("accept_rate_by_temp", "swap_rate", "divergences"):
        assert a["diag"].get(k) == b["diag"].get(k), k


# ---------------------------------------------------------------------------
# staging and the Laplace fit against JAX
# ---------------------------------------------------------------------------

def test_constants_and_synthesized_data_equal_jax(jb, tb, jax_study, study):
    from fakepta_tpu.sample import model as jmodel
    assert (SAMPLE_SCHEMA, SAMPLE_TAG, SWAP_TAG) == (
        jmodel.SAMPLE_SCHEMA, jmodel.SAMPLE_TAG, jmodel.SWAP_TAG)
    assert run_mod._SNAP_KEYS == jrun_mod._SNAP_KEYS
    # the same host draw from KeyStream(data_seed, "sample_data")
    np.testing.assert_allclose(study.residuals, jax_study.residuals,
                               rtol=0, atol=1e-12 * np.abs(
                                   jax_study.residuals).max())


def test_stage_moments_within_1e_12(jb, tb, jax_study, study):
    want = jrun_mod.stage_moments(jax_study.compiled, jb,
                                  jax_study.residuals)
    got = run_mod.stage_moments(study.compiled, tb, jax_study.residuals)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


def test_laplace_mode_and_factor_within_1e_9(jax_study, study):
    assert study.laplace_iters == jax_study.laplace_iters
    np.testing.assert_allclose(study.mode_v, jax_study.mode_v, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(study.chol_cov, jax_study.chol_cov, rtol=0,
                               atol=1e-9 * np.abs(jax_study.chol_cov).max())
    np.testing.assert_allclose(study.mode_theta, jax_study.mode_theta,
                               rtol=1e-9)
    v = np.array([0.3, -0.4])
    assert study.lnpost_unconstrained(v) == pytest.approx(
        jax_study.lnpost_unconstrained(v), rel=1e-12)
    np.testing.assert_allclose(study.lnpost_grad(v),
                               jax_study.lnpost_grad(v), rtol=1e-9)
    # the JAX fit feeds the port's warm start
    warm = _study(study.batch, warm_from=jax_study.laplace_state())
    assert warm.laplace_iters <= 2
    np.testing.assert_allclose(warm.mode_v, jax_study.mode_v, atol=1e-9)


def test_run_chain_for_chain_with_jax_at_float64(ref, jax_out):
    assert ref["theta"].shape == jax_out["theta"].shape == (8, 8, 2)
    assert ref["theta"].dtype == np.float64
    np.testing.assert_allclose(ref["theta"], jax_out["theta"], rtol=1e-9,
                               atol=0)
    for k in ("accept_rate_by_temp", "swap_rate", "divergences",
              "nonfinite_lnl", "n_kept"):
        assert ref["diag"][k] == jax_out["diag"][k], k
    np.testing.assert_allclose(ref["diag"]["rhat"], jax_out["diag"]["rhat"],
                               rtol=1e-9)
    assert ref["param_names"] == jax_out["param_names"]
    np.testing.assert_array_equal(ref["betas"], jax_out["betas"])
    assert set(ref) == set(jax_out)
    assert set(ref["summary"]) == set(jax_out["summary"])


#: the float32 moments run: long enough that both packages' chains converge
#: (R-hat under 1.05), one temperature, every step kept
F32_SPEC = dict(n_chains=16, n_temps=1, warmup=32, thin=1, n_leapfrog=4)
F32_STEPS = 128


def _chain_moments(theta):
    """Posterior mean and standard deviation over all kept draws of a
    (S, K, D) stream, each with its Monte-Carlo standard error from the
    spread of the K independent chains' own estimates."""
    theta = np.asarray(theta, np.float64)
    k = theta.shape[1]
    means, stds = theta.mean(0), theta.std(0)
    return (means.mean(0), means.std(0, ddof=1) / np.sqrt(k),
            stds.mean(0), stds.std(0, ddof=1) / np.sqrt(k))


def test_float32_posterior_moments_within_mc_error_of_jax():
    """The float32 sampler (the port's ln-phi Woodbury form in row groups,
    as it runs on the card) against the JAX SamplingRun at float32 on the
    same batch, spec and seeds: the chains part after a few steps, so the
    two converged runs' posterior means and standard deviations are held
    within 4 combined Monte-Carlo standard errors."""
    jb32 = JaxBatch.synthetic(**BATCH_KW)
    tb32 = PulsarBatch.from_numpy(
        {f.name: np.asarray(getattr(jb32, f.name))
         for f in dataclasses.fields(jb32)}, device="cpu")
    assert tb32.dtype == torch.float32
    want = JRun(jb32, JSpec(model=_model(JComp, JFree, JModel), **F32_SPEC),
                mesh=jax_mesh(jax.devices()[:1]), data_seed=1,
                truth=TRUTH).run(F32_STEPS, seed=3, segment=F32_STEPS,
                                 pipeline_depth=0)
    got = SamplingRun(tb32, SampleSpec(model=_model(), **F32_SPEC),
                      device="cpu", data_seed=1, truth=TRUTH).run(
        F32_STEPS, seed=3, segment=F32_STEPS, pipeline_depth=0)
    assert got["theta"].shape == want["theta"].shape == (F32_STEPS, 16, 2)
    assert not np.array_equal(got["theta"], want["theta"])
    for out in (got, want):
        assert out["diag"]["rhat_max"] < 1.05
        assert out["diag"]["divergences"] == 0
    gm, gm_se, gs, gs_se = _chain_moments(got["theta"])
    wm, wm_se, ws, ws_se = _chain_moments(want["theta"])
    assert np.all(np.abs(gm - wm) <= 4 * np.hypot(gm_se, wm_se)), (gm, wm)
    assert np.all(np.abs(gs - ws) <= 4 * np.hypot(gs_se, ws_se)), (gs, ws)


# ---------------------------------------------------------------------------
# a JAX checkpoint resumed in the port (the rest of the invariances, the
# chaos lanes and the CLI: tests/test_torch_sample_runs.py)
# ---------------------------------------------------------------------------

def test_jax_checkpoint_resumes_in_the_port(jax_study, jax_out, tb,
                                            tmp_path):
    """A checkpoint the JAX SamplingRun wrote (cut after its second
    segment) resumes in the port: the resumed stream is the uninterrupted
    JAX stream within the float64 bound, and the port leaves no files."""
    ck = tmp_path / "jax.json"

    class Stop(RuntimeError):
        pass

    def bomb(done, total):
        if done >= 16:
            raise Stop("cut")

    with pytest.raises(Stop):
        jax_study.run(N_STEPS, checkpoint=ck, pipeline_depth=0,
                      progress=bomb, **RUN)
    out = _study(tb).run(N_STEPS, checkpoint=ck, **RUN)
    np.testing.assert_allclose(out["theta"], jax_out["theta"], rtol=1e-9)
    assert out["diag"]["accept_rate_by_temp"] == \
        jax_out["diag"]["accept_rate_by_temp"]
    assert not list(tmp_path.glob("jax.json*"))


# ---------------------------------------------------------------------------
# spec validation, diagnostics, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    (dict(n_chains=1), "n_chains"), (dict(n_temps=0), "n_temps"),
    (dict(n_temps=2, max_temp=1.0), "max_temp"),
    (dict(step_size=0.0), "step_size"), (dict(n_leapfrog=0), "n_leapfrog"),
    (dict(thin=0), "thin"), (dict(swap_every=0), "swap_every"),
    (dict(warmup=-1), "warmup")])
def test_as_spec_errors_match_jax(bad, match):
    from fakepta_tpu.sample import as_spec as jas_spec
    with pytest.raises(ValueError, match=match) as got:
        as_spec(SampleSpec(model=_model(), **bad))
    with pytest.raises(ValueError) as want:
        jas_spec(JSpec(model=_model(JComp, JFree, JModel), **bad))
    assert str(got.value) == str(want.value)


def test_as_spec_types():
    assert isinstance(as_spec(_model()), SampleSpec)
    with pytest.raises(TypeError, match="SampleSpec"):
        as_spec("nope")


def test_diagnostics_equal_jax():
    rng = np.random.default_rng(5)
    k, n, d = 8, 400, 2
    draws = rng.standard_normal((n, k, d))
    draws[:, : k // 2] += 0.3
    accum = dict(n=np.int32(n), npair=np.int32(n - 1),
                 s1=draws.sum(axis=0), s2=(draws ** 2).sum(axis=0),
                 s11=(draws[1:] * draws[:-1]).sum(axis=0),
                 accept=np.array([int(0.8 * n * k), int(0.6 * n * k)]),
                 swap=np.array([40, 0]), swap_att=np.array([80, 0]),
                 divergent=np.int32(1), nonfinite=np.int32(0))
    got = diagnostics(accum, k, 2, n)
    want = jdiagnostics(accum, k, 2, n)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-12)
    assert diagnostics(dict(accum, n=np.int32(2)), k, 2, n).keys() == \
        jdiagnostics(dict(accum, n=np.int32(2)), k, 2, n).keys()


def test_closed_form_derivatives_match_autodiff(study):
    """The Laplace fit's closed-form Hessian equals ``torch.func.hessian``
    of the objective, and ``lnlike_lnphi`` (the well-conditioned form the
    chains use) equals ``lnlike_from_moments`` and its autodiff gradient in
    ln phi, to float64 roundoff; at float32 it stays finite where phi is
    tiny (the JAX form's ``1/phi^2`` overflows there)."""
    from fakepta_tpu_torch.ops import woodbury
    for v in (np.zeros(2), np.array([1.2, -0.7]), study.mode_v):
        want = torch.func.hessian(study._lnpost64)(torch.as_tensor(v))
        np.testing.assert_allclose(study._hessian(v), want.numpy(),
                                   rtol=1e-8, atol=1e-8 * float(
                                       want.abs().max()))
    m, lndet, nv, d0, dt = (torch.as_tensor(x) for x in study._mom64)
    psi = torch.log(study.compiled.phi(torch.as_tensor(study.mode_theta),
                                       study._nsb64))

    def f(ps):
        return woodbury.lnlike_from_moments(d0, dt, m, lndet, nv,
                                            torch.exp(ps)).sum()

    lnl, grad, hess = woodbury.lnlike_lnphi(m, torch.exp(psi), d0, dt,
                                            lndet, nv, order=2)
    assert float(lnl.sum()) == pytest.approx(float(f(psi)), rel=1e-12)
    want = torch.func.grad(f)(psi)
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=0,
                               atol=1e-8 * float(want.abs().max()))
    tiny = torch.exp(psi).float() * 1e-12
    l32, g32 = woodbury.lnlike_lnphi(m.float(), tiny, d0.float(),
                                     dt.float(), lndet.float(), nv.float(),
                                     order=1)
    assert torch.isfinite(l32).all() and torch.isfinite(g32).all()
    _, g_jax_form = woodbury.lnlike_and_grad_phi(
        m.float(), tiny, d0.float(), dt.float(), lndet.float(), nv.float())
    assert not torch.isfinite(g_jax_form).all()
