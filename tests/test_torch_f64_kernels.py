"""The port's kernel paths on a float64 batch, against the JAX package on
the CPU.

The kernels' plain versions at float64 (what the wrappers run on a CPU
tensor, and what the card's kernels are held to) and the float64 engine on
``stat_path="fused"`` and ``"mega"``. Inputs are made with numpy from a
seed. Bounds:

- #1 (``binned_correlation``) at float64 against the JAX kernel on the same
  float64 rows in interpret mode, shared and PL < PF: within ``F32_TOL``
  (1e-6) of the curve scale at ``'f32'`` (both round each pair sum and each
  slot's sum to float32) and ``BF16_TOL`` (1e-5) at ``'bf16'`` (float32 sums
  of the same bf16 products in another order). The curves are float32 in
  both. ``mxu_binning=False`` raises at float64 in both.
- #3/#4 (``chunk_stats``) at float64 against tests/test_megakernel.py's
  dense numpy-float64 recomputation on its inputs (R 4, P 6, T 48, three
  stages), on both operand sets: rtol 1e-13 with atol 1e-13 of the largest
  value, that test's own bound. Under bf16 storage the JAX kernel's compute
  type is float32 but its float64 tables promote the phase and the basis,
  which its float32 product rounds: the port's basis against a numpy oracle
  of that flow within a float32 ULP, its residuals within ``F32_TOL`` of
  their scale, and the statistic within the bf16 bound ``BF16_ENGINE_TOL``
  (1e-2, the engine's).
- The float64 engine on ``fused`` against the JAX engine's
  ``use_pallas=True`` at float64 (``pallas_precision='f32'``), on one device
  and on a psr-2 mesh of ``["cpu"] * 8`` with the OS lane and its null
  stream: curves and autos within ``F32_TOL``, float32 in both; amp2 and
  null amp2 within ``F32_TOL`` of max |amp2|, float64 in both.
- The float64 engine on ``mega`` against the JAX XLA float64 engine within
  1e-6 of the curve scale (tests/test_megakernel.py's engine-level bound:
  the XLA path rounds its pair sums to float32, the megakernel does not),
  float64 curves, on one device and a psr-2 mesh; its likelihood lane
  within rtol 1e-9 (tests/test_megakernel.py::test_mega_lnlike_lane's).
- ``model_bytes_per_chunk`` equal to the JAX engine's at float64 on both
  kernel paths and under bf16 storage; ``mega -> fused`` and ``bf16 ->
  f32`` recovery at float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.ops.pallas_kernels import binned_correlation as jax_bc
from fakepta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fakepta_tpu_torch import faults
from fakepta_tpu_torch import infer as tinfer
from fakepta_tpu_torch.detect import OSSpec
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.ops import megakernel as mk
from fakepta_tpu_torch.parallel.mesh import make_mesh
from test_torch_f64_engine import (CPU8, R, SEED, JaxOSSpec, _curn,
                                   _jax_sim, _port_sim, _THETA, jinfer)

F32_TOL = 1e-6
BF16_TOL = 1e-5
BF16_ENGINE_TOL = 1e-2
MEGA_TOL = 1e-6
ORACLE_RTOL = 1e-13
LNL_RTOL = 1e-9
ORFS = ("hd", "dipole")


def _scale_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# -- #1 at float64 ---------------------------------------------------------------

K1_R, K1_P, K1_T, K1_NB = 4, 8, 100, 6
K1_PL = 3       # a psr shard's rows against the whole array


@pytest.fixture(scope="module")
def k1_inputs():
    rng = np.random.default_rng(11)
    res = rng.standard_normal((K1_R, K1_P, K1_T)) * 1e-6
    w = rng.standard_normal((K1_NB + 1, K1_P, K1_P))
    return {"shared": (res, res, w),
            "local": (res[:, :K1_PL].copy(), res, w[:, :K1_PL].copy())}


@pytest.fixture(scope="module")
def k1_jax(k1_inputs):
    """The JAX kernel (interpret mode) on each layout and precision."""
    out = {}
    for layout, (a, b, w) in k1_inputs.items():
        for prec in ("f32", "bf16"):
            c, au = jax_bc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                           nbins=K1_NB, rt=1, interpret=True,
                           precision=prec)
            out[(layout, prec)] = (np.asarray(c), np.asarray(au))
    return out


@pytest.mark.parametrize("layout", ["shared", "local"])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_plain_k1_f64_matches_the_jax_kernel(k1_inputs, k1_jax, layout,
                                             prec):
    a, b, w = (torch.from_numpy(x) for x in k1_inputs[layout])
    got = bc.binned_correlation(a, b, w, K1_NB, precision=prec)
    want = k1_jax[(layout, prec)]
    assert want[0].dtype == np.float32
    assert got[0].dtype == got[1].dtype == torch.float32
    tol = F32_TOL if prec == "f32" else BF16_TOL
    _scale_close(np.concatenate([got[0].numpy(), got[1].numpy()[:, None]], 1),
                 np.concatenate([want[0], want[1][:, None]], 1), tol,
                 f"{layout} {prec}")


def test_mxu_binning_false_refuses_float64_as_jax_raises(k1_inputs):
    a, b, w = k1_inputs["shared"]
    with pytest.raises((TypeError, ValueError)):
        jax_bc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w), nbins=K1_NB,
               rt=1, interpret=True, precision="f32", mxu_binning=False)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    with pytest.raises(ValueError, match="float64"):
        bc.binned_correlation_vpu(ta, ta, tw, K1_NB, precision="f32")


def test_bf16_rounding_of_float64_is_one_rounding():
    """The port rounds a float64 residual to bf16 as the JAX kernel's
    ``astype(jnp.bfloat16)`` does, value for value: one round to nearest
    even of its float32 value. Values within 2^-24 of a bf16 tie land on
    the tie in float32 and go to even (1 + 2^-8 + 2^-30 to 1, 1 + 2^-7 +
    2^-8 - 2^-30 to 1 + 2^-6), where a direct rounding would not."""
    ties = np.array([1 + 2**-8 + 2**-30, 1 + 2**-8 - 2**-30,
                     1 + 2**-7 + 2**-8 - 2**-30, 1 + 2**-7 + 2**-8 + 2**-30,
                     1 + 2**-8, 1 + 3 * 2**-8, -2.5e-6, 0.0, -0.0])
    x = np.concatenate([ties, -ties,
                        np.random.default_rng(3).standard_normal(4096)])
    got = bc.round_bf16(torch.from_numpy(x).float())
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))
    assert got.tolist()[:4] == [1.0, 1.0, 1 + 2**-6, 1 + 2**-6]


# -- #3/#4 at float64 ------------------------------------------------------------

def _oracle_inputs():
    """tests/test_megakernel.py::test_mega_f64_oracle's inputs."""
    rng = np.random.default_rng(5)
    R_, P, T, nbins = 4, 6, 48, 5
    stages = (mk.MegaStage(4, mk.T_OWN, 0), mk.MegaStage(3, mk.T_OWN, 1),
              mk.MegaStage(4, mk.T_COMMON, 0))
    K = mk.stage_k(stages)
    t_own = np.tile(np.linspace(0.0, 1.0, T), (P, 1))
    times = np.stack([t_own, t_own])
    mask = np.ones((P, T))
    mask[:, -5:] = 0.0
    scales = np.stack([mask, mask * 1.7])
    base = rng.standard_normal((R_, P, T)) * mask[None]
    coef = rng.standard_normal((R_, P, K))
    w = rng.standard_normal((nbins + 1, P, P))
    return stages, nbins, base, coef, times, scales, w


def _oracle_basis(stages, times, scales, two_pi=2.0 * np.pi):
    """tests/test_megakernel.py's dense numpy-float64 basis."""
    P, T = times.shape[1:]
    blocks = []
    for st in stages:
        n = np.arange(1, st.nbin + 1)
        ph = two_pi * times[st.tcol][:, :, None] * n
        b = np.stack([np.cos(ph), np.sin(ph)], axis=2)     # (P, T, 2, N)
        blocks.append((b * scales[st.scol][:, :, None, None])
                      .reshape(P, T, 2 * st.nbin))
    return np.concatenate(blocks, axis=-1)                 # (P, T, K)


def _local_kw(pl, base, coef, times, scales):
    return dict(base_local=base[:, :pl].contiguous(),
                coef_local=coef[:, :pl].contiguous(),
                times_local=times[:, :pl].contiguous(),
                scales_local=scales[:, :pl].contiguous())


@pytest.mark.parametrize("pl", [6, 2])
def test_plain_k2_f64_matches_the_numpy_oracle(pl):
    """The float64 chunk_stats (its plain version, as the wrapper runs it
    on the CPU) against the dense numpy-float64 recomputation; pl < 6 is
    the local+full set. Float64 curves and autos."""
    stages, nbins, base, coef, times, scales, w = _oracle_inputs()
    basis = _oracle_basis(stages, times, scales)
    res = base + np.einsum("ptk,rpk->rpt", basis, coef)
    want = np.einsum("rpq,npq->rn",
                     np.einsum("rpt,rqt->rpq", res[:, :pl], res), w[:, :pl])
    t = [torch.from_numpy(x) for x in (base, coef, times, scales)]
    kw = _local_kw(pl, *t) if pl < 6 else {}
    curves, autos = mk.chunk_stats(*t, torch.from_numpy(w[:, :pl].copy()),
                                   stages=stages, nbins=nbins,
                                   precision="f32", **kw)
    assert curves.dtype == autos.dtype == torch.float64
    got = np.concatenate([curves.numpy(), autos.numpy()[:, None]], axis=1)
    np.testing.assert_allclose(got, want, rtol=ORACLE_RTOL,
                               atol=ORACLE_RTOL * np.abs(want).max())


def test_plain_k2_bf16_storage_follows_the_jax_dtype_flow():
    """bf16 storage on float64 tables: the JAX kernel's cdtype is float32,
    2 pi is rounded to it, the float64 tables promote the phase and the
    basis to float64, the float32 product rounds the basis to float32, the
    residuals and the statistic are float32 (a numpy oracle of that flow;
    its float32 sums run in another order)."""
    stages, nbins, base, coef, times, scales, w = _oracle_inputs()
    base16 = torch.from_numpy(base).to(torch.bfloat16)
    coef16 = torch.from_numpy(coef * 1e-1).to(torch.bfloat16)
    t64, s64 = torch.from_numpy(times), torch.from_numpy(scales)
    basis = _oracle_basis(stages, times, scales,
                          two_pi=float(np.float32(2 * np.pi)))
    basis32 = basis.astype(np.float32)
    got_basis = mk.basis_f32(t64, s64, stages)
    assert got_basis.dtype == torch.float32
    np.testing.assert_allclose(got_basis.numpy(), basis32, rtol=0,
                               atol=2.0 ** -22)
    # the float32 phase's basis is visibly off the flow's
    off = mk.basis_f32(t64.float(), s64.float(), stages).numpy()
    assert np.abs(off - basis32).max() > 2.0 ** -20
    res = (base16.float().numpy()
           + np.einsum("ptk,rpk->rpt", basis32, coef16.float().numpy()))
    got_res = mk.project_plain(base16, coef16, t64, s64, stages)
    assert got_res.dtype == torch.float32
    _scale_close(got_res.numpy(), res, F32_TOL, "residuals")
    rb = torch.from_numpy(res).to(torch.bfloat16).float().numpy()
    want = np.einsum("rpq,npq->rn", np.einsum("rpt,rqt->rpq", rb, rb),
                     w.astype(np.float32))
    curves, autos = mk.chunk_stats(base16, coef16, t64, s64,
                                   torch.from_numpy(w), stages=stages,
                                   nbins=nbins, precision="bf16")
    assert curves.dtype == torch.float32
    got = np.concatenate([curves.numpy(), autos.numpy()[:, None]], axis=1)
    _scale_close(got, want, BF16_ENGINE_TOL, "bf16 storage")


def test_chunk_stats_f64_operand_rules():
    stages, nbins, base, coef, times, scales, w = _oracle_inputs()
    t = [torch.from_numpy(x) for x in (base, coef, times, scales)]
    tw = torch.from_numpy(w)
    with pytest.raises(ValueError, match="float64 base"):
        mk.chunk_stats(*t, tw, stages=stages, nbins=nbins, precision="bf16")
    with pytest.raises(ValueError, match="float64 base"):
        mk.chunk_stats(t[0], t[1], t[2].float(), t[3].float(), tw,
                       stages=stages, nbins=nbins)


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f64():
    """The JAX engine's float64 runs: the fused kernel (interpret mode,
    'f32') on one device and, with the OS lane and its null stream, on a
    psr-2 mesh; the XLA path on one device and a psr-2 mesh, and its
    likelihood lane."""
    psr2 = jax_make_mesh(jax.devices(), psr_shards=2)
    fused = dict(use_pallas=True, pallas_precision="f32")
    lnl = jinfer.InferSpec(model=_curn(jinfer), theta=_THETA, mode="lnlike")
    xla = _jax_sim()
    return {
        "fused_one": _jax_sim(**fused).run(R, seed=SEED, chunk=R),
        "fused_psr2_os": _jax_sim(psr2, **fused).run(
            R, seed=SEED, chunk=R, os=JaxOSSpec(orf=ORFS, null=True)),
        "xla_one": xla.run(R, seed=SEED, chunk=R),
        "xla_psr2": _jax_sim(psr2).run(R, seed=SEED, chunk=R),
        "xla_lnlike": xla.run(R, seed=SEED, chunk=R, lnlike=lnl),
        "sim": xla, "fused_sim": _jax_sim(**fused),
    }


def _stats_close(got, want, tol, what):
    assert got["curves"].dtype == want["curves"].dtype, what
    assert got["autos"].dtype == want["autos"].dtype, what
    _scale_close(got["curves"], want["curves"], tol, what)
    np.testing.assert_allclose(got["autos"], want["autos"], rtol=tol,
                               err_msg=what)


def test_fused_f64_matches_the_jax_kernel_engine(jax_f64):
    sim = _port_sim(stat_path="fused", pallas_precision="f32")
    out = sim.run(R, seed=SEED, chunk=R)
    assert out["statistic_path"] == "fused" and out["precision"] == "f32"
    assert out["curves"].dtype == np.float32
    _stats_close(out, jax_f64["fused_one"], F32_TOL, "one device")


def test_fused_f64_psr2_os_lane_matches_the_jax_kernel_engine(jax_f64):
    want = jax_f64["fused_psr2_os"]
    sim = _port_sim(stat_path="fused", pallas_precision="f32",
                    mesh=make_mesh(CPU8, psr_shards=2))
    out = sim.run(R, seed=SEED, chunk=R, os=OSSpec(orf=ORFS, null=True))
    _stats_close(out, want, F32_TOL, "psr2 os")
    for orf in ORFS:
        got, ref = out["os"]["stats"][orf], want["os"]["stats"][orf]
        scale = np.abs(ref["amp2"]).max()
        for key in ("amp2", "null_amp2"):
            assert got[key].dtype == ref[key].dtype == np.float64
            np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                       atol=F32_TOL * scale,
                                       err_msg=f"{orf} {key}")


@pytest.mark.parametrize("mesh", ["one", "psr2"])
def test_mega_f64_matches_the_jax_xla_engine(jax_f64, mesh):
    kw = {} if mesh == "one" else dict(mesh=make_mesh(CPU8, psr_shards=2))
    out = _port_sim(stat_path="mega", **kw).run(R, seed=SEED, chunk=R)
    assert out["statistic_path"] == "mega"
    assert out["curves"].dtype == out["autos"].dtype == np.float64
    _stats_close(out, jax_f64[f"xla_{mesh}"], MEGA_TOL, mesh)


def test_mega_f64_bf16_storage_within_the_bf16_bound(jax_f64):
    out = _port_sim(stat_path="mega").run(R, seed=SEED, chunk=R,
                                          precision="bf16")
    assert out["curves"].dtype == np.float64
    _stats_close(out, jax_f64["xla_one"], BF16_ENGINE_TOL, "bf16 storage")


def test_mega_f64_likelihood_lane_matches_jax(jax_f64):
    want = jax_f64["xla_lnlike"]
    out = _port_sim(stat_path="mega").run(
        R, seed=SEED, chunk=R, lnlike=tinfer.InferSpec(
            model=_curn(tinfer), theta=_THETA, mode="lnlike"))
    assert out["curves"].dtype == np.float64
    np.testing.assert_allclose(out["lnlike"]["lnl"], want["lnlike"]["lnl"],
                               rtol=LNL_RTOL)
    _scale_close(out["curves"], want["curves"], MEGA_TOL, "lnlike curves")


@pytest.mark.parametrize("path,prec", [("fused", None), ("mega", "f32"),
                                       ("mega", "bf16")])
def test_model_bytes_match_jax_at_float64(jax_f64, path, prec):
    jsim = jax_f64["fused_sim" if path == "fused" else "sim"]
    jpath = {"fused": "fused", "mega": "mega"}[path]
    sim = _port_sim(stat_path=path)
    for chunk in (8, 1024):
        want = jsim.model_bytes_per_chunk(chunk, jpath, prec)
        assert sim.model_bytes_per_chunk(chunk, path, prec) == want
        assert want == mk.chunk_bytes_model(
            chunk, 8, 64, mk.stage_k(sim._mega_tables[0]),
            mode=path if prec != "bf16" else "mega_bf16", dtype_bytes=8)


def test_mega_to_fused_recovery_at_float64(jax_f64):
    """A kernel failure on chunk 1 steps mega -> fused at float64: the
    fused chunks' float32 curves join the mega chunks' float64 ones, all
    within the fused bound of the JAX XLA run."""
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "degrade", at=(1,))])
    with faults.inject(plan):
        out = _port_sim(stat_path="mega").run(2 * R, seed=SEED, chunk=R // 2,
                                              precision="f32")
    assert out["statistic_path"] == "fused"
    assert out["report"].meta["degraded_path"] == "fused"
    assert out["curves"].dtype == np.float64
    _scale_close(out["curves"][:R], jax_f64["xla_one"]["curves"], MEGA_TOL,
                 "recovered")


def test_bf16_to_f32_recovery_at_float64(jax_f64):
    plan = faults.FaultPlan(
        [faults.FaultSpec("mc.dispatch", "precision", at=(0,))])
    with faults.inject(plan):
        out = _port_sim(stat_path="fused", pallas_precision="bf16").run(
            R, seed=SEED, chunk=R)
    assert out["precision"] == "f32"
    _stats_close(out, jax_f64["fused_one"], F32_TOL, "bf16 -> f32")
