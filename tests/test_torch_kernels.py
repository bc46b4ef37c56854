"""The PyTorch port's two statistic kernels and their plain versions.

On the CPU the wrappers run the plain torch versions, which are held here
against the JAX package's Pallas kernels (interpret mode, float32 inputs)
and a dense numpy-float64 oracle. The CUDA kernels themselves run only on
a card: tests/test_torch_cuda.py compares each with its plain version
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.ops.megakernel import chunk_stats as jax_chunk_stats
from fakepta_tpu.ops.pallas_kernels import binned_correlation as jax_binned
from fakepta_tpu_torch.ops import binned_corr as bc
from fakepta_tpu_torch.ops import megakernel as mk
from fakepta_tpu_torch.ops.megakernel import T_COMMON, T_OWN, MegaStage

TOL = {"f32": 1e-5, "bf16": 1e-2}
STAGES = (MegaStage(4, T_OWN, 0), MegaStage(3, T_OWN, 1),
          MegaStage(4, T_COMMON, 0))


def _res(seed, R=4, P=8, T=64):
    return np.random.default_rng(seed).standard_normal(
        (R, P, T)).astype(np.float32)


def _assert_close(got, want, prec):
    (gc, ga), (wc, wa) = got, want
    gc, ga, wc, wa = (np.asarray(x, np.float64) for x in (gc, ga, wc, wa))
    scale = np.abs(np.concatenate([wc.ravel(), wa.ravel()])).max()
    np.testing.assert_allclose(gc, wc, rtol=0, atol=TOL[prec] * scale)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=TOL[prec] * scale)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("p_local", [8, 4])
def test_binned_correlation_plain_matches_pallas(prec, p_local):
    """nbins angular bins + n_os OS slots + the auto slot; the local rows
    are all pulsars (the single-device path) or a leading subset."""
    res = _res(1)
    nbins, n_os = 5, 2
    w = np.random.default_rng(2).standard_normal(
        (nbins + n_os + 1, p_local, res.shape[1])).astype(np.float32)
    res_l = res[:, :p_local]
    want = jax_binned(jnp.asarray(res_l), jnp.asarray(res), jnp.asarray(w),
                      nbins=nbins + n_os, rt=2, interpret=True,
                      precision=prec)
    got = bc.binned_correlation_plain(torch.tensor(res_l), torch.tensor(res),
                                      torch.tensor(w), nbins + n_os,
                                      precision=prec)
    assert got[0].shape == (4, nbins + n_os) and got[1].shape == (4,)
    _assert_close([g.numpy() for g in got], want, prec)


def _mega_inputs(seed=5, R=4, P=6, T=48, nbins=5):
    """The dense oracle's inputs (tests/test_megakernel.py's f64 oracle)."""
    rng = np.random.default_rng(seed)
    K = mk.stage_k(STAGES)
    t_own = np.tile(np.linspace(0.0, 1.0, T), (P, 1))
    times = np.stack([t_own, t_own])
    mask = np.ones((P, T))
    mask[:, -5:] = 0.0
    scales = np.stack([mask, mask * 1.7])
    base = rng.standard_normal((R, P, T)) * mask[None]
    coef = rng.standard_normal((R, P, K))
    w = rng.standard_normal((nbins + 1, P, P))
    return base, coef, times, scales, w


def _dense_oracle(base, coef, times, scales, w):
    P, T = times.shape[1:]
    blocks = []
    for st in STAGES:
        n = np.arange(1, st.nbin + 1)
        ph = 2.0 * np.pi * times[st.tcol][:, :, None] * n
        b = np.stack([np.cos(ph), np.sin(ph)], axis=2)     # (P, T, 2, N)
        blocks.append((b * scales[st.scol][:, :, None, None])
                      .reshape(P, T, 2 * st.nbin))
    basis = np.concatenate(blocks, axis=-1)                # (P, T, K)
    res = base + np.einsum("ptk,rpk->rpt", basis, coef)
    want = np.einsum("rpt,rqt->rpq", res, res)
    want = np.einsum("rpq,npq->rn", want, w)
    return want[:, :-1], want[:, -1]


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_stats_plain_matches_dense_f64_oracle(prec):
    """f32: the f32 rounding of the inputs is the whole difference. bf16:
    base and coefficients stored in bfloat16, correlation operands rounded
    to bf16, projection at f32 (the oracle sees the stored values)."""
    base, coef, times, scales, w = _mega_inputs()
    dt = torch.float32 if prec == "f32" else torch.bfloat16
    tb, tc = torch.tensor(base).to(dt), torch.tensor(coef).to(dt)
    got = mk.chunk_stats_plain(tb, tc, torch.tensor(times).float(),
                               torch.tensor(scales).float(),
                               torch.tensor(w).float(), stages=STAGES,
                               nbins=5, precision=prec)
    want = _dense_oracle(tb.double().numpy(), tc.double().numpy(), times,
                         scales, w)
    _assert_close([g.numpy() for g in got], want, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_chunk_stats_plain_matches_pallas_without_stages(prec):
    """chunk_stats(stages=()) is the configuration the JAX megakernel still
    traces: base-only residuals through correlation and binning."""
    base, _, times, scales, w = (x.astype(np.float32)
                                 for x in _mega_inputs(seed=6))
    want = jax_chunk_stats(None, jnp.asarray(base), None, None, None,
                           jnp.asarray(times), None, jnp.asarray(scales),
                           jnp.asarray(w), stages=(), nbins=5, rt=2,
                           interpret=True, precision=prec)
    got = mk.chunk_stats_plain(torch.tensor(base), None, torch.tensor(times),
                               torch.tensor(scales), torch.tensor(w),
                               stages=(), nbins=5, precision=prec)
    _assert_close([g.numpy() for g in got], want, prec)


def test_wrappers_take_the_plain_path_on_cpu():
    res = torch.tensor(_res(3))
    w = torch.randn(6, 8, 8, generator=torch.Generator().manual_seed(0))
    before = (bc.launches, mk.launches)
    for prec in ("f32", "bf16"):
        got = bc.binned_correlation(res, res, w, 5, precision=prec)
        want = bc.binned_correlation_plain(res, res, w, 5, precision=prec)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    base, coef, times, scales, wm = (torch.tensor(x).float()
                                     for x in _mega_inputs())
    got = mk.chunk_stats(base, coef, times, scales, wm, stages=STAGES,
                         nbins=5)
    want = mk.chunk_stats_plain(base, coef, times, scales, wm,
                                stages=STAGES, nbins=5)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert (bc.launches, mk.launches) == before
    with pytest.raises(ValueError):
        bc.binned_correlation(res, res, w, 5, precision="f16")
    with pytest.raises(ValueError):
        mk.chunk_stats(base, coef, times, scales, wm, stages=STAGES,
                       nbins=5, precision="tf32")


def test_chunk_bytes_model_matches_jax():
    from fakepta_tpu.ops.megakernel import chunk_bytes_model as jax_model
    for mode in ("xla", "fused", "mega", "mega_bf16"):
        for shards in (1, 4):
            args = (1024, 100, 780, 320)
            assert mk.chunk_bytes_model(*args, mode=mode,
                                        psr_shards=shards) == \
                jax_model(*args, mode=mode, psr_shards=shards)
