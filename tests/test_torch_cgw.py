"""The PyTorch port's continuous-wave model (``models/cgw.py``) against the
JAX package's, on the CPU.

At float64 every function agrees with its JAX counterpart to
``rtol=1e-10``, the bound ``tests/test_cgw_batch_sampling.py`` holds the
batched JAX waveform to; ``psrterm_phase_bulk`` is the same numpy code and
agrees to 1e-13. At float32 (the engine's sampled path: absolute MJD-second
epochs of ~4.6e9 s, ~512 s per float32 ULP, earth-term phases of hundreds
of radians) the waveforms agree within 2e-4 of the term's scale, the JAX
package's own bound for its float32 waveforms
(``tests/test_cgw_batch_sampling.py``).
"""

import jax
import numpy as np
import pytest
import torch

from fakepta_tpu import constants as jconst
from fakepta_tpu.models import cgw as jcgw
from fakepta_tpu_torch.models import cgw as tcgw

MJD0_S = 53000.0 * 86400.0
SRC = dict(cos_gwtheta=0.21, gwphi=2.9, cos_inc=0.4, log10_mc=9.2,
           log10_fgw=-7.9, log10_h=-13.6, phase0=1.1, psi=0.7)
MODES = {"evolve": dict(evolve=True),
         "phase_approx": dict(evolve=False, phase_approx=True),
         "phase_approx_pinned": dict(evolve=False, phase_approx=True,
                                     p_phase=0.4),
         "rigid": dict(evolve=False)}
RTOL64 = 1e-10
TOL32 = 2e-4


def _pulsars(P=4, T=60, seed=5):
    r = np.random.default_rng(seed)
    toas = MJD0_S + np.sort(r.uniform(0, 10 * jconst.yr, (P, T)), axis=1)
    pos = r.standard_normal((P, 3))
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    pdist = np.column_stack([r.uniform(0.5, 1.5, P), r.uniform(0, 0.2, P)])
    return toas, pos, pdist


def _sources(S=3, seed=6):
    r = np.random.default_rng(seed)
    return dict(cos_gwtheta=r.uniform(-1, 1, S),
                gwphi=r.uniform(0, 2 * np.pi, S),
                cos_inc=r.uniform(-1, 1, S),
                log10_mc=r.uniform(8.5, 9.5, S),
                log10_fgw=r.uniform(-8.5, -7.7, S),
                log10_h=r.uniform(-14.5, -13.5, S),
                phase0=r.uniform(0, 2 * np.pi, S),
                psi=r.uniform(0, np.pi, S))


def test_antenna_pattern_matches_jax():
    _, pos, _ = _pulsars()
    src = _sources()
    for i in range(len(pos)):
        got = tcgw.antenna_pattern(torch.tensor(pos[i]), np.arccos(
            src["cos_gwtheta"]), src["gwphi"])
        want = jcgw.antenna_pattern(pos[i], np.arccos(src["cos_gwtheta"]),
                                    src["gwphi"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-14)
    # sources (S, 1) against pulsars (P, 3): (S, P)
    th = torch.tensor(np.arccos(src["cos_gwtheta"]))[:, None]
    got = tcgw.antenna_pattern(torch.tensor(pos), th,
                               torch.tensor(src["gwphi"])[:, None])
    assert got[0].shape == (3, len(pos))
    want = jcgw.antenna_pattern(pos[1], np.arccos(src["cos_gwtheta"][2]),
                                src["gwphi"][2])
    np.testing.assert_allclose(got[1][2, 1].item(), float(want[1]),
                               rtol=1e-12)


@pytest.mark.parametrize("psrterm", (False, True))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cw_delay_f64_matches_jax(mode, psrterm):
    toas, pos, pdist = _pulsars()
    for i in range(2):
        kw = dict(SRC, psrTerm=psrterm, p_dist=0.7, **MODES[mode])
        got = tcgw.cw_delay(torch.tensor(toas[i]), torch.tensor(pos[i]),
                            tuple(pdist[i]), **kw).numpy()
        want = np.asarray(jcgw.cw_delay(toas[i], pos[i], tuple(pdist[i]),
                                        **kw))
        assert np.abs(want).max() > 1e-9
        np.testing.assert_allclose(got, want, rtol=RTOL64,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("psrterm", (False, True))
def test_cw_delay_distance_mode_and_tref(psrterm):
    toas, pos, pdist = _pulsars()
    kw = dict(SRC, psrTerm=psrterm, tref=MJD0_S + 3e7)
    kw.pop("log10_h")
    got = tcgw.cw_delay(torch.tensor(toas[1]), torch.tensor(pos[1]),
                        tuple(pdist[1]), log10_dist=1.8, **kw).numpy()
    want = np.asarray(jcgw.cw_delay(toas[1], pos[1], tuple(pdist[1]),
                                    log10_dist=1.8, **kw))
    np.testing.assert_allclose(got, want, rtol=RTOL64,
                               atol=1e-12 * np.abs(want).max())
    with pytest.raises(ValueError, match="log10_dist or log10_h"):
        tcgw.cw_delay(torch.tensor(toas[1]), torch.tensor(pos[1]),
                      tuple(pdist[1]), **kw)


def test_psrterm_phase_bulk_matches_jax():
    r = np.random.default_rng(2)
    tau = r.uniform(1e10, 2e11, (5, 7))
    mc, fg = r.uniform(8.5, 9.5, (5, 1)), r.uniform(-8.5, -7.5, (5, 1))
    got = tcgw.psrterm_phase_bulk(tau, mc, fg)
    np.testing.assert_allclose(got, jcgw.psrterm_phase_bulk(tau, mc, fg),
                               rtol=1e-13, atol=1e-13)
    assert got.min() >= 0.0 and got.max() < 2 * np.pi
    # the merger clamp keeps a retarded epoch past merger finite
    assert np.isfinite(tcgw.psrterm_phase_bulk(-1e20, 9.5, -7.5))


def _split_inputs(toas, pos, pdist, pd=0.3):
    tau = (pdist[0] + pdist[1] * pd) * jconst.kpc / jconst.c * (
        1.0 - float(jcgw.antenna_pattern(pos, np.arccos(SRC["cos_gwtheta"]),
                                         SRC["gwphi"])[2]))
    return jcgw.psrterm_phase_bulk(tau, SRC["log10_mc"], SRC["log10_fgw"])


def test_cw_delay_psrterm_split_f64():
    toas, pos, pdist = _pulsars()
    t = toas[0] - MJD0_S
    bulk = _split_inputs(toas[0], pos[0], pdist[0])
    got = tcgw.cw_delay_psrterm_split(torch.tensor(t), torch.tensor(pos[0]),
                                      tuple(pdist[0]), bulk, p_dist=0.3,
                                      **SRC).numpy()
    want = np.asarray(jcgw.cw_delay_psrterm_split(
        t, pos[0], tuple(pdist[0]), bulk, p_dist=0.3, **SRC))
    np.testing.assert_allclose(got, want, rtol=RTOL64,
                               atol=1e-12 * np.abs(want).max())
    # the split is exact: the unsplit pulsar term at f64 (the bulk's mod
    # 2pi moves the phase by whole turns only)
    full = tcgw.cw_delay(torch.tensor(t), torch.tensor(pos[0]),
                         tuple(pdist[0]), psrTerm=True, p_dist=0.3,
                         **SRC).numpy()
    np.testing.assert_allclose(got, full, rtol=0,
                               atol=1e-6 * np.abs(full).max())


@pytest.mark.parametrize("psrterm", (False, True))
def test_cw_delay_batched_f64_matches_jax(psrterm):
    toas, pos, pdist = _pulsars()
    src = _sources()
    got = tcgw.cw_delay_batched(torch.tensor(toas), torch.tensor(pos),
                                torch.tensor(pdist), **src, psrTerm=psrterm,
                                evolve=True).numpy()
    want = np.asarray(jcgw.cw_delay_batched(toas, pos, pdist, **src,
                                            psrTerm=psrterm, evolve=True))
    assert got.shape == want.shape == toas.shape
    np.testing.assert_allclose(got, want, rtol=RTOL64,
                               atol=1e-12 * np.abs(want).max())
    # the sum over sources of the per-source calls
    loop = sum(tcgw.cw_delay(torch.tensor(toas[1]), torch.tensor(pos[1]),
                             tuple(pdist[1]), psrTerm=psrterm,
                             **{k: v[s] for k, v in src.items()})
               for s in range(3)).numpy()
    np.testing.assert_allclose(got[1], loop, rtol=1e-12,
                               atol=1e-14 * np.abs(loop).max())
    with pytest.raises(ValueError, match="exactly one"):
        tcgw.cw_delay_batched(toas, pos, pdist,
                              **dict(src, log10_dist=np.full(3, 2.0)))


def _f32_case(mode, psrterm):
    toas, pos, pdist = _pulsars(P=3, T=96, seed=8)
    kw = dict(SRC, psrTerm=psrterm, **MODES[mode])
    return toas, pos.astype(np.float32), pdist.astype(np.float32), kw


@pytest.mark.parametrize("mode", ("evolve", "phase_approx", "rigid"))
@pytest.mark.parametrize("tref", ("zero", "mid"))
def test_cw_delay_f32_within_bound(mode, tref):
    """float32 earth-term waveforms at epochs relative to ``tref``: 0
    (absolute epochs, the sampled path's condition in ``ipta_dr3``) or
    mid-span. The port stays within 2e-4 of the float64 waveform's scale,
    and no farther from it than the JAX function at float32 is (beyond
    2e-5 of the scale): at tref = 0 the JAX function's float32 ``pow``
    moves it by ~1e-3 of the scale. (At float32 the pulsar term goes
    through :func:`cw_delay_psrterm_split`, below, in both packages.)"""
    toas, pos, pdist, kw = _f32_case(mode, False)
    t0 = 0.0 if tref == "zero" else MJD0_S + 5 * jconst.yr
    f32 = {k: (np.float32(v) if isinstance(v, float) else v)
           for k, v in kw.items()}
    for i in range(len(toas)):
        t = (toas[i] - t0).astype(np.float32)
        truth = np.asarray(jcgw.cw_delay(t.astype(np.float64),
                                         pos[i].astype(np.float64),
                                         tuple(pdist[i].astype(np.float64)),
                                         **kw))
        got = tcgw.cw_delay(torch.tensor(t), torch.tensor(pos[i]),
                            tuple(torch.tensor(pdist[i])), **f32)
        assert got.dtype == torch.float32
        jax32 = np.asarray(jax.jit(lambda tt, p, d: jcgw.cw_delay(
            tt, p, (d[0], d[1]), **f32))(t, pos[i], pdist[i]))
        assert jax32.dtype == np.float32
        scale = np.abs(truth).max()
        err = np.abs(got.numpy() - truth).max()
        assert err <= TOL32 * scale, err / scale
        assert err <= max(np.abs(jax32 - truth).max(), 2e-5 * scale)


def test_split_and_batched_f32_within_bound_of_jax():
    toas, pos, pdist = _pulsars(P=3, T=96, seed=8)
    t = (toas - MJD0_S).astype(np.float32)
    bulk = np.float32(_split_inputs(toas[0], pos[0], pdist[0]))
    src32 = {k: np.float32(v) for k, v in SRC.items()}
    got = tcgw.cw_delay_psrterm_split(
        torch.tensor(t[0]), torch.tensor(pos[0], dtype=torch.float32),
        tuple(torch.tensor(pdist[0], dtype=torch.float32)),
        torch.tensor(bulk), p_dist=np.float32(0.3), **src32).numpy()
    want = np.asarray(jax.jit(lambda tt, p, d, b: jcgw.cw_delay_psrterm_split(
        tt, p, (d[0], d[1]), b, p_dist=np.float32(0.3), **src32))(
        t[0], pos[0].astype(np.float32), pdist[0].astype(np.float32), bulk))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL32 * np.abs(want).max())
    src = {k: v.astype(np.float32) for k, v in _sources().items()}
    got = tcgw.cw_delay_batched(torch.tensor(t), torch.tensor(
        pos, dtype=torch.float32), torch.tensor(pdist, dtype=torch.float32),
        **src).numpy()
    want = np.asarray(jax.jit(lambda tt, p, d: jcgw.cw_delay_batched(
        tt, p, d, **src))(t, pos.astype(np.float32),
                          pdist.astype(np.float32)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL32 * np.abs(want).max())


def test_per_realization_sources_broadcast():
    """(R, 1) source parameters against (P, 3) pulsars and (P, T) epochs
    give (R, P, T), each realization its own call's waveform bit for bit
    at float64."""
    toas, pos, pdist = _pulsars()
    src = _sources(S=5, seed=11)
    col = {k: torch.tensor(v)[:, None] for k, v in src.items()}
    pd = torch.tensor(np.random.default_rng(1).normal(size=(5, 4)))
    got = tcgw.cw_delay(torch.tensor(toas - MJD0_S), torch.tensor(pos),
                        (torch.tensor(pdist[:, 0]), torch.tensor(pdist[:, 1])),
                        psrTerm=True, p_dist=pd, **col)
    assert got.shape == (5, 4, toas.shape[1])
    for r in range(5):
        for i in range(4):
            one = tcgw.cw_delay(torch.tensor(toas[i] - MJD0_S),
                                torch.tensor(pos[i]), tuple(pdist[i]),
                                psrTerm=True, p_dist=float(pd[r, i]),
                                **{k: float(v[r]) for k, v in src.items()})
            np.testing.assert_allclose(got[r, i].numpy(), one.numpy(),
                                       rtol=1e-13,
                                       atol=1e-15 * one.abs().max().item())
