"""The PyTorch port's batch, bases, spectra and ORFs against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu import spectrum as jspec
from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.batch import fourier_basis_norm as jax_basis
from fakepta_tpu.ops import gwb as jgwb
from fakepta_tpu.scenarios import registry as jreg
from fakepta_tpu_torch import spectrum as tspec
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.batch import fourier_basis_norm
from fakepta_tpu_torch.ops import gwb as tgwb
from fakepta_tpu_torch.scenarios import registry as treg

SYNTH = (dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=4,
              n_dm=4, seed=1),
         dict(npsr=6, ntoa=40, n_red=5, n_dm=3, n_chrom=4,
              chrom_log10_A=-14.2, seed=4))


def _leaves(jb):
    return {f.name: np.asarray(getattr(jb, f.name))
            for f in dataclasses.fields(jb)}


def _assert_same_leaves(tb, jb):
    for name, want in _leaves(jb).items():
        got = getattr(tb, name).numpy()
        assert got.shape == want.shape, name
        assert got.dtype.kind == want.dtype.kind, name
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kw", SYNTH)
def test_synthetic_leaves_bit_identical(kw):
    _assert_same_leaves(PulsarBatch.synthetic(**kw, device="cpu"),
                        JaxBatch.synthetic(**kw))


def test_flagship_batch_bit_identical():
    tb = treg.flagship_batch(device="cpu")
    assert (tb.npsr, tb.max_toa) == (100, 780)
    _assert_same_leaves(tb, jreg.flagship_batch())


def test_from_numpy_round_trips_a_jax_batch():
    jb = JaxBatch.synthetic(**SYNTH[1])
    tb = PulsarBatch.from_numpy(_leaves(jb), device="cpu")
    _assert_same_leaves(tb, jb)
    assert tb.mask.dtype == torch.bool and tb.epoch_idx.dtype == torch.int64
    back = tb.numpy()
    for name, want in _leaves(jb).items():
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    with pytest.raises(KeyError):
        PulsarBatch.from_numpy({"t_own": back["t_own"]}, device="cpu")


def test_to_moves_every_leaf():
    tb = PulsarBatch.synthetic(**SYNTH[0], device="cpu").to("cpu")
    for f in dataclasses.fields(tb):
        assert getattr(tb, f.name).device.type == "cpu"


@pytest.mark.parametrize("nbin,offset", [(4, 0), (30, 0), (100, 0), (6, 3)])
def test_fourier_basis_norm(nbin, offset):
    jb = JaxBatch.synthetic(**SYNTH[0])
    tb = PulsarBatch.synthetic(**SYNTH[0], device="cpu")
    scale_j = (1400.0 / (jb.freqs * 0.7)) ** 2
    scale_t = (1400.0 / (tb.freqs * 0.7)) ** 2
    want = np.asarray(jax_basis(jb.t_own, nbin, scale=scale_j,
                                bin_offset=offset))
    got = fourier_basis_norm(tb.t_own, nbin, scale=scale_t,
                             bin_offset=offset).numpy()
    assert got.shape == want.shape == (8, 64, 2, nbin)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("powerlaw", dict(log10_A=-14.3, gamma=3.7)),
    ("turnover", dict(log10_A=-14.0, gamma=4.0, lf0=-8.4)),
    ("t_process", dict(log10_A=-14.1, alphas=np.linspace(0.5, 2.0, 12))),
    ("t_process_adapt", dict(alphas_adapt=3.0, nfreq=4.0)),
    ("turnover_knee", dict(log10_A=-14.5)),
    ("broken_powerlaw", dict(log10_A=-14.2, delta=0.3)),
    ("free_spectrum", dict(log10_rho=np.linspace(-7.0, -8.0, 12))),
])
def test_spectra_match_host_f64(name, kwargs):
    f = np.arange(1, 13) / (12.5 * 3.15576e7)
    want = np.asarray(jspec.evaluate(name, jnp.asarray(f), **kwargs))
    got = tspec.evaluate_host(name, f, **kwargs)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert set(tspec.SPECTRA) == set(jspec.SPECTRA)
    assert tspec.spec_params[name] == jspec.spec_params[name]


@pytest.mark.parametrize("orf", ["hd", "dipole", "monopole", "curn"])
def test_orfs_and_cholesky_host_f64(orf):
    pos = np.asarray(JaxBatch.synthetic(**SYNTH[0]).pos, dtype=np.float64)
    want = np.asarray(jgwb.build_orf(orf, pos))
    got = tgwb.build_orf(orf, torch.as_tensor(pos))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    try:
        want_chol = np.asarray(jgwb.orf_cholesky(want))
    except np.linalg.LinAlgError:
        # a rank-deficient ORF the jitter cannot rescue fails the same way
        with pytest.raises(np.linalg.LinAlgError):
            tgwb.orf_cholesky(got)
        return
    np.testing.assert_allclose(tgwb.orf_cholesky(got), want_chol,
                               rtol=0, atol=1e-12)


def test_build_orf_rejects_what_it_lacks():
    pos = np.eye(3)
    with pytest.raises(ValueError, match="h_map"):
        tgwb.build_orf("anisotropic", pos)
    with pytest.raises(KeyError):
        tgwb.build_orf("quadrupole", pos)
