"""The PyTorch port's threefry key tree against jax.random.

``key``/``fold_in``/``split``/``random_bits``/``uniform`` must be bit-exact
(they are integer hashes and exact float bit casts); ``normal`` goes through
XLA's float32 erf_inv polynomial on both sides and may differ by a few ULP
of log1p/sqrt rounding (observed maximum: 3 ULP over 2**20 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu_torch.utils import rng

SEEDS = (0, 1, 3, 12345, 2 ** 31 - 1, 2 ** 40 + 7)
SHAPES = ((5,), (3, 7), (2, 4, 100))
NORMAL_MAX_ULP = 4


def _jkey(seed):
    return jax.random.key(seed)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bit_exact(seed):
    tk = rng.key(seed, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), _data(_jkey(seed)))
    for d in (0, 1, 0x51, 0x6B, 0x9C, 0xD7, 0xE1, 77777, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(tk, d).numpy(),
            _data(jax.random.fold_in(_jkey(seed), d)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (2, 6, 33))
def test_split_bit_exact(seed, num):
    np.testing.assert_array_equal(
        rng.split(rng.key(seed, device="cpu"), num).numpy(),
        _data(jax.random.split(_jkey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bit_exact(seed, shape):
    tk = rng.key(seed, device="cpu")
    bits = jax.random.bits(_jkey(seed), shape, jnp.uint32)
    np.testing.assert_array_equal(rng.random_bits(tk, shape).numpy(),
                                  np.asarray(bits).astype(np.int64))
    uni = jax.random.uniform(jax.random.fold_in(_jkey(seed), 1), shape,
                             jnp.float32)
    got = rng.uniform(rng.fold_in(tk, 1), shape).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(uni).view(np.int32))
    lo, hi = -0.75, 2.5
    uni = jax.random.uniform(jax.random.fold_in(_jkey(seed), 2), shape,
                             jnp.float32, lo, hi)
    got = rng.uniform(rng.fold_in(tk, 2), shape, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(uni).view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_ulps(seed, shape):
    want = np.asarray(jax.random.normal(_jkey(seed), shape, jnp.float32))
    got = rng.normal(rng.key(seed, device="cpu"), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _ulp_diff(got, want).max() <= NORMAL_MAX_ULP


def test_normal_tail_ulps_large_sample():
    want = np.asarray(jax.random.normal(_jkey(7), (1 << 20,), jnp.float32))
    got = rng.normal(rng.key(7, device="cpu"), (1 << 20,)).numpy()
    assert _ulp_diff(got, want).max() <= NORMAL_MAX_ULP
    # the tails (|z| > 3, the w >= 5 polynomial branch) are covered
    assert np.abs(want).max() > 4.0


def test_batched_keys_match_vmap():
    """Key batches broadcast like a vmap: per-realization fold_in, then a
    per-pulsar fold/split tree, then draws (the engine's layout)."""
    base = _jkey(3)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(4))
    jroot = jax.vmap(lambda k: jax.random.fold_in(k, 0x51))(jkeys)
    jpsr = jax.vmap(lambda k: jax.vmap(lambda g: jax.random.split(
        jax.random.fold_in(k, g), 6))(jnp.arange(5)))(jroot)
    jz = jax.vmap(jax.vmap(lambda k: jax.random.normal(k[0], (9,),
                                                       jnp.float32)))(jpsr)

    tkeys = rng.fold_in(rng.key(3, device="cpu"), torch.arange(4))
    troot = rng.fold_in(tkeys, 0x51)
    tpsr = rng.split(rng.fold_in(troot[:, None, :], torch.arange(5)), 6)
    np.testing.assert_array_equal(tpsr.numpy(), _data(jpsr))
    tz = rng.normal(tpsr[:, :, 0], 9).numpy()
    assert _ulp_diff(tz, jz).max() <= NORMAL_MAX_ULP


def test_erfinv_edges():
    x = torch.tensor([-1.0, 0.0, 1.0, 0.5, -0.999], dtype=torch.float32)
    y = rng.erfinv_f32(x)
    assert y[0] == -np.inf and y[2] == np.inf and y[1] == 0.0
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert _ulp_diff(y[3:].numpy(), want[3:]).max() <= NORMAL_MAX_ULP


def test_key_rejects_negative_seed():
    with pytest.raises(ValueError):
        rng.key(-1, device="cpu")
