"""#1's 'bf16' mode on float64 rows, against the JAX kernel on the CPU, on
residuals built to sit next to bf16 ties.

The JAX kernel rounds a float64 row to bf16 with ``astype(jnp.bfloat16)``,
which XLA computes through float32. A value within 2^-24 (relative) of a
bf16 tie lands on the tie in float32 and then rounds to even, where a
direct float64 -> bf16 rounding goes to the nearer side. Random normals
almost never fall there, so these rows are built to: most values are a
bf16 tie moved by 2^-30 of itself, to either side. The port's plain
``binned_correlation`` (what the wrapper runs on a CPU tensor, and what
the card's kernel is held to) must then agree with the JAX kernel in
interpret mode within 1e-6 of the curve scale, on the shared set and on a
psr shard's rows (PL < PF): float32 sums of the same bf16 products in
another order, binned against the same weights. A rounding that differs
by one bf16 ULP on half the values moves the curves by ~1e-3 of their
scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.ops.pallas_kernels import binned_correlation as jax_bc
from fakepta_tpu_torch.ops import binned_corr as bc

R, P, T, NB = 4, 8, 64, 6
PL = 3          # a psr shard's rows against the whole array
TOL = 1e-6
NEAR = 2.0 ** -30


def tie_adjacent(rng, shape, frac=0.9):
    """float64 values ~1e-6: a fraction ``frac`` of them a bf16 tie (the
    midpoint of two neighbouring bf16 values) times 1 +- 2^-30, the rest
    plain normals."""
    v = rng.standard_normal(shape) * 1e-6
    ulp = 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)
    grid = np.trunc(v / ulp) * ulp                 # a bf16 value
    tie = grid + np.sign(v) * ulp / 2
    near = tie * (1 + rng.choice([-NEAR, NEAR], shape))
    return np.where(rng.uniform(size=shape) < frac, near, v)


def direct_bf16(x):
    """float64 -> bf16 in one rounding (to nearest even), as float64."""
    bits = np.asarray(x, np.float64).view(np.int64)
    bits = (bits + ((1 << 44) - 1) + ((bits >> 45) & 1)) & ~((1 << 45) - 1)
    return bits.view(np.float64)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(26)
    res = tie_adjacent(rng, (R, P, T))
    w = rng.standard_normal((NB + 1, P, P))
    return {"shared": (res, res, w),
            "local": (res[:, :PL].copy(), res, w[:, :PL].copy())}


@pytest.fixture(scope="module")
def jax_out(inputs):
    """The JAX kernel (interpret mode) at 'bf16' on each layout."""
    out = {}
    for layout, (a, b, w) in inputs.items():
        c, au = jax_bc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                       nbins=NB, rt=1, interpret=True, precision="bf16")
        out[layout] = np.concatenate([np.asarray(c),
                                      np.asarray(au)[:, None]], 1)
    return out


def test_rows_sit_next_to_bf16_ties(inputs):
    """Most values lie within 2^-24 of a tie, and on about half of them a
    direct rounding lands one bf16 ULP away from the JAX rounding: the
    rows are ones on which the two roundings differ."""
    x = inputs["shared"][0].ravel()
    jax_r = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)
    lo = np.floor(x / ulp) * ulp
    dist = np.abs(x - (lo + ulp / 2)) / np.abs(x)
    assert np.mean(dist <= 2.0 ** -24) > 0.85
    apart = np.abs(direct_bf16(x) - jax_r) > 0
    assert 0.3 < np.mean(apart) < 0.6
    assert np.array_equal(bc.round_bf16(torch.from_numpy(x).float())
                          .double().numpy(), jax_r)


@pytest.mark.parametrize("layout", ["shared", "local"])
def test_plain_k1_bf16_on_tie_adjacent_rows_matches_the_jax_kernel(
        inputs, jax_out, layout):
    a, b, w = (torch.from_numpy(x) for x in inputs[layout])
    curves, autos = bc.binned_correlation(a, b, w, NB, precision="bf16")
    assert curves.dtype == autos.dtype == torch.float32
    got = np.concatenate([curves.numpy(), autos.numpy()[:, None]], 1)
    want = jax_out[layout]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=layout)
