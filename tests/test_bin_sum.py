"""Per-batch bin sums of the distant instruments stay accurate when one
bin takes every lane of a batch (a point source's peel-off into one SED
bin): a plain float scatter-add rounds each of those equal terms the same
way as the sum grows."""

import jax.numpy as jnp
import numpy as np
import pytest

from skirt9_tpu.instruments import distant as dinst


@pytest.mark.parametrize("n", [1 << 16, 1 << 20])
def test_one_hot_bin_sum_of_equal_terms(n):
    """sqrt(n) rows of sqrt(n) terms: rounding within ~2 sqrt(n) ulp (a
    single f32 running sum of 2^20 such terms is 5e-4 low on the CPU)."""
    val = jnp.full((n,), 0.3, jnp.float32)
    exact = n * np.float64(np.float32(0.3))
    got = float(dinst._bin_sum(jnp.zeros((n,), jnp.int32), val, 4)[0])
    assert abs(got / exact - 1) < 2 * np.sqrt(n) * 2.0 ** -24


def test_bin_sums_match_float64_reference():
    rs = np.random.default_rng(3)
    n, size = 1 << 16, 4096
    idx = np.clip(np.round(rs.normal(2048, 40, n)), 0, size - 1).astype(
        np.int32)
    val = rs.uniform(0.5, 1.5, n).astype(np.float32)
    want = np.bincount(idx, weights=val.astype(np.float64), minlength=size)
    got = np.asarray(dinst._bin_sum(jnp.asarray(idx), jnp.asarray(val),
                                    size), np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
