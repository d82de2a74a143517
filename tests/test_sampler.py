"""The Poisson sampler (physics/noise.py): ``jax.random.poisson`` behind
``poisson_counts`` / ``maybe_poisson``, the one sampler every engine uses.

Moments and the pmf fit at the rates the engines produce (dark scan-frame
pixels well below 1, bright ones in the tens to hundreds); the GPU repeats
the chi-square fit on the card (test_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rescan_line_sted_tpu.physics.noise import maybe_poisson, poisson_counts


@pytest.mark.parametrize("lam", [0.05, 0.3, 1.2, 7.0, 40.0, 300.0])
def test_sampler_moments(lam):
    n = 100_000
    x = np.asarray(poisson_counts(jax.random.key(int(lam * 10) + 3),
                                  jnp.full((n,), lam, jnp.float32)))
    # standard errors: mean sqrt(lam/n), variance ~ lam sqrt(2/n)
    assert abs(x.mean() - lam) < 5 * np.sqrt(lam / n)
    assert abs(x.var() - lam) < 6 * lam * np.sqrt((2.0 + 1.0 / lam) / n)


def test_sampler_chi_square_vs_pmf():
    from scipy import stats

    lam = 3.0
    x = np.asarray(poisson_counts(jax.random.key(5),
                                  jnp.full((200_000,), lam, jnp.float32)))
    obs = np.bincount(x.astype(np.int64), minlength=20)[:20]
    exp = stats.poisson.pmf(np.arange(20), lam) * x.size
    mask = exp > 5
    chi2 = ((obs[mask] - exp[mask]) ** 2 / exp[mask]).sum()
    assert 1 - stats.chi2.cdf(chi2, mask.sum() - 1) > 1e-4


def test_zero_lambda_and_determinism():
    lam = jnp.asarray([[0.0, 5.0], [12.0, 0.0]])
    a = np.asarray(poisson_counts(jax.random.key(1), lam))
    b = np.asarray(poisson_counts(jax.random.key(1), lam))
    np.testing.assert_array_equal(a, b)
    assert a[0, 0] == 0 and a[1, 1] == 0
    c = np.asarray(poisson_counts(jax.random.key(2),
                                  jnp.full((64,), 5.0)))
    assert not np.array_equal(
        c, np.asarray(poisson_counts(jax.random.key(1),
                                     jnp.full((64,), 5.0))))


def test_negative_mean_clamps_to_zero():
    """Band-limited placement can leave tiny negative means; they draw 0."""
    x = np.asarray(poisson_counts(jax.random.key(4),
                                  jnp.full((1000,), -1e-3)))
    assert (x == 0).all()


def test_shape_dtype_integrality_odd_shape():
    lam = jnp.zeros((3, 37, 190)).at[:, 5:8, :].set(7.0)
    x = poisson_counts(jax.random.key(3), lam)
    assert x.shape == lam.shape and x.dtype == jnp.float32
    a = np.asarray(x)
    assert (a == np.round(a)).all() and (a >= 0).all()
    assert (a[:, :5] == 0).all() and (a[:, 8:] == 0).all()
    assert abs(a[:, 5:8].mean() - 7.0) < 0.5


def test_maybe_poisson_passthrough_and_jit():
    """``key=None`` returns the mean untouched (a static choice: no draw
    is traced); a key draws counts, also under jit."""
    mean = jnp.linspace(0.0, 20.0, 256)
    assert maybe_poisson(None, mean) is mean
    f = jax.jit(lambda k, m: maybe_poisson(k, m))
    a = np.asarray(f(jax.random.key(9), mean))
    np.testing.assert_array_equal(
        a, np.asarray(maybe_poisson(jax.random.key(9), mean)))
    assert (a == np.round(a)).all()
    jaxpr = str(jax.make_jaxpr(lambda m: maybe_poisson(None, m))(mean))
    assert "random" not in jaxpr
