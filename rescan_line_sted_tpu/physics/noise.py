"""Poisson shot noise (reference component C7, SURVEY.md section 3).

The reference samples ``np.random.poisson(brightness * camera)`` per scan
step; here detected counts are sampled with ``jax.random.poisson`` under jit,
with PRNG keys threaded explicitly for determinism (fixed key => bit-identical
images across runs and across jit/eager). This is the one sampler of the
package: every engine's per-step and collapsed draws go through
``maybe_poisson``.

Statistical note (exploited by the analytic engines, see
``imaging/analytic.py``): sums of independent Poisson variables are Poisson
in the summed mean, so any detection pipeline that only *adds* raw camera
pixels (pinhole sums, slit sums, detector re-binning, pixel reassignment with
each camera pixel landing in exactly one canvas pixel) may equivalently sample
once from the accumulated noise-free mean.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def poisson_counts(key: jax.Array, mean: jnp.ndarray) -> jnp.ndarray:
    """Sample detected photon counts; returns float32 counts.

    ``mean`` is the expected detected intensity (already brightness-scaled).
    Negative means -- the tiny excursions band-limited placement can carry
    -- are clamped to zero.
    """
    return jax.random.poisson(key, jnp.maximum(mean, 0.0)).astype(
        jnp.float32)


def maybe_poisson(key, mean: jnp.ndarray) -> jnp.ndarray:
    """Noise-free passthrough when ``key is None`` (a static choice under jit)."""
    if key is None:
        return mean
    return poisson_counts(key, mean)
