"""Checks that need the GPU: the sampler's statistics and the parity of the
windowed and full-frame pipelines on cuBLAS/cuFFT at the timed sizes.

Every test here is marked ``gpu``: it skips elsewhere and runs on the card
through ``python chip_smoke.py`` (one process for the card). CPU versions of
the same contracts at small sizes live in test_sampler.py,
test_rescan_windowed.py and test_engines_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import LINE_KW, POINT_KW, noise_free_sampler, rel_err
from rescan_line_sted_tpu.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import line_sted, point_sted, rescan
from rescan_line_sted_tpu.physics.noise import poisson_counts

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("lam", [0.05, 0.5, 3.0, 9.0, 50.0, 300.0])
def test_sampler_chi_square_on_gpu(lam):
    """jax.random.poisson on the card: moments and a chi-square goodness of
    fit against the exact pmf (200k draws)."""
    from scipy import stats

    x = np.asarray(poisson_counts(jax.random.key(int(lam * 13) + 1),
                                  jnp.full((200_000,), lam, jnp.float32)))
    assert abs(x.mean() - lam) < 0.02 * max(lam, 1.0)
    assert abs(x.var() - lam) < 0.05 * max(lam, 1.0)
    lo = max(0, int(lam - 6 * np.sqrt(lam) - 3))
    hi = int(lam + 6 * np.sqrt(lam) + 5)
    obs, _ = np.histogram(x, bins=np.arange(lo, hi + 2) - 0.5)
    exp = stats.poisson.pmf(np.arange(lo, hi + 1), lam) * x.size
    mask = exp > 5
    chi2 = ((obs[mask] - exp[mask]) ** 2 / exp[mask]).sum()
    assert 1 - stats.chi2.cdf(chi2, mask.sum() - 1) > 1e-4


def _per_step_routes(scan, sample, params, geom):
    """Noise-free per-step canvas of the windowed and the full-frame route."""
    key = jax.random.key(0)
    with noise_free_sampler():
        return [np.asarray(jax.jit(lambda s, p, k, w=w: scan(
            s, p, geom, k, "per_step", windowed=w))(sample, params, key))
            for w in (True, False)]


@pytest.mark.parametrize("r,b", [(2.0, 1), (2.5, 2), (1.0 + np.pi / 16, 1)])
def test_rescan_windowed_matches_full_frame_on_gpu(r, b):
    size = 512
    params = LineSTEDParams.create(brightness=50.0, **LINE_KW)
    geom = RescanGeometry(Grid(size, size), rescan_factor=r, binning=b)
    win, full = _per_step_routes(
        lambda s, p, g, k, m, windowed: rescan._scan(
            s, p, g, k, m, windowed=windowed),
        samples.siemens_star((size, size)), params, geom)
    assert rel_err(win, full) < 1e-5


def test_line_windowed_matches_full_frame_on_gpu():
    size = 512
    params = LineSTEDParams.create(brightness=50.0, **LINE_KW)
    win, full = _per_step_routes(
        line_sted._scan, samples.siemens_star((size, size)), params,
        LineSTEDGeometry(Grid(size, size)))
    assert rel_err(win, full) < 1e-5


def test_point_windowed_matches_full_frame_on_gpu():
    size = 256
    params = PointSTEDParams.create(brightness=50.0, **POINT_KW)
    win, full = _per_step_routes(
        point_sted._scan, samples.siemens_star((size, size)), params,
        PointSTEDGeometry(Grid(size, size)))
    assert rel_err(win, full) < 1e-5


def test_per_step_noise_moments_on_gpu():
    """Per-step draws through the windowed pipelines: per-pixel mean and
    Poisson variance over 24 keys (line), and the canvas total's Poisson
    variance (fractional-R rescan, where band-limited placement conserves
    the photon count)."""
    size = 256
    key0 = jax.random.key(11)
    sample = jax.random.uniform(key0, (size, size), jnp.float32) * 5.0
    params = LineSTEDParams.create(brightness=100.0, **LINE_KW)
    keys = jax.random.split(key0, 24)
    lgeom = LineSTEDGeometry(Grid(size, size))
    f = jax.jit(lambda s, k: line_sted.line_sted_image(
        s, params, lgeom, key=k, method="scan", noise_mode="per_step").image)
    mean = np.asarray(line_sted.line_sted_image(sample, params, lgeom,
                                                method="scan").image)
    draws = np.stack([np.asarray(f(sample, k)) for k in keys])
    sel = mean > 20.0
    assert np.abs(draws.mean(0)[sel] - mean[sel]).mean() / mean[sel].mean() \
        < 0.03
    var_ratio = (draws.var(0, ddof=1)[sel] / mean[sel]).mean()
    assert 0.9 < var_ratio < 1.1
    rgeom = RescanGeometry(Grid(size, size), rescan_factor=1.5)
    g = jax.jit(lambda s, k: rescan.rescanned_line_sted_image(
        s, params, rgeom, key=k, method="scan", noise_mode="per_step").image)
    rmean = np.asarray(rescan.rescanned_line_sted_image(
        sample, params, rgeom, method="scan").image)
    totals = np.stack([float(jnp.sum(g(sample, k))) for k in keys])
    ratio = totals.var(ddof=1) / rmean.sum()
    assert 0.4 < ratio < 2.5, ratio
    assert abs(totals.mean() - rmean.sum()) < 6 * np.sqrt(rmean.sum() / 24)
