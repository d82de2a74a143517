"""Per-step noise streams: every engine's per-step draws are deterministic in
the key, independent across chunks and keys, and absent without a key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rescan_line_sted_tpu.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import (
    line_sted_image,
    point_sted_image,
    rescanned_line_sted_image,
)

PARAMS = LineSTEDParams.create(sigma_exc=2.0, sigma_det=2.5,
                               stripe_period=9.0, depletion=4.0,
                               slit_halfwidth=3.0, brightness=100.0)


def _engine(name, size=48):
    """``f(sample, key) -> per-step image`` for one engine (the windowed
    routes engage at the 192^2 size, the full-frame ones at 48^2)."""
    grid = Grid(size, size)
    if name == "point":
        geom = PointSTEDGeometry(grid, chunk=size)
        params = PointSTEDParams.create(brightness=100.0)
        return lambda s, k: point_sted_image(
            s, params, geom, key=k, method="scan",
            noise_mode="per_step").image
    if name == "line":
        geom = LineSTEDGeometry(grid, chunk=16)
        return lambda s, k: line_sted_image(
            s, PARAMS, geom, key=k, method="scan",
            noise_mode="per_step").image
    geom = RescanGeometry(grid, rescan_factor=1.5, chunk=16)
    return lambda s, k: rescanned_line_sted_image(
        s, PARAMS, geom, key=k, method="scan", noise_mode="per_step").image


@pytest.mark.parametrize("engine,size", [("point", 48), ("line", 192),
                                         ("rescan", 192)])
def test_per_step_deterministic_in_key(engine, size):
    f = jax.jit(_engine(engine, size))
    sample = samples.siemens_star((size, size)) * 3.0
    a = np.asarray(f(sample, jax.random.key(11)))
    b = np.asarray(f(sample, jax.random.key(11)))
    c = np.asarray(f(sample, jax.random.key(12)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_chunks_draw_independent_noise():
    """A uniform sample gives every scan position the same mean; per-step
    columns from different chunks must still carry different noise (each
    chunk draws from its own split key)."""
    size = 192
    sample = jnp.ones((size, size)) * 3.0
    img = np.asarray(_engine("line", size)(sample, jax.random.key(0)))
    cols = img[:, ::16]                      # one column per chunk
    assert len({c.tobytes() for c in cols.T}) == cols.shape[1]


def test_noise_free_path_draws_nothing():
    """``key=None`` never traces a draw: per-step mode is then exactly the
    noise-free scan."""
    size = 48
    geom = LineSTEDGeometry(Grid(size, size), chunk=16)
    sample = samples.siemens_star((size, size))
    f = lambda s: line_sted_image(s, PARAMS, geom, method="scan",  # noqa
                                  noise_mode="per_step").image
    assert "random" not in str(jax.make_jaxpr(f)(sample))
    np.testing.assert_array_equal(
        np.asarray(f(sample)),
        np.asarray(line_sted_image(sample, PARAMS, geom,
                                   method="scan").image))


def test_vmapped_keys_give_independent_images():
    size = 48
    f = jax.vmap(_engine("rescan", size), in_axes=(None, 0))
    sample = samples.siemens_star((size, size)) * 3.0
    imgs = np.asarray(f(sample, jax.random.split(jax.random.key(2), 3)))
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])


def test_per_step_first_moments():
    """The per-step path produces correct first moments."""
    geom = LineSTEDGeometry(Grid(48, 48), chunk=16)
    sample = jnp.ones((48, 48)) * 3.0
    mean = np.asarray(line_sted_image(sample, PARAMS, geom,
                                      method="scan").image)
    draws = np.stack([
        np.asarray(line_sted_image(sample, PARAMS, geom,
                                   key=jax.random.key(i), method="scan",
                                   noise_mode="per_step").image)
        for i in range(8)])
    sel = mean > 20
    rel = abs(draws.mean(0)[sel] - mean[sel]).mean() / mean[sel].mean()
    assert rel < 0.05
