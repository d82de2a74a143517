"""vmap over sample batches: every engine must be batchable (DP over
samples is the other natural batch axis besides sweep points)."""

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


SHAPE = (32, 32)
BATCH = jnp.stack([samples.rings(SHAPE, period=9.0),
                   samples.siemens_star(SHAPE, spokes=6),
                   samples.sparse_points(SHAPE, spacing=16)])
LP = LineSTEDParams.create(depletion=4.0, brightness=30.0)
PP = PointSTEDParams.create(depletion=4.0, brightness=30.0)


def _check_batched(batched_fn, single_fn):
    got = batched_fn(BATCH)
    for i in range(BATCH.shape[0]):
        want = single_fn(BATCH[i])
        np.testing.assert_allclose(np.asarray(got[i]), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_vmap_line(method):
    geom = LineSTEDGeometry(Grid(*SHAPE), chunk=16)
    f = lambda s: line_sted_image(s, LP, geom, method=method).image
    _check_batched(jax.jit(jax.vmap(f)), f)


@pytest.mark.parametrize("method", ["analytic", "scan"])
def test_vmap_point(method):
    geom = PointSTEDGeometry(Grid(*SHAPE), chunk=32)
    f = lambda s: point_sted_image(s, PP, geom, method=method).image
    _check_batched(jax.jit(jax.vmap(f)), f)


@pytest.mark.parametrize("rescan_factor", [2.0, 2.5])  # scatter / phases
def test_vmap_rescan(rescan_factor):
    geom = RescanGeometry(Grid(*SHAPE), rescan_factor=rescan_factor,
                          chunk=16)
    f = lambda s: rescanned_line_sted_image(
        s, LP, geom, method="scan").image
    _check_batched(jax.jit(jax.vmap(f)), f)


def test_vmap_with_noise_keys():
    geom = LineSTEDGeometry(Grid(*SHAPE), chunk=16)
    keys = jax.random.split(jax.random.key(0), BATCH.shape[0])
    imgs = jax.vmap(lambda s, k: line_sted_image(
        s, LP, geom, key=k, method="scan").image)(BATCH, keys)
    arr = np.asarray(imgs)
    assert np.isfinite(arr).all()
    assert (arr == np.round(arr)).all()
    # different keys -> different noise
    assert np.abs(arr[0] - arr[1]).max() > 0


def test_nested_vmap_sweep_over_samples():
    """Two-level batching: dose sweep vmapped over a sample batch."""
    from rescan_line_sted_tpu.sweeps import dose_matched_sweep

    pgeom = PointSTEDGeometry(Grid(*SHAPE), chunk=32)
    lgeom = LineSTEDGeometry(Grid(*SHAPE), chunk=16)
    powers = jnp.asarray([0.0, 4.0])
    f = jax.jit(jax.vmap(lambda s: dose_matched_sweep(
        s, PP, LP, pgeom, lgeom, powers, 100.0)))
    out = f(BATCH)
    assert out.point.image.shape == (3, 2, *SHAPE)
    for i in range(3):
        single = dose_matched_sweep(BATCH[i], PP, LP, pgeom, lgeom,
                                    powers, 100.0)
        np.testing.assert_allclose(np.asarray(out.point.image[i]),
                                   np.asarray(single.point.image),
                                   rtol=1e-5, atol=1e-4)
