"""Rescan scatter-add placement (C6/C17) vs a numpy loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rescan_line_sted_tpu.kernels.rescan_accumulate import (
    rescan_accumulate_reference,
)


def _case(n=7, h=16, w=24, wc=48, seed=0):
    rng = np.random.default_rng(seed)
    canvas = jnp.asarray(rng.uniform(size=(h, wc)), jnp.float32)
    frames = jnp.asarray(rng.uniform(size=(n, h, w)), jnp.float32)
    offsets = jnp.asarray(rng.integers(0, wc, size=(n,)), jnp.int32)
    return canvas, frames, offsets


def test_reference_scatter_add_accumulates_duplicates():
    canvas = jnp.zeros((4, 8), jnp.float32)
    frames = jnp.ones((3, 4, 4), jnp.float32)
    offsets = jnp.asarray([0, 0, 6], jnp.int32)  # duplicate + wrap
    out = np.asarray(rescan_accumulate_reference(canvas, frames, offsets))
    np.testing.assert_allclose(out[:, 0], 3.0)   # two at 0 + wrap of 6
    np.testing.assert_allclose(out[:, 1], 3.0)
    np.testing.assert_allclose(out[:, 2], 2.0)
    np.testing.assert_allclose(out[:, 6], 1.0)
    np.testing.assert_allclose(out[:, 4], 0.0)


def _numpy_accumulate(canvas, frames, offsets):
    out = np.array(canvas, np.float64)
    wc = out.shape[-1]
    for f, o in zip(np.asarray(frames), np.asarray(offsets)):
        for x in range(f.shape[-1]):
            out[:, (int(o) + x) % wc] += f[:, x]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_matches_numpy_loop(seed):
    canvas, frames, offsets = _case(seed=seed)
    got = rescan_accumulate_reference(canvas, frames, offsets)
    np.testing.assert_allclose(np.asarray(got),
                               _numpy_accumulate(canvas, frames, offsets),
                               rtol=1e-6, atol=1e-5)


def test_scatter_wrap_heavy():
    # every frame wraps around the canvas end; negative offsets wrap too
    canvas, frames, _ = _case(n=5, w=24, wc=32)
    offsets = jnp.asarray([30, 31, -7, 9, 16], jnp.int32)
    got = rescan_accumulate_reference(canvas, frames, offsets)
    np.testing.assert_allclose(np.asarray(got),
                               _numpy_accumulate(canvas, frames, offsets),
                               rtol=1e-6, atol=1e-5)


def test_scatter_under_vmap():
    b = 3
    cases = [_case(seed=s) for s in range(b)]
    canvases = jnp.stack([c[0] for c in cases])
    frames = jnp.stack([c[1] for c in cases])
    offsets = jnp.stack([c[2] for c in cases])
    got = jax.jit(jax.vmap(rescan_accumulate_reference))(
        canvases, frames, offsets)
    for i in range(b):
        np.testing.assert_allclose(
            np.asarray(got[i]),
            _numpy_accumulate(canvases[i], frames[i], offsets[i]),
            rtol=1e-6, atol=1e-5)


def test_rescan_factor_validation():
    from rescan_line_sted_tpu.config import Grid, RescanGeometry

    with pytest.raises(ValueError):
        RescanGeometry(Grid(32, 32), rescan_factor=0.5)
