"""Multi-orientation line-STED acquisition (component C10; call stack 4.5).

The descanned line-STED system kernel is anisotropic (STED-sharp along the
scan axis x, diffraction-limited along the line axis y), so the reference
acquires several scan orientations and fuses them with multi-view
Richardson-Lucy into an isotropic-resolution image.

Orientations are a vmapped batch -- rotate-acquire-derotate for
all V angles compiles to one batched program (batched FFTs / batched scan),
and the per-view system kernels for RL fusion come from rotating the
closed-form descanned kernel.

Convention: view at angle theta scans along the direction theta (radians,
CCW in array coords). Implementation: rotate the sample by -theta, acquire
with the x-scan engine, rotate the image back by +theta; the effective
kernel in the sample frame is the x-scan kernel rotated by +theta.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.config import LineSTEDGeometry, LineSTEDParams
from rescan_line_sted_tpu.imaging.analytic import line_system_kernel
from rescan_line_sted_tpu.imaging.line_sted import line_sted_image
from rescan_line_sted_tpu.utils.rotate import rotate_image


def orientation_kernels(
    shape: tuple[int, int], params: LineSTEDParams, angles: jnp.ndarray
) -> jnp.ndarray:
    """Per-view centered system kernels [V, H, W] for RL fusion."""
    base = line_system_kernel(shape, params)
    return jax.vmap(lambda t: rotate_image(base, t))(angles)


def multi_orientation_line_sted(
    sample: jnp.ndarray,
    params: LineSTEDParams,
    geom: LineSTEDGeometry,
    angles: jnp.ndarray,
    key: jax.Array | None = None,
    method: str = "analytic",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Acquire descanned line-STED views at each angle.

    Returns ``(views [V, H, W], kernels [V, H, W])``, both in the sample
    frame, ready for ``richardson_lucy_views``.
    """
    angles = jnp.asarray(angles, jnp.float32)

    def acquire(theta, k):
        s_rot = rotate_image(sample, -theta)
        img = line_sted_image(s_rot, params, geom, key=k, method=method).image
        return rotate_image(img, theta)

    if key is None:
        views = jax.vmap(lambda t: acquire(t, None))(angles)
    else:
        keys = jax.random.split(key, angles.shape[0])
        views = jax.vmap(acquire)(angles, keys)
    kernels = orientation_kernels(sample.shape[-2:], params, angles)
    return views, kernels
