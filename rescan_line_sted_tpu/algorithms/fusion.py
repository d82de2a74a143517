"""Operator-form Richardson-Lucy and rescanned-view fusion.

``richardson_lucy_views`` (richardson_lucy.py) covers views modeled by plain
centered PSFs on the sample grid. Rescanned line-STED views live on the
**canvas** grid -- the forward model is the exact closed-form acquisition
operator ``analytic.rescan_canvas_mean`` (any rescan factor, any detector
binning) -- so fusion needs RL in general linear-operator form:

    est <- est * [ sum_v A_v^T(data_v / A_v(est)) ] / [ sum_v A_v^T(1) ]

``A^T`` is the EXACT adjoint, obtained with ``jax.linear_transpose`` of the
forward map (including the view rotation -- the true transpose of the
bilinear-resampling rotation is its scatter adjoint, not rotation by the
opposite angle). This fuses multi-orientation *rescanned* acquisitions --
the paper's headline modality -- directly into a sample-grid estimate,
deconvolving, de-binning, and de-rescanning in one fixed-point loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.config import RescanGeometry, RescanParams
from rescan_line_sted_tpu.imaging.analytic import rescan_canvas_mean
from rescan_line_sted_tpu.imaging.rescan import rescanned_line_sted_image
from rescan_line_sted_tpu.utils.rotate import rotate_image


def richardson_lucy_operator(
    data: list[jnp.ndarray],
    operators: list[tuple],
    num_iter: int,
    init: jnp.ndarray,
    eps: float = 1e-6,
    accelerate: bool = False,
) -> jnp.ndarray:
    """RL with per-view (forward, adjoint) linear-operator pairs.

    ``data[v]`` may live on any grid; ``operators[v] = (fwd, adj)`` maps the
    sample-grid estimate to that grid and back. ``init`` fixes the estimate
    shape. The view loop is unrolled (V is small and static).

    ``accelerate=True`` enables the same Biggs-Andrews vector extrapolation
    as ``richardson_lucy_views`` (Appl. Opt. 36, 1766 (1997)): each
    multiplicative update is applied at a point extrapolated along the
    recent trajectory, reaching a given restoration error in ~2-3x fewer
    iterations at one extra elementwise pass per iteration (no extra
    operator applications).
    """
    scale = jnp.maximum(jnp.mean(jnp.abs(data[0])), 1e-30)
    tiny = eps * scale
    norm = sum(adj(jnp.ones_like(d)) for d, (_, adj) in zip(data, operators))
    norm = jnp.maximum(norm, eps)

    def rl_update(est):
        acc = jnp.zeros_like(est)
        for d, (fwd, adj) in zip(data, operators):
            pred = fwd(est)
            ratio = jnp.where(pred > tiny, d / jnp.maximum(pred, tiny), 0.0)
            acc = acc + adj(ratio)
        return est * acc / norm

    if not accelerate:
        return jax.lax.fori_loop(0, num_iter, lambda _, e: rl_update(e), init)

    def body(_, carry):
        x, x_prev, g_prev = carry
        g = x - x_prev
        num = jnp.sum(g * g_prev)
        den = jnp.maximum(jnp.sum(g_prev * g_prev), 1e-30)
        alpha = jnp.clip(num / den, 0.0, 0.999)
        y = jnp.maximum(x + alpha * g, 0.0)
        return rl_update(y), x, g

    x, _, _ = jax.lax.fori_loop(
        0, num_iter, body, (init, init, jnp.zeros_like(init)))
    return x


def rescan_operator(geom: RescanGeometry, params: RescanParams,
                    angle=None) -> tuple:
    """(forward, adjoint) pair of one rescanned line-STED view.

    forward: sample grid [H, W] -> canvas [H/b, round(R*W)/b] (the exact
    acquisition mean, any R / binning); adjoint: the exact transpose via
    ``jax.linear_transpose``. ``angle`` (radians) composes a scan-axis
    rotation: the view scans along direction ``angle``.
    """
    def fwd(est):
        if angle is not None:
            est = rotate_image(est, -angle)
        return rescan_canvas_mean(est, params, geom)

    primal = jax.ShapeDtypeStruct(geom.grid.shape, jnp.float32)

    def adj(y):
        (x,) = jax.linear_transpose(fwd, primal)(y)
        return x

    return fwd, adj


def multi_orientation_rescan(
    sample: jnp.ndarray,
    params: RescanParams,
    geom: RescanGeometry,
    angles,
    key: jax.Array | None = None,
    method: str = "analytic",
) -> jnp.ndarray:
    """Acquire rescanned line-STED canvases [V, H/b, R*W/b], one per angle.

    Convention matches ``imaging/orientations.py``: view v scans along
    direction ``angles[v]`` (sample rotated by -angle, acquired with the
    x-scan engine; canvases stay in each view's scan frame -- fusion's
    operators fold the rotation back).
    """
    angles = jnp.asarray(angles, jnp.float32)

    def acquire(theta, k):
        s_rot = rotate_image(sample, -theta)
        return rescanned_line_sted_image(
            s_rot, params, geom, key=k, method=method).image

    if key is None:
        return jax.vmap(lambda t: acquire(t, None))(angles)
    keys = jax.random.split(key, angles.shape[0])
    return jax.vmap(acquire)(angles, keys)


def rescan_fusion(
    canvases: jnp.ndarray,
    params: RescanParams,
    geom: RescanGeometry,
    angles,
    num_iter: int,
    init: jnp.ndarray | None = None,
    accelerate: bool = False,
) -> jnp.ndarray:
    """Fuse multi-orientation rescanned canvases into a sample-grid estimate.

    ``angles`` must be *static* Python floats (they parameterize the per-view
    operators); under jit pass a tuple, not a traced array. ``accelerate``
    turns on Biggs-Andrews extrapolation (see richardson_lucy_operator).
    """
    h, w = geom.grid.shape
    ops = [rescan_operator(geom, params, angle=float(a)) for a in angles]
    data = [canvases[v] for v in range(canvases.shape[0])]
    if init is None:
        # each canvas pixel sums binning^2 camera pixels spread over R*W/b
        # columns; undo both to land near the sample's mean intensity
        init = jnp.full((h, w), jnp.mean(canvases) * geom.rescan_factor
                        / (geom.binning ** 2
                           * jnp.maximum(params.brightness, 1e-30)))
    return richardson_lucy_operator(data, ops, num_iter, init,
                                    accelerate=accelerate)


def ism_deconvolve(
    canvas: jnp.ndarray,
    params,
    geom,
    num_iter: int = 30,
    accelerate: bool = False,
) -> jnp.ndarray:
    """Deconvolve a rescanned point-STED (ISM) canvas with its system kernel.

    The classic ISM post-processing step: the canvas is exactly
    ``conv(place_2d(sample, R), H)`` with the NONNEGATIVE reassigned kernel
    ``H = rescan_point_system_kernel`` (every term ``eff(t) det(v+(R-1)t)``
    is nonnegative), so standard canvas-grid RL applies and is stable.
    Returns the deconvolved CANVAS-grid estimate (the R-magnified,
    resolution-enhanced image; for integer R its exact target is the
    zero-inserted upsampled sample). Operator-form RL straight to the
    sample grid was tried and REJECTED: the band-limited place operator
    rings negative, which destabilizes the multiplicative update.

    ``params``: PointSTEDParams; ``geom``: RescanPointGeometry (binning=1).
    """
    from rescan_line_sted_tpu.algorithms.richardson_lucy import (
        richardson_lucy_views,
    )
    from rescan_line_sted_tpu.imaging.rescan_point import (
        rescan_point_system_kernel,
    )

    kern = rescan_point_system_kernel(geom, params)
    # sum-normalize the kernel: RL's multiplicative update is stationary at
    # a sum(psf)-scaled estimate, so deconvolve with H/S and undo the S
    # afterwards to keep absolute intensities
    s = jnp.maximum(jnp.sum(kern), 1e-30)
    est = richardson_lucy_views(canvas[None], (kern / s)[None], num_iter,
                                accelerate=accelerate)
    return est / s
