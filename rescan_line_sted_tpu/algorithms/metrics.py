"""Resolution / signal metrics (component C9, SURVEY.md section 3).

The reference prints/plots PSF FWHM, emitted-photon counts per dose, and
scan-step counts to build its comparison figures. Here the measurements are
jittable (subpixel FWHM via linear interpolation, no data-dependent shapes)
so they can run inside vmapped sweeps.
"""

from __future__ import annotations

import jax.numpy as jnp

from rescan_line_sted_tpu.config import (
    LineSTEDParams,
    PointSTEDParams,
)
from rescan_line_sted_tpu.imaging import analytic
from rescan_line_sted_tpu.utils import struct


def fwhm_1d(profile: jnp.ndarray) -> jnp.ndarray:
    """Full width at half maximum of a 1D profile, subpixel, in pixels.

    Contract: the profile must have ONE lobe above half maximum. Crossings
    are found by linear interpolation between samples; jit/vmap-safe (no
    dynamic shapes). Returns NaN -- never a plausible-looking wrong number
    -- when the contract is violated: multi-lobed profiles (more than one
    rising+falling half-max crossing pair), flat or non-positive profiles,
    and profiles whose half-max level is never crossed on one side. Callers
    feeding sweep curves (``sweeps/dose.py``, ``sweeps/fov.py``) propagate
    the NaN into the curve where it is visible, not silently absorbed.
    """
    peak_val = jnp.max(profile)
    flat = (peak_val <= 0) | (peak_val <= jnp.min(profile))
    p = profile / jnp.where(flat, 1.0, peak_val)
    n = p.shape[-1]
    idx = jnp.arange(n, dtype=p.dtype)
    half = 0.5
    above = p >= half
    # single-lobe check: exactly one contiguous above-half region
    n_crossings = jnp.sum((above[:-1] != above[1:]).astype(jnp.int32))
    boundary_above = above[0].astype(jnp.int32) + above[-1].astype(jnp.int32)
    multi_lobed = (n_crossings + boundary_above) > 2
    # Rising edge: last index i with p[i] < half while p[i+1] >= half,
    # searching left of the peak; falling edge symmetric.
    peak = jnp.argmax(p)
    left_cand = jnp.where((~above[:-1]) & above[1:] & (idx[:-1] < peak),
                          idx[:-1], -jnp.inf)
    i_l = jnp.max(left_cand)
    right_cand = jnp.where(above[:-1] & (~above[1:]) & (idx[:-1] >= peak),
                           idx[:-1], jnp.inf)
    i_r = jnp.min(right_cand)

    def interp(i, rising):
        i0 = jnp.clip(i.astype(jnp.int32), 0, n - 2)
        y0, y1 = p[i0], p[i0 + 1]
        t = (half - y0) / jnp.where(y1 == y0, 1.0, y1 - y0)
        return i0 + t

    x_l = interp(i_l, True)
    x_r = interp(i_r, False)
    ok = jnp.isfinite(i_l) & jnp.isfinite(i_r) & ~multi_lobed & ~flat
    return jnp.where(ok, x_r - x_l, jnp.asarray(jnp.nan, p.dtype))


def fwhm_2d(kernel: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(FWHM along y, FWHM along x) through the peak of a centered kernel."""
    h, w = kernel.shape[-2:]
    return fwhm_1d(kernel[..., :, w // 2]), fwhm_1d(kernel[..., h // 2, :])


@struct.dataclass
class ResolutionReport:
    """System-kernel resolution measurement for one configuration."""

    fwhm_y: jnp.ndarray  # pixels
    fwhm_x: jnp.ndarray  # pixels


def system_resolution_report(
    shape: tuple[int, int],
    params: PointSTEDParams | LineSTEDParams,
) -> ResolutionReport:
    """FWHM of the modality's closed-form system kernel.

    Point params -> point-STED kernel; line params -> descanned line-STED
    kernel (anisotropic: x is the STED-sharpened scan axis, y is the
    diffraction-limited line axis -- the anisotropy that motivates
    multi-orientation fusion).
    """
    if isinstance(params, PointSTEDParams):
        k = analytic.point_system_kernel(shape, params)
    else:
        k = analytic.line_system_kernel(shape, params)
    fy, fx = fwhm_2d(k)
    return ResolutionReport(fwhm_y=fy, fwhm_x=fx)
