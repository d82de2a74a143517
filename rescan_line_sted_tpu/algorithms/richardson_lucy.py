"""Richardson-Lucy deconvolution as a jitted fixed-point loop (component C11).

The reference fuses multi-orientation line-STED acquisitions with an inline
multiplicative-update loop (SURVEY.md sections 1.1 and 4.5):

    est <- est * (1/N) * sum_v [ (data_v / (est (*) psf_v)) (*) flip(psf_v) ]

Design:

* the view axis is a *batched leading dimension*, so each iteration is one
  batched rFFT2 round-trip over all views at once (no per-view Python loop);
* OTFs are precomputed once; the iteration runs under ``lax.fori_loop``
  inside jit (BASELINE.json: "Richardson-Lucy deconvolution as a jitted
  fixed-point loop");
* the back-projection ``(*) flip(psf)`` is a spectral conjugate -- no flipped
  kernels are materialized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.kernels import fftconv


def richardson_lucy_views(
    data: jnp.ndarray,
    psfs: jnp.ndarray,
    num_iter: int,
    eps: float = 1e-6,
    init: jnp.ndarray | None = None,
    accelerate: bool = False,
) -> jnp.ndarray:
    """Multi-view RL fusion.

    data: [V, H, W] acquired views; psfs: [V, H, W] centered per-view system
    kernels (each view's image is modeled as ``est (*) psf_v``). Returns the
    fused estimate [H, W]. ``num_iter`` is static under jit.

    ``accelerate=True`` enables Biggs-Andrews vector extrapolation (Appl.
    Opt. 36, 1766 (1997)): each multiplicative update is applied at a point
    extrapolated along the recent trajectory, typically reaching a given
    restoration error in ~2-3x fewer iterations (each iteration does the
    same one batched FFT round-trip).
    """
    otfs = fftconv.kernel_to_otf(psfs)  # [V, H, W//2+1]
    shape = data.shape[-2:]
    if init is None:
        init = jnp.full(shape, jnp.mean(data), data.dtype)
    # Scale-aware guard: where the forward model is ~0 (e.g. empty background
    # with a point sample) the ratio is pinned to 0 instead of data/eps,
    # which keeps the f32 iteration from blowing up to NaN.
    tiny = eps * jnp.maximum(jnp.mean(jnp.abs(data)), 1e-30)

    @jax.named_scope("rl_iter")
    def rl_update(est):
        fwd = fftconv.convolve_otf(est[None], otfs, shape)      # [V, H, W]
        ratio = jnp.where(fwd > tiny, data / jnp.maximum(fwd, tiny), 0.0)
        back = fftconv.correlate_otf(ratio, otfs, shape)        # [V, H, W]
        return est * jnp.mean(back, axis=0)

    if not accelerate:
        return jax.lax.fori_loop(0, num_iter, lambda _, e: rl_update(e), init)

    def body(_, carry):
        x, x_prev, g_prev = carry
        # extrapolation weight from successive update directions
        g = x - x_prev
        num = jnp.sum(g * g_prev)
        den = jnp.maximum(jnp.sum(g_prev * g_prev), 1e-30)
        alpha = jnp.clip(num / den, 0.0, 0.999)
        y = jnp.maximum(x + alpha * g, 0.0)
        x_new = rl_update(y)
        return x_new, x, g
    x, _, _ = jax.lax.fori_loop(
        0, num_iter, body, (init, init, jnp.zeros_like(init)))
    return x


def richardson_lucy(
    data: jnp.ndarray,
    psf: jnp.ndarray,
    num_iter: int,
    eps: float = 1e-6,
) -> jnp.ndarray:
    """Single-view RL deconvolution of ``data`` [H, W] with a centered PSF."""
    return richardson_lucy_views(data[None], psf[None], num_iter, eps)
