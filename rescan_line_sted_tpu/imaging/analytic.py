"""Closed-form system kernels: each modality's noise-free image as ONE conv.

This module is the heart of the engine. The reference simulates
every modality with a per-scan-position Python loop (SURVEY.md section 4); but
for linear descanned/rescanned detection the whole acquisition collapses
analytically to a **single circular FFT convolution** of the sample with a
modality-specific *system kernel*, and -- because sums of independent Poisson
variables are Poisson -- sampling shot noise once from that accumulated mean
is *statistically exact* (see ``physics/noise.py``). This turns the
reference's O(W^2 FFTs) point-STED scan into O(1) FFTs without changing the
physics.

Derivations (circular grid, centered kernels; ``corr(sample, K)(r) =
sum_a sample(a) K(a - r)``; see ``kernels/fftconv.py``):

* **Descanned point-STED** -- camera mean at scan position x0 is
  ``B * (sample . eff(.-x0)) (*) det``; the descanned pinhole sum is then
  ``img(x0) = B * corr(sample, K)`` with ``K = eff . (pinhole (*) det)``.
* **Descanned line-STED** -- the slit sum over camera row y collapses the
  same way with ``K(vy, vx) = e(vx) . flip(conv_x(det, slit))(vy, vx)``
  where ``e`` is the 1D effective line-excitation profile.
* **Rescanned line-STED** -- reassigning camera column x of scan position x0
  to canvas column ``u = R*x0 + (x - x0)`` gives
  ``canvas(y, u) = sum_a sample(., a) H(y-., u - R*a)``, i.e. the sample
  **upsampled by R along x** convolved with the rescan kernel
  ``H(vy, vx) = sum_t e(t) det(vy, vx + (R-1) t)``
  = ``corr_x(det, upsample_x(e, R-1))``. For non-integer R the subpixel
  (band-limited Fourier) placement keeps this form with phase-ramp
  upsampling; detector re-binning by b makes the map b-periodically
  shift-variant, splitting it into b column-phase convolutions (one kernel
  ``H_rho`` per residue ``a mod b``, see ``rescan_x_kernels_rfft``). Differs
  from the per-step process only through circular wrap (the scan path wraps
  illumination mod the sample width W but frames mod the canvas width R*W).
  For samples that are zero within ~PSF support of their x-edges the two
  paths agree everywhere on the canvas -- pad the sample if edge wrap
  matters.

These kernels double as the per-view PSFs for Richardson-Lucy fusion and as
the resolution-metric input (FWHM of K), mirroring the reference's
``psf_report``-style calculators (component C8/C9).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rescan_line_sted_tpu.config import (
    LineSTEDParams,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_tpu.imaging.shifts import flip_centered
from rescan_line_sted_tpu.kernels import fftconv
from rescan_line_sted_tpu.physics import models
from rescan_line_sted_tpu.physics import psf as psfs

from rescan_line_sted_tpu.config import matmul_precision

# engine matmul precision (HIGHEST unless RLS_MATMUL_PRECISION overrides;
# see config.matmul_precision for the measured error budget)
_PRECISION = matmul_precision()


def point_system_kernel(
    shape: tuple[int, int], params: PointSTEDParams
) -> jnp.ndarray:
    """Centered system kernel K of descanned point-STED, [H, W].

    ``K = psf_eff . (pinhole (*) psf_det)``; the noise-free image is
    ``brightness * corr(sample, K)``.
    """
    eff = models.effective_point_psf(shape, params)
    det = psfs.detection_psf(shape, params.sigma_det)
    pin = psfs.pinhole_mask(shape, params.pinhole_radius)
    return eff * fftconv.fft_convolve(pin, det)


def line_system_kernel(
    shape: tuple[int, int], params: LineSTEDParams
) -> jnp.ndarray:
    """Centered system kernel K of descanned line-STED, [H, W].

    ``K(vy, vx) = e_eff(vx) . flip(det (*)_x slit)(vy, vx)`` where the slit
    integrates camera columns and detection keeps row resolution.
    """
    h, w = shape
    eff = models.effective_line_profile(w, params)
    det = psfs.detection_psf(shape, params.sigma_det)
    slit = psfs.slit_profile(w, params.slit_halfwidth)
    # 1D circular convolution of each det row with the centered slit.
    slit_k = jnp.fft.ifftshift(slit)
    d = jnp.fft.irfft(jnp.fft.rfft(det, axis=-1) * jnp.fft.rfft(slit_k), n=w, axis=-1)
    return eff[None, :] * flip_centered(d)


def _np_phases(theta: "np.ndarray") -> jnp.ndarray:
    """f64 numpy ``exp(-2i pi theta)`` -> complex64 device constant.

    Phase arguments reach ~1e4 radians at large widths; computing them in
    f32 inside jit loses ~1e-4 of phase and breaks the 1e-5 parity bar, so
    every *static* phase table is built in float64 on the host, then
    rounded to a (cos, sin) f32 pair and combined into complex64 on
    device.
    """
    z = np.exp(-2j * np.pi * theta)
    return jax.lax.complex(jnp.asarray(z.real.astype(np.float32)),
                           jnp.asarray(z.imag.astype(np.float32)))


def rescan_x_kernels_rfft(
    geom: RescanGeometry, params: LineSTEDParams
) -> jnp.ndarray:
    """rfft-domain column-phase rescan kernels ``H_rho`` [b, Wc//2+1].

    Derivation (subpixel reassignment, camera indices unwrapped -- exact for
    samples zero near their x-edges, see module doc). With sample column
    ``a = b*m + rho`` and scan position ``x0 = a - t``::

        canvas(U) = sum_rho sum_m sYb(b m + rho) H_rho(U - R m)
        H_rho(V)  = sum_t eff(t) sum_X d_rho(X) D_Wc(V - X - (R-1)(rho-t)/b)
        d_rho(X)  = sum_j det_x(b X + j - rho)        (phase-rho binned det)

    where ``D_Wc`` is the canvas-ring Dirichlet kernel (what an exact FFT
    phase-ramp shift interpolates with). Returned in the rfft domain:
    ``H_rho_hat(k) = D_hat_rho(k) * E_hat_rho(k)`` with the centered index
    conventions of the scan engine (illumination peak at ``w//2``).
    Brightness is NOT included.
    """
    b = geom.binning
    r = float(geom.rescan_factor)
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    kk = np.arange(wc // 2 + 1, dtype=np.float64)

    eff = models.effective_line_profile(w, params)
    det_x = psfs.detection_profile(w, params.sigma_det)

    # d_rho[X] = sum_j det_x[(b X + j - rho) % w], all rho at once. [b, w/b]
    x_idx = np.arange(w // b)
    j_idx = np.arange(b)
    rho_idx = np.arange(b)
    gather = (b * x_idx[None, :, None] + j_idx[None, None, :]
              - rho_idx[:, None, None]) % w
    d = det_x[gather].sum(-1)                                  # [b, w/b]
    # D_hat_rho(k) = rfft_pad(d_rho)(k) * exp(+2i pi k c / wc), c = w//(2b)
    # (the X index is centered at c on the canvas ring).
    center_ph = _np_phases(-kk * (w // (2 * b)) / wc)          # e^{+2i pi ...}
    d_hat = jnp.fft.rfft(d, n=wc, axis=-1) * center_ph[None, :]

    # E_hat_rho(k) = sum_t eff[t] exp(-2i pi k (R-1)(rho - t_c) / (b wc))
    t_c = np.arange(w, dtype=np.float64) - w // 2
    pe = _np_phases(-kk[None, :] * (r - 1.0) * t_c[:, None] / (b * wc))
    e_base = jnp.einsum("t,tk->k", eff.astype(jnp.complex64), pe,
                        precision=_PRECISION)   # [K]
    rho_ph = _np_phases(kk[None, :] * (r - 1.0) * rho_idx[:, None]
                        / (b * wc))                            # [b, K]
    return d_hat * e_base[None, :] * rho_ph


def _binned_row_matrix(h: int, b: int, det_y: jnp.ndarray) -> jnp.ndarray:
    """[h, h/b] matrix G with ``(G^T @ sample)[Y] = sum_j conv_y(sample,
    det_y)[b Y + j]`` -- the y-convolve + row-bin of the scan engine."""
    my = fftconv.circulant_matrix(det_y)                       # [h, h]
    return my.reshape(h, h // b, b).sum(-1)


def rescan_canvas_mean(
    sample: jnp.ndarray,
    params: LineSTEDParams,
    geom: RescanGeometry,
) -> jnp.ndarray:
    """Noise-free rescanned canvas [H/b, Wc]: exact closed form for ANY
    ``rescan_factor >= 1`` (fractional R via band-limited subpixel
    reassignment) and ANY ``binning``.

    One y matmul + b phase-placement matmuls + one irfft; agrees with the
    subpixel scan engine to float precision away from the circular seam
    (parity-tested against the f64 oracle at R=1.5, binning=2).
    """
    b = geom.binning
    r = float(geom.rescan_factor)
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    kk = np.arange(wc // 2 + 1, dtype=np.float64)

    det_y = psfs.detection_profile(h, params.sigma_det)
    gy = _binned_row_matrix(h, b, det_y)                       # [h, hc]
    s_yb = jnp.einsum("hY,hw->Yw", gy, sample,
                      precision=_PRECISION)     # [hc, w]
    # split columns by phase: a = b*m + rho -> [b(rho), hc, w/b(m)]
    s_ph = s_yb.reshape(hc, w // b, b).transpose(2, 0, 1)

    h_hat = rescan_x_kernels_rfft(geom, params)                # [b, K]
    pm = _np_phases(kk[None, :] * r * np.arange(w // b)[:, None]
                    / wc)                                      # [w/b, K]
    canvas_rfft = jnp.einsum("pYm,mk,pk->Yk",
                             s_ph.astype(jnp.complex64), pm, h_hat,
                             precision=_PRECISION)
    return params.brightness * jnp.fft.irfft(canvas_rfft, n=wc, axis=-1)


def rescan_system_kernel(
    geom: RescanGeometry, params: LineSTEDParams
) -> jnp.ndarray:
    """Centered effective rescan kernel H on the canvas grid, [H/b, Wc].

    ``H(vy, vx) = sum_t e_eff(t) det(vy, vx + (R-1) t)``: the detection PSF
    sheared by the (R-1)-stretched effective excitation line; any
    ``rescan_factor`` (fractional R via exact phase placement). With
    ``binning > 1`` the system is b-periodically shift-variant; the returned
    kernel is the position-aligned average over the b column/row phases (the
    exact per-phase kernels are ``rescan_x_kernels_rfft``). The noise-free
    canvas is ``brightness * conv(place_x(sample, R), H)``; for b = 1 this
    is exact and matches ``rescan_canvas_mean``.
    """
    b = geom.binning
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    kk = np.arange(wc // 2 + 1, dtype=np.float64)
    rho = np.arange(b, dtype=np.float64)

    # x: phase rho's response sits at relative offset -rho/b on the canvas
    # (camera-column quantization); align each before averaging.
    h_hat = rescan_x_kernels_rfft(geom, params)                # [b, K]
    align = _np_phases(kk[None, :] * rho[:, None] / (b * wc))  # shift +rho/b
    hx = jnp.fft.fftshift(
        jnp.fft.irfft((h_hat * align).mean(0), n=wc))          # [wc] centered

    # y: binned detection profile, phase-aligned the same way.
    det_y = psfs.detection_profile(h, params.sigma_det)
    y_idx = np.arange(hc)
    gather = (b * y_idx[None, :, None] + np.arange(b)[None, None, :]
              - np.arange(b)[:, None, None]) % h
    dy = det_y[gather].sum(-1)                                 # [b, hc]
    ky = np.arange(hc // 2 + 1, dtype=np.float64)
    centery = _np_phases(-ky * (h // (2 * b)) / hc)
    aligny = _np_phases(ky[None, :] * rho[:, None] / (b * hc))
    gy = jnp.fft.fftshift(jnp.fft.irfft(
        (jnp.fft.rfft(dy, n=hc, axis=-1) * centery[None, :]
         * aligny).mean(0), n=hc))                             # [hc] centered
    return jnp.outer(gy, hx)


def upsample_x(sample: jnp.ndarray, factor: int, out_width: int) -> jnp.ndarray:
    """Zero-insertion upsampling along x: pixel a -> column factor * a."""
    h, w = sample.shape[-2:]
    out = jnp.zeros(sample.shape[:-1] + (out_width,), sample.dtype)
    return out.at[..., jnp.arange(w) * factor].set(sample)
