"""Point-scanning STED engine (reference call stack 4.1; BASELINE config 1).

Two method paths, identical physics:

* ``"analytic"`` (default): one FFT correlation of the sample with the
  closed-form system kernel, then one Poisson draw -- statistically exact
  (see ``imaging/analytic.py``). This is the production path.
* ``"scan"``: the faithful per-scan-position process (the reference's
  ``W*H``-iteration Python hot loop). With per-step noise it is a
  ``lax.scan`` over chunks: batched gather-shift / emit-multiply /
  FFT-convolve / Poisson / pinhole-sum. With collapsed noise the
  pinhole-folded raster reduces exactly to one circular correlation with
  ``P = eff . (pinhole (*) det)`` -- identical math, no loop. Used for
  parity testing and per-step camera-frame inspection on small grids.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.config import PointSTEDGeometry, PointSTEDParams
from rescan_line_sted_tpu.imaging import analytic
from rescan_line_sted_tpu.imaging.shifts import shifted_images
from rescan_line_sted_tpu.kernels import fftconv
from rescan_line_sted_tpu.physics import models
from rescan_line_sted_tpu.physics import psf as psfs
from rescan_line_sted_tpu.physics.dose import DoseReport, point_sted_dose
from rescan_line_sted_tpu.physics.noise import maybe_poisson
from rescan_line_sted_tpu.utils import struct

from rescan_line_sted_tpu.config import matmul_precision

# engine matmul precision (HIGHEST unless RLS_MATMUL_PRECISION overrides;
# see config.matmul_precision for the measured error budget)
_PRECISION = matmul_precision()


@struct.dataclass
class AcquisitionResult:
    image: jnp.ndarray
    dose: DoseReport


def point_sted_image(
    sample: jnp.ndarray,
    params: PointSTEDParams,
    geom: PointSTEDGeometry,
    key: jax.Array | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    boundary: str = "circular",
    margin: int | None = None,
) -> AcquisitionResult:
    """Simulate a full descanned point-STED acquisition of ``sample``.

    ``key=None`` returns the noise-free expected image. ``noise_mode`` (scan
    path): ``"collapsed"`` draws shot noise once from the detected mean --
    statistically identical to per-camera-pixel draws (pinhole sums of
    independent Poissons are Poisson; see ``physics/noise.py``);
    ``"per_step"`` samples every camera frame like the reference's loop.
    ``boundary``: ``"circular"`` (grid-periodic world) or ``"padded"``
    (open boundary via pad-acquire-crop, margin >= PSF support; dose is
    reported for the requested field).
    """
    if boundary == "apodized":
        # raised-cosine taper to zero at the edges: kills wrap artifacts
        # without the padded-acquisition cost (see imaging/boundary.py)
        from rescan_line_sted_tpu.imaging.boundary import (
            apodize_sample,
            default_margin,
        )

        sample = apodize_sample(
            sample, default_margin(geom) if margin is None else margin)
        boundary = "circular"
    if boundary == "padded":
        from rescan_line_sted_tpu.imaging.boundary import (
            acquire_padded,
            default_margin,
        )

        res = acquire_padded(
            lambda s, g, **kw: point_sted_image(s, params, g, **kw),
            sample, geom, default_margin(geom) if margin is None else margin,
            key=key, method=method, noise_mode=noise_mode)
        return res.replace(dose=point_sted_dose(params, geom))
    if boundary != "circular":
        raise ValueError(f"unknown boundary {boundary!r}")
    if method == "analytic":
        image = _analytic(sample, params, geom, key)
    elif method == "scan":
        image = _scan(sample, params, geom, key, noise_mode)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(image=image, dose=point_sted_dose(params, geom))


def _analytic(sample, params, geom, key):
    k = analytic.point_system_kernel(geom.grid.shape, params)
    mean = params.brightness * fftconv.fft_correlate(sample, k)
    return maybe_poisson(key, mean)


def _scan(sample, params, geom, key, noise_mode="collapsed",
          windowed=None):
    """The scan path. ``windowed`` picks the per-step pipeline: ``None``
    takes the banded-window one exactly when ``_point_band`` finds static
    windows, ``True`` requires them (``ValueError`` otherwise), ``False``
    forces the full-frame one (parity tests, route timings)."""
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    shape = geom.grid.shape
    h, w = shape
    chunk = geom.chunk
    num_steps = geom.num_steps
    if num_steps % chunk:
        raise ValueError("chunk must divide height * width")
    n_chunks = num_steps // chunk
    per_step = key is not None and noise_mode == "per_step"

    eff = models.effective_point_psf(shape, params)
    det = psfs.detection_psf(shape, params.sigma_det)
    pin = psfs.pinhole_mask(shape, params.pinhole_radius)

    if not per_step:
        # All W*H steps collapse: folding detection into the step
        # (Q = pin (*) det) makes each detected value an inner product with
        # a shifted copy of P = eff . Q, so the whole raster is ONE circular
        # correlation with P -- the same kernel the analytic path derives.
        p2d = eff * fftconv.fft_convolve(pin, det)
        img = params.brightness * fftconv.fft_correlate(sample, p2d)
        return img if key is None else maybe_poisson(key, img)

    # Banded-window engine: when static supports are available, the whole
    # per-step pipeline -- illuminate, separable 2D convolve, Poisson
    # sample, pinhole-sum -- runs on translating 2D windows (the spot
    # illuminates ~6.5 sigma, the pinhole reads even less), batched over
    # row blocks. ~200x less sampled data than full frames at 512^2.
    band = _point_band(params, h, w, chunk)
    if windowed is None:
        windowed = band is not None
    elif windowed and band is None:
        raise ValueError(
            "windowed route needs static point windows (concrete sigma_exc "
            "and pinhole radius, Gaussian excitation, chunks within one row, "
            "windows smaller than the field)")
    if windowed:
        return _banded_point_scan(sample, params, geom, key, eff, pin, band)

    # Full-frame per-step camera synthesis with separable detection: two 1D
    # convolutions instead of a 2D FFT pair (the 2D illumination must stay
    # inside the loop, but det = gy (x) gx always factorizes).
    otf_y = fftconv.profile_to_otf1d(psfs.detection_profile(h, params.sigma_det))
    otf_x = fftconv.profile_to_otf1d(psfs.detection_profile(w, params.sigma_det))
    # Raster scan: step s visits pixel (s // W, s % W).
    steps = jnp.arange(num_steps).reshape(n_chunks, chunk)
    xs = (steps, jax.random.split(key, n_chunks))

    # Descanned pinhole detection runs as a spectral dot against the STATIC
    # pinhole's OTF, evaluated at the scan position (correlate_otf_at),
    # instead of a second [C, H, W] position-gather of the pinhole followed
    # by a reduction: the same pinhole-masked camera sum (centered-kernel
    # convention, identical to the analytic collapse) for one rfft2 + an
    # O(H*W/2) bilinear form per step -- no [C, H, W] inverse FFT, no
    # gather, and the raster image is rebuilt from scan's stacked outputs
    # with no scatter at all.
    pin_otf = fftconv.kernel_to_otf(pin)

    def body(_, chunk_in):
        pos_flat, k = chunk_in
        pos = jnp.stack([pos_flat // w, pos_flat % w], axis=-1)  # [C, 2] (y, x)
        with jax.named_scope("conv"):
            ill = shifted_images(eff, pos)                       # [C, H, W]
            blurred = fftconv.convolve_otf1d(
                fftconv.convolve_otf1d(ill * sample, otf_x, axis=-1, n=w),
                otf_y, axis=-2, n=h)
        with jax.named_scope("sample"):
            cam = maybe_poisson(k, params.brightness * blurred)
        with jax.named_scope("place"):
            vals = fftconv.correlate_otf_at(cam, pin_otf, pos,
                                            precision=_PRECISION)
        return None, vals

    _, vals = jax.lax.scan(body, None, xs)
    # Chunks tile the raster in order: stacked outputs ARE the image.
    return vals.reshape(shape)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _point_band(params, h: int, w: int,
                chunk: int) -> tuple[int, int, int, int] | None:
    """Static 2D band windows ``(dy_in, dx_in, dy_out, dx_out)`` for the
    per-step point engine.

    Raster chunks that divide the width stay within ONE row, so the C
    positions of a chunk share a y window and span a contiguous x window:

    * input (sample/illumination) windows bound the effective spot's
      support (``exc_support``, < 4e-10 of peak outside ~6.5 sigma;
      depletion only narrows it);
    * output (camera) windows bound the PINHOLE support -- descanned
      detection reads nothing else, so camera pixels outside are neither
      produced nor sampled (their noise cannot reach the image; the same
      argument as the line engines' slit windows).

    All conv/pinhole tables are then chunk-invariant up to translation.
    None when a needed support is unavailable (traced widths without
    static ``*_support`` fields, custom illumination model) or the
    windows would not be smaller than the field.
    """
    m = getattr(params, "model", None)
    if m is not None and not getattr(m, "gaussian_excitation", False):
        return None  # unknown excitation support -> full-frame pipeline
    from rescan_line_sted_tpu.config import _aperture_support, _support

    # explicit is-None tests: a legitimate 0 support must not be treated
    # as missing (falsy) and re-derived from a possibly-traced width
    s_exc = getattr(params, "exc_support", None)
    if s_exc is None:
        s_exc = _support(params.sigma_exc)
    pin = getattr(params, "pin_support", None)
    if pin is None:
        pin = _aperture_support(params.pinhole_radius)
    if s_exc is None or pin is None:
        return None
    if w % chunk:
        return None  # chunks must not cross rows
    kx = 128 if w >= 256 else 8  # contraction width rounds up to 128 when it fits
    dx_in = _round_up(chunk + 2 * s_exc, kx)
    dy_in = _round_up(2 * s_exc + 2, 8)
    dx_out = _round_up(chunk + 2 * pin, 8)
    dy_out = _round_up(2 * pin + 2, 8)
    if dx_in >= w or dy_in >= h or dx_out >= w or dy_out >= h:
        return None
    return (dy_in, dx_in, dy_out, dx_out)


def _banded_point_scan(sample, params, geom, key, eff, pin, band,
                       draw_noise: bool = True):
    """Per-step point-STED scan on translating 2D windows (see _point_band).

    Batched over row blocks: one scan iteration processes every position of
    ``hc`` rows x one x-chunk, as two grouped matmuls (y-conv with the
    illumination folded in as a static 4D tensor, then x-conv), a windowed
    Poisson draw, and a pinhole-weighted reduction. The full-frame
    camera is never materialized. ``draw_noise=False`` skips the Poisson
    draw (the deterministic windowed scan -- must equal the collapsed
    closed form exactly; parity-tested).
    """
    h, w = geom.grid.shape
    chunk = geom.chunk
    dy_in, dx_in, dy_out, dx_out = band
    sy_in, sx_in = dy_in // 2, (dx_in - chunk) // 2
    sy_out, sx_out = dy_out // 2, (dx_out - chunk) // 2
    cy, cx = h // 2, w // 2
    # largest row block <= 64 that divides h (memory: t1 is
    # [hc, chunk * dy_out, dx_in] f32)
    hc = 64
    while h % hc:
        hc //= 2
    nx = w // chunk
    n_iter = (h // hc) * nx

    det_y = psfs.detection_profile(h, params.sigma_det)
    det_x = psfs.detection_profile(w, params.sigma_det)
    cc = jnp.arange(chunk)
    yi = jnp.arange(dy_in)
    xi = jnp.arange(dx_in)
    y2 = jnp.arange(dy_out)
    x2 = jnp.arange(dx_out)
    # chunk-invariant tables (values traced, shapes static)
    eff_wc = eff[((cy + yi - sy_in) % h)[None, :, None],
                 ((cx + xi[None, None, :] - sx_in - cc[:, None, None]) % w)]
    dety_blk = det_y[(cy + (y2[:, None] - sy_out) - (yi[None, :] - sy_in))
                     % h]                                    # [Do_y, Di_y]
    detx_blk = det_x[(cx + (x2[:, None] - sx_out) - (xi[None, :] - sx_in))
                     % w]                                    # [Do_x, Di_x]
    pin_wc = pin[((cy + y2 - sy_out) % h)[None, :, None],
                 ((cx + x2[None, None, :] - sx_out - cc[:, None, None]) % w)]
    # stage-1 tensor: y-conv with the illumination folded in.
    # P[xi, yi, (c, y2)] = dety_blk[y2, yi] * eff_wc[c, yi, xi]
    p_t = jnp.einsum("oy,cyx->xyco", dety_blk, eff_wc,
                     precision=_PRECISION).reshape(
        dx_in, dy_in, chunk * dy_out)

    keys = jax.random.split(key, n_iter)
    row_off = jnp.arange(hc)[:, None] + jnp.arange(dy_in)[None, :] - sy_in

    def body(img, chunk_in):
        g, k = chunk_in
        i, j = g // nx, g % nx
        y_base, x0 = i * hc, j * chunk
        with jax.named_scope("conv"):
            s_x = jnp.roll(sample, sx_in - x0, axis=1)[:, :dx_in]  # [H, Di_x]
            s_w = s_x[(y_base + row_off) % h]         # [hc, Di_y, Di_x]
            # stage 1 (y-conv, illumination folded): batch over xi
            t1 = jnp.einsum("xyn,hyx->hnx", p_t, s_w,
                            preferred_element_type=jnp.float32,
                            precision=_PRECISION)     # [hc, C*Do_y, Di_x]
            # stage 2 (x-conv)
            cam = jnp.einsum("hnx,ox->hno", t1, detx_blk,
                             preferred_element_type=jnp.float32,
                             precision=_PRECISION)    # [hc, C*Do_y, Do_x]
            cam = params.brightness * cam.reshape(hc, chunk, dy_out, dx_out)
        with jax.named_scope("sample"):
            counts = maybe_poisson(k, cam) if draw_noise else cam
        with jax.named_scope("place"):
            vals = jnp.einsum("hcyx,cyx->hc", counts, pin_wc,
                              precision=_PRECISION)
            return jax.lax.dynamic_update_slice(img, vals, (y_base, x0)), None

    init = jnp.zeros((h, w), jnp.float32)
    img, _ = jax.lax.scan(body, init, (jnp.arange(n_iter), keys))
    return img
