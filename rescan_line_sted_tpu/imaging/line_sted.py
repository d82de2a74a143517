"""Descanned line-STED engine (reference call stack 4.2; BASELINE config 2).

The excitation line runs along y and is scanned along x: ``W`` scan positions
produce one image column each through a descanned slit. Methods as in
``point_sted.py``: ``"analytic"`` (one FFT correlation with the closed-form
system kernel, exact statistics) and ``"scan"`` (the per-scan-position
process; this is the scan-steps/sec benchmark path). Scan scheduling:

* collapsed noise (default): detection folds into the step (``q = slit (*)
  gx``) and every step is an inner product with a shifted copy of
  ``p = eff . q`` -- the whole raster is ONE matmul against
  ``circulant(p)``.
* per-step noise: chunked ``lax.scan``; each chunk's camera frames come from
  a (windowed) circulant matmul, get Poisson-sampled, then slit-summed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.config import LineSTEDGeometry, LineSTEDParams
from rescan_line_sted_tpu.imaging import analytic
from rescan_line_sted_tpu.imaging.point_sted import AcquisitionResult
from rescan_line_sted_tpu.imaging.shifts import shifted_profiles
from rescan_line_sted_tpu.kernels import fftconv
from rescan_line_sted_tpu.physics import psf as psfs
from rescan_line_sted_tpu.physics.dose import line_sted_dose
from rescan_line_sted_tpu.physics.noise import maybe_poisson

from rescan_line_sted_tpu.config import matmul_precision

# engine matmul precision (HIGHEST unless RLS_MATMUL_PRECISION overrides;
# see config.matmul_precision for the measured error budget)
_PRECISION = matmul_precision()


def line_sted_image(
    sample: jnp.ndarray,
    params: LineSTEDParams,
    geom: LineSTEDGeometry,
    key: jax.Array | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    boundary: str = "circular",
    margin: int | None = None,
) -> AcquisitionResult:
    """Simulate a full descanned line-STED acquisition of ``sample``.

    ``noise_mode`` (scan path only): ``"collapsed"`` draws shot noise once
    from the accumulated detected mean -- statistically identical to
    per-camera-pixel draws because detection only *adds* independent Poisson
    variables (see ``physics/noise.py``) and ~4x faster; ``"per_step"``
    samples every camera frame like the reference's loop does.
    ``boundary``: ``"circular"`` or ``"padded"`` (open boundary via
    pad-acquire-crop; dose reported for the requested field).
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
            lambda s, g, **kw: line_sted_image(s, params, g, **kw),
            sample, geom, default_margin(geom) if margin is None else margin,
            key=key, method=method, noise_mode=noise_mode)
        return res.replace(dose=line_sted_dose(params, geom))
    if boundary != "circular":
        raise ValueError(f"unknown boundary {boundary!r}")
    if method == "analytic":
        image = _analytic(sample, params, geom, key)
    elif method == "scan":
        image = _scan(sample, params, geom, key, noise_mode)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(image=image, dose=line_sted_dose(params, geom))


def effective_line_profile(width: int, params: LineSTEDParams) -> jnp.ndarray:
    """Centered 1D effective (depleted) excitation line profile, [W].

    Built through ``params.model`` (physics/models.py pluggable-generator
    seam; None = Gaussian line + sin^2 stripe closed forms).
    """
    from rescan_line_sted_tpu.physics import models

    return models.effective_line_profile(width, params)


def _analytic(sample, params, geom, key):
    k = analytic.line_system_kernel(geom.grid.shape, params)
    mean = params.brightness * fftconv.fft_correlate(sample, k)
    return maybe_poisson(key, mean)


def _scan(sample, params, geom, key, noise_mode="collapsed",
          windowed=None):
    """The scan path. ``windowed`` picks the per-step pipeline: ``None``
    takes the windowed one exactly when ``_line_band`` finds static windows,
    ``True`` requires them (``ValueError`` otherwise), ``False`` forces the
    full-frame one (parity tests, route timings)."""
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    shape = geom.grid.shape
    h, w = shape
    chunk = geom.chunk
    if w % chunk:
        raise ValueError("chunk must divide width")
    n_chunks = w // chunk
    per_step = key is not None and noise_mode == "per_step"

    eff = effective_line_profile(w, params)
    slit = psfs.slit_profile(w, params.slit_halfwidth)

    # Separable detection: det = gy (x) gx exactly, and the line illumination
    # is y-invariant, so convy hoists out of the loop:
    # conv2d(det, sample . ill) == convx(gx, ill . convy(gy, sample)).
    gx = psfs.detection_profile(w, params.sigma_det)
    otf_y = fftconv.profile_to_otf1d(psfs.detection_profile(h, params.sigma_det))
    sample_y = fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h)
    if not per_step:
        # All W scan steps collapse to ONE matmul: folding detection into
        # the step (q = slit (*) gx) gives img(y, x0) = sum_a sample_y(y, a)
        # * p(a - x0) with p = eff . q, i.e. sample_y @ circulant(p). Same
        # per-step physics, scheduled as a single W x W matmul.
        q = fftconv.convolve_profiles(slit, gx)
        p_mat = fftconv.circulant_matrix(params.brightness * eff * q)
        img = jnp.dot(sample_y, p_mat,
                      preferred_element_type=jnp.float32,
                      precision=_PRECISION)
        return img if key is None else maybe_poisson(key, img)

    # Per-step noise: chunked lax.scan over explicit camera frames. With
    # static windows (_line_band) the pipeline is WINDOWED: the conv
    # contracts over a D_in sample-column window, and only the D_out camera
    # columns the slit can read are produced and sampled (descanned
    # detection never reads the rest, so its noise cannot reach the image)
    # -- all tables chunk-invariant. Otherwise every chunk synthesizes full
    # frames with one circulant matmul.
    band = _line_band(params, w, chunk)
    if windowed is None:
        windowed = band is not None
    elif windowed and band is None:
        raise ValueError(
            "windowed route needs static line windows (concrete sigma_exc "
            "and slit halfwidth, Gaussian excitation, windows narrower than "
            "the frame)")
    positions = jnp.arange(w).reshape(n_chunks, chunk)
    xs = (positions, jax.random.split(key, n_chunks))
    init = jnp.zeros(shape, jnp.float32)

    if windowed:
        d_in, d_out = band
        s_in = (d_in - chunk) // 2
        s_out = (d_out - chunk) // 2
        ci = jnp.arange(chunk)[:, None]
        # chunk-invariant tables (chunk positions are contiguous):
        # illumination window, windowed detection circulant block (straight
        # from the profile, no [W, W] intermediate), and the slit weights
        # inside the output window
        di = jnp.arange(d_in)[None, :]
        ill_w = eff[(w // 2 + di - s_in - ci) % w]               # [C, Di]
        g0w = fftconv.circulant_window(gx, d_out, d_in, s_out, s_in)
        scaled_win = (params.brightness
                      * g0w[None] * ill_w[:, None, :])           # [C, Do, Di]
        do = jnp.arange(d_out)[None, :]
        slit_w = slit[(w // 2 + do - s_out - ci) % w]            # [C, Do]
        sample_t = sample_y.T                                    # [W, H]

        def body(img, chunk_in):
            pos, k = chunk_in
            with jax.named_scope("conv"):
                a0 = pos[0] - s_in
                sample_win = jnp.take(sample_t,
                                      (a0 + jnp.arange(d_in)) % w,
                                      axis=0)                    # [Di, H]
                cam_win = jnp.einsum("cxd,dh->cxh", scaled_win, sample_win,
                                     preferred_element_type=jnp.float32,
                                     precision=_PRECISION)       # [C, Do, H]
            with jax.named_scope("sample"):
                frames = maybe_poisson(k, cam_win)
            with jax.named_scope("place"):
                cols = jnp.einsum("cxh,cx->hc", frames, slit_w)  # [H, C]
                return img.at[:, pos].set(cols), None
    else:
        gx_mat = fftconv.circulant_matrix(gx)

        def body(img, chunk_in):
            pos, k = chunk_in
            with jax.named_scope("conv"):
                ill = shifted_profiles(eff, pos)                 # [C, W]
                emitted_y = ill[:, None, :] * sample_y[None]     # [C, H, W]
                cam = params.brightness * jnp.einsum(
                    "cha,ax->chx", emitted_y, gx_mat,
                    preferred_element_type=jnp.float32,
                    precision=_PRECISION)
            with jax.named_scope("sample"):
                cam = maybe_poisson(k, cam)
            with jax.named_scope("place"):
                slits = shifted_profiles(slit, pos)              # [C, W]
                cols = jnp.einsum("chw,cw->hc", cam, slits)      # [H, C]
                return img.at[:, pos].set(cols), None

    img, _ = jax.lax.scan(body, init, xs)
    return img


def _line_band(params, w: int, chunk: int) -> tuple[int, int] | None:
    """Static band windows ``(d_in, d_out)`` for the line per-step pipeline.

    Same construction as ``rescan.py:_illum_band`` (illumination bounded by
    its Gaussian envelope -> a D_in sample-contraction window), except the
    OUTPUT window only needs the slit support: descanned detection reads
    nothing else, so camera columns outside ``d_out = C + 2(slit_hw + 2)``
    are neither produced nor sampled (their noise cannot reach the
    image). Exact: the slit profile
    has hard support. None when any needed parameter is traced, a custom
    illumination model with a non-default EXCITATION is installed (custom
    depletion keeps the band; models.py ``gaussian_excitation``), or the
    windows don't pay.
    """
    m = getattr(params, "model", None)
    if m is not None and not getattr(m, "gaussian_excitation", False):
        return None
    # static support fields ride the params treedef (config.py), so banding
    # survives params passed as jit arguments / vmapped
    from rescan_line_sted_tpu.config import _aperture_support, _support

    # explicit is-None tests: a legitimate 0 support must not be treated
    # as missing (falsy) and re-derived from a possibly-traced width
    s_exc = getattr(params, "exc_support", None)
    if s_exc is None:
        s_exc = _support(params.sigma_exc)
    slit_hw = getattr(params, "slit_support_px", None)
    if slit_hw is None:
        slit_hw = _aperture_support(params.slit_halfwidth)
    if s_exc is None or slit_hw is None:
        return None
    d_in = -(-(chunk + 2 * s_exc) // 128) * 128
    if d_in >= w:
        return None
    d_out = -(-(chunk + 2 * slit_hw) // 8) * 8
    if d_out >= w:
        return None  # slit wider than the frame: nothing to window
    return (d_in, d_out)
