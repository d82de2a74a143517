"""Rescanned point-STED: 2D pixel reassignment (ISM / rescan-confocal
detection applied to the point-STED scan; beyond-reference capability).

The paper's rescanned LINE-STED (``imaging/rescan.py``; reference call
stack 4.3) descends from rescan confocal / image-scanning microscopy, where
the full 2D camera frame captured at every POINT-scan position ``p`` is
accumulated into a magnified canvas at ``R * p`` (canvas pixel of camera
pixel ``x``: ``u = R*p + (x - p)``). This module completes that family: the
same pixel-reassignment physics in both axes, with the donut-depleted point
illumination. At ``s = 0`` it reproduces classic rescan confocal (sqrt(2)
resolution gain at matched widths); with depletion it is "rescan STED".

Methods:

* ``"analytic"`` (default): the closed-form canvas mean, any rescan factor
  and any binning (b > 1 runs the b^2-residue form in
  ``rescan_point_canvas_mean``; DERIVATIONS 3c). Derivation for b = 1
  (camera indices unwrapped -- exact for samples zero within ~PSF support
  of ALL edges, both axes reassign; pad otherwise). With centered PSFs
  (center ``c``), subpixel placement, canvas ring ``Nc = (Hc, Wc)`` and
  frequency ``k = (ky, kx)``::

      canvas_hat(k) = B * D_hat(k) * E(k) * S_R(k)
      D_hat(k) = sum_a det[a] exp(-2i pi k.(a - c) / Nc)
      E(k)     = sum_a eff[a] exp(+2i pi k.(R-1)(a - c) / Nc)
      S_R(k)   = sum_a sample[a] exp(-2i pi k.R a / Nc)

  (obtained by pushing the reassignment sum through the image formation:
  ``canvas(u) = sum_p sum_y sample(y) eff(y-p) det(u - Ry + (R-1)(y-p))``).
  ``E`` and ``S_R`` are scaled 2D DFTs -- the exponent separates per axis,
  so each is two (complex) matmuls against static f64-built phase
  tables; ``D_hat`` is one zero-padded rfft2 of the (traced) detection PSF.
  O(1) FFTs + four matmuls per acquisition, any ``rescan_factor >= 1``
  (fractional R exact via band-limited placement).

* ``"scan"``: the faithful per-scan-position process (every camera frame
  simulated, re-binned, and placed spectrally with per-position 2D phase
  ramps), any binning; ``noise_mode="per_step"`` draws per-frame shot
  noise on every camera frame. O(H*W) frames: use for verification and
  camera-statistics studies, the analytic path for production.

Noise semantics match ``imaging/rescan.py``: with integer reassignment each
camera pixel lands on one canvas pixel and collapsed noise is exact;
subpixel placement of integer counts carries bounded sinc ringing.

Camera-frame inspection: the raw frames of this modality are identical to
point-STED's (same illumination and detection; only the accumulation
differs) -- use ``imaging/frames.py:point_sted_camera_frames``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rescan_line_sted_tpu.config import (
    PointSTEDParams,
    RescanPointGeometry,
    matmul_precision,
)
from rescan_line_sted_tpu.imaging.analytic import _np_phases
from rescan_line_sted_tpu.imaging.point_sted import AcquisitionResult
from rescan_line_sted_tpu.imaging.shifts import shifted_images
from rescan_line_sted_tpu.kernels import fftconv
from rescan_line_sted_tpu.physics import psf as psfs
from rescan_line_sted_tpu.physics.dose import point_sted_dose
from rescan_line_sted_tpu.physics.noise import maybe_poisson

# engine matmul precision (HIGHEST unless RLS_MATMUL_PRECISION overrides;
# see config.matmul_precision for the measured error budget)
_PRECISION = matmul_precision()


def effective_point_psf(shape: tuple[int, int],
                        params: PointSTEDParams) -> jnp.ndarray:
    """Centered depleted point illumination ``exc * exp(-s * dep)``.

    Built through ``params.model`` (physics/models.py pluggable-generator
    seam; None = Gaussian excitation + ``u e^{1-u}`` donut closed forms).
    """
    from rescan_line_sted_tpu.physics import models

    return models.effective_point_psf(shape, params)


def optimal_rescan_factor_point(params: PointSTEDParams,
                                size: int) -> jnp.ndarray:
    """Theory-optimal 2D rescan factor ``R = 1 + sigma_det^2/sigma_ill^2``.

    Same inverse-variance weighting as the line case
    (``imaging/rescan.py:optimal_rescan_factor``), isotropic here; the
    effective illumination width is measured from the depleted point PSF's
    central x-profile.

    Note: strong depletion collapses sigma_ill and pushes the optimum very
    high (R ~ 25 at s = 8 with matched base widths) -- a canvas R x the
    field per axis. The information gain beyond R ~ 2-3 is marginal (the
    reassigned photons are already far sharper than the canvas pixel);
    practical acquisitions cap R at a few, which this function deliberately
    does not do for you.
    """
    from rescan_line_sted_tpu.algorithms.metrics import fwhm_1d

    eff = effective_point_psf((size, size), params)
    sigma_ill = fwhm_1d(eff[size // 2]) / 2.3548200450309493
    return 1.0 + jnp.square(params.sigma_det) / jnp.square(sigma_ill)


def practical_rescan_factor_point(params: PointSTEDParams, size: int,
                                  tolerance: float = 0.05,
                                  cap: float | None = None,
                                  snap: int | None = 8) -> jnp.ndarray:
    """Smallest 2D rescan factor within ``tolerance`` of optimal resolution.

    The isotropic analog of ``imaging/rescan.py:practical_rescan_factor``
    (same closed form -- the reassigned-kernel variance
    ``s_i^2 (1-1/R)^2 + s_d^2 / R^2`` applies per axis); see there for the
    derivation, including the ``snap`` rounding (rational R keeps canvas
    shapes round-number-friendly; the line engine's strip-path routing
    argument applies to its x axis). Recommended operating point for ISM
    acquisitions where the exact optimum's R x field canvas is impractical.
    """
    from rescan_line_sted_tpu.algorithms.metrics import fwhm_1d
    from rescan_line_sted_tpu.imaging.rescan import (
        practical_factor_from_sigmas,
    )

    eff = effective_point_psf((size, size), params)
    sigma_ill = fwhm_1d(eff[size // 2]) / 2.3548200450309493
    return practical_factor_from_sigmas(sigma_ill, params.sigma_det,
                                        tolerance, cap, snap)


def rescanned_point_sted_image(
    sample: jnp.ndarray,
    params: PointSTEDParams,
    geom: RescanPointGeometry,
    key: jax.Array | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    reassignment: str = "auto",
    boundary: str = "circular",
    margin: int | None = None,
) -> AcquisitionResult:
    """Simulate a full rescanned point-STED acquisition of ``sample``.

    Returns the canvas ``[round(R*H)/b, round(R*W)/b]``. ``params`` is
    ``PointSTEDParams`` (``pinhole_radius`` is ignored -- rescan detection
    keeps the whole camera frame). See the module doc for methods and
    noise semantics.
    """
    if boundary == "apodized":
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
            lambda s, g, **kw: rescanned_point_sted_image(s, params, g, **kw),
            sample, geom, default_margin(geom) if margin is None else margin,
            key=key, method=method, noise_mode=noise_mode,
            reassignment=reassignment)
        return res.replace(dose=point_sted_dose(params, geom))
    if boundary != "circular":
        raise ValueError(f"unknown boundary {boundary!r}")
    if method == "analytic":
        image = _analytic(sample, params, geom, key)
    elif method == "scan":
        image = _scan(sample, params, geom, key, noise_mode, reassignment)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(image=image, dose=point_sted_dose(params, geom))


def _phase_tables(h: int, w: int, hc: int, wc: int, r: float):
    """All static phase tables of the closed form (f64 host-built)."""
    ay = np.arange(h, dtype=np.float64)
    ax = np.arange(w, dtype=np.float64)
    ky = np.arange(hc, dtype=np.float64)
    kx = np.arange(wc // 2 + 1, dtype=np.float64)
    cy, cx = h // 2, w // 2
    py = _np_phases(ky[None, :] * r * ay[:, None] / hc)          # [h, Hc]
    px = _np_phases(kx[None, :] * r * ax[:, None] / wc)          # [w, Kx]
    by = _np_phases(-ky[None, :] * (r - 1.0) * (ay - cy)[:, None] / hc)
    bx = _np_phases(-kx[None, :] * (r - 1.0) * (ax - cx)[:, None] / wc)
    # recenter rfft2(embed(det)) by +c: D_hat(k) = rfft2 * exp(+2i pi k.c/Nc)
    dy = _np_phases(-ky * cy / hc)                               # [Hc]
    dx = _np_phases(-kx * cx / wc)                               # [Kx]
    return py, px, by, bx, dy, dx


def _analytic(sample, params, geom, key):
    return maybe_poisson(key, rescan_point_canvas_mean(sample, params, geom))


def rescan_point_canvas_mean(
    sample: jnp.ndarray,
    params: PointSTEDParams,
    geom: RescanPointGeometry,
) -> jnp.ndarray:
    """Noise-free rescanned point-STED canvas: the closed form of the module
    doc (``canvas_hat = B * D_hat * E * S_R``), exact for ANY rescan factor
    and ANY detector binning. Linear in ``sample`` -- also the forward
    operator for operator-form deconvolution.

    With ``binning > 1`` the reassignment map is b-periodically
    shift-variant in BOTH axes: writing the emitter position ``a = b*m +
    rho`` per axis (b^2 residue classes) and pushing the binned-frame
    placement through the image formation gives

        canvas_hat(k) = B * E_b(k) * sum_rho Dy_ry(ky) Dx_rx(kx) S_rho(k)

    where ``D*_r`` are the phase-r binned detection profile spectra
    (recentered; the detection PSF is separable so the 2D binned kernel
    factorizes exactly), ``E_b`` is the illumination DFT at the
    b-scaled frequencies, and ``S_rho`` is the scaled DFT of the
    ``rho``-residue subsampled sample placed at ``R*m`` -- the same
    per-axis algebra the line engine's ``rescan_x_kernels_rfft`` uses
    (parity-verified there), applied to both axes.
    """
    if geom.binning != 1:
        return _canvas_mean_binned(sample, params, geom)
    h, w = geom.grid.shape
    hc, wc = geom.canvas_shape
    # module-level jit (static geometry as static args; inlines for free
    # under an outer jit): eager callers compile the complex chain once
    return _canvas_mean_b1(sample, params, shape=(h, w),
                           canvas_shape=(hc, wc),
                           r=float(geom.rescan_factor))


@functools.partial(jax.jit, static_argnames=("shape", "canvas_shape", "r"))
def _canvas_mean_b1(sample, params, *, shape, canvas_shape, r):
    h, w = shape
    hc, wc = canvas_shape
    py, px, by, bx, dy, dx = _phase_tables(h, w, hc, wc, r)

    eff = effective_point_psf((h, w), params).astype(jnp.complex64)
    det = psfs.detection_psf((h, w), params.sigma_det)
    d_embed = jnp.zeros((hc, wc), jnp.float32).at[:h, :w].set(det)
    d_hat = jnp.fft.rfft2(d_embed) * dy[:, None] * dx[None, :]  # [Hc, Kx]

    e1 = jnp.einsum("yx,yk->kx", eff, by, precision=_PRECISION)  # [Hc, w]
    e_hat = jnp.einsum("kx,xq->kq", e1, bx, precision=_PRECISION)
    s1 = jnp.einsum("yx,yk->kx", sample.astype(jnp.complex64), py,
                    precision=_PRECISION)                        # [Hc, w]
    s_hat = jnp.einsum("kx,xq->kq", s1, px, precision=_PRECISION)

    canvas = jnp.fft.irfft2(s_hat * e_hat * d_hat, s=(hc, wc))
    return params.brightness * canvas


def _binned_axis_spectra(n: int, nc: int, b: int, r: float, kk, det_profile):
    """Per-residue binned-detection spectra for one axis: [b, len(kk)].

    ``d_rho[u] = sum_j det[(b u + j - rho) % n]`` rfft-embedded on the
    canvas ring, recentered to the binned center ``n // (2b)``, and
    multiplied by the residue placement phase
    ``exp(-2i pi k (R-1) rho / (b nc))`` (mirrors the line engine's
    ``rescan_x_kernels_rfft``, whose recipe is oracle-verified at b=2).
    """
    u_idx = np.arange(n // b)
    j_idx = np.arange(b)
    rho_idx = np.arange(b)
    gather = (b * u_idx[None, :, None] + j_idx[None, None, :]
              - rho_idx[:, None, None]) % n
    d = det_profile[gather].sum(-1)                            # [b, n/b]
    center_ph = _np_phases(-kk * (n // (2 * b)) / nc)
    rho_ph = _np_phases(kk[None, :] * (r - 1.0) * rho_idx[:, None] / (b * nc))
    # full FFT then slice: the y axis keeps ALL nc modes under rfft2, the
    # x axis only the one-sided nc//2+1 -- len(kk) selects either
    spec = jnp.fft.fft(d, n=nc, axis=-1)[:, :kk.shape[0]]
    return spec * center_ph[None, :] * rho_ph


def _canvas_mean_binned(sample, params, geom):
    """The b > 1 closed form (see ``rescan_point_canvas_mean``)."""
    return _canvas_mean_bn(sample, params, b=geom.binning,
                           shape=geom.grid.shape,
                           canvas_shape=geom.canvas_shape,
                           r=float(geom.rescan_factor))


@functools.partial(jax.jit,
                   static_argnames=("b", "shape", "canvas_shape", "r"))
def _canvas_mean_bn(sample, params, *, b, shape, canvas_shape, r):
    h, w = shape
    hc, wc = canvas_shape
    ky = np.arange(hc, dtype=np.float64)
    kx = np.arange(wc // 2 + 1, dtype=np.float64)
    cy, cx = h // 2, w // 2

    det_y = psfs.detection_profile(h, params.sigma_det)
    det_x = psfs.detection_profile(w, params.sigma_det)
    dy = _binned_axis_spectra(h, hc, b, r, ky, det_y)          # [b, Hc]
    # x axis: the rfft ring is one-sided; same formula on the kept modes
    dx = _binned_axis_spectra(w, wc, b, r, kx, det_x)          # [b, Kx]

    # E_b: illumination DFT at the b-scaled frequencies (full 2D eff)
    ay = np.arange(h, dtype=np.float64)
    ax = np.arange(w, dtype=np.float64)
    by = _np_phases(-ky[None, :] * (r - 1.0) * (ay - cy)[:, None] / (b * hc))
    bx = _np_phases(-kx[None, :] * (r - 1.0) * (ax - cx)[:, None] / (b * wc))
    eff = effective_point_psf((h, w), params).astype(jnp.complex64)
    e1 = jnp.einsum("yx,yk->kx", eff, by, precision=_PRECISION)
    e_hat = jnp.einsum("kx,xq->kq", e1, bx, precision=_PRECISION)

    # placement tables for the residue-subsampled sample at R * m
    my = np.arange(h // b, dtype=np.float64)
    mx = np.arange(w // b, dtype=np.float64)
    py = _np_phases(ky[None, :] * r * my[:, None] / hc)        # [h/b, Hc]
    px = _np_phases(kx[None, :] * r * mx[:, None] / wc)        # [w/b, Kx]

    s_split = sample.reshape(h // b, b, w // b, b).astype(jnp.complex64)
    canvas_hat = jnp.zeros((hc, wc // 2 + 1), jnp.complex64)
    for ry in range(b):
        for rx in range(b):
            s_rho = s_split[:, ry, :, rx]                      # [h/b, w/b]
            s1 = jnp.einsum("yx,yk->kx", s_rho, py, precision=_PRECISION)
            s_hat = jnp.einsum("kx,xq->kq", s1, px, precision=_PRECISION)
            canvas_hat = canvas_hat + dy[ry][:, None] * dx[rx][None, :] \
                * s_hat
    canvas = jnp.fft.irfft2(e_hat * canvas_hat, s=(hc, wc))
    return params.brightness * canvas


def rescan_point_system_kernel(
    geom: RescanPointGeometry, params: PointSTEDParams
) -> jnp.ndarray:
    """Centered effective rescan kernel H on the canvas grid, [Hc, Wc].

    ``H(v) = sum_t eff(t) det(v + (R-1) t)``: the detection PSF smeared by
    the (R-1)-scaled depleted illumination spot. The noise-free canvas is
    ``brightness * conv(place_2d(sample, R), H)`` (binning=1); serves as the
    deconvolution PSF and resolution-metric input for this modality.
    """
    if geom.binning != 1:
        raise ValueError("system kernel defined for binning=1")
    return _system_kernel(params, shape=geom.grid.shape,
                          canvas_shape=geom.canvas_shape,
                          r=float(geom.rescan_factor))


@functools.partial(jax.jit, static_argnames=("shape", "canvas_shape", "r"))
def _system_kernel(params, *, shape, canvas_shape, r):
    h, w = shape
    hc, wc = canvas_shape
    _, _, by, bx, dy, dx = _phase_tables(h, w, hc, wc, r)
    eff = effective_point_psf((h, w), params).astype(jnp.complex64)
    det = psfs.detection_psf((h, w), params.sigma_det)
    d_embed = jnp.zeros((hc, wc), jnp.float32).at[:h, :w].set(det)
    d_hat = jnp.fft.rfft2(d_embed) * dy[:, None] * dx[None, :]
    e1 = jnp.einsum("yx,yk->kx", eff, by, precision=_PRECISION)
    e_hat = jnp.einsum("kx,xq->kq", e1, bx, precision=_PRECISION)
    return jnp.fft.fftshift(jnp.fft.irfft2(e_hat * d_hat, s=(hc, wc)))


def _rebin2(cam: jnp.ndarray, b: int) -> jnp.ndarray:
    if b == 1:
        return cam
    *lead, h, w = cam.shape
    return cam.reshape(*lead, h // b, b, w // b, b).sum(axis=(-3, -1))


def _scan(sample, params, geom, key, noise_mode="collapsed",
          reassignment="auto"):
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if reassignment not in ("auto", "rounded", "subpixel"):
        raise ValueError(f"unknown reassignment {reassignment!r}")
    h, w = geom.grid.shape
    b = geom.binning
    hc, wc = geom.canvas_shape
    chunk = geom.chunk
    if (h * w) % chunk:
        raise ValueError("chunk must divide height * width")
    if reassignment == "auto":
        step = (geom.rescan_factor - 1.0) / b
        reassignment = "rounded" if abs(step - round(step)) < 1e-9 \
            else "subpixel"
    r = float(geom.rescan_factor)

    # per-position canvas phase ramps, separable per axis, f64 host-built
    oy = (r - 1.0) * np.arange(h, dtype=np.float64) / b
    ox = (r - 1.0) * np.arange(w, dtype=np.float64) / b
    if reassignment == "rounded":
        oy, ox = np.round(oy), np.round(ox)
    ky = np.arange(hc, dtype=np.float64)
    kx = np.arange(wc // 2 + 1, dtype=np.float64)
    phy = np.exp(-2j * np.pi * ky[None, :] * oy[:, None] / hc)   # [h, Hc]
    phx = np.exp(-2j * np.pi * kx[None, :] * ox[:, None] / wc)   # [w, Kx]
    ph_pairs = tuple(
        (jnp.asarray(p.real.astype(np.float32)),
         jnp.asarray(p.imag.astype(np.float32))) for p in (phy, phx))

    per_step = key is not None and noise_mode == "per_step"
    keys = jax.random.split(key, (h * w) // chunk) if per_step else None
    canvas = _scan_loop(sample, params, keys, ph_pairs,
                        shape=(h, w), canvas_shape=(hc, wc), b=b,
                        chunk=chunk)
    if key is not None and noise_mode == "collapsed":
        canvas = maybe_poisson(key, canvas)
    return canvas


@functools.partial(
    jax.jit, static_argnames=("shape", "canvas_shape", "b", "chunk"))
def _scan_loop(sample, params, keys, ph_pairs, *, shape, canvas_shape, b,
               chunk):
    h, w = shape
    hc, wc = canvas_shape
    per_step = keys is not None
    n_chunks = (h * w) // chunk

    eff = effective_point_psf(shape, params)
    otf_y = fftconv.profile_to_otf1d(
        psfs.detection_profile(h, params.sigma_det))
    otf_x = fftconv.profile_to_otf1d(
        psfs.detection_profile(w, params.sigma_det))
    (phy_re, phy_im), (phx_re, phx_im) = ph_pairs

    steps = jnp.arange(h * w).reshape(n_chunks, chunk)
    xs = (steps, keys) if per_step else steps

    def body(canvas_hat, chunk_in):
        pos_flat, k = chunk_in if per_step else (chunk_in, None)
        pos = jnp.stack([pos_flat // w, pos_flat % w], axis=-1)  # [C, 2]
        ill = shifted_images(eff, pos)                           # [C, H, W]
        blurred = fftconv.convolve_otf1d(
            fftconv.convolve_otf1d(ill * sample, otf_x, axis=-1, n=w),
            otf_y, axis=-2, n=h)
        frames = _rebin2(params.brightness * blurred, b)
        frames = maybe_poisson(k, frames)
        spec = jnp.fft.rfft2(frames, s=(hc, wc))                 # [C, Hc, Kx]
        phc_y = jax.lax.complex(phy_re[pos[:, 0]], phy_im[pos[:, 0]])
        phc_x = jax.lax.complex(phx_re[pos[:, 1]], phx_im[pos[:, 1]])
        add = jnp.einsum("chk,ch,ck->hk", spec, phc_y, phc_x,
                         precision=_PRECISION)
        return canvas_hat + add, None

    init = jnp.zeros((hc, wc // 2 + 1), jnp.complex64)
    canvas_hat, _ = jax.lax.scan(body, init, xs)
    return jnp.fft.irfft2(canvas_hat, s=(hc, wc))
