"""Independent float64 numpy oracle for the STED simulation physics.

Written directly from the image-formation equations (SURVEY.md section 1.1),
NOT ported from the JAX engine and NOT from the reference (whose mount was
empty -- SURVEY.md section 0). Deliberately simple and loop-based: explicit
per-scan-position loops, ``np.roll`` shifts, full-grid circular FFT
convolutions, float64 throughout. Serves as

1. the correctness target for engine parity tests (BASELINE: <= 1e-5
   relative error on noise-free images), and
2. the CPU wall-clock denominator for the >= 100x speedup north star.

Shared conventions with the engine (documented in ``physics/psf.py``):
centered PSFs with center at ``n // 2``, circular convolution, illumination
PSFs peak-normalized, detection PSF sum-normalized.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------- PSFs ----

def _coords(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.float64) - (n // 2)


def radius_sq(shape) -> np.ndarray:
    y = _coords(shape[0])[:, None]
    x = _coords(shape[1])[None, :]
    return y * y + x * x


def gaussian_psf(shape, sigma) -> np.ndarray:
    return np.exp(-radius_sq(shape) / (2.0 * sigma**2))


def donut_psf(shape, sigma) -> np.ndarray:
    u = radius_sq(shape) / (2.0 * sigma**2)
    return u * np.exp(1.0 - u)


def line_excitation_profile(width, sigma) -> np.ndarray:
    x = _coords(width)
    return np.exp(-(x**2) / (2.0 * sigma**2))


def stripe_depletion_profile(width, period) -> np.ndarray:
    x = _coords(width)
    return np.sin(np.pi * x / period) ** 2


def detection_psf(shape, sigma) -> np.ndarray:
    g = gaussian_psf(shape, sigma)
    return g / g.sum()


def effective_psf(exc, dep, s) -> np.ndarray:
    return exc * np.exp(-s * dep)


def pinhole_mask(shape, radius) -> np.ndarray:
    return (radius_sq(shape) <= radius**2).astype(np.float64)


def slit_profile(width, halfwidth) -> np.ndarray:
    return (np.abs(_coords(width)) <= halfwidth).astype(np.float64)


# ----------------------------------------------------- building blocks ----

def fft_convolve(img: np.ndarray, kernel_centered: np.ndarray) -> np.ndarray:
    """Circular convolution with a centered kernel (peak at n//2)."""
    otf = np.fft.rfft2(np.fft.ifftshift(kernel_centered))
    return np.fft.irfft2(np.fft.rfft2(img) * otf, s=img.shape)


def fft_correlate(img: np.ndarray, kernel_centered: np.ndarray) -> np.ndarray:
    """Circular correlation: out(r) = sum_a img(a) k(a - r)."""
    otf = np.fft.rfft2(np.fft.ifftshift(kernel_centered))
    return np.fft.irfft2(np.fft.rfft2(img) * np.conj(otf), s=img.shape)


def shift_to(arr_centered: np.ndarray, y0: int, x0: int) -> np.ndarray:
    """Circularly move a centered array's center to pixel (y0, x0)."""
    return np.roll(arr_centered,
                   (y0 - arr_centered.shape[0] // 2,
                    x0 - arr_centered.shape[1] // 2), axis=(0, 1))


def shift_profile_to(profile_centered: np.ndarray, x0: int) -> np.ndarray:
    return np.roll(profile_centered, x0 - profile_centered.shape[0] // 2)


# ----------------------------------------------------------- modalities ----

def point_sted_image(sample, *, sigma_exc, sigma_det, sigma_dep, depletion,
                     pinhole_radius, brightness, rng=None) -> np.ndarray:
    """Descanned point-STED: loop over every pixel as a scan position."""
    sample = np.asarray(sample, np.float64)
    shape = sample.shape
    exc = gaussian_psf(shape, sigma_exc)
    dep = donut_psf(shape, sigma_dep)
    eff = effective_psf(exc, dep, depletion)
    det = detection_psf(shape, sigma_det)
    pin = pinhole_mask(shape, pinhole_radius)
    img = np.zeros(shape)
    for y0 in range(shape[0]):
        for x0 in range(shape[1]):
            ill = shift_to(eff, y0, x0)
            cam = brightness * fft_convolve(sample * ill, det)
            if rng is not None:
                cam = rng.poisson(np.maximum(cam, 0.0)).astype(np.float64)
            img[y0, x0] = np.sum(cam * shift_to(pin, y0, x0))
    return img


def line_sted_image(sample, *, sigma_exc, sigma_det, stripe_period, depletion,
                    slit_halfwidth, brightness, rng=None) -> np.ndarray:
    """Descanned line-STED: loop over the W column scan positions."""
    sample = np.asarray(sample, np.float64)
    h, w = sample.shape
    exc = line_excitation_profile(w, sigma_exc)
    dep = stripe_depletion_profile(w, stripe_period)
    eff = effective_psf(exc, dep, depletion)
    det = detection_psf(sample.shape, sigma_det)
    slit = slit_profile(w, slit_halfwidth)
    img = np.zeros((h, w))
    for x0 in range(w):
        ill = shift_profile_to(eff, x0)[None, :]
        cam = brightness * fft_convolve(sample * ill, det)
        if rng is not None:
            cam = rng.poisson(np.maximum(cam, 0.0)).astype(np.float64)
        img[:, x0] = cam @ shift_profile_to(slit, x0)
    return img


def rescanned_line_sted_image(sample, *, sigma_exc, sigma_det, stripe_period,
                              depletion, brightness, rescan_factor=2.0,
                              binning=1, rng=None,
                              reassignment="rounded") -> np.ndarray:
    """Rescanned line-STED: re-binned camera frames scatter-added at R*x0.

    ``reassignment="rounded"`` snaps each frame's canvas offset
    ``(R-1)*x0/b`` to the nearest binned pixel (the only option for integer
    R, where it is exact); ``"subpixel"`` places the frame at the exact
    fractional offset by band-limited (Fourier phase-ramp) interpolation on
    the canvas ring, the ideal continuous rescan sweep.
    """
    sample = np.asarray(sample, np.float64)
    h, w = sample.shape
    b = binning
    hc, wc = h // b, int(round(rescan_factor * w)) // b
    exc = line_excitation_profile(w, sigma_exc)
    dep = stripe_depletion_profile(w, stripe_period)
    eff = effective_psf(exc, dep, depletion)
    det = detection_psf(sample.shape, sigma_det)
    canvas = np.zeros((hc, wc))
    k = np.arange(wc // 2 + 1)
    for x0 in range(w):
        ill = shift_profile_to(eff, x0)[None, :]
        cam = brightness * fft_convolve(sample * ill, det)
        if rng is not None:
            cam = rng.poisson(np.maximum(cam, 0.0)).astype(np.float64)
        frame = cam.reshape(h // b, b, w // b, b).sum(axis=(1, 3))
        if reassignment == "rounded":
            off = int(round((rescan_factor - 1.0) * x0 / b))
            cols = (off + np.arange(w // b)) % wc
            canvas[:, cols] += frame
        elif reassignment == "subpixel":
            off = (rescan_factor - 1.0) * x0 / b
            spec = np.fft.rfft(frame, n=wc, axis=-1)
            spec *= np.exp(-2j * np.pi * k * off / wc)
            canvas += np.fft.irfft(spec, n=wc, axis=-1)
        else:
            raise ValueError(f"unknown reassignment {reassignment!r}")
    return canvas


def rescanned_point_sted_image(sample, *, sigma_exc, sigma_det, sigma_dep,
                               depletion, brightness, rescan_factor=2.0,
                               binning=1, rng=None,
                               reassignment="rounded") -> np.ndarray:
    """Rescanned point-STED (2D pixel reassignment, ISM-style): the
    re-binned camera frame of every scan position (y0, x0) is scatter-added
    into the canvas at R*(y0, x0).

    ``reassignment`` as in ``rescanned_line_sted_image``, applied per axis
    (subpixel = 2D Fourier phase-ramp placement on the canvas ring).
    """
    sample = np.asarray(sample, np.float64)
    h, w = sample.shape
    b = binning
    hc = int(round(rescan_factor * h)) // b
    wc = int(round(rescan_factor * w)) // b
    exc = gaussian_psf(sample.shape, sigma_exc)
    dep = donut_psf(sample.shape, sigma_dep)
    eff = effective_psf(exc, dep, depletion)
    det = detection_psf(sample.shape, sigma_det)
    canvas = np.zeros((hc, wc))
    ky = np.arange(hc)[:, None]
    kx = np.arange(wc // 2 + 1)[None, :]
    for y0 in range(h):
        for x0 in range(w):
            ill = shift_to(eff, y0, x0)
            cam = brightness * fft_convolve(sample * ill, det)
            if rng is not None:
                cam = rng.poisson(np.maximum(cam, 0.0)).astype(np.float64)
            frame = cam.reshape(h // b, b, w // b, b).sum(axis=(1, 3))
            if reassignment == "rounded":
                oy = int(round((rescan_factor - 1.0) * y0 / b))
                ox = int(round((rescan_factor - 1.0) * x0 / b))
                rows = (oy + np.arange(h // b)) % hc
                cols = (ox + np.arange(w // b)) % wc
                canvas[np.ix_(rows, cols)] += frame
            elif reassignment == "subpixel":
                oy = (rescan_factor - 1.0) * y0 / b
                ox = (rescan_factor - 1.0) * x0 / b
                spec = np.fft.rfft2(frame, s=(hc, wc))
                spec *= np.exp(-2j * np.pi * (ky * oy / hc + kx * ox / wc))
                canvas += np.fft.irfft2(spec, s=(hc, wc))
            else:
                raise ValueError(f"unknown reassignment {reassignment!r}")
    return canvas


# -------------------------------------------------------- deconvolution ----

def richardson_lucy(data_views, psf_views, num_iter: int,
                    eps: float = 1e-9, floor: float | None = None
                    ) -> np.ndarray:
    """Multi-view Richardson-Lucy fusion (SURVEY.md section 1.1):

    ``est <- est * mean_v[ (data_v / (est (*) psf_v)) (*) flip(psf_v) ]``.

    ``psf_views`` are centered kernels; flip is point reflection through the
    grid center (circular). The ratio divides by ``max(fwd, eps)``; with
    ``floor`` it is instead 0 wherever ``fwd <= floor`` (a forward model
    that is ~0 or negative there carries no information).
    """
    data_views = [np.asarray(d, np.float64) for d in data_views]
    psf_views = [np.asarray(p, np.float64) for p in psf_views]
    est = np.full_like(data_views[0], np.mean(data_views[0]))
    for _ in range(num_iter):
        ratio_sum = np.zeros_like(est)
        for d, p in zip(data_views, psf_views):
            fwd = fft_convolve(est, p)
            if floor is None:
                ratio = d / np.maximum(fwd, eps)
            else:
                ratio = np.where(fwd > floor, d / np.maximum(fwd, floor), 0.0)
            ratio_sum += fft_correlate(ratio, p)  # back-projection
        est = est * ratio_sum / len(data_views)
    return est
