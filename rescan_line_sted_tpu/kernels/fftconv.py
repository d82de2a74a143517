"""Fused circular FFT convolution (reference component C3, SURVEY.md section 3).

The reference convolves with ``scipy.signal.fftconvolve`` / ``np.fft`` per
scan step; here the detection OTF is computed **once** and reused across every
scan step and sweep point, so each step costs one rFFT2 + spectral multiply +
irFFT2, batched over chunked scan positions and fully fused by XLA
(BASELINE.json north_star: "fused FFT convolutions").

Conventions:

* Convolutions are **circular** on the simulation grid (the grid is the
  periodic world; samples should be padded by the caller if edge wrap
  matters). The numpy oracle uses the identical convention.
* Kernels are supplied *centered* (peak at ``(H//2, W//2)``);
  ``kernel_to_otf`` ifftshifts so that convolution does not translate.
* Everything is f32 real / c64 spectral; batching is over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def kernel_to_otf(kernel: jnp.ndarray) -> jnp.ndarray:
    """Centered real kernel [..., H, W] -> OTF [..., H, W//2+1] (rfft2)."""
    return jnp.fft.rfft2(jnp.fft.ifftshift(kernel, axes=(-2, -1)))


def convolve_otf(img: jnp.ndarray, otf: jnp.ndarray, shape=None) -> jnp.ndarray:
    """Circular convolution of ``img`` [..., H, W] with a precomputed OTF."""
    if shape is None:
        shape = img.shape[-2:]
    return jnp.fft.irfft2(jnp.fft.rfft2(img) * otf, s=shape)


def correlate_otf(img: jnp.ndarray, otf: jnp.ndarray, shape=None) -> jnp.ndarray:
    """Circular cross-correlation: ``out(r) = sum_a img(a) k(a - r)``.

    Equivalent to convolving with the flipped kernel; in the spectral domain
    that is multiplication by ``conj(otf)``. Used by Richardson-Lucy's
    transpose step and by the analytic system-kernel engines.
    """
    if shape is None:
        shape = img.shape[-2:]
    return jnp.fft.irfft2(jnp.fft.rfft2(img) * jnp.conj(otf), s=shape)


def correlate_otf_at(img: jnp.ndarray, otf: jnp.ndarray, pos: jnp.ndarray,
                     precision=None) -> jnp.ndarray:
    """Evaluate ``correlate_otf(img, otf)`` at ONE pixel per batch element,
    skipping the inverse FFT (reference call stack 4.1's pinhole readout,
    SURVEY.md section 4.1 -- the reference materializes the full camera
    correlation and reads one value; here the readout is a spectral dot).

    ``img``: real ``[C, H, W]``; ``otf``: ``[H, W//2+1]`` (or batched
    ``[C, H, W//2+1]``); ``pos``: integer ``[C, 2]`` pixel coordinates
    ``(y, x)``. Returns ``[C]`` real values equal to
    ``correlate_otf(img, otf)[c, y_c, x_c]``.

    The irfft2 of ``S = rfft2(img) * conj(otf)`` at a single ``(y, x)`` is
    ``(1/(H W)) * Re( sum_{ky,kx} wx[kx] S[ky,kx] e^{2 pi i ky y / H}
    e^{2 pi i kx x / W} )`` where ``wx`` folds the hermitian half of the
    rfft axis (2 everywhere except 1 at ``kx = 0`` and, for even ``W``,
    ``kx = W/2``). Cost: one O(H W/2) bilinear form per element instead of
    the O(H W log H W) irfft2 plus a ``[C, H, W]`` real materialization.
    Phase arguments are reduced with INTEGER modular arithmetic before the
    f32 ``exp`` (``ky * y`` reaches ~(H-1)^2, far past f32's exact-integer
    range for H >= 256).
    """
    h, w = img.shape[-2:]
    wr = w // 2 + 1
    spec = jnp.fft.rfft2(img) * jnp.conj(otf)
    wx = jnp.full((wr,), 2.0, jnp.float32).at[0].set(1.0)
    if w % 2 == 0:
        wx = wx.at[-1].set(1.0)
    ky = jnp.arange(h, dtype=jnp.int32)
    kx = jnp.arange(wr, dtype=jnp.int32)
    py = (pos[:, 0:1].astype(jnp.int32) * ky[None, :]) % h       # [C, H]
    px = (pos[:, 1:2].astype(jnp.int32) * kx[None, :]) % w       # [C, Wr]
    ey = jnp.exp((2j * jnp.pi / h) * py.astype(jnp.float32))
    ex = jnp.exp((2j * jnp.pi / w) * px.astype(jnp.float32)) * wx
    t = jnp.einsum("...hw,...w->...h", spec, ex, precision=precision)
    vals = jnp.einsum("...h,...h->...", t, ey, precision=precision)
    return vals.real / (h * w)


def fft_convolve(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """One-shot circular convolution with a centered kernel."""
    return convolve_otf(img, kernel_to_otf(kernel))


def fft_correlate(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """One-shot circular correlation with a centered kernel."""
    return correlate_otf(img, kernel_to_otf(kernel))


def convolve_profiles(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Circular 1D convolution of two centered profiles -> centered profile."""
    n = a.shape[-1]
    spec = (jnp.fft.rfft(jnp.fft.ifftshift(a))
            * jnp.fft.rfft(jnp.fft.ifftshift(b)))
    return jnp.fft.fftshift(jnp.fft.irfft(spec, n=n))


def circulant_matrix(profile: jnp.ndarray) -> jnp.ndarray:
    """Centered 1D kernel [W] -> circulant matrix M[a, x] = k(x - a), [W, W].

    ``img @ M`` is circular convolution along the last axis as ONE matmul;
    the full-frame scan pipelines use it instead of per-step FFTs when they
    need explicit camera frames.

    Built WITHOUT a gather: a W*(W+1) tiling reshaped to [W, W+1] shifts
    each row by one (``i*(W+1) === i mod W``), so slicing the first W
    columns and reversing rows yields exactly ``p[(x - a + W//2) % W]`` --
    bit-identical to the modular-index gather, as a tile and a reshape.
    """
    w = profile.shape[-1]
    q = jnp.roll(profile, -(1 + w // 2))
    t = jnp.tile(q, w + 1).reshape(w, w + 1)[:, :w]
    return t[::-1]


def circulant_window(profile: jnp.ndarray, d_rows: int, d_cols: int,
                     s_row: int, s_col: int) -> jnp.ndarray:
    """Banded window of the TRANSPOSED circulant, straight from the profile.

    Returns ``W[r, c] = k((r - s_row) - (c - s_col))`` for ``r < d_rows``,
    ``c < d_cols`` -- identical to
    ``circulant_matrix(p).T[(arange(d_rows) - s_row) % w]
    [:, (arange(d_cols) - s_col) % w]`` but as one d_rows x d_cols gather
    of the 1D profile instead of materializing the [W, W] circulant and
    row/column-gathering it (the W-scale intermediates dominate the banded
    engines' per-image cost at large W; see circulant_matrix). Used for
    the banded engines' chunk-invariant conv tables.
    """
    w = profile.shape[-1]
    r = jnp.arange(d_rows)[:, None] - s_row
    c = jnp.arange(d_cols)[None, :] - s_col
    return profile[(r - c + w // 2) % w]


def profile_to_otf1d(profile: jnp.ndarray) -> jnp.ndarray:
    """Centered 1D kernel [n] -> 1D OTF [n//2+1] (rfft)."""
    return jnp.fft.rfft(jnp.fft.ifftshift(profile, axes=-1))


def convolve_otf1d(img: jnp.ndarray, otf: jnp.ndarray, axis: int,
                   n: int) -> jnp.ndarray:
    """Circular 1D convolution along ``axis`` with a precomputed 1D OTF."""
    spec = jnp.fft.rfft(img, axis=axis)
    shape = [1] * spec.ndim
    shape[axis] = otf.shape[-1]
    return jnp.fft.irfft(spec * otf.reshape(shape), n=n, axis=axis)
