"""Rescanned line-STED engine -- the paper's headline modality
(reference call stack 4.3; BASELINE config 3).

Camera-based detection with pixel reassignment: the camera frame captured at
scan position ``x0`` is re-binned by the detector binning factor ``b`` and
accumulated into the output canvas at column offset
``round((R - 1) * x0 / b)`` (so camera column x lands at canvas column
``R*x0 + (x - x0)``), wrapping circularly on the ``round(R*W)/b``-wide canvas.

Methods:

* ``"analytic"``: the closed-form canvas mean (``analytic.rescan_canvas_mean``,
  exact for ANY rescan factor -- fractional R via band-limited subpixel
  placement -- and any binning), one Poisson draw. Matches the subpixel scan
  path away from the circular seam.
* ``"scan"``: the per-scan-position process. ``reassignment="rounded"``
  snaps each frame's offset to the nearest binned canvas pixel (exact when
  ``(R-1)/b`` is an integer); ``"subpixel"`` places every frame at its
  exact fractional offset -- the ideal continuous rescan sweep; ``"auto"``
  (default) picks subpixel exactly when the offsets are fractional.
  Scheduling is chosen from what the call makes observable. When the static
  band windows exist (concrete sigmas, Gaussian excitation envelope, windows
  narrower than the frame; ``_illum_band``) every chunk of scan positions
  runs the WINDOWED pipeline: the x-convolution contracts a D_in-column
  sample window into the D_out-column frame window as one
  ``[C*Do, Di] @ [Di, H]`` matmul, per-step noise samples only that window,
  and placement is a real-DFT matmul of the window (any R) or, for
  collapsed noise at a rational step, integer strip sums. Otherwise (traced
  sigmas, custom excitation models, narrow grids) the FULL-FRAME pipeline
  synthesizes whole camera frames and places them with the XLA scatter-add
  (rounded) or frame-rfft phase accumulation (subpixel). Both pipelines
  compute the same canvas (parity-tested).

Noise exactness: with integer reassignment each camera pixel lands on ONE
canvas pixel, so collapsed Poisson is distributionally exact
(docs/DERIVATIONS.md). Subpixel placement spreads a camera pixel over the
canvas band-limitedly, so ``noise_mode="collapsed"`` then means "shot noise
of the ideal canvas" (the sum of interpolated Poissons is no longer exactly
Poisson); use ``noise_mode="per_step"`` for camera-faithful statistics.
Note that band-limited placement of integer photon counts carries sinc
ringing: per-step subpixel canvases contain small negative excursions
(~0.05% of the total mass at typical counts) exactly as an ideal continuous
reassignment of discrete photons would; clamp at zero downstream if a
nonnegative canvas is required (RL fusion already handles this).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from rescan_line_sted_tpu.config import (
    RescanGeometry,
    RescanParams,
    matmul_precision,
)
from rescan_line_sted_tpu.imaging import analytic
from rescan_line_sted_tpu.imaging.line_sted import effective_line_profile
from rescan_line_sted_tpu.imaging.point_sted import AcquisitionResult
from rescan_line_sted_tpu.imaging.shifts import shifted_profiles
from rescan_line_sted_tpu.kernels import fftconv
from rescan_line_sted_tpu.kernels.rescan_accumulate import (
    rescan_accumulate_reference,
)
from rescan_line_sted_tpu.physics import psf as psfs
from rescan_line_sted_tpu.physics.dose import line_sted_dose
from rescan_line_sted_tpu.physics.noise import maybe_poisson

# engine matmul precision (HIGHEST unless RLS_MATMUL_PRECISION overrides;
# see config.matmul_precision for the measured error budget)
_PRECISION = matmul_precision()


def rescanned_line_sted_image(
    sample: jnp.ndarray,
    params: RescanParams,
    geom: RescanGeometry,
    key: jax.Array | None = None,
    method: str = "analytic",
    noise_mode: str = "collapsed",
    reassignment: str = "auto",
    boundary: str = "circular",
    margin: int | None = None,
) -> AcquisitionResult:
    """Simulate a full rescanned line-STED acquisition of ``sample``.

    Returns the rescanned canvas ``[H/b, round(R*W)/b]``. Any
    ``rescan_factor >= 1`` (fractional R is placed subpixel-exactly) and any
    binning. ``reassignment`` ("auto" | "rounded" | "subpixel", scan path
    only) controls frame placement; see the module doc for the noise-mode
    semantics of each. ``boundary``: ``"circular"`` or ``"padded"`` (open
    boundary via pad-acquire-crop; dose reported for the requested field).

    Spatial sharding (several devices): a ``sample`` committed to a
    ``NamedSharding`` that splits its rows over a mesh axis runs the same
    scan path under GSPMD, which partitions the windowed contraction and
    inserts the collectives (parity-tested on a virtual mesh in
    tests/test_mesh.py). Per-step noise comes from ``jax.random`` with
    partitionable Threefry, so a sharded call draws the same counts as the
    unsharded call with the same key.
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
            lambda s, g, **kw: rescanned_line_sted_image(s, params, g, **kw),
            sample, geom, default_margin(geom) if margin is None else margin,
            key=key, method=method, noise_mode=noise_mode,
            reassignment=reassignment)
        return res.replace(dose=line_sted_dose(params, geom))
    if boundary != "circular":
        raise ValueError(f"unknown boundary {boundary!r}")
    if method == "analytic":
        image = _analytic(sample, params, geom, key)
    elif method == "scan":
        image = _scan(sample, params, geom, key, noise_mode, reassignment)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AcquisitionResult(image=image, dose=line_sted_dose(params, geom))


def optimal_rescan_factor(params: RescanParams, width: int) -> jnp.ndarray:
    """Optimal rescan (sweep) factor from the simulated PSF widths (C6).

    A photon detected at camera x while scanning at x0 has position estimate
    ``y_hat = x0 + (x - x0) * w`` with inverse-variance weight
    ``w = sigma_ill^2 / (sigma_ill^2 + sigma_det^2)``. Rescan writes the
    photon at ``u = R*x0 + (x - x0)``, i.e. ``u/R = x0 + (x - x0)/R`` on the
    magnification-corrected grid, so the sharpest sum has ``R = 1/w``:

        R = 1 + sigma_det^2 / sigma_ill_eff^2

    ``sigma_ill_eff`` is measured from the *depleted* excitation line (its
    FWHM / 2.3548), so stronger STED pushes R up -- the sharper the line,
    the more each photon's position should collapse toward the scan
    position. R = 2 exactly when the effective line width equals the
    detection width (classic rescan confocal).

    CAUTION: this is the exact information-theoretic optimum, and strong
    depletion collapses ``sigma_ill_eff`` so hard that it can return R ~ 11+
    (an 11x-wide canvas per acquisition) for a resolution gain that is
    marginal beyond R ~ 2-4 -- the variance curve is very flat near its
    minimum. Use ``practical_rescan_factor`` for an operating point; this
    function deliberately does not cap.
    """
    from rescan_line_sted_tpu.algorithms.metrics import fwhm_1d

    eff = effective_line_profile(width, params)
    sigma_ill = fwhm_1d(eff) / 2.3548200450309493
    return 1.0 + jnp.square(params.sigma_det) / jnp.square(sigma_ill)


def rescan_kernel_sigma(params: RescanParams, width: int,
                        factors: jnp.ndarray) -> jnp.ndarray:
    """Reassigned-kernel width (sigma, sample px) vs rescan factor.

    On the magnification-corrected grid (canvas / R), a photon from an
    emitter at 0 lands at ``u/R = x0 (1 - 1/R) + x/R`` with scan position
    ``x0 ~ sigma_ill_eff`` and camera position ``x ~ sigma_det``, so

        sigma^2(R) = sigma_ill^2 (1 - 1/R)^2 + sigma_det^2 / R^2

    -- minimized exactly at ``optimal_rescan_factor`` and very flat around
    it. This is the marginal-gain curve behind ``practical_rescan_factor``;
    broadcast over ``factors``.
    """
    from rescan_line_sted_tpu.algorithms.metrics import fwhm_1d

    eff = effective_line_profile(width, params)
    sigma_ill = fwhm_1d(eff) / 2.3548200450309493
    t = 1.0 / jnp.asarray(factors, jnp.float32)
    return jnp.sqrt(jnp.square(sigma_ill) * jnp.square(1.0 - t)
                    + jnp.square(params.sigma_det) * jnp.square(t))


def practical_rescan_factor(params: RescanParams, width: int,
                            tolerance: float = 0.05,
                            cap: float | None = None,
                            snap: int | None = 8) -> jnp.ndarray:
    """Smallest rescan factor within ``tolerance`` of the optimal resolution.

    The exact optimum (``optimal_rescan_factor``) sits on a very flat
    variance curve: accepting a ``tolerance`` (default 5%) broader
    reassigned kernel typically shrinks R -- and the canvas -- severalfold.
    Solving ``sigma^2(R) = (1 + tolerance)^2 * sigma^2(R_opt)`` (see
    ``rescan_kernel_sigma``) for the smaller root in closed form:

        t = [s_i^2 + sqrt(s_i^4 - (s_i^2 + s_d^2)(s_i^2 - target))]
            / (s_i^2 + s_d^2),                R = 1 / t

    with ``target = (1+tol)^2 * s_i^2 s_d^2 / (s_i^2 + s_d^2)``. ``cap``
    additionally clamps the recommendation (R = 1 means no magnification;
    the result never exceeds the exact optimum). Jittable; returns a scalar.

    ``snap`` (default 8) rounds the recommendation UP to the nearest
    multiple of ``1/snap`` (clamped at the exact optimum, never past it).
    R is a free design parameter, so this is not an approximation: any R
    in the tolerance band is an equally valid operating point, and a
    rational ``R - 1 = p/q`` with small q routes the collapsed scan engine
    onto the rational-step STRIP placement path (no per-frame DFT
    matmul). Rounding up moves toward the optimum on a
    decreasing curve, so the snapped R stays within ``tolerance``.
    ``snap=None`` returns the continuous root.
    """
    from rescan_line_sted_tpu.algorithms.metrics import fwhm_1d

    eff = effective_line_profile(width, params)
    sigma_ill = fwhm_1d(eff) / 2.3548200450309493
    return practical_factor_from_sigmas(sigma_ill, params.sigma_det,
                                        tolerance, cap, snap)


def practical_factor_from_sigmas(sigma_ill, sigma_det,
                                 tolerance: float = 0.05,
                                 cap: float | None = None,
                                 snap: int | None = 8) -> jnp.ndarray:
    """The closed-form tolerance-band solve behind both
    ``practical_rescan_factor`` (line) and the point/ISM variant
    (``rescan_point.practical_rescan_factor_point``) -- see the former's
    docstring for the derivation. One implementation so a change to the
    tolerance/snap semantics applies to both modalities."""
    si2 = jnp.square(sigma_ill)
    sd2 = jnp.square(sigma_det)
    target = (1.0 + tolerance) ** 2 * si2 * sd2 / (si2 + sd2)
    disc = jnp.maximum(si2 * si2 - (si2 + sd2) * (si2 - target), 0.0)
    t = (si2 + jnp.sqrt(disc)) / (si2 + sd2)
    r = jnp.maximum(1.0 / jnp.maximum(t, 1e-12), 1.0)
    if snap:
        r = jnp.minimum(jnp.ceil(r * snap) / snap, 1.0 + sd2 / si2)
    if cap is not None:
        r = jnp.minimum(r, cap)
    return r


def _analytic(sample, params, geom, key):
    return maybe_poisson(key, analytic.rescan_canvas_mean(sample, params, geom))


def _rebin(cam: jnp.ndarray, b: int) -> jnp.ndarray:
    """Sum camera pixels in b x b blocks: [..., H, W] -> [..., H/b, W/b]."""
    if b == 1:
        return cam
    *lead, h, w = cam.shape
    return cam.reshape(*lead, h // b, b, w // b, b).sum(axis=(-3, -1))


def _scan(sample, params, geom, key, noise_mode="collapsed",
          reassignment="auto", windowed=None):
    """The scan path (see the module doc for the two pipelines).

    ``windowed``: ``None`` takes the windowed pipeline exactly when its
    static band windows exist; ``True`` requires them (``ValueError``
    otherwise); ``False`` forces the full-frame pipeline. Forcing a route
    serves the parity tests and the route timings; both routes compute the
    same canvas.
    """
    if noise_mode not in ("collapsed", "per_step"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if reassignment not in ("auto", "rounded", "subpixel"):
        raise ValueError(f"unknown reassignment {reassignment!r}")
    h, w = geom.grid.shape
    b = geom.binning
    chunk = geom.chunk
    if w % chunk:
        raise ValueError("chunk must divide width")
    hc, wc = geom.canvas_shape
    per_step = key is not None and noise_mode == "per_step"
    if reassignment == "auto":
        # offsets (R-1)*x0/b are all integral iff (R-1)/b is an integer
        step = (geom.rescan_factor - 1.0) / b
        reassignment = "rounded" if abs(step - round(step)) < 1e-9 \
            else "subpixel"
    subpixel = reassignment == "subpixel"

    eff = effective_line_profile(w, params)
    # Separable detection: convy hoisted out of the loop; the x-convolution
    # runs per chunk (a circulant matmul, or its banded window). The rescan
    # canvas needs the camera frame each step, so detection cannot fold away.
    otf_y = fftconv.profile_to_otf1d(psfs.detection_profile(h, params.sigma_det))
    gx = psfs.detection_profile(w, params.sigma_det)
    sample_y = fftconv.convolve_otf1d(sample, otf_y, axis=-2, n=h)

    band = _illum_band(params, w, chunk, b)
    has_windows = band is not None and band[1] is not None
    if windowed is None:
        windowed = has_windows
    elif windowed and not has_windows:
        raise ValueError(
            "windowed route needs static band windows (concrete sigmas, a "
            "Gaussian excitation envelope, windows narrower than the frame)")
    band = band if windowed else None

    # Rational-step STRIP placement (windowed, collapsed noise): when the
    # per-position canvas offset step (R-1)/b is a small rational p/q with
    # q | chunk, chunk positions fall into q fractional-offset CLASSES with a
    # static within-chunk pattern (chunk starts are q-multiples): frame c
    # places at integer offset I0 + (p*c)//q within class r = c % q, and the
    # class's fractional residue ((p*r) % q)/q is applied ONCE per image as
    # a spectral shift of the accumulated class canvas. Placement then costs
    # static-shift strip sums + one dynamic slice-add per chunk instead of
    # the per-frame DFT matmul. Exact: integer placement is the scatter, the
    # q-1 end-of-image phase ramps are the same math the spectral path
    # applies per frame. Rounded placement joins only for fully integral
    # steps (q == 1 == exact): for fractional steps np.round's half-even
    # ties depend on the integer part, so rounded offsets are not
    # chunk-invariant. Per-step noise keeps the DFT placement, where the
    # sampled window feeds the placement matmul directly.
    strips = None
    if (windowed and not per_step
            and os.environ.get("RLS_RESCAN_STRIPS", "1") != "0"):
        pq = _rational_step((float(geom.rescan_factor) - 1.0) / b, chunk)
        if pq is not None and (subpixel or pq[1] == 1):
            p_c, q_try = pq
            if band[1] // b + (p_c * (chunk - 1)) // q_try + 1 < wc:
                strips = (p_c, q_try)

    # Placement: the windowed route places each sampled window by a real-DFT
    # matmul against per-position phase ramps (exact for any R; for rounded
    # offsets the phases are exact roots of unity, identical to the
    # scatter). The full-frame route accumulates frame rffts times the same
    # ramps for subpixel offsets and scatter-adds rounded ones.
    phase_accum = windowed or subpixel
    ph_pair = dft_pair = None
    if phase_accum and strips is None:
        # Per-position canvas phase ramps exp(-2i pi k off/wc), built in f64
        # on the host (f32 phase arguments lose ~1e-4 at these magnitudes)
        # and kept as a (cos, sin) f32 pair: the per-chunk gathers index
        # the real tables, the complex value is formed on device after.
        kk = np.arange(wc // 2 + 1, dtype=np.float64)
        offs = (float(geom.rescan_factor) - 1.0) * np.arange(w) / b
        if not subpixel:
            offs = np.round(offs)
        ph = np.exp(-2j * np.pi * kk[None, :] * offs[:, None] / wc)
        ph_pair = (jnp.asarray(ph.real.astype(np.float32)),      # [W, K]
                   jnp.asarray(ph.imag.astype(np.float32)))
        if windowed:
            # real-DFT rows of the binned frame columns: the window's
            # placement gathers its rows, and the zero padding up to wc
            # folds away (only the first W/b rows are ever needed)
            xx = np.arange(w // b, dtype=np.float64)
            ang = -2.0 * np.pi * xx[:, None] * kk[None, :] / wc
            dft_pair = (jnp.asarray(np.cos(ang).astype(np.float32)),
                        jnp.asarray(np.sin(ang).astype(np.float32)))

    n_chunks = w // chunk
    keys = jax.random.split(key, n_chunks) if per_step else None
    canvas = _scan_loop(
        sample_y, params.brightness * eff, gx, keys, ph_pair, dft_pair,
        wc=wc, chunk=chunk, b=b, rescan_factor=float(geom.rescan_factor),
        phase_accum=phase_accum, band=band, strips=strips)
    if key is not None and noise_mode == "collapsed":
        canvas = maybe_poisson(key, canvas)
    return canvas


def _rational_step(step: float, chunk: int):
    """Smallest q <= 8 with q | chunk and ``step * q`` integral (1e-9 tol).

    Returns ``(p, q)`` with ``step == p / q``, or None. The ONE place the
    "rational placement step" contract lives, so every caller agrees on
    which placements have class structure.
    """
    for q_try in range(1, 9):
        if chunk % q_try == 0 \
                and abs(step * q_try - round(step * q_try)) < 1e-9:
            return int(round(step * q_try)), q_try
    return None


def _apply_class_residues(folded, fracs, wc: int):
    """Sum folded class canvases ``[q, wc, H]``, applying each class's
    fractional canvas shift as ONE spectral phase ramp before the sum.

    Phases are roots of unity built in f64 on the host (exact, like the
    per-position ``ph_pair`` ramps). The q = 1 case (residue 0 by
    construction) is the plain transpose. Returns the [H, wc] canvas.
    The strips engine's once-per-image epilogue.
    """
    if len(fracs) == 1:
        return folded[0].T
    kdim = wc // 2 + 1
    ang = (-2.0 * np.pi / wc) * np.arange(kdim)[None, :] \
        * np.asarray(fracs, np.float64)[:, None]
    ph = jax.lax.complex(jnp.asarray(np.cos(ang), jnp.float32),
                         jnp.asarray(np.sin(ang), jnp.float32))  # [q, K]
    spec = jnp.fft.rfft(folded, n=wc, axis=1)                    # [q, K, H]
    return jnp.fft.irfft(jnp.sum(spec * ph[:, :, None], axis=0),
                         n=wc, axis=0).T


def _illum_band(params, w: int, chunk: int,
                b: int = 1) -> tuple[int, int | None] | None:
    """Static band windows ``(d_in, d_out)`` for the windowed pipeline.

    The effective excitation line is bounded by its Gaussian envelope
    (``exp(-s dep) <= 1`` only narrows it), so for chunk positions
    ``[p0, p0+C)``:

    * illumination is < 4e-10 of peak outside a contiguous ``d_in =
      C + 2 S_exc``-column SAMPLE window (``S_exc ~ 6.5 sigma_exc``) -- the
      x-conv contraction restricts to it;
    * the camera response is < ~1e-12 outside a contiguous ``d_out =
      C + 2 (S_exc + S_det)``-column FRAME window -- sampling and the DFT
      placement restrict to it (the dark remainder's Poisson draws are
      zeros with probability 1 to ~1e-4 photons/image, far below shot
      noise).

    Both windows translate with the chunk, so every conv table is
    chunk-invariant (no per-chunk gathers of the tables). Both round up to
    multiples of 128 columns. ``d_out`` is None when the frame window would
    not be narrower than the frame (no windowed route); the whole return is None when nothing pays, a
    sigma is traced (vmapped over), the binning misaligns the window, or a
    custom illumination model with a non-default EXCITATION is installed
    (unknown support; custom DEPLETION generators keep the band -- the
    effective line <= the Gaussian excitation envelope regardless, see
    models.GaussianDonutModel.gaussian_excitation).
    """
    m = getattr(params, "model", None)
    if m is not None and not getattr(m, "gaussian_excitation", False):
        return None
    # static support fields ride the params treedef (config.py), so banding
    # survives params passed as jit arguments / vmapped; a concrete sigma
    # is the fallback for hand-built params
    from rescan_line_sted_tpu.config import _support

    # explicit is-None tests: a legitimate 0 support must not be treated
    # as missing (falsy) and re-derived from a possibly-traced width
    s_exc = getattr(params, "exc_support", None)
    if s_exc is None:
        s_exc = _support(params.sigma_exc)
    s_det = getattr(params, "det_support", None)
    if s_det is None:
        s_det = _support(params.sigma_det)
    if s_exc is None or s_det is None:
        return None  # traced sigma and no static support bound
    d_in = -(-(chunk + 2 * s_exc) // 128) * 128
    if d_in >= w:
        return None
    d_out = -(-(chunk + 2 * (s_exc + s_det)) // 128) * 128
    if d_out >= w:
        return (d_in, None)
    # b-aligned frame window: chunk starts are b-aligned iff b | chunk, and
    # the window offset s_out must be a b multiple for the re-bin grid
    if chunk % b or ((d_out - chunk) // 2) % b:
        return (d_in, None)
    return (d_in, d_out)


@functools.partial(
    jax.jit,
    static_argnames=("wc", "chunk", "b", "rescan_factor", "phase_accum",
                     "band", "strips"))
def _scan_loop(sample_y, eff_b, gx, keys, ph_pair, dft_pair=None, *,
                   wc, chunk, b, rescan_factor, phase_accum, band=None,
                   strips=None):
    """The chunked ``lax.scan`` engine, jitted as one unit (static geometry
    as static args) so eager callers compile it once; it inlines for free
    under an outer jit.

    ``eff_b`` is the brightness-scaled effective profile, ``gx`` the
    centered detection profile, ``keys`` [n_chunks] PRNG keys for per-step
    noise or None. ``band`` (``(d_in, d_out)`` from ``_illum_band``) selects
    the windowed pipeline; ``None`` the full-frame one. ``strips`` (p, q)
    selects rational strip placement inside the windowed pipeline.
    """
    h, w = sample_y.shape
    hc = h // b
    per_step = keys is not None
    n_chunks = w // chunk
    positions = jnp.arange(w).reshape(n_chunks, chunk)
    xs = (positions, keys) if per_step else positions
    if strips is not None:
        # Rational-step strip placement (see _scan): static per-chunk
        # geometry. Frame c of a chunk places at integer extended-canvas
        # offset I0 + strip_shift[c] in class c % q (I0 = p*pos0/q, integral
        # since q | chunk | pos0); the class's fractional residue is applied
        # once per image, as a spectral shift of the folded class canvas.
        # The frame window's camera coordinates g = gstart + d are UNWRAPPED
        # (the window content is wb-periodic, but a camera column's true
        # placement is (g mod wb) + offset, and g and g - wb land wb mod wc
        # apart on the canvas) -- so each chunk splits its frames at the one
        # possible wb boundary into two masked variants placed wb apart.
        # Placement per chunk = 2 masked static strip sums + 2 dynamic
        # slice-adds instead of the per-frame DFT matmul.
        p_n, q_n = strips
        dob = band[1] // b
        wb = w // b
        s_out_s = (band[1] - chunk) // 2
        strip_w = dob + (p_n * (chunk - 1)) // q_n + 1
        strip_shift = tuple((p_n * c) // q_n for c in range(chunk))
        strip_frac = tuple(((p_n * r) % q_n) / q_n for r in range(q_n))
        # extended canvas: slice starts are reduced into [0, wc); the tail
        # (folded back mod wc at the end) holds one full strip
        w_ext = wc + -(-strip_w // 8) * 8
    if band is not None:
        # Static banded tables (see _illum_band), all chunk-invariant:
        # * illumination window: with chunk positions contiguous
        #   (pos[c] = p0 + c) and window start a0 = p0 - S, the block
        #   ill[c, (a0+d) % w] = eff[(w//2 + d - S - c) % w] is one static
        #   [C, D_in] table;
        # * the frame window translates WITH the sample window, so the
        #   detection block is chunk-invariant too: the scaled conv tensor
        #   [C, D_out, D_in] is built ONCE and every chunk is a single
        #   [C*D_out, D_in] @ [D_in, H] matmul against the gathered sample
        #   rows.
        d_in, d_out = band
        s_in = (d_in - chunk) // 2
        s_out = (d_out - chunk) // 2
        ci = jnp.arange(chunk)[:, None]
        di = jnp.arange(d_in)[None, :]
        ill_w = eff_b[(w // 2 + di - s_in - ci) % w]             # [C, D_in]
        g0w = fftconv.circulant_window(gx, d_out, d_in, s_out, s_in)
        scaled_win = g0w[None] * ill_w[:, None, :]               # [C, Do, Di]
        sample_t = sample_y.T                                    # [W, H]
    else:
        gx_mat = fftconv.circulant_matrix(gx)

    def place_strips(canvas, frames_t, pos):
        # integer strip placement (see the constants block): frame c covers
        # unwrapped camera columns gstart + d and places at ext-canvas start
        # B0 - wb*k(d) + strip_shift[c]
        gstart = (pos[0] - s_out_s) // b
        i0 = p_n * pos[0] // q_n
        k0 = jnp.floor_divide(gstart, wb)
        glob = gstart + jnp.arange(dob)
        m_hi = (glob >= wb * (k0 + 1)).astype(frames_t.dtype)
        blocks = []
        for mask in (1.0 - m_hi, m_hi):
            fm = frames_t * mask[None, :, None]
            blk = jnp.zeros((q_n, strip_w, hc), frames_t.dtype)
            for c in range(chunk):
                blk = blk.at[
                    c % q_n, strip_shift[c]:strip_shift[c] + dob].add(fm[c])
            blocks.append(blk)
        sa = (gstart + i0 - wb * k0) % wc
        for blk, start in ((blocks[0], sa), (blocks[1], (sa - wb) % wc)):
            idx = (jnp.int32(0), start, jnp.int32(0))
            cur = jax.lax.dynamic_slice(canvas, idx, (q_n, strip_w, hc))
            canvas = jax.lax.dynamic_update_slice(canvas, cur + blk, idx)
        return canvas

    def place_dft(canvas, frames_t, pos):
        # forward rDFT of each window as two matmuls against the frame rows
        # of the DFT matrix (zero padding to wc folds away), then the
        # per-position phase ramps
        rows = ((pos[0] - s_out) // b + jnp.arange(d_out // b)) % (w // b)
        dre = jnp.take(dft_pair[0], rows, axis=0)                # [Do/b, K]
        dim = jnp.take(dft_pair[1], rows, axis=0)
        sre = jnp.einsum("cxh,xk->ckh", frames_t, dre,
                         preferred_element_type=jnp.float32,
                         precision=_PRECISION)
        sim = jnp.einsum("cxh,xk->ckh", frames_t, dim,
                         preferred_element_type=jnp.float32,
                         precision=_PRECISION)
        spec_t = jax.lax.complex(sre, sim)                       # [C, K, H/b]
        ph_c = jax.lax.complex(ph_pair[0][pos], ph_pair[1][pos])
        return canvas + jnp.einsum("ckh,ck->kh", spec_t, ph_c,
                                   precision=_PRECISION)

    def place_frames(canvas, frames, pos):
        if phase_accum:
            spec = jnp.fft.rfft(frames, n=wc, axis=-1)           # [C, H/b, K]
            ph_c = jax.lax.complex(ph_pair[0][pos], ph_pair[1][pos])
            return canvas + jnp.einsum("chk,ck->hk", spec, ph_c,
                                       precision=_PRECISION)
        offsets = jnp.round((rescan_factor - 1.0) * pos / b).astype(jnp.int32)
        return rescan_accumulate_reference(canvas, frames, offsets)

    def body(canvas, chunk_in):
        pos, k = chunk_in if per_step else (chunk_in, None)
        # named scopes conv / sample / place label the stages in profiles
        if band is not None:
            # Windowed pipeline: conv, sampling AND placement act on the
            # D_out-column frame window; only two row gathers depend on the
            # chunk.
            with jax.named_scope("conv"):
                a0 = pos[0] - s_in
                sample_win = jnp.take(sample_t, (a0 + jnp.arange(d_in)) % w,
                                      axis=0)                    # [Di, H]
                cam = jnp.einsum("cxd,dh->cxh", scaled_win, sample_win,
                                 preferred_element_type=jnp.float32,
                                 precision=_PRECISION)           # [C, Do, H]
            # bin the noise-free mean, then draw per-frame shot noise on the
            # binned window -- distributionally identical to sampling before
            # binning (sums of independent Poissons are Poisson), b^2 fewer
            # draws
            with jax.named_scope("sample"):
                frames_t = maybe_poisson(k, _rebin(cam, b))      # [C, Do/b, H]
            with jax.named_scope("place"):
                if strips is not None:
                    return place_strips(canvas, frames_t, pos), None
                return place_dft(canvas, frames_t, pos), None
        # Full-frame pipeline: whole camera frames, circulant x-convolution
        with jax.named_scope("conv"):
            ill = shifted_profiles(eff_b, pos)                   # [C, W]
            emitted_y = ill[:, None, :] * sample_y[None]         # [C, H, W]
            cam = jnp.einsum("cha,ax->chx", emitted_y, gx_mat,
                             preferred_element_type=jnp.float32,
                             precision=_PRECISION)
        with jax.named_scope("sample"):
            frames = _rebin(maybe_poisson(k, cam), b)            # [C, H/b, W/b]
        with jax.named_scope("place"):
            return place_frames(canvas, frames, pos), None

    kdim = wc // 2 + 1
    if strips is not None:
        init = jnp.zeros((q_n, w_ext, hc), jnp.float32)          # class canvases
    elif band is not None:
        init = jnp.zeros((kdim, hc), jnp.complex64)              # canvas^T spec
    elif phase_accum:
        init = jnp.zeros((hc, kdim), jnp.complex64)
    else:
        init = jnp.zeros((hc, wc), jnp.float32)
    canvas, _ = jax.lax.scan(body, init, xs)
    if strips is not None:
        # fold the extended tail back (canvas wrap), then apply each class's
        # fractional residue as ONE spectral shift and sum the classes
        folded = canvas[:, :wc]
        off = wc
        while off < w_ext:
            wdt = min(wc, w_ext - off)
            folded = folded.at[:, :wdt].add(canvas[:, off:off + wdt])
            off += wc
        return _apply_class_residues(folded, strip_frac, wc)
    if band is not None:
        return jnp.fft.irfft(canvas, n=wc, axis=0).T
    if phase_accum:
        return jnp.fft.irfft(canvas, n=wc, axis=-1)
    return canvas
