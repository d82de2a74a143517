"""Pluggable illumination models (the PSF-generator seam).

SURVEY.md:104-109 tags the reference's exact depletion-PSF constructions
[M]/[L] ("make the generator pluggable"): the closed forms this engine
defaults to (Gaussian excitation, ``u e^{1-u}`` donut, ``sin^2`` stripe --
``physics/psf.py``) are physically standard but unverifiable against the
empty reference mount. This module makes the generators swappable without
touching ``physics/psf.py``: every engine builds illumination through the
``model`` field of its params (``PointSTEDParams.model`` /
``LineSTEDParams.model``), which defaults to the closed forms.

Models are small **frozen dataclasses** (hashable, eq-comparable): they ride
the params pytree as *static* leaves (``struct.field(pytree_node=False)``),
so jit specializes per model class+fields while the physics scalars stay
traced/vmappable. A model's builders receive traced params and must be
jittable; peak normalization is the engine-wide convention (physics/psf.py
module doc).

Provided alternatives prove the seam with real physics:

* ``PupilDonutModel`` -- the STED donut as actually created in hardware: a
  circular pupil with a charge-``m`` vortex phase mask ``e^{i m theta}``,
  focused by FFT; the intensity ``|FFT(pupil)|^2`` has an exact on-axis zero
  (the vortex) and Airy-like outer rings the analytic ``u e^{1-u}`` form
  lacks. The aperture cutoff is calibrated so the first intensity ring sits
  at ``r = sigma_dep * sqrt(2)`` -- the same ring radius as the default
  donut, making the two forms drop-in comparable at equal ``sigma_dep``.
* ``EnvelopedStripeModel`` -- the standing-wave stripe under a finite
  Gaussian envelope (a real depletion line has finite extent; the pure
  ``sin^2`` idealizes an infinite interference field).
* ``VectorialDonutModel`` -- full Richards-Wolf high-NA focal fields
  (``|Ex|^2+|Ey|^2+|Ez|^2``) of the vortex beam: polarization-dependent
  null quality (co-handed circular preserves the null, counter-handed
  fills it through the z-field) -- the quarter-wave-plate alignment
  physics scalar models cannot express.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.physics import psf as psfs

# First-intensity-ring radius of a charge-1 vortex-pupil donut with aperture
# cutoff f_max (cycles/pixel): r_ring ~= _VORTEX_RING_CONST / f_max, measured
# numerically (N-independent to <0.3% over N = 128..512).
_VORTEX_RING_CONST = 0.3925


def _pupil_grid(sigma_dep, shape: tuple[int, int]):
    """Shared vortex-pupil prologue: frequency grids, azimuth, and the
    ring-calibrated aperture mask (first intensity ring at
    ``sigma_dep * sqrt(2)``, DC sample excluded -- the vortex phase is
    singular there and the lone unpaired discrete sample would break the
    exact on-axis null: every (k, -k) pair cancels, k = 0 has no partner).
    Returns ``(fr, phi, f_max, mask)``."""
    h, w = shape
    fy = jnp.fft.fftfreq(h).astype(jnp.float32)[:, None]
    fx = jnp.fft.fftfreq(w).astype(jnp.float32)[None, :]
    fr = jnp.sqrt(fy * fy + fx * fx)
    phi = jnp.arctan2(fy, fx)
    f_max = _VORTEX_RING_CONST / (jnp.sqrt(2.0) * sigma_dep)
    f_max = jnp.minimum(f_max, 0.5)  # aperture cannot exceed Nyquist
    mask = jnp.where((fr <= f_max) & (fr > 0.0), 1.0, 0.0)
    return fr, phi, f_max, mask


@functools.partial(jax.jit, static_argnames=("shape", "charge"))
def _vortex_donut(sigma_dep, *, shape: tuple[int, int],
                  charge: int) -> jnp.ndarray:
    """``|FFT(circ(f<=f_max) e^{i m theta})|^2``, peak-normalized.

    Module-level jit (static shape/charge; same pattern as
    ``imaging/rescan_point.py``'s analytic wrappers): eager callers compile
    the complex pupil chain once, and it inlines for free under an outer
    jit.
    """
    _, theta, _, mask = _pupil_grid(sigma_dep, shape)
    pupil = jax.lax.complex(mask * jnp.cos(charge * theta),
                            mask * jnp.sin(charge * theta))
    field = jnp.fft.fftshift(jnp.fft.ifft2(pupil))
    inten = jnp.square(jnp.abs(field))
    return inten / jnp.maximum(jnp.max(inten), 1e-30)


@dataclasses.dataclass(frozen=True)
class GaussianDonutModel:
    """Default point-STED illumination: the closed forms of physics/psf.py
    (Gaussian excitation, ``u e^{1-u}`` LG01-like donut).

    ``gaussian_excitation = True`` (here and on every shipped model whose
    ``excitation`` builder is the package's standard Gaussian) tells the
    banded-window engines that the params' static ``exc_support`` bound
    applies: the effective PSF ``exc * exp(-s dep) <= exc`` for ANY
    depletion generator, so custom DEPLETION models keep the fast banded
    routes. A user model with a wider excitation must leave it False
    (the default) and takes the full-frame pipeline."""

    gaussian_excitation = True

    def excitation(self, shape: tuple[int, int], params) -> jnp.ndarray:
        return psfs.gaussian_psf(shape, params.sigma_exc)

    def depletion(self, shape: tuple[int, int], params) -> jnp.ndarray:
        return psfs.donut_psf(shape, params.sigma_dep)


@dataclasses.dataclass(frozen=True)
class PupilDonutModel:
    """Physical vortex-phase pupil donut: ``|FFT(circ(f <= f_max) e^{i m
    theta})|^2``, peak-normalized, with ``f_max`` chosen so the first
    intensity ring lands at ``sigma_dep * sqrt(2)`` (matching
    ``GaussianDonutModel`` at equal params). ``charge`` is the vortex
    topological charge m (1 = LG01-like). Exact zero on axis for any m >= 1
    (the pupil integral of ``e^{i m theta}`` vanishes by symmetry).
    """

    gaussian_excitation = True

    charge: int = 1

    def excitation(self, shape: tuple[int, int], params) -> jnp.ndarray:
        return psfs.gaussian_psf(shape, params.sigma_exc)

    def depletion(self, shape: tuple[int, int], params) -> jnp.ndarray:
        return _vortex_donut(params.sigma_dep, shape=tuple(shape),
                             charge=self.charge)


@functools.partial(jax.jit, static_argnames=("shape", "charge", "na",
                                             "polarization"))
def _vectorial_donut(sigma_dep, *, shape: tuple[int, int], charge: int,
                     na: float, polarization: str) -> jnp.ndarray:
    """High-NA vectorial focal intensity of a vortex beam (Richards-Wolf /
    Debye): ``|Ex|^2 + |Ey|^2 + |Ez|^2`` with the pupil's s/p polarization
    rotation, ``sqrt(cos th)`` apodization, and ``e^{i m phi}`` vortex.

    The polarization physics the scalar ``_vortex_donut`` cannot express:
    a charge-``m`` vortex gives field components with vortex charges
    ``m`` (transverse) and ``m -/+ 1`` (z, from the +/- circular parts of
    the input), so the on-axis null survives ONLY when every component
    keeps charge != 0 -- circular polarization co-handed with the vortex
    (``m + 1``: null preserved) vs counter-handed (``m - 1 = 0`` for
    m = 1: the z-field FILLS the null) vs linear (half the power in the
    filling component). Null quality directly caps STED resolution, which
    is why real systems interlock the quarter-wave plate with the phase
    mask handedness.

    Module-level jit for the same reason as ``_vortex_donut``. ``na`` sets ``sin(theta_max)``; the aperture cutoff
    keeps the scalar model's ring calibration (first ring at
    ``sigma_dep * sqrt(2)``, NA-exact in the paraxial limit; at NA ~ 0.9
    the vectorial ring sits a few % wider -- physics, not a bug).
    """
    fr, phi, f_max, mask = _pupil_grid(sigma_dep, shape)
    # f = f_max maps to theta_max = asin(na): focal angles scale with the
    # pupil radius under the Abbe sine condition (r = f_lens sin th)
    sin_th = jnp.clip(fr / jnp.maximum(f_max, 1e-30), 0.0, 1.0) * na
    cos_th = jnp.sqrt(jnp.maximum(1.0 - sin_th * sin_th, 0.0))
    if polarization in ("circular+", "circular-"):
        s = 1.0 if polarization == "circular+" else -1.0
        ex0, ey0 = 1.0 / jnp.sqrt(2.0), s * 1j / jnp.sqrt(2.0)
    elif polarization in ("linear-x", "linear-y"):
        ex0, ey0 = (1.0, 0.0) if polarization == "linear-x" else (0.0, 1.0)
    else:
        raise ValueError(f"unknown polarization {polarization!r}")
    cosp, sinp = jnp.cos(phi), jnp.sin(phi)
    # s/p rotation of the collimated input into the converging cone
    # (Richards-Wolf A-matrix, Novotny & Hecht ch. 3)
    axx = cos_th * cosp * cosp + sinp * sinp
    axy = (cos_th - 1.0) * sinp * cosp
    ayy = cos_th * sinp * sinp + cosp * cosp
    azx = -sin_th * cosp
    azy = -sin_th * sinp
    apod = mask * jnp.sqrt(jnp.maximum(cos_th, 0.0))
    vort = jax.lax.complex(jnp.cos(charge * phi), jnp.sin(charge * phi))
    pupil = apod * vort
    inten = jnp.zeros(shape, jnp.float32)
    for gx, gy in ((axx, axy), (axy, ayy), (azx, azy)):
        comp = jnp.fft.fftshift(jnp.fft.ifft2(pupil * (gx * ex0 + gy * ey0)))
        inten = inten + jnp.square(jnp.abs(comp))
    return inten / jnp.maximum(jnp.max(inten), 1e-30)


@dataclasses.dataclass(frozen=True)
class VectorialDonutModel:
    """Richards-Wolf vectorial vortex donut (see ``_vectorial_donut``).

    ``polarization``: ``"circular+"`` (co-handed with the vortex -- the
    correct STED alignment, on-axis null preserved), ``"circular-"``
    (counter-handed: the z-field fills the null and caps the achievable
    depletion contrast), ``"linear-x"`` / ``"linear-y"`` (partial fill).
    ``na`` is the objective's numerical aperture (sin of the cone
    half-angle, water/air-normalized).
    """

    gaussian_excitation = True

    charge: int = 1
    na: float = 0.9
    polarization: str = "circular+"

    def excitation(self, shape: tuple[int, int], params) -> jnp.ndarray:
        return psfs.gaussian_psf(shape, params.sigma_exc)

    def depletion(self, shape: tuple[int, int], params) -> jnp.ndarray:
        return _vectorial_donut(params.sigma_dep, shape=tuple(shape),
                                charge=self.charge, na=self.na,
                                polarization=self.polarization)


@dataclasses.dataclass(frozen=True)
class GaussianStripeModel:
    """Default line-STED illumination: Gaussian excitation line profile,
    ``sin^2`` standing-wave depletion stripe (physics/psf.py)."""

    gaussian_excitation = True

    def excitation(self, width: int, params) -> jnp.ndarray:
        return psfs.line_excitation_profile(width, params.sigma_exc)

    def depletion(self, width: int, params) -> jnp.ndarray:
        return psfs.stripe_depletion_profile(width, params.stripe_period)


@dataclasses.dataclass(frozen=True)
class EnvelopedStripeModel:
    """Standing-wave stripe under a finite Gaussian envelope of width
    ``envelope_sigmas * stripe_period`` pixels -- a physical depletion line
    has finite extent, so far-out stripe maxima carry less intensity than
    the idealized infinite ``sin^2`` field. Peak-normalized at the first
    maximum (``x = period/2``)."""

    gaussian_excitation = True

    envelope_sigmas: float = 4.0

    def excitation(self, width: int, params) -> jnp.ndarray:
        return psfs.line_excitation_profile(width, params.sigma_exc)

    def depletion(self, width: int, params) -> jnp.ndarray:
        stripe = psfs.stripe_depletion_profile(width, params.stripe_period)
        x = jnp.arange(width, dtype=jnp.float32) - (width // 2)
        sig = self.envelope_sigmas * params.stripe_period
        env = jnp.exp(-jnp.square(x) / (2.0 * jnp.square(sig)))
        out = stripe * env
        return out / jnp.maximum(jnp.max(out), 1e-30)


@dataclasses.dataclass(frozen=True)
class InterferenceStripeModel:
    """Two-beam interference stripe with polarization-limited visibility --
    the line-STED analog of ``VectorialDonutModel``'s alignment physics.

    Two plane waves crossing at half-angle ``theta`` (set by the period:
    ``sin theta = wavelength_px / (2 * stripe_period)``) interfere with
    fringe visibility 1 for s-polarization (fields parallel, out of the
    incidence plane) but only ``|cos 2 theta|`` for p-polarization (the
    in-plane field vectors are rotated by ``2 theta`` between the beams),
    so a p-polarized depletion stripe has its nulls FILLED by
    ``(1 - v) / (1 + v)`` of the peak -- unbleachable background right on
    the scanned line, capping line-STED resolution exactly like the
    counter-handed donut caps point-STED.

    ``I(x) = (1 - v cos(2 pi x / P)) / (1 + v)``, peak-normalized; v = 1
    is the default ``sin^2`` stripe's closed form (equal to f32 rounding).
    """

    gaussian_excitation = True

    polarization: str = "s"
    wavelength_px: float = 4.0

    def excitation(self, width: int, params) -> jnp.ndarray:
        return psfs.line_excitation_profile(width, params.sigma_exc)

    def depletion(self, width: int, params) -> jnp.ndarray:
        if self.polarization == "s":
            vis = jnp.float32(1.0)
        elif self.polarization == "p":
            sin_th = jnp.clip(
                self.wavelength_px / (2.0 * params.stripe_period), 0.0, 1.0)
            cos2 = 1.0 - 2.0 * sin_th * sin_th       # cos(2 theta)
            vis = jnp.abs(cos2)
        else:
            raise ValueError(f"unknown polarization {self.polarization!r}")
        x = jnp.arange(width, dtype=jnp.float32) - (width // 2)
        fringe = jnp.cos(2.0 * jnp.pi * x / params.stripe_period)
        return (1.0 - vis * fringe) / (1.0 + vis)


DEFAULT_POINT_MODEL = GaussianDonutModel()
DEFAULT_LINE_MODEL = GaussianStripeModel()


def point_model(params):
    """The illumination model of point-STED params (None -> default)."""
    return getattr(params, "model", None) or DEFAULT_POINT_MODEL


def line_model(params):
    """The illumination model of line-STED params (None -> default)."""
    return getattr(params, "model", None) or DEFAULT_LINE_MODEL


def effective_point_psf(shape: tuple[int, int], params) -> jnp.ndarray:
    """Depleted point illumination ``exc * exp(-s * dep)`` through the
    params' model (the single construction point every point engine uses)."""
    m = point_model(params)
    return psfs.effective_psf(m.excitation(shape, params),
                              m.depletion(shape, params), params.depletion)


def effective_line_profile(width: int, params) -> jnp.ndarray:
    """Depleted line-excitation profile through the params' model (the
    single construction point every line engine uses)."""
    m = line_model(params)
    return psfs.effective_psf(m.excitation(width, params),
                              m.depletion(width, params), params.depletion)
