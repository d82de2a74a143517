"""Configuration dataclasses.

Two kinds of configuration, split by how JAX treats them:

* **Geometry** (plain frozen dataclasses): static, hashable facts that determine
  array *shapes* and compiled control flow -- grid size, scan chunking, rescan
  factor, detector binning. Changing one recompiles.
* **Params** (``utils.struct`` pytrees of scalars): physics knobs that are traced
  values -- PSF widths, depletion saturation ``s``, brightness, pinhole/slit
  sizes. These can be ``vmap``-ped over (the dose sweep vmaps over
  ``depletion``) without recompilation. Each params class also carries an
  optional STATIC ``model`` field (``pytree_node=False``) selecting the
  illumination-PSF generators (``physics/models.py``); ``None`` means the
  built-in closed forms.

The reference hard-codes all of these as constants inside each figure script
(SURVEY.md section 6, "Config / flag system": none in reference).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from rescan_line_sted_tpu.utils import struct

# ---------------------------------------------------------------------------
# Static geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """Simulation pixel grid. Convolutions are circular on this grid."""

    height: int
    width: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class PointSTEDGeometry:
    """Static geometry of a 2D point-scanning STED acquisition.

    The scan visits every pixel: ``height * width`` scan positions
    (SURVEY.md section 4.1). ``chunk`` scan positions are processed per
    ``lax.scan`` step as one batched FFT; it must divide ``height * width``.
    """

    grid: Grid
    chunk: int = 64

    @property
    def num_steps(self) -> int:
        return self.grid.height * self.grid.width


@dataclasses.dataclass(frozen=True)
class LineSTEDGeometry:
    """Static geometry of a descanned line-STED acquisition.

    The excitation line runs along y and is scanned along x: ``width`` scan
    positions, one output column each (SURVEY.md section 4.2). ``chunk`` must
    divide ``width``.
    """

    grid: Grid
    chunk: int = 32

    @property
    def num_steps(self) -> int:
        return self.grid.width


@dataclasses.dataclass(frozen=True)
class RescanGeometry:
    """Static geometry of a rescanned line-STED acquisition.

    Pixel reassignment: the (re-binned) camera frame captured at scan position
    ``x0`` is accumulated into the output canvas at rescan position
    ``R * x0`` (SURVEY.md section 4.3). Canvas column of camera pixel ``x``:
    ``u = R*x0 + (x - x0)``, i.e. frame offset ``(R-1)*x0``, wrapped
    circularly on a canvas of width ``round(R*width)``.

    * ``rescan_factor`` -- R. Offsets are rounded to the nearest (binned)
      canvas pixel; with integer R and ``binning=1`` the placement is exact
      and the analytic engine matches the scan engine bit-for-math.
    * ``binning`` -- detector re-binning factor b: camera pixels are summed
      in ``b x b`` blocks before reassignment. Must divide height and width.
    """

    grid: Grid
    rescan_factor: float = 2.0
    binning: int = 1
    chunk: int = 32

    def __post_init__(self):
        if self.grid.height % self.binning or self.grid.width % self.binning:
            raise ValueError("binning must divide the grid shape")
        if self.rescan_factor < 1.0:
            raise ValueError("rescan_factor must be >= 1 (canvas must hold "
                             "a full camera frame)")

    @property
    def num_steps(self) -> int:
        return self.grid.width

    @property
    def canvas_shape(self) -> tuple[int, int]:
        h = self.grid.height // self.binning
        w = int(round(self.rescan_factor * self.grid.width)) // self.binning
        return (h, w)


@dataclasses.dataclass(frozen=True)
class RescanPointGeometry:
    """Static geometry of a rescanned POINT-STED acquisition (2D pixel
    reassignment -- the rescan-confocal / ISM detection scheme the paper's
    line-rescan theory descends from; beyond-reference capability).

    The scan visits every pixel; the (re-binned) camera frame captured at
    scan position ``p = (y0, x0)`` is accumulated into the canvas at
    ``R * p`` (canvas pixel of camera pixel ``x``: ``u = R*p + (x - p)``),
    wrapping circularly on the ``round(R*H)/b x round(R*W)/b`` canvas.
    ``chunk`` scan positions are processed per ``lax.scan`` step.
    """

    grid: Grid
    rescan_factor: float = 2.0
    binning: int = 1
    chunk: int = 64

    def __post_init__(self):
        if self.grid.height % self.binning or self.grid.width % self.binning:
            raise ValueError("binning must divide the grid shape")
        if self.rescan_factor < 1.0:
            raise ValueError("rescan_factor must be >= 1 (canvas must hold "
                             "a full camera frame)")

    @property
    def num_steps(self) -> int:
        return self.grid.height * self.grid.width

    @property
    def canvas_shape(self) -> tuple[int, int]:
        h = int(round(self.rescan_factor * self.grid.height)) // self.binning
        w = int(round(self.rescan_factor * self.grid.width)) // self.binning
        return (h, w)


# ---------------------------------------------------------------------------
# Traced physics parameters (vmappable pytrees)
# ---------------------------------------------------------------------------


def _f(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float32)


def _support(sigma, pad: int = 5) -> int | None:
    """Static support half-width (px) bounding a Gaussian of width
    ``sigma``: < 4e-10 of peak beyond ``6.5 sigma``. None when ``sigma`` is
    traced (then no static bound exists)."""
    try:
        return int(6.5 * float(sigma)) + pad
    except Exception:
        return None


def _aperture_support(radius, pad: int = 2) -> int | None:
    """Static half-width (px) bounding a hard aperture (pinhole radius /
    slit half-width). None when ``radius`` is traced.

    The single source of truth for the banded engines' aperture windows:
    ``create`` fills the ``*_support`` fields with it, and the engines'
    band gates fall back to it for hand-built params (the two must agree
    or the windows would disagree with the params' static supports)."""
    try:
        return int(float(radius)) + pad
    except Exception:
        return None


@struct.dataclass
class PointSTEDParams:
    """Physics of a point-STED acquisition (all traced f32 scalars).

    * ``sigma_exc``    Gaussian excitation PSF width (pixels).
    * ``sigma_det``    Gaussian detection PSF width (pixels).
    * ``sigma_dep``    donut depletion scale: peak intensity ring at
                       ``r = sigma_dep * sqrt(2)`` pixels.
    * ``depletion``    saturation factor ``s``: surviving emission is
                       ``exp(-s * dep(r))`` (the ``1 - exp(-I/I_sat)``
                       depletion nonlinearity; BASELINE.json north_star).
    * ``pinhole_radius`` descanned pinhole radius (pixels).
    * ``brightness``   expected detected photons scale per scan step.
    * ``model``        STATIC illumination-model override (see
                       ``physics/models.py``; ``None`` = Gaussian excitation
                       + ``u e^{1-u}`` donut closed forms).
    * ``exc_support`` / ``det_support``  STATIC half-widths (px) bounding
                       the excitation / detection PSF supports; auto-filled
                       by ``create`` from concrete sigmas. They enable the
                       banded-window engines under jit/vmap (where sigmas
                       trace); if you ``replace`` a sigma with a LARGER
                       value, update or None the matching support (a stale
                       too-small bound truncates real signal).
    """

    sigma_exc: jnp.ndarray
    sigma_det: jnp.ndarray
    sigma_dep: jnp.ndarray
    depletion: jnp.ndarray
    pinhole_radius: jnp.ndarray
    brightness: jnp.ndarray
    model: object = struct.field(pytree_node=False, default=None)
    exc_support: int | None = struct.field(pytree_node=False, default=None)
    det_support: int | None = struct.field(pytree_node=False, default=None)
    pin_support: int | None = struct.field(pytree_node=False, default=None)

    @classmethod
    def create(cls, sigma_exc=3.0, sigma_det=3.0, sigma_dep=3.0,
               depletion=0.0, pinhole_radius=4.0, brightness=100.0,
               model=None):
        pin_sup = _aperture_support(pinhole_radius)
        return cls(_f(sigma_exc), _f(sigma_det), _f(sigma_dep),
                   _f(depletion), _f(pinhole_radius), _f(brightness),
                   model=model,
                   exc_support=_support(sigma_exc),
                   det_support=_support(sigma_det),
                   pin_support=pin_sup)


@struct.dataclass
class LineSTEDParams:
    """Physics of a (de/re)scanned line-STED acquisition.

    * ``sigma_exc``     Gaussian width of the excitation *line* profile
                        (along the scan axis x; pixels).
    * ``sigma_det``     Gaussian detection PSF width (pixels).
    * ``stripe_period`` period of the standing-wave depletion stripe pattern
                        ``sin^2(pi * x / period)`` -- zero along the excitation
                        line, first intensity maximum at ``period / 2``.
    * ``depletion``     saturation factor ``s`` (as in PointSTEDParams).
    * ``slit_halfwidth`` descanned slit half-width (pixels); only used by the
                        descanned engine, ignored by the rescanned engine.
    * ``brightness``    expected detected photons scale per scan step.
    * ``model``         STATIC illumination-model override (see
                        ``physics/models.py``; ``None`` = Gaussian line +
                        ``sin^2`` stripe closed forms).
    * ``exc_support`` / ``det_support`` / ``slit_support_px``  STATIC
                        half-widths (px) bounding the excitation line,
                        detection PSF, and slit supports; auto-filled by
                        ``create`` from concrete values. They enable the
                        banded-window engines under jit/vmap (where the
                        physics scalars trace); if you ``replace`` a width
                        with a LARGER value, update or None the matching
                        support (a stale too-small bound truncates signal).
    """

    sigma_exc: jnp.ndarray
    sigma_det: jnp.ndarray
    stripe_period: jnp.ndarray
    depletion: jnp.ndarray
    slit_halfwidth: jnp.ndarray
    brightness: jnp.ndarray
    model: object = struct.field(pytree_node=False, default=None)
    exc_support: int | None = struct.field(pytree_node=False, default=None)
    det_support: int | None = struct.field(pytree_node=False, default=None)
    slit_support_px: int | None = struct.field(pytree_node=False,
                                               default=None)

    @classmethod
    def create(cls, sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
               depletion=0.0, slit_halfwidth=4.0, brightness=100.0,
               model=None):
        slit_sup = _aperture_support(slit_halfwidth)
        return cls(_f(sigma_exc), _f(sigma_det), _f(stripe_period),
                   _f(depletion), _f(slit_halfwidth), _f(brightness),
                   model=model,
                   exc_support=_support(sigma_exc),
                   det_support=_support(sigma_det),
                   slit_support_px=slit_sup)


# The rescanned engine shares the line physics; alias for API clarity.
RescanParams = LineSTEDParams


def matmul_precision():
    """The matmul precision every engine matmul uses.

    Default ``HIGHEST`` (float32 operands, float32 accumulation): the
    engines are held to 1e-5 relative error against the float64 oracle, and
    reduced-precision passes (bf16 ``DEFAULT``, or TF32 where a backend
    lowers ``HIGH`` to it) keep only ~3 decimal digits per product. Override
    with ``RLS_MATMUL_PRECISION={default,high,highest}`` (read at import
    time) for experiments.
    """
    import os

    import jax

    name = os.environ.get("RLS_MATMUL_PRECISION", "highest").upper()
    return getattr(jax.lax.Precision, name)
