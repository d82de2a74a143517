"""Rescan line-STED microscopy simulation engine in JAX.

A JAX/XLA framework with the capabilities of the reference
publication repo ``AndrewGYork/rescan_line_sted`` (see SURVEY.md): PSF synthesis
with saturable STED depletion, point-/line-/rescanned-STED image formation,
Poisson shot noise, multi-orientation Richardson-Lucy fusion, and dose-matched
comparison sweeps -- all compiled to single XLA programs and mesh-shardable.

Layer map (SURVEY.md section 2.2):
  physics/    PSF synthesis, depletion nonlinearity, noise, dose accounting
  kernels/    FFT convolution helpers; rescan scatter-add placement
  imaging/    point-STED / descanned-line / rescanned-line engines
  algorithms/ Richardson-Lucy deconvolution, resolution metrics
  sweeps/     vmapped dose-matched comparison sweeps
  parallel/   jax.sharding mesh utilities (single-chip safe)
  data/       procedural test samples
  io/         TIFF / npz output
  pipelines/  figure-equivalent end-to-end pipelines + CLI
"""

__version__ = "0.1.0"

from rescan_line_sted_tpu.config import (  # noqa: F401
    Grid,
    PointSTEDGeometry,
    LineSTEDGeometry,
    RescanGeometry,
    RescanPointGeometry,
    PointSTEDParams,
    LineSTEDParams,
    RescanParams,
)
