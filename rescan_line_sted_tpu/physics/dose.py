"""Photodose accounting (reference component C8, SURVEY.md section 3).

The reference tallies excitation and depletion dose per scan position and
compares point- vs line-STED under an equal photodamage budget
(SURVEY.md section 1.1, "Dose accounting").

For circular scans that visit every position the accumulated dose is
*spatially uniform*, with closed forms (no per-step loop needed):

* point-STED over all ``H*W`` positions: every pixel receives
  ``sum(exc_psf)`` excitation and ``s * sum(dep_psf)`` depletion.
* line-STED over all ``W`` column positions: every pixel receives
  ``sum_x(exc_profile)`` excitation and ``s * sum_x(stripe_profile)``
  depletion (the line/stripe are uniform along y).

Similarly the expected *emitted* photons per unit sample brightness is the
spatially uniform factor ``sum(psf_eff)`` (point) / ``sum_x(eff_profile)``
(line): line-STED extracts the same signal in ``W`` instead of ``W**2`` steps,
which is the paper's speed/dose argument.
"""

from __future__ import annotations

import jax.numpy as jnp

from rescan_line_sted_tpu.config import (
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
    RescanPointGeometry,
)
from rescan_line_sted_tpu.physics import models
from rescan_line_sted_tpu.physics import psf as psfs
from rescan_line_sted_tpu.utils import struct


@struct.dataclass
class DoseReport:
    """Per-pixel photodose and signal ledger for one acquisition.

    All entries are per-pixel (dose is spatially uniform, see module doc) and
    per unit dwell/exposure; ``num_steps`` is the scan-position count.
    """

    excitation_dose: jnp.ndarray  # time-integrated excitation intensity
    depletion_dose: jnp.ndarray   # time-integrated depletion intensity (s-scaled)
    emission_per_unit_sample: jnp.ndarray  # expected emitted photons factor
    num_steps: jnp.ndarray

    @property
    def total_dose(self) -> jnp.ndarray:
        return self.excitation_dose + self.depletion_dose

    @property
    def signal_per_dose(self) -> jnp.ndarray:
        return self.emission_per_unit_sample / self.total_dose


def point_sted_dose(
    params: PointSTEDParams,
    geom: "PointSTEDGeometry | RescanPointGeometry",
) -> DoseReport:
    shape = geom.grid.shape
    m = models.point_model(params)
    exc = m.excitation(shape, params)
    dep = m.depletion(shape, params)
    eff = psfs.effective_psf(exc, dep, params.depletion)
    return DoseReport(
        excitation_dose=jnp.sum(exc),
        depletion_dose=params.depletion * jnp.sum(dep),
        emission_per_unit_sample=jnp.sum(eff),
        num_steps=jnp.asarray(geom.num_steps, jnp.float32),
    )


def line_sted_dose(
    params: LineSTEDParams, geom: LineSTEDGeometry | RescanGeometry
) -> DoseReport:
    w = geom.grid.width
    m = models.line_model(params)
    exc = m.excitation(w, params)
    dep = m.depletion(w, params)
    eff = psfs.effective_psf(exc, dep, params.depletion)
    return DoseReport(
        excitation_dose=jnp.sum(exc),
        depletion_dose=params.depletion * jnp.sum(dep),
        emission_per_unit_sample=jnp.sum(eff),
        num_steps=jnp.asarray(geom.num_steps, jnp.float32),
    )
