"""Dose-matched point-vs-line STED comparison sweep (component C8;
call stack 4.4; BASELINE config 4).

The paper's central comparison: sweep the depletion saturation ``s`` for both
modalities while holding the **total per-pixel photodose** (excitation +
depletion, the photodamage proxy) at a fixed budget, and compare resolution,
emitted signal, and scan-step counts. The reference reruns its whole
simulation per sweep point in Python; here the sweep axis is ``vmap``-ped so
the entire comparison compiles to ONE XLA program (BASELINE.json: "Batch
entire dose-matched point-vs-line comparison sweeps with vmap/pmap") and the
batch axis can be sharded over a device mesh (see ``parallel/mesh.py``).

Dose matching: for each sweep point and modality the exposure (dwell-time
scale) is set to ``budget / (exc_dose + dep_dose(s))``; line-STED exposure is
further divided by the number of acquisition orientations so the *summed*
line dose meets the same budget. Emitted signal then follows the closed-form
ledger in ``physics/dose.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rescan_line_sted_tpu.algorithms.metrics import fwhm_2d
from rescan_line_sted_tpu.config import (
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
)
from rescan_line_sted_tpu.imaging import analytic
from rescan_line_sted_tpu.imaging.line_sted import line_sted_image
from rescan_line_sted_tpu.imaging.point_sted import point_sted_image
from rescan_line_sted_tpu.physics.dose import line_sted_dose, point_sted_dose
from rescan_line_sted_tpu.utils import struct


@struct.dataclass
class ModalitySweep:
    """Per-sweep-point results for one modality (leading dim = sweep)."""

    image: jnp.ndarray           # [B, H, W] dose-matched acquisition
    fwhm_x: jnp.ndarray          # [B] system-kernel FWHM, scan axis
    fwhm_y: jnp.ndarray          # [B]
    emitted_signal: jnp.ndarray  # [B] expected emitted photons (whole image)
    exposure: jnp.ndarray        # [B] dwell scale that meets the budget
    num_steps: jnp.ndarray       # [B] scan positions per acquisition
    # [B] achieved-with-noise resolution (sample px) from two-independent-
    # acquisition Fourier Ring Correlation (algorithms/frc.py, 1/7
    # criterion); None unless the sweep ran with frc=True
    frc_resolution: jnp.ndarray | None = None
    # [B] per-axis sectored-FRC resolutions (sample px) for anisotropic
    # canvases (the unfused rescan arm), where a radial ring would mix two
    # different physical frequencies; None elsewhere / when frc=False
    frc_resolution_x: jnp.ndarray | None = None
    frc_resolution_y: jnp.ndarray | None = None


@struct.dataclass
class DoseMatchedComparison:
    depletion_powers: jnp.ndarray  # [B]
    dose_budget: jnp.ndarray       # scalar (per-pixel total dose)
    point: ModalitySweep
    line: ModalitySweep            # descanned line-STED
    rescan: ModalitySweep | None = None  # rescanned line-STED (optional arm)
    ism: ModalitySweep | None = None     # rescanned point-STED (optional arm)


def dose_matched_sweep(
    sample: jnp.ndarray,
    point_base: PointSTEDParams,
    line_base: LineSTEDParams,
    point_geom: PointSTEDGeometry,
    line_geom: LineSTEDGeometry,
    depletion_powers: jnp.ndarray,
    dose_budget,
    key: jax.Array | None = None,
    orientations: int = 1,
    rescan_geom=None,
    fuse_orientations: bool = False,
    fusion_iters: int = 30,
    ism_geom=None,
    fusion_accelerate: bool = False,
    frc: bool = False,
) -> DoseMatchedComparison:
    """Run the full dose-matched comparison as one vmapped program.

    ``depletion_powers`` [B] is the sweep axis (shard it over a mesh "batch"
    axis for multi-chip). ``key=None`` gives noise-free expected images.
    Passing a ``RescanGeometry`` adds a third arm -- rescanned line-STED at
    the same illumination/dose as the descanned line (only detection
    differs), the paper's headline modality. Passing a
    ``RescanPointGeometry`` (``ism_geom``, binning=1) adds a fourth,
    beyond-reference arm: rescanned POINT-STED (2D pixel reassignment /
    ISM) at the point arm's illumination and dose -- only detection
    differs, so the comparison isolates what pixel reassignment buys a
    point scanner. Its images live on the R-magnified canvas grid;
    resolution columns are reported in sample pixels (canvas FWHM / R).

    ``fuse_orientations=True`` runs the paper's actual protocol (call stack
    4.4/4.5): the line arm acquires ``orientations`` rotated views at the
    matched *total* dose and reports the multi-view RL-fused image; the
    rescan arm fuses its rotated canvases through the operator-form RL onto
    the sample grid. For an apples-to-apples comparison the point arm is
    RL-deconvolved with the same iteration count. Resolution columns then
    report the *achieved* post-fusion resolution -- the FWHM of each arm's
    RL-restored point response (same protocol, ``fusion_iters`` iterations)
    -- instead of the raw system-kernel FWHM, so the fused line/rescan
    numbers are isotropic (fwhm_y ~ fwhm_x) at high depletion.

    ``fusion_accelerate=True`` turns on Biggs-Andrews extrapolation in every
    RL loop of the fused protocol (views, operator fusion, ISM deconvolve):
    the same restoration error is reached in ~2-3x fewer ``fusion_iters``,
    cutting the dominant per-sweep-point cost (each point pays the loop
    twice: image + point-response).

    ``frc=True`` (requires ``key``) acquires a SECOND independent noisy
    realization per arm and reports the achieved-with-noise resolution via
    two-acquisition Fourier Ring Correlation (``algorithms/frc.py``, 1/7
    criterion) in each arm's ``frc_resolution`` column [sample px] -- the
    data-driven counterpart to the kernel/point-response FWHM columns.
    The unfused rescan canvas is anisotropically scaled, so its radial
    FRC column stays None and it instead reports per-axis sectored-FRC
    resolutions (``frc_resolution_x/_y``, sample px; see
    ``algorithms/frc.frc_sectored_resolution``); ISM's isotropic canvas
    is reported divided by R.
    """
    if frc and key is None:
        raise ValueError("frc=True needs a PRNG key (two noisy draws)")
    shape = point_geom.grid.shape
    powers = jnp.asarray(depletion_powers, jnp.float32)
    budget = jnp.asarray(dose_budget, jnp.float32)
    sample_sum = jnp.sum(sample)
    if fuse_orientations:
        from rescan_line_sted_tpu.algorithms.richardson_lucy import (
            richardson_lucy_views,
        )
        from rescan_line_sted_tpu.imaging.orientations import (
            multi_orientation_line_sted,
        )
        from rescan_line_sted_tpu.imaging.shifts import flip_centered

        angles = jnp.arange(orientations) * (jnp.pi / orientations)

        def fused_point_response(kernels):
            """FWHM of the RL-fused restoration of a point source.

            The noise-free view of a centered unit delta through kernel K is
            ``corr(delta, K) = flip(K)``; restoring those views with the
            same RL protocol measures the achieved (post-deconvolution)
            resolution.
            """
            views = jax.vmap(flip_centered)(kernels)
            psf = richardson_lucy_views(views, kernels, num_iter=fusion_iters,
                                        accelerate=fusion_accelerate)
            return fwhm_2d(psf)

    def one(s, kp, kl, kr, ki):
        pp = point_base.replace(depletion=s)
        lp = line_base.replace(depletion=s)
        pdose = point_sted_dose(pp, point_geom)
        ldose = line_sted_dose(lp, line_geom)
        exp_p = budget / pdose.total_dose
        exp_l = budget / (ldose.total_dose * orientations)
        pp_run = pp.replace(brightness=pp.brightness * exp_p)
        lp_run = lp.replace(brightness=lp.brightness * exp_l)

        pkern = analytic.point_system_kernel(shape, pp)

        def acquire_point(k):
            img = point_sted_image(sample, pp_run, point_geom, key=k).image
            if fuse_orientations:
                img = richardson_lucy_views(img[None], pkern[None],
                                            num_iter=fusion_iters,
                                            accelerate=fusion_accelerate)
            return img

        def acquire_line(k):
            if fuse_orientations:
                views, kernels = multi_orientation_line_sted(
                    sample, lp_run, line_geom, angles, key=k)
                img = richardson_lucy_views(views, kernels,
                                            num_iter=fusion_iters,
                                            accelerate=fusion_accelerate)
                return img, kernels
            return line_sted_image(sample, lp_run, line_geom,
                                   key=k).image, None

        pimg = acquire_point(kp)
        limg, kernels = acquire_line(kl)
        if fuse_orientations:
            p_fy, p_fx = fused_point_response(pkern[None])
            l_fy, l_fx = fused_point_response(kernels)
        else:
            p_fy, p_fx = fwhm_2d(pkern)
            l_fy, l_fx = fwhm_2d(analytic.line_system_kernel(shape, lp))

        p_frc = l_frc = None
        if frc:
            from rescan_line_sted_tpu.algorithms.frc import frc_resolution

            p_frc = frc_resolution(pimg, acquire_point(
                jax.random.fold_in(kp, 1)))
            l_frc = frc_resolution(limg, acquire_line(
                jax.random.fold_in(kl, 1))[0])

        point_res = ModalitySweep(
            image=pimg, fwhm_x=p_fx, fwhm_y=p_fy, frc_resolution=p_frc,
            emitted_signal=(pp.brightness * exp_p
                            * pdose.emission_per_unit_sample * sample_sum),
            exposure=exp_p,
            num_steps=pdose.num_steps,
        )
        line_res = ModalitySweep(
            image=limg, fwhm_x=l_fx, fwhm_y=l_fy, frc_resolution=l_frc,
            emitted_signal=(lp.brightness * exp_l * orientations
                            * ldose.emission_per_unit_sample * sample_sum),
            exposure=exp_l,
            num_steps=ldose.num_steps * orientations,
        )
        ism_res = None
        if ism_geom is not None:
            # beyond-reference arm: 2D pixel reassignment at the POINT
            # arm's illumination and dose (only detection differs)
            from rescan_line_sted_tpu.algorithms.fusion import ism_deconvolve
            from rescan_line_sted_tpu.imaging.rescan_point import (
                rescan_point_canvas_mean,
                rescan_point_system_kernel,
            )
            from rescan_line_sted_tpu.physics.noise import maybe_poisson

            r_ism = ism_geom.rescan_factor

            def acquire_ism(k):
                img = maybe_poisson(
                    k, rescan_point_canvas_mean(sample, pp_run, ism_geom))
                if fuse_orientations:
                    # apples-to-apples with the fused arms: deconvolve with
                    # the same iteration count (ISM is isotropic -- one view)
                    img = ism_deconvolve(img, pp_run, ism_geom,
                                         num_iter=fusion_iters,
                                         accelerate=fusion_accelerate)
                return img

            iimg = acquire_ism(ki)
            if fuse_orientations:
                delta = jnp.zeros(shape, jnp.float32).at[
                    shape[0] // 2, shape[1] // 2].set(1.0)
                ipsf = ism_deconvolve(
                    rescan_point_canvas_mean(delta, pp, ism_geom), pp,
                    ism_geom, num_iter=fusion_iters,
                    accelerate=fusion_accelerate)
                i_fy, i_fx = fwhm_2d(ipsf)
            else:
                i_fy, i_fx = fwhm_2d(
                    rescan_point_system_kernel(ism_geom, pp))
            i_frc = None
            if frc:
                # isotropic R-magnified canvas: report in sample px
                i_frc = frc_resolution(iimg, acquire_ism(
                    jax.random.fold_in(ki, 1))) / r_ism
            ism_res = ModalitySweep(
                image=iimg, frc_resolution=i_frc,
                fwhm_x=i_fx / r_ism, fwhm_y=i_fy / r_ism,
                emitted_signal=point_res.emitted_signal,
                exposure=exp_p,
                num_steps=pdose.num_steps,
            )
        if rescan_geom is None:
            return point_res, line_res, None, ism_res

        if fuse_orientations:
            from rescan_line_sted_tpu.algorithms.fusion import (
                multi_orientation_rescan,
                rescan_fusion,
            )

            angles_static = tuple(
                v * 3.141592653589793 / orientations
                for v in range(orientations))

            def acquire_rescan_fused(k):
                canv = multi_orientation_rescan(sample, lp_run, rescan_geom,
                                                angles, key=k)
                return rescan_fusion(canv, lp_run, rescan_geom,
                                     angles_static, num_iter=fusion_iters,
                                     accelerate=fusion_accelerate)

            rimg = acquire_rescan_fused(kr)
            # achieved fused resolution: restore a point source's canvases
            # through the same operator RL (already on the sample grid)
            delta = jnp.zeros(shape, jnp.float32).at[
                shape[0] // 2, shape[1] // 2].set(1.0)
            pviews = multi_orientation_rescan(delta, lp_run, rescan_geom,
                                              angles)
            rpsf = rescan_fusion(pviews, lp_run, rescan_geom, angles_static,
                                 num_iter=fusion_iters,
                                 accelerate=fusion_accelerate)
            r_fy, r_fx = fwhm_2d(rpsf)
            r_frc = None
            if frc:
                r_frc = frc_resolution(rimg, acquire_rescan_fused(
                    jax.random.fold_in(kr, 1)))
            rescan_res = ModalitySweep(
                image=rimg, fwhm_x=r_fx, fwhm_y=r_fy, frc_resolution=r_frc,
                emitted_signal=line_res.emitted_signal,
                exposure=exp_l,
                num_steps=ldose.num_steps * orientations,
            )
            return point_res, line_res, rescan_res, ism_res

        from rescan_line_sted_tpu.imaging.rescan import (
            rescanned_line_sted_image,
        )

        rimg = rescanned_line_sted_image(
            sample, lp_run, rescan_geom, key=kr).image
        hk = analytic.rescan_system_kernel(rescan_geom, lp)
        r_fy, r_fx = fwhm_2d(hk)
        r_frc_x = r_frc_y = None
        if frc:
            from rescan_line_sted_tpu.algorithms.frc import (
                frc_sectored_resolution,
            )

            # the canvas is anisotropic (x magnified R/b, y shrunk b) so
            # radial FRC is meaningless; sectored per-axis FRC measures
            # each axis's crossing, rescaled by that axis's factor alone
            rimg2 = rescanned_line_sted_image(
                sample, lp_run, rescan_geom,
                key=jax.random.fold_in(kr, 1)).image
            cx, cy = frc_sectored_resolution(rimg, rimg2)
            r_frc_x = cx * rescan_geom.binning / rescan_geom.rescan_factor
            r_frc_y = cy * rescan_geom.binning
        rescan_res = ModalitySweep(
            image=rimg,
            # canvas x is magnified by R/b and y shrunk by b; report
            # sample-scale resolution
            fwhm_x=r_fx * rescan_geom.binning / rescan_geom.rescan_factor,
            fwhm_y=r_fy * rescan_geom.binning,
            frc_resolution_x=r_frc_x, frc_resolution_y=r_frc_y,
            emitted_signal=line_res.emitted_signal,
            exposure=exp_l,
            num_steps=ldose.num_steps * orientations,
        )
        return point_res, line_res, rescan_res, ism_res

    b = powers.shape[0]
    if key is None:
        point_res, line_res, rescan_res, ism_res = jax.vmap(
            lambda s: one(s, None, None, None, None))(powers)
    else:
        kp, kl, kr, ki = jax.random.split(key, 4)
        point_res, line_res, rescan_res, ism_res = jax.vmap(one)(
            powers, jax.random.split(kp, b), jax.random.split(kl, b),
            jax.random.split(kr, b), jax.random.split(ki, b))
    return DoseMatchedComparison(
        depletion_powers=powers, dose_budget=budget,
        point=point_res, line=line_res, rescan=rescan_res, ism=ism_res)
