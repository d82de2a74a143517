"""Drive the STED engines' main path once on the GPU and check every result.

    python chip_smoke.py               # one card: the five BASELINE configs
    python chip_smoke.py --four-cards  # four cards: the GSPMD mesh path only

One process owns the card(s). The script prints the card's name and power
limit (``nvidia-smi``), the JAX device, then one line per phase -- compile
and run wall time, the check made, its tolerance and the matmul precision --
then runs the ``gpu``-marked tests in this same process, and ends with one
JSON line ``{"ok": true, "device": {...}}``. It exits nonzero, without that
line, when JAX finds no GPU or when any check fails; nothing falls back to
the CPU.

Checks: noise-free results against the float64 numpy oracle
(``tests/oracle``) at 512^2 and against the analytic engine at 2048^2
(relative L2 error <= 1e-5); noisy results statistically: the photon total
within 6 sigma of the noise-free mean (``z``) and the residual power
``sum((n - m)^2) / sum(m)`` (``chi2/N``, Poisson: 1) in [0.75, 1.3].
Noise-free per-step pipelines run with the sampler replaced by the identity
(``noise_free_sampler``); the same pipelines then run with it.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REL_TOL = 1e-5
Z_MAX = 6.0
CHI2_RANGE = (0.75, 1.3)

# bench.py's configuration: sigmas 3 px, depletion 8, 12 px stripes,
# 4 px pinhole / slit halfwidth
POINT_KW = dict(sigma_exc=3.0, sigma_det=3.0, sigma_dep=3.0,
                pinhole_radius=4.0, depletion=8.0)
LINE_KW = dict(sigma_exc=3.0, sigma_det=3.0, stripe_period=12.0,
               slit_halfwidth=4.0, depletion=8.0)


class CheckFailed(AssertionError):
    pass


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_close(name: str, got, want, tol: float = REL_TOL) -> str:
    err = rel_err(got, want)
    if not err <= tol:
        raise CheckFailed(f"{name}: rel_err {err:.3e} > {tol:g}")
    return f"{name} rel_err={err:.3e}<={tol:g}"


def check_noise(name: str, noisy, mean) -> str:
    noisy = np.asarray(noisy, np.float64)
    mean = np.asarray(mean, np.float64)
    total = mean.sum()
    if not total > 1e4:
        raise CheckFailed(f"{name}: only {total:.0f} photons expected")
    z = abs(noisy.sum() - total) / np.sqrt(total)
    chi2 = ((noisy - mean) ** 2).sum() / total
    if not (z < Z_MAX and CHI2_RANGE[0] <= chi2 <= CHI2_RANGE[1]):
        raise CheckFailed(f"{name}: z={z:.2f} chi2/N={chi2:.3f}")
    return f"{name} z={z:.2f}<{Z_MAX:g} chi2/N={chi2:.3f}"


def check_spans(name: str, x, n: int) -> None:
    """The result of a sharded call must live on all ``n`` devices."""
    got = len(x.sharding.device_set)
    if got != n:
        raise CheckFailed(f"{name}: result on {got} devices, not {n}")


def timed(fn, *args):
    """``(compile_s, run_s, out)``: the first call (trace + compile + run)
    and a second, warm call, each fenced with ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return first, time.perf_counter() - t0, out


@contextlib.contextmanager
def noise_free_sampler():
    """Replace the engines' Poisson draw by the identity, so per-step
    pipelines return their noise-free mean. Compiled programs are dropped
    on entry and exit so no executable traced under the patch is reused."""
    import jax

    from rescan_line_sted_tpu.imaging import line_sted, point_sted, rescan

    mods = (line_sted, point_sted, rescan)
    saved = [m.maybe_poisson for m in mods]
    jax.clear_caches()
    for m in mods:
        m.maybe_poisson = lambda k, mean: mean
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.maybe_poisson = f
        jax.clear_caches()


def _sample(size: int, scale: float = 1.0):
    from rescan_line_sted_tpu.data import samples

    return samples.siemens_star((size, size)) * scale


def _x_padded(sample, margin: int):
    """Zero the sample within ``margin`` columns of its x-edges: the
    analytic rescan engine then agrees with the scan path everywhere."""
    import jax.numpy as jnp

    w = sample.shape[-1]
    cols = jnp.arange(w)
    return sample * ((cols >= margin) & (cols < w - margin))[None, :]


# --------------------------------------------------------------- phases ----

def phase_point(size: int = 512, brightness: float = 50.0,
                spot_checks: int = 32) -> list[str]:
    """Config 1: point-STED, collapsed scan, analytic and per-step."""
    import jax

    from rescan_line_sted_tpu.config import PointSTEDGeometry, PointSTEDParams
    from rescan_line_sted_tpu.config import Grid
    from rescan_line_sted_tpu.imaging import point_sted_image
    from tests.oracle import oracle

    geom = PointSTEDGeometry(Grid(size, size))
    params = PointSTEDParams.create(brightness=brightness, **POINT_KW)
    sample = _sample(size)
    s64 = np.asarray(sample, np.float64)
    kw = dict(POINT_KW, brightness=brightness)
    # f64 reference: the pinhole-folded raster is one circular correlation
    # with P = eff . (pin (*) det), built from the oracle's own blocks ...
    shape = (size, size)
    eff = oracle.effective_psf(oracle.gaussian_psf(shape, kw["sigma_exc"]),
                               oracle.donut_psf(shape, kw["sigma_dep"]),
                               kw["depletion"])
    q = oracle.fft_convolve(oracle.pinhole_mask(shape, kw["pinhole_radius"]),
                            oracle.detection_psf(shape, kw["sigma_det"]))
    want = brightness * oracle.fft_correlate(s64, eff * q)
    # ... and spot-checked against the oracle's per-position loop formula
    rng = np.random.default_rng(0)
    det = oracle.detection_psf(shape, kw["sigma_det"])
    pin = oracle.pinhole_mask(shape, kw["pinhole_radius"])
    for y0, x0 in rng.integers(0, size, size=(spot_checks, 2)):
        cam = brightness * oracle.fft_convolve(
            s64 * oracle.shift_to(eff, y0, x0), det)
        v = np.sum(cam * oracle.shift_to(pin, y0, x0))
        if abs(v - want[y0, x0]) > 1e-9 * max(abs(v), 1.0):
            raise CheckFailed(f"point reference spot check at {y0},{x0}")

    lines = []
    for method in ("scan", "analytic"):
        f = jax.jit(lambda s, p, m=method: point_sted_image(
            s, p, geom, method=m).image)
        c, r, out = timed(f, sample, params)
        lines.append(_line("point", f"{size}^2 {method} noise-free", c, r,
                           check_close("vs f64 oracle", out, want)))
    step = jax.jit(lambda s, p, k: point_sted_image(
        s, p, geom, key=k, method="scan", noise_mode="per_step").image)
    key = jax.random.key(1)
    with noise_free_sampler():
        c, r, mean = timed(step, sample, params, key)
    lines.append(_line("point", f"{size}^2 per-step mean", c, r,
                       check_close("vs f64 oracle", mean, want)))
    c, r, noisy = timed(step, sample, params, key)
    lines.append(_line("point", f"{size}^2 per-step noisy", c, r,
                       check_noise("vs per-step mean", noisy, mean)))
    return lines


def phase_line(size: int = 2048, oracle_size: int = 512,
               brightness: float = 50.0) -> list[str]:
    """Config 2: descanned line-STED, collapsed and per-step."""
    import jax

    from rescan_line_sted_tpu.config import Grid, LineSTEDGeometry
    from rescan_line_sted_tpu.config import LineSTEDParams
    from rescan_line_sted_tpu.imaging import line_sted_image
    from tests.oracle import oracle

    params = LineSTEDParams.create(brightness=brightness, **LINE_KW)
    lines = []
    key = jax.random.key(2)
    for n in (oracle_size, size):
        geom = LineSTEDGeometry(Grid(n, n))
        sample = _sample(n)
        collapsed = jax.jit(lambda s, p, g=geom: line_sted_image(
            s, p, g, method="scan").image)
        step = jax.jit(lambda s, p, k, g=geom: line_sted_image(
            s, p, g, key=k, method="scan", noise_mode="per_step").image)
        if n == oracle_size:
            want = oracle.line_sted_image(
                np.asarray(sample, np.float64), brightness=brightness,
                **LINE_KW)
            ref = "vs f64 oracle"
        else:
            analytic = jax.jit(lambda s, p, g=geom: line_sted_image(
                s, p, g, method="analytic").image)
            c, r, want = timed(analytic, sample, params)
            lines.append(_line("line", f"{n}^2 analytic", c, r,
                               "reference for the scan path"))
            ref = "vs analytic"
        c, r, out = timed(collapsed, sample, params)
        lines.append(_line("line", f"{n}^2 collapsed noise-free", c, r,
                           check_close(ref, out, want)))
        with noise_free_sampler():
            c, r, mean = timed(step, sample, params, key)
        lines.append(_line("line", f"{n}^2 per-step mean", c, r,
                           check_close(ref, mean, want)))
        if n == size:
            c, r, noisy = timed(step, sample, params, key)
            lines.append(_line("line", f"{n}^2 per-step noisy", c, r,
                               check_noise("vs per-step mean", noisy,
                                           mean)))
    return lines


def rescan_cells(size: int):
    """Config 3's placements: integer R (R=2, b=1), rational R (R=2.5,
    b=2) and the theory-optimal irrational R at the bench sigmas."""
    from rescan_line_sted_tpu.config import LineSTEDParams
    from rescan_line_sted_tpu.imaging.rescan import optimal_rescan_factor

    r_opt = float(optimal_rescan_factor(
        LineSTEDParams.create(**LINE_KW), size))
    return [("R=2 b=1", 2.0, 1), ("R=2.5 b=2", 2.5, 2),
            (f"R={r_opt:.4f} b=1", r_opt, 1)]


def phase_rescan(size: int = 2048, oracle_size: int = 512,
                 brightness: float = 50.0, chunk: int = 32) -> list[str]:
    """Config 3: rescanned line-STED (the flagship), per-step at three
    placements, plus the collapsed route at R = 2."""
    import jax

    from rescan_line_sted_tpu.config import Grid, LineSTEDParams
    from rescan_line_sted_tpu.config import RescanGeometry
    from rescan_line_sted_tpu.imaging import rescanned_line_sted_image
    from tests.oracle import oracle

    params = LineSTEDParams.create(brightness=brightness, **LINE_KW)
    kw = {k: v for k, v in LINE_KW.items() if k != "slit_halfwidth"}
    lines = []
    key = jax.random.key(3)
    step_fn = jax.jit(
        lambda s, p, k, g: rescanned_line_sted_image(
            s, p, g, key=k, method="scan", noise_mode="per_step").image,
        static_argnums=3)
    scan_fn = jax.jit(
        lambda s, p, g: rescanned_line_sted_image(
            s, p, g, method="scan").image, static_argnums=2)
    ana_fn = jax.jit(
        lambda s, p, g: rescanned_line_sted_image(
            s, p, g, method="analytic").image, static_argnums=2)
    # oracle size: scan (collapsed and per-step mean) vs the f64 loop
    sample = _sample(oracle_size)
    for label, r, b in rescan_cells(oracle_size):
        geom = RescanGeometry(Grid(oracle_size, oracle_size),
                              rescan_factor=r, binning=b, chunk=chunk)
        step = (r - 1.0) / b
        mode = "rounded" if abs(step - round(step)) < 1e-9 else "subpixel"
        want = oracle.rescanned_line_sted_image(
            np.asarray(sample, np.float64), rescan_factor=r, binning=b,
            brightness=brightness, reassignment=mode, **kw)
        c, r_s, out = timed(scan_fn, sample, params, geom)
        lines.append(_line("rescan", f"{oracle_size}^2 {label} collapsed",
                           c, r_s, check_close("vs f64 oracle", out, want)))
        with noise_free_sampler():
            c, r_s, mean = timed(step_fn, sample, params, key, geom)
        lines.append(_line("rescan", f"{oracle_size}^2 {label} per-step "
                           "mean", c, r_s,
                           check_close("vs f64 oracle", mean, want)))
    # full size: per-step vs the analytic engine on an x-padded sample
    sample = _x_padded(_sample(size), size // 16)
    for label, r, b in rescan_cells(size):
        geom = RescanGeometry(Grid(size, size), rescan_factor=r, binning=b,
                              chunk=chunk)
        c, r_s, want = timed(ana_fn, sample, params, geom)
        lines.append(_line("rescan", f"{size}^2 {label} analytic", c, r_s,
                           "reference for the scan path"))
        if label.startswith("R=2 "):
            c, r_s, out = timed(scan_fn, sample, params, geom)
            lines.append(_line("rescan", f"{size}^2 {label} collapsed", c,
                               r_s, check_close("vs analytic", out, want)))
        with noise_free_sampler():
            c, r_s, mean = timed(step_fn, sample, params, key, geom)
        lines.append(_line("rescan", f"{size}^2 {label} per-step mean", c,
                           r_s, check_close("vs analytic", mean, want)))
        c, r_s, noisy = timed(step_fn, sample, params, key, geom)
        lines.append(_line("rescan", f"{size}^2 {label} per-step noisy", c,
                           r_s, check_noise("vs per-step mean", noisy,
                                            mean)))
    return lines


def sweep_setup(size: int, num_powers: int):
    """The config-4 sweep: point, line and rescan (R=2) arms over
    ``num_powers`` depletion powers in [0, 16] at a 100-photon dose
    budget, as the CLI's ``figure sweep`` runs it."""
    import jax.numpy as jnp

    from rescan_line_sted_tpu.config import (Grid, LineSTEDGeometry,
                                             LineSTEDParams,
                                             PointSTEDGeometry,
                                             PointSTEDParams, RescanGeometry)

    grid = Grid(size, size)
    pkw = {k: v for k, v in POINT_KW.items() if k != "depletion"}
    lkw = {k: v for k, v in LINE_KW.items() if k != "depletion"}
    return dict(
        sample=_sample(size),
        point_base=PointSTEDParams.create(brightness=1.0, **pkw),
        line_base=LineSTEDParams.create(brightness=1.0, **lkw),
        point_geom=PointSTEDGeometry(grid), line_geom=LineSTEDGeometry(grid),
        depletion_powers=jnp.linspace(0.0, 16.0, num_powers),
        dose_budget=100.0, rescan_geom=RescanGeometry(grid))


def phase_sweep(size: int = 512, num_powers: int = 16) -> list[str]:
    """Config 4: the dose-matched sweep with the rescan arm."""
    import jax

    from rescan_line_sted_tpu.sweeps import dose_matched_sweep
    from tests.oracle import oracle

    cfg = sweep_setup(size, num_powers)
    run = jax.jit(lambda s, pb, lb, pw, k: dose_matched_sweep(
        s, pb, lb, cfg["point_geom"], cfg["line_geom"], pw,
        cfg["dose_budget"], key=k, rescan_geom=cfg["rescan_geom"]))
    args = (cfg["sample"], cfg["point_base"], cfg["line_base"],
            cfg["depletion_powers"])
    c, r, clean = timed(run, *args, None)
    j = num_powers - 1
    lkw = {k: v for k, v in LINE_KW.items() if k != "depletion"}
    want = oracle.line_sted_image(
        np.asarray(cfg["sample"], np.float64),
        depletion=float(cfg["depletion_powers"][j]),
        brightness=float(clean.line.exposure[j]), **lkw)
    lines = [_line("sweep", f"{size}^2 {num_powers} powers noise-free", c, r,
                   check_close(f"line arm power {j} vs f64 oracle",
                               clean.line.image[j], want))]
    c, r, noisy = timed(run, *args, jax.random.key(4))
    arms = ("point", "line", "rescan")
    for leaf in jax.tree.leaves(noisy):
        if not np.isfinite(np.asarray(leaf)).all():
            raise CheckFailed("sweep: non-finite output")
    checks = [check_noise(f"{a} arm", getattr(noisy, a).image,
                          getattr(clean, a).image) for a in arms]
    lines.append(_line("sweep", f"{size}^2 {num_powers} powers noisy", c, r,
                       "; ".join(checks)))
    return lines


def phase_fusion(size: int = 512, num_angles: int = 4,
                 rl_iters: int = 50, rl_tol: float = REL_TOL) -> list[str]:
    """Config 5: ``figure fusion`` through the CLI, then the RL fusion of
    the same views checked against the float64 oracle's RL."""
    import jax
    import jax.numpy as jnp

    from rescan_line_sted_tpu import cli
    from rescan_line_sted_tpu.algorithms import richardson_lucy_views
    from rescan_line_sted_tpu.config import Grid, LineSTEDGeometry
    from rescan_line_sted_tpu.config import LineSTEDParams
    from rescan_line_sted_tpu.imaging.orientations import (
        multi_orientation_line_sted,
    )
    from tests.oracle import oracle

    argv = ["figure", "fusion", "--size", str(size), "--num-angles",
            str(num_angles), "--rl-iters", str(rl_iters)]
    with tempfile.TemporaryDirectory() as out:
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            cli.main(argv + ["--out", out])
            walls.append(time.perf_counter() - t0)
        fused_tif = os.path.join(out, "fusion_fused_rl.tif")
        if not os.path.exists(fused_tif):
            raise CheckFailed("fusion: CLI wrote no fused image")
    lines = [_line("fusion", f"{size}^2 CLI {num_angles} angles "
                   f"{rl_iters} RL iters", walls[0], walls[1],
                   "fused image written")]
    # the same acquisition + RL, noise-free, vs the f64 oracle's RL
    params = LineSTEDParams.create(depletion=8.0, brightness=200.0)
    angles = jnp.arange(num_angles) * (jnp.pi / num_angles)
    views, kernels = multi_orientation_line_sted(
        _sample(size), params, LineSTEDGeometry(Grid(size, size)), angles)
    rl = jax.jit(lambda v, k: richardson_lucy_views(v, k, num_iter=rl_iters))
    c, r, fused = timed(rl, views, kernels)
    # the engine zeroes the ratio where the forward model is below
    # 1e-6 x mean|data| (its default guard); the oracle applies the same
    views64 = np.asarray(views, np.float64)
    want = oracle.richardson_lucy(list(views64),
                                  list(np.asarray(kernels, np.float64)),
                                  rl_iters,
                                  floor=1e-6 * np.abs(views64).mean())
    lines.append(_line("fusion", f"{size}^2 RL {rl_iters} iters", c, r,
                       check_close("vs f64 oracle RL", fused, want,
                                   tol=rl_tol)))
    return lines


def phase_mesh(size: int = 2048, sweep_size: int = 512,
               num_powers: int = 16, brightness: float = 50.0) -> list[str]:
    """The multi-device path (``parallel.mesh``) on every visible device:
    the config-4 sweep on a ``{"batch": n}`` mesh, then a line acquisition
    and a per-step rescan with rows on ``{"batch": n/2, "space": 2}`` --
    each against the same call on one device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.config import (Grid, LineSTEDGeometry,
                                             LineSTEDParams, RescanGeometry)
    from rescan_line_sted_tpu.imaging import (line_sted_image,
                                              rescanned_line_sted_image)
    from rescan_line_sted_tpu.parallel import make_mesh, replicate
    from rescan_line_sted_tpu.parallel import shard_batch
    from rescan_line_sted_tpu.sweeps import dose_matched_sweep

    n = len(jax.devices())
    if n < 2 or n % 2:
        raise CheckFailed(f"mesh phase needs an even device count, got {n}")
    one = jax.devices()[0]
    lines = []
    # config-4 sweep, powers sharded over "batch"
    cfg = sweep_setup(sweep_size, num_powers)
    run = jax.jit(lambda s, pb, lb, pw, k: dose_matched_sweep(
        s, pb, lb, cfg["point_geom"], cfg["line_geom"], pw,
        cfg["dose_budget"], key=k, rescan_geom=cfg["rescan_geom"]))
    args = (cfg["sample"], cfg["point_base"], cfg["line_base"],
            cfg["depletion_powers"])
    single = jax.device_put(args, one)
    mesh = make_mesh({"batch": n})
    sharded = (*replicate(mesh, args[:3]), shard_batch(mesh, args[3]))
    k = jax.random.key(5)
    _, _, want = timed(run, *single, None)
    c, r, got = timed(run, *sharded, None)
    check_spans("sweep", got.line.image, n)
    checks = [check_close(f"{a} arm", getattr(got, a).image,
                          getattr(want, a).image)
              for a in ("point", "line", "rescan")]
    lines.append(_line("mesh", f"sweep {sweep_size}^2 {num_powers} powers "
                       f"batch={n} noise-free", c, r,
                       "vs one device: " + "; ".join(checks)))
    c, r, noisy = timed(run, *sharded, k)
    checks = [check_noise(f"{a} arm", getattr(noisy, a).image,
                          getattr(want, a).image)
              for a in ("point", "line", "rescan")]
    lines.append(_line("mesh", f"sweep batch={n} noisy", c, r,
                       "; ".join(checks)))
    # rows over "space": line acquisition and per-step rescan
    mesh = make_mesh({"batch": n // 2, "space": 2})
    rows = NamedSharding(mesh, P("space", None))
    params = LineSTEDParams.create(brightness=brightness, **LINE_KW)
    sample = _sample(size)
    lgeom = LineSTEDGeometry(Grid(size, size))
    rgeom = RescanGeometry(Grid(size, size), rescan_factor=2.5, binning=2)
    cases = [
        ("line collapsed", jax.jit(lambda s, p, k: line_sted_image(
            s, p, lgeom, method="scan").image), None),
        ("line per-step", jax.jit(lambda s, p, k: line_sted_image(
            s, p, lgeom, key=k, method="scan",
            noise_mode="per_step").image), k),
        ("rescan R=2.5 b=2 per-step", jax.jit(
            lambda s, p, k: rescanned_line_sted_image(
                s, p, rgeom, key=k, method="scan",
                noise_mode="per_step").image), k),
    ]
    s1, p1 = jax.device_put((sample, params), one)
    ss, ps = jax.device_put(sample, rows), replicate(mesh, params)
    for name, f, key in cases:
        if key is None:
            _, _, want = timed(f, s1, p1, None)
            c, r, got = timed(f, ss, ps, None)
            check_spans(name, got, n)
            lines.append(_line("mesh", f"{size}^2 {name} space=2", c, r,
                               check_close("vs one device", got, want)))
            continue
        with noise_free_sampler():
            _, _, want = timed(f, s1, p1, key)
            c, r, got = timed(f, ss, ps, key)
        check_spans(name, got, n)
        lines.append(_line("mesh", f"{size}^2 {name} mean space=2", c, r,
                           check_close("vs one device", got, want)))
        c, r, noisy = timed(f, ss, ps, key)
        lines.append(_line("mesh", f"{size}^2 {name} noisy space=2", c, r,
                           check_noise("vs one-device mean", noisy, want)))
    return lines


def _line(phase: str, what: str, compile_s: float, run_s: float,
          check: str) -> str:
    """One phase line; the precision is the one every engine matmul uses
    (``config.matmul_precision``)."""
    from rescan_line_sted_tpu.imaging.rescan import _PRECISION

    return (f"phase={phase} {what}: compile_s={compile_s:.2f} "
            f"run_s={run_s:.4f} precision={_PRECISION.name} check: {check}")


def run_gpu_tests(repo: str) -> None:
    """The ``gpu``-marked tests, in this process (the card is already
    initialised; a second JAX process could not reserve it)."""
    import pytest

    os.environ["RLS_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "-p", "no:randomly",
                      os.path.join(repo, "tests")])
    if rc != 0:
        raise CheckFailed(f"gpu-marked tests failed (pytest exit {int(rc)})")
    print("phase=tests gpu-marked tests passed", flush=True)


def main(argv: list[str]) -> int:
    four = "--four-cards" in argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(f"unknown arguments: {unknown}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120, check=True)
    print(smi.stdout.strip(), flush=True)

    import jax

    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    print(f"jax: platform={platform} device_kind={kind} count={len(devs)}",
          flush=True)
    if platform != "gpu":
        print("no GPU found by JAX; nothing runs on another platform",
              file=sys.stderr)
        return 1
    if four and len(devs) != 4:
        print(f"--four-cards needs 4 devices, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from rescan_line_sted_tpu.utils.observability import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    phases = [phase_mesh] if four else [
        phase_point, phase_line, phase_rescan, phase_sweep, phase_fusion]
    for phase in phases:
        for line in phase():
            print(line, flush=True)
    if not four:
        run_gpu_tests(repo)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
