"""Mesh-sharded execution tests on the virtual 8-device CPU mesh
(SURVEY.md section 5.2.5: single-chip-safe distributed paths)."""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rescan_line_sted_tpu.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
)
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.parallel import (
    make_mesh,
    replicate,
    shard_batch,
)
from rescan_line_sted_tpu.sweeps import dose_matched_sweep


@pytest.fixture(autouse=True)
def _eight_devices():
    """These tests shard over the virtual 8-device CPU platform
    (tests/conftest.py); decided per test, at run time."""
    if len(jax.devices()) < 8:
        pytest.skip("mesh tests need >= 8 (virtual) devices")


SHAPE = (48, 48)
SAMPLE = samples.siemens_star(SHAPE, spokes=8)
PGEOM = PointSTEDGeometry(Grid(*SHAPE), chunk=48)
LGEOM = LineSTEDGeometry(Grid(*SHAPE), chunk=16)
PBASE = PointSTEDParams.create(brightness=1.0)
LBASE = LineSTEDParams.create(brightness=1.0)


def test_make_mesh_uses_all_devices():
    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())


def test_make_mesh_validates_sizes():
    with pytest.raises(ValueError):
        make_mesh({"batch": 3})  # 8 devices, not divisible


def test_sharded_sweep_matches_unsharded():
    powers = jnp.linspace(0.0, 8.0, 8)

    def sweep(sample, p):
        return dose_matched_sweep(sample, PBASE, LBASE, PGEOM, LGEOM, p, 100.0)

    want = jax.jit(sweep)(SAMPLE, powers)

    mesh = make_mesh({"batch": 8})
    powers_sharded = shard_batch(mesh, powers)
    sample_repl = replicate(mesh, SAMPLE)
    got = jax.jit(sweep)(sample_repl, powers_sharded)
    np.testing.assert_allclose(np.asarray(got.point.image),
                               np.asarray(want.point.image),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.line.fwhm_x),
                               np.asarray(want.line.fwhm_x), rtol=1e-5)
    # result really is distributed over the batch axis
    shd = got.point.image.sharding
    assert shd.is_fully_replicated is False


def test_spatially_sharded_fft_engine():
    """Shard image rows over a 'space' axis: XLA inserts the FFT collectives."""
    from rescan_line_sted_tpu.imaging import line_sted_image
    mesh = make_mesh({"batch": 2, "space": 4})
    from jax.sharding import NamedSharding, PartitionSpec as P
    sample = jax.device_put(SAMPLE, NamedSharding(mesh, P("space", None)))
    params = replicate(mesh, LBASE)
    got = jax.jit(lambda s, p: line_sted_image(s, p, LGEOM).image)(
        sample, params)
    want = line_sted_image(SAMPLE, LBASE, LGEOM).image
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=1e-5)


def test_sweep_spec_check_without_execution():
    """SURVEY 5.2.5: validate shapes/dtypes of the whole sweep by tracing
    only (jax.eval_shape) -- multi-chip program structure is checkable
    without devices."""
    powers = jax.ShapeDtypeStruct((16,), jnp.float32)
    sample = jax.ShapeDtypeStruct(SHAPE, jnp.float32)
    out = jax.eval_shape(
        lambda s, p: dose_matched_sweep(s, PBASE, LBASE, PGEOM, LGEOM,
                                        p, 100.0),
        sample, powers)
    assert out.point.image.shape == (16, *SHAPE)
    assert out.line.fwhm_x.shape == (16,)
    assert out.point.image.dtype == jnp.float32


def test_large_fov_spatially_sharded_acquisition():
    """1024^2 acquisition with rows sharded over the 'space' mesh axis
    (SURVEY section 6 long-context-equivalent row; VERDICT r1 item 8).

    Analytic engine: the 1024^2 FFT convolutions run under GSPMD with the
    sample's rows distributed, forcing cross-device collectives.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.config import Grid, LineSTEDGeometry
    from rescan_line_sted_tpu.data import samples
    from rescan_line_sted_tpu.imaging import line_sted_image

    big = 1024
    mesh = make_mesh({"space": 8})
    geom = LineSTEDGeometry(Grid(big, big), chunk=64)
    sample = jax.device_put(
        samples.siemens_star((big, big)), NamedSharding(mesh, P("space")))
    params = replicate(mesh, LBASE)
    img = jax.jit(lambda s, p: line_sted_image(s, p, geom).image)(
        sample, params)
    jax.block_until_ready(img)
    assert img.shape == (big, big)
    assert np.isfinite(np.asarray(img[::64, ::64])).all()


def test_orientation_sharded_fusion():
    """Shard the orientation (view) axis over 'batch' and RL-fuse: GSPMD
    inserts the cross-device collectives the fusion's view-sum needs."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.algorithms import richardson_lucy_views
    from rescan_line_sted_tpu.imaging.orientations import (
        multi_orientation_line_sted,
    )

    mesh = make_mesh({"batch": 8})
    angles = jnp.arange(8) * (jnp.pi / 8)
    views, kernels = multi_orientation_line_sted(
        SAMPLE, LBASE.replace(depletion=jnp.float32(8.0)), LGEOM, angles)
    sharding = NamedSharding(mesh, P("batch", None, None))
    views_s = jax.device_put(views, sharding)
    kernels_s = jax.device_put(kernels, sharding)
    fused_s = jax.jit(lambda v, k: richardson_lucy_views(v, k, num_iter=10))(
        views_s, kernels_s)
    fused = richardson_lucy_views(views, kernels, num_iter=10)
    np.testing.assert_allclose(np.asarray(fused_s), np.asarray(fused),
                               rtol=2e-4, atol=1e-5)


def test_spatially_sharded_rescan_scan_path():
    """Flagship modality under spatial sharding (VERDICT r2 item 2): the
    rescan engine's canvas-grid SCAN path with the sample's rows sharded
    over 'space'; parity against the replicated result, and the per-step
    noisy path executes sharded too."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.config import RescanGeometry
    from rescan_line_sted_tpu.imaging import rescanned_line_sted_image

    mesh = make_mesh({"batch": 2, "space": 4})
    geom = RescanGeometry(Grid(*SHAPE), rescan_factor=2.0, chunk=16)
    params = replicate(mesh, LBASE.replace(depletion=jnp.float32(4.0)))
    sample = jax.device_put(SAMPLE, NamedSharding(mesh, P("space", None)))
    got = jax.jit(lambda s, p: rescanned_line_sted_image(
        s, p, geom, method="scan").image)(sample, params)
    want = rescanned_line_sted_image(
        SAMPLE, LBASE.replace(depletion=jnp.float32(4.0)), geom,
        method="scan").image
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=1e-5)
    # camera-faithful per-step noise under the sharded sample: assert
    # DISTRIBUTIONAL parity (VERDICT r3 item 5), not just shapes -- the
    # sharded noisy canvas's total photons must sit within shot noise of
    # the replicated noise-free expectation, and the per-pixel residual
    # power must match the Poisson variance (Var = mean, accumulation is
    # a linear scatter of independent draws).
    bright = LBASE.replace(depletion=jnp.float32(4.0),
                           brightness=jnp.float32(200.0))
    bright_r = replicate(mesh, bright)
    expected = np.asarray(rescanned_line_sted_image(
        SAMPLE, bright, geom, method="scan").image, np.float64)
    noisy = np.asarray(jax.jit(lambda s, p, k: rescanned_line_sted_image(
        s, p, geom, key=k, method="scan", noise_mode="per_step").image)(
        sample, bright_r, jax.random.key(0)), np.float64)
    assert noisy.shape == geom.canvas_shape
    etotal = expected.sum()
    assert etotal > 1e4  # enough photons for the bounds below to be tight
    z = abs(noisy.sum() - etotal) / np.sqrt(etotal)
    assert z < 6.0, f"sharded noisy total off by {z:.1f} sigma"
    chi2_ratio = ((noisy - expected) ** 2).sum() / etotal
    assert 0.75 < chi2_ratio < 1.3, chi2_ratio


def test_spatially_sharded_rescan_strips_path():
    """The rational-step STRIP placement (the collapsed default wherever
    band windows exist at rational R, incl. the snapped practical
    recommendation) compiles and matches under GSPMD with the sample's
    rows sharded over 'space', against the full-frame route."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.config import RescanGeometry
    from rescan_line_sted_tpu.imaging import rescanned_line_sted_image

    from rescan_line_sted_tpu.imaging import rescan

    mesh = make_mesh({"batch": 2, "space": 4})
    w = 192  # band windows engage
    big = samples.siemens_star((w, w), spokes=10)
    geom = RescanGeometry(Grid(w, w), rescan_factor=2.5, chunk=16)
    lp = LineSTEDParams.create(sigma_exc=1.2, sigma_det=1.2, depletion=4.0,
                               brightness=1.0)
    params = replicate(mesh, lp)
    want = rescan._scan(big, lp, geom, None, windowed=False)
    sample = jax.device_put(big, NamedSharding(mesh, P("space", None)))
    got = jax.jit(lambda s, p: rescanned_line_sted_image(
        s, p, geom, method="scan").image)(sample, params)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=1e-5)


def test_spatially_sharded_rescan_fusion():
    """Operator-form rescan fusion with the canvases' rows sharded over
    'space' (VERDICT r2 item 2): the exact-adjoint RL loop runs under GSPMD
    and matches the unsharded fusion."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.algorithms.fusion import (
        multi_orientation_rescan,
        rescan_fusion,
    )
    from rescan_line_sted_tpu.config import RescanGeometry, RescanParams

    mesh = make_mesh({"batch": 2, "space": 4})
    geom = RescanGeometry(Grid(*SHAPE), rescan_factor=2.0, chunk=16)
    params = RescanParams.create(depletion=4.0, brightness=100.0)
    angles = (0.0, float(np.pi / 2))
    canv = multi_orientation_rescan(SAMPLE, params, geom, list(angles))
    canv_s = jax.device_put(
        canv, NamedSharding(mesh, P(None, "space", None)))
    got = jax.jit(lambda c: rescan_fusion(
        c, params, geom, angles, num_iter=10))(canv_s)
    want = rescan_fusion(canv, params, geom, angles, num_iter=10)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=1e-5)


def test_multihost_initialize_single_process():
    """initialize_multihost: no-op without a cluster environment; real
    jax.distributed init with explicit single-process wiring; idempotent.
    Runs in a subprocess because distributed state is process-global."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        from rescan_line_sted_tpu.parallel import (
            initialize_multihost, is_initialized, local_device_slice,
            make_mesh)

        assert not is_initialized()
        assert initialize_multihost() == (0, 1)      # no cluster env: no-op
        assert not is_initialized()
        # ephemeral port: a hard-coded one collides under parallel runs
        import socket
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        got = initialize_multihost(f"localhost:{port}", num_processes=1,
                                   process_id=0)
        assert got == (0, 1) and is_initialized()
        assert initialize_multihost() == (0, 1)      # idempotent
        mesh = make_mesh()
        assert local_device_slice(mesh, "batch") == (0, mesh.devices.shape[0])
        print("MULTIHOST_OK")
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # subprocess forces cpu via jax.config
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "MULTIHOST_OK" in out.stdout, (out.stdout, out.stderr)


def test_multihost_two_process_rendezvous(tmp_path):
    """A REAL 2-process jax.distributed rendezvous (r3 VERDICT item 6):
    two local processes join via gloo on the CPU backend, build a global
    4-device mesh, run one sharded dose-sweep chunk, and each asserts the
    global device count; the parent asserts cross-rank and vs-unsharded
    result parity. This is the one code path that only matters
    multi-process, so it is exercised multi-process."""
    import socket
    import subprocess
    import sys
    import textwrap

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    worker = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import jax
        jax.config.update("jax_platforms", "cpu")
        import numpy as np
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from rescan_line_sted_tpu.parallel import (initialize_multihost,
                                                   make_mesh)

        rank, coord = int(sys.argv[1]), sys.argv[2]
        idx, cnt = initialize_multihost(coord, num_processes=2,
                                        process_id=rank)
        assert (idx, cnt) == (rank, 2), (idx, cnt)
        assert len(jax.devices()) == 4, jax.devices()   # global world
        assert len(jax.local_devices()) == 2

        from rescan_line_sted_tpu.config import (Grid, LineSTEDGeometry,
                                                 LineSTEDParams,
                                                 PointSTEDGeometry,
                                                 PointSTEDParams)
        from rescan_line_sted_tpu.data import samples
        from rescan_line_sted_tpu.sweeps import dose_matched_sweep

        mesh = make_mesh({"batch": 4})

        def gput(x, spec):
            x = np.asarray(x)
            sh = NamedSharding(mesh, spec)
            return jax.make_array_from_callback(x.shape, sh,
                                                lambda i: x[i])

        size = 32
        grid = Grid(size, size)
        sample = gput(samples.siemens_star((size, size)), P())
        pbase = jax.tree.map(lambda v: gput(v, P()),
                             PointSTEDParams.create(brightness=1.0))
        lbase = jax.tree.map(lambda v: gput(v, P()),
                             LineSTEDParams.create(brightness=1.0))
        powers = gput(np.linspace(0.0, 8.0, 4, dtype=np.float32),
                      P("batch"))
        out = jax.jit(lambda s, pp, lp, pw: dose_matched_sweep(
            s, pp, lp, PointSTEDGeometry(grid, chunk=32),
            LineSTEDGeometry(grid, chunk=16), pw, 100.0))(
            sample, pbase, lbase, powers)
        # collective read-back: sum over the cross-process batch axis
        tot = float(jnp.sum(out.point.fwhm_x) + jnp.sum(out.line.fwhm_x))
        print(f"RANK{rank}_OK {tot:.6f}", flush=True)
    """)
    script = tmp_path / "mh_worker.py"
    script.write_text(worker)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), f"localhost:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (rc, out, err) in enumerate(outs):
        if rc != 0 and ("gloo" in err.lower()
                        and "unavailable" in err.lower()):
            pytest.skip(f"CPU gloo collectives unavailable: {err[-300:]}")
        assert rc == 0, f"rank {r} failed:\n{out}\n{err[-2000:]}"
        assert f"RANK{r}_OK" in out, (out, err[-500:])
    vals = [float(o.split("_OK ")[1].split()[0]) for _, o, _ in outs]
    assert vals[0] == vals[1]  # both ranks saw the same global result

    # parity vs the unsharded single-process sweep (this process)
    out1 = dose_matched_sweep(
        samples.siemens_star((32, 32)), PointSTEDParams.create(
            brightness=1.0), LineSTEDParams.create(brightness=1.0),
        PointSTEDGeometry(Grid(32, 32), chunk=32),
        LineSTEDGeometry(Grid(32, 32), chunk=16),
        jnp.linspace(0.0, 8.0, 4), 100.0)
    want = float(jnp.sum(out1.point.fwhm_x) + jnp.sum(out1.line.fwhm_x))
    np.testing.assert_allclose(vals[0], want, rtol=2e-4)


def test_local_device_slice_ownership_semantics():
    """local_device_slice reads ownership off the device array itself:
    contiguous leading-axis blocks slice per process, an axis every process
    touches returns the full range, non-contiguous ownership raises."""
    import types

    from rescan_line_sted_tpu.parallel.multihost import local_device_slice

    def dev(p):
        return types.SimpleNamespace(process_index=p)

    # 2 hosts x 4 chips, mesh (batch=4, space=2), process-major layout:
    # host 0 owns rows 0-1 of 'batch' but BOTH columns of 'space'.
    devices = np.array([[dev(0), dev(0)], [dev(0), dev(0)],
                        [dev(1), dev(1)], [dev(1), dev(1)]])
    mesh = types.SimpleNamespace(axis_names=("batch", "space"),
                                 devices=devices)
    assert local_device_slice(mesh, "batch") == (0, 2)   # this proc is 0
    assert local_device_slice(mesh, "space") == (0, 2)   # full range

    # non-contiguous ownership along 'batch' -> explicit error, not a
    # silently wrong slice
    devices_nc = np.array([[dev(0)], [dev(1)], [dev(0)], [dev(1)]])
    mesh_nc = types.SimpleNamespace(axis_names=("batch",), devices=devices_nc)
    with pytest.raises(ValueError, match="not contiguous"):
        local_device_slice(mesh_nc, "batch")

    # a process owning nothing on the axis -> explicit error
    devices_other = np.array([[dev(1)], [dev(1)]])
    mesh_o = types.SimpleNamespace(axis_names=("batch",),
                                   devices=devices_other)
    with pytest.raises(ValueError, match="owns no devices"):
        local_device_slice(mesh_o, "batch")


SHARD_W = 192  # smallest grid where the 128-column band windows engage
SHARD_SAMPLE = samples.siemens_star((SHARD_W, SHARD_W), spokes=10) * 3.0
SHARD_PARAMS = LineSTEDParams.create(sigma_exc=1.2, sigma_det=1.2,
                                     depletion=4.0, brightness=50.0)


@pytest.mark.parametrize("noise", ["noise_free", "per_step"])
@pytest.mark.parametrize("r_factor,b", [(2.0, 1), (1.5, 1), (2.5, 2),
                                        (1.0 + np.pi / 16, 1),
                                        (1.0 + np.pi / 8, 2)])
def test_sharded_rescan_matches_replicated(r_factor, b, noise):
    """Rows sharded over 'space' (GSPMD) vs the replicated call, on the
    windowed route: integer, rational and irrational steps, with and
    without binning. Noise-free: equal to f32 rounding; per-step: photon
    total and residual power consistent with the replicated mean."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from chip_smoke import check_noise
    from rescan_line_sted_tpu.config import RescanGeometry
    from rescan_line_sted_tpu.imaging import rescanned_line_sted_image

    mesh = make_mesh({"batch": 2, "space": 4})
    geom = RescanGeometry(Grid(SHARD_W, SHARD_W), rescan_factor=r_factor,
                          binning=b, chunk=16)
    want = np.asarray(rescanned_line_sted_image(
        SHARD_SAMPLE, SHARD_PARAMS, geom, method="scan").image)
    sharded = jax.device_put(SHARD_SAMPLE,
                             NamedSharding(mesh, P("space", None)))
    if noise == "noise_free":
        got = jax.jit(lambda s, p: rescanned_line_sted_image(
            s, p, geom, method="scan").image)(
            sharded, replicate(mesh, SHARD_PARAMS))
        assert got.shape == geom.canvas_shape
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                                   atol=2e-5 * scale)
        return
    noisy = jax.jit(lambda s, p, k: rescanned_line_sted_image(
        s, p, geom, key=k, method="scan", noise_mode="per_step").image)(
        sharded, replicate(mesh, SHARD_PARAMS), jax.random.key(3))
    assert noisy.shape == geom.canvas_shape
    check_noise("sharded per-step", noisy, want)


def test_row_sharded_call_validates_arguments_like_unsharded():
    """Same arguments, same validation, sharded or not: an unknown
    reassignment raises ValueError for both."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rescan_line_sted_tpu.config import RescanGeometry
    from rescan_line_sted_tpu.imaging import rescanned_line_sted_image

    mesh = make_mesh({"batch": 2, "space": 4})
    geom = RescanGeometry(Grid(SHARD_W, SHARD_W), rescan_factor=1.5,
                          chunk=16)
    sharded = jax.device_put(SHARD_SAMPLE,
                             NamedSharding(mesh, P("space", None)))
    for arr in (SHARD_SAMPLE, sharded):
        with pytest.raises(ValueError, match="unknown reassignment"):
            rescanned_line_sted_image(arr, SHARD_PARAMS, geom,
                                      method="scan",
                                      reassignment="nearest")


def test_sharded_sweep_with_rescan_arm_matches_unsharded():
    """The config-4 sweep with the rescan arm (windowed route at 192^2),
    sweep points sharded over 'batch': every arm matches the unsharded
    sweep, noise-free."""
    from rescan_line_sted_tpu.config import RescanGeometry

    grid = Grid(SHARD_W, SHARD_W)
    pgeom, lgeom = PointSTEDGeometry(grid), LineSTEDGeometry(grid)
    rgeom = RescanGeometry(grid, rescan_factor=2.0, chunk=16)
    pbase = PointSTEDParams.create(sigma_exc=1.2, sigma_det=1.2,
                                   sigma_dep=1.2, brightness=1.0)
    powers = jnp.linspace(0.0, 8.0, 8)

    def sweep(s, p):
        return dose_matched_sweep(s, pbase, SHARD_PARAMS, pgeom, lgeom, p,
                                  100.0, rescan_geom=rgeom)

    want = jax.jit(sweep)(SHARD_SAMPLE, powers)
    mesh = make_mesh({"batch": 8})
    got = jax.jit(sweep)(replicate(mesh, SHARD_SAMPLE),
                         shard_batch(mesh, powers))
    for arm in ("point", "line", "rescan"):
        w = np.asarray(getattr(want, arm).image)
        np.testing.assert_allclose(np.asarray(getattr(got, arm).image), w,
                                   rtol=2e-5, atol=2e-5 * np.abs(w).max())
    assert got.rescan.image.sharding.is_fully_replicated is False
