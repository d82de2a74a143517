"""Windowed and full-frame rescan pipelines (imaging/rescan.py).

The windowed pipeline (band-limited conv, window sampling, DFT or strip
placement) is the default wherever its static band windows exist; the
full-frame pipeline (whole camera frames, scatter or phase accumulation)
takes traced sigmas, custom excitation models and narrow grids. Both are
checked against the independent float64 dense oracle (tests/oracle: one full
camera frame per scan position, scatter or Fourier placement) and against
each other, noise-free and with per-step noise, and the route choice is
checked from the preconditions the code can observe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import check_noise, noise_free_sampler, rel_err
from rescan_line_sted_tpu.config import Grid, LineSTEDParams, RescanGeometry
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import rescan, rescanned_line_sted_image
from tests.oracle import oracle

W = 192  # smallest grid where the 128-column band windows engage
CHUNK = 16
SAMPLE = samples.siemens_star((W, W), spokes=10) * 3.0
SAMPLE_NP = np.asarray(SAMPLE, np.float64)
KW = dict(sigma_exc=1.2, sigma_det=1.2, stripe_period=8.0, depletion=4.0,
          brightness=50.0)
PARAMS = LineSTEDParams.create(**KW)


def _geom(r, b=1, w=W):
    return RescanGeometry(Grid(w, w), rescan_factor=r, binning=b,
                          chunk=CHUNK)


def _mode(r, b):
    step = (r - 1.0) / b
    return "rounded" if abs(step - round(step)) < 1e-9 else "subpixel"


def _oracle(r, b):
    return oracle.rescanned_line_sted_image(
        SAMPLE_NP, rescan_factor=r, binning=b, reassignment=_mode(r, b),
        **KW)


def _per_step_mean(geom, windowed=None):
    """Noise-free canvas of the per-step pipeline (sampler = identity)."""
    with noise_free_sampler():
        return np.asarray(rescan._scan(SAMPLE, PARAMS, geom,
                                       jax.random.key(0), "per_step",
                                       windowed=windowed))


@pytest.fixture
def loop_spy(monkeypatch):
    """Record the static route arguments of every ``_scan_loop`` call."""
    calls = []
    orig = rescan._scan_loop

    def spy(*a, **kw):
        calls.append({k: kw.get(k) for k in ("band", "strips",
                                             "phase_accum")})
        return orig(*a, **kw)

    monkeypatch.setattr(rescan, "_scan_loop", spy)
    return calls


@pytest.mark.parametrize("q,binning,rf", [(1, 1, 2.0), (1, 2, 3.0),
                                          (2, 1, 1.5), (4, 1, 2.25)])
def test_windowed_matches_dense_oracle(q, binning, rf, loop_spy):
    """Integer and rational placements (q fractional-offset classes): the
    collapsed (strips) and per-step (DFT placement) windowed pipelines
    match the float64 oracle."""
    geom = _geom(rf, binning)
    want = _oracle(rf, binning)
    got = rescanned_line_sted_image(SAMPLE, PARAMS, geom,
                                    method="scan").image
    assert rel_err(got, want) < 1e-5
    assert rel_err(_per_step_mean(geom), want) < 1e-5
    assert loop_spy[0]["band"] is not None
    assert loop_spy[0]["strips"] == ((round((rf - 1) / binning * q), q))


@pytest.mark.parametrize("r_factor,binning", [
    (1.0 + np.pi / 16, 1),          # transcendental step
    (1.6180339887, 1),              # golden ratio
    (1.0 + np.pi / 8, 2),           # irrational step with binning
    (1.0 + 3.0 / 16.0, 1),          # rational but q = 16 > 8: no classes
])
def test_windowed_irrational_matches_dense_oracle(r_factor, binning,
                                                  loop_spy):
    """Steps with no class structure place by the DFT matmul, collapsed
    and per-step alike, subpixel-exact against the oracle."""
    geom = _geom(r_factor, binning)
    want = _oracle(r_factor, binning)
    got = rescanned_line_sted_image(SAMPLE, PARAMS, geom,
                                    method="scan").image
    assert rel_err(got, want) < 1e-5
    assert rel_err(_per_step_mean(geom), want) < 1e-5
    assert loop_spy[0]["band"] is not None
    assert loop_spy[0]["strips"] is None


@pytest.mark.parametrize("rf,binning", [(2.0, 1), (3.0, 1), (2.0, 2),
                                        (1.5, 1), (2.25, 1)])
def test_windowed_matches_full_frame(rf, binning):
    """The two pipelines compute the same canvas, collapsed and per-step
    (noise-free), at integer and rational steps, with binning."""
    geom = _geom(rf, binning)
    full = np.asarray(rescan._scan(SAMPLE, PARAMS, geom, None,
                                   windowed=False))
    win = np.asarray(rescan._scan(SAMPLE, PARAMS, geom, None,
                                  windowed=True))
    assert win.shape == full.shape == geom.canvas_shape
    assert rel_err(win, full) < 2e-6
    assert rel_err(_per_step_mean(geom, True),
                   _per_step_mean(geom, False)) < 2e-6


def test_strips_opt_out_matches_dft_placement(monkeypatch, loop_spy):
    """``RLS_RESCAN_STRIPS=0`` keeps the collapsed windowed route on the
    DFT placement -- the same canvas."""
    geom = _geom(2.5)
    strips = np.asarray(rescanned_line_sted_image(
        SAMPLE, PARAMS, geom, method="scan").image)
    monkeypatch.setenv("RLS_RESCAN_STRIPS", "0")
    dft = np.asarray(rescanned_line_sted_image(
        SAMPLE, PARAMS, geom, method="scan").image)
    assert [c["strips"] for c in loop_spy] == [(3, 2), None]
    assert rel_err(dft, strips) < 2e-6


def test_route_defaults_to_windowed_when_windows_exist(loop_spy):
    rescanned_line_sted_image(SAMPLE, PARAMS, _geom(2.0), method="scan",
                              key=jax.random.key(0), noise_mode="per_step")
    assert loop_spy[0]["band"] == rescan._illum_band(PARAMS, W, CHUNK, 1)
    # per-step noise always places by the DFT (never strips)
    assert loop_spy[0]["strips"] is None and loop_spy[0]["phase_accum"]


def test_route_full_frame_on_narrow_grid(loop_spy):
    """Band windows as wide as the frame do not pay: full-frame route,
    scatter for rounded placement, phase accumulation for subpixel."""
    small = samples.siemens_star((64, 64))
    for r, accum in ((2.0, False), (2.5, True)):
        rescanned_line_sted_image(small, PARAMS, _geom(r, w=64),
                                  method="scan")
        assert loop_spy[-1]["band"] is None
        assert loop_spy[-1]["phase_accum"] is accum


def test_route_full_frame_for_custom_excitation(loop_spy):
    """A model whose excitation support is unknown has no static windows;
    the full-frame route still matches the oracle-validated default
    route's physics for the same model (here: a Gaussian by another
    name, so both agree)."""
    from rescan_line_sted_tpu.physics import psf as psfs

    class PlainModel:  # no gaussian_excitation flag -> unknown support
        def excitation(self, width, params):
            return psfs.line_excitation_profile(width, params.sigma_exc)

        def depletion(self, width, params):
            return psfs.stripe_depletion_profile(width,
                                                 params.stripe_period)

    custom = LineSTEDParams.create(**KW, model=PlainModel())
    assert rescan._illum_band(custom, W, CHUNK) is None
    got = rescanned_line_sted_image(SAMPLE, custom, _geom(2.0),
                                    method="scan").image
    assert loop_spy[-1]["band"] is None
    assert rel_err(got, _oracle(2.0, 1)) < 1e-5


def test_route_windowed_request_refused_without_windows():
    with pytest.raises(ValueError, match="static band windows"):
        rescan._scan(samples.siemens_star((64, 64)), PARAMS,
                     _geom(2.0, w=64), None, windowed=True)


def test_route_strips_only_for_collapsed_rational(loop_spy):
    """Strips need a rational step (q <= 8, q | chunk) and collapsed
    noise; rounded reassignment of a fractional step keeps the DFT."""
    geom = _geom(2.5)
    rescan._scan(SAMPLE, PARAMS, geom, None)                      # strips
    rescan._scan(SAMPLE, PARAMS, geom, None, reassignment="rounded")
    rescan._scan(SAMPLE, PARAMS, _geom(1.0 + np.pi / 16), None)   # no q
    assert [c["strips"] for c in loop_spy] == [(3, 2), None, None]


def test_route_full_frame_for_traced_sigma(loop_spy):
    """Params built by hand with a traced sigma carry no static support:
    no windows exist inside the trace, so the full-frame route runs."""
    hand = LineSTEDParams(*[jnp.float32(v) for v in (
        1.2, 1.2, 8.0, 4.0, 4.0, 50.0)])
    f = jax.jit(lambda s, se: rescan._scan(
        s, hand.replace(sigma_exc=se), _geom(2.0), None))
    got = f(SAMPLE, jnp.float32(1.2))
    assert loop_spy[-1]["band"] is None
    assert rel_err(got, _oracle(2.0, 1)) < 1e-5


def test_windowed_collapsed_noise_draws_once():
    """Collapsed noise on the windowed route: one Poisson draw on the
    accumulated canvas -- integer counts (rounded placement), total within
    shot noise, deterministic in the key."""
    geom = _geom(2.0)
    clean = rescanned_line_sted_image(SAMPLE, PARAMS, geom,
                                      method="scan").image
    k = jax.random.key(11)
    noisy = rescanned_line_sted_image(SAMPLE, PARAMS, geom, method="scan",
                                      key=k).image
    again = rescanned_line_sted_image(SAMPLE, PARAMS, geom, method="scan",
                                      key=k).image
    np.testing.assert_array_equal(np.asarray(noisy), np.asarray(again))
    assert (np.asarray(noisy) == np.round(np.asarray(noisy))).all()
    check_noise("collapsed", noisy, clean)


@pytest.mark.parametrize("rf,binning", [(2.0, 1), (1.0 + np.pi / 8, 2)])
def test_windowed_per_step_noise_statistics(rf, binning):
    """Per-step draws on the sampled windows: photon total within 6 sigma
    and residual power Poisson-like against the per-step mean."""
    geom = _geom(rf, binning)
    noisy = rescanned_line_sted_image(
        SAMPLE, PARAMS, geom, method="scan", key=jax.random.key(3),
        noise_mode="per_step").image
    check_noise("per-step", noisy, _per_step_mean(geom))


def test_narrow_canvas_windowed_matches_oracle():
    """R close to 1 (q = 10 > 8: no strips) places by the DFT on a canvas
    barely wider than the frame."""
    geom = _geom(1.1)
    got = rescanned_line_sted_image(SAMPLE, PARAMS, geom,
                                    method="scan").image
    assert got.shape == geom.canvas_shape
    assert rel_err(got, _oracle(1.1, 1)) < 1e-5


def test_full_frame_scatter_matches_numpy_loop():
    """Drive ``_scan_loop``'s full-frame scatter route directly against a
    numpy reimplementation (camera frame per position, scatter at the
    rounded offset)."""
    rng = np.random.default_rng(0)
    h, w, wc, r = 16, 32, 64, 2.0
    sample_y = rng.uniform(size=(h, w)).astype(np.float32)
    eff = rng.uniform(size=(w,)).astype(np.float32)
    gx = rng.uniform(size=(w,)).astype(np.float32)
    got = np.asarray(rescan._scan_loop(
        jnp.asarray(sample_y), jnp.asarray(eff), jnp.asarray(gx), None,
        None, wc=wc, chunk=16, b=1, rescan_factor=r, phase_accum=False))
    gx_mat = np.stack([np.roll(gx, a - w // 2) for a in range(w)])
    want = np.zeros((h, wc))
    for i in range(w):
        cam = (sample_y * np.roll(eff, i - w // 2)[None, :]) @ gx_mat
        want[:, (round((r - 1.0) * i) + np.arange(w)) % wc] += cam
    assert rel_err(got, want) < 1e-6
