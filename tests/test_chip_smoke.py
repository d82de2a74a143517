"""chip_smoke.py's phases at tiny sizes on the CPU, called directly.

The script itself never runs on the CPU: without a GPU it exits nonzero
and prints no result line (checked here too, as is bench.py's refusal).
The phase functions are the same code it runs on the card, so their
checks, references and control flow are exercised here at small shapes;
the mesh phase runs on the virtual 8-device CPU platform.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_lines(lines, phase, n):
    assert len(lines) == n
    for line in lines:
        assert line.startswith(f"phase={phase} ")
        assert "compile_s=" in line and "run_s=" in line
        assert "precision=HIGHEST" in line and "check: " in line


def test_phase_point_tiny():
    lines = cs.phase_point(size=64, spot_checks=8)
    _assert_lines(lines, "point", 4)
    assert "z=" in lines[-1] and "chi2/N=" in lines[-1]


def test_phase_line_tiny():
    # 256^2: the windowed per-step route engages; 64^2: the f64 oracle
    _assert_lines(cs.phase_line(size=256, oracle_size=64), "line", 6)


def test_phase_rescan_tiny():
    lines = cs.phase_rescan(size=256, oracle_size=64)
    _assert_lines(lines, "rescan", 6 + 3 * 3 + 1)
    assert sum("vs f64 oracle" in ln for ln in lines) == 6
    assert sum("vs analytic" in ln for ln in lines) == 4


def test_phase_sweep_tiny():
    lines = cs.phase_sweep(size=64, num_powers=4)
    _assert_lines(lines, "sweep", 2)
    assert "rescan arm" in lines[1]


def test_phase_fusion_tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _assert_lines(cs.phase_fusion(size=64, rl_iters=10), "fusion", 2)


def test_phase_mesh_on_virtual_devices():
    """The ``--four-cards`` path on the 8 virtual CPU devices."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device CPU platform")
    lines = cs.phase_mesh(size=256, sweep_size=32, num_powers=8)
    _assert_lines(lines, "mesh", 2 + 1 + 2 * 2)


def test_checks_fail_loudly():
    with pytest.raises(cs.CheckFailed, match="rel_err"):
        cs.check_close("x", np.ones(4) * 1.001, np.ones(4))
    mean = np.full((200, 200), 5.0)
    with pytest.raises(cs.CheckFailed, match="z="):
        cs.check_noise("biased", mean * 1.1, mean)
    with pytest.raises(cs.CheckFailed, match="chi2/N="):
        cs.check_noise("noise-free", mean, mean)
    with pytest.raises(cs.CheckFailed, match="photons"):
        cs.check_noise("dim", np.zeros(4), np.ones(4))
    counts = np.random.default_rng(0).poisson(mean).astype(np.float64)
    assert "z=" in cs.check_noise("poisson", counts, mean)


def test_noise_free_sampler_restores_the_draw():
    from rescan_line_sted_tpu.imaging import line_sted, point_sted, rescan

    before = [m.maybe_poisson for m in (line_sted, point_sted, rescan)]
    with cs.noise_free_sampler():
        assert rescan.maybe_poisson(jax.random.key(0), 3.0) == 3.0
    assert [m.maybe_poisson for m in (line_sted, point_sted, rescan)] \
        == before


def _run_without_gpu(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=os.path.dirname(sys.executable))  # no nvidia-smi
    return subprocess.run([sys.executable, os.path.join(REPO, script),
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_script_refuses_without_gpu(args):
    out = _run_without_gpu("chip_smoke.py", *args)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_bench_refuses_without_gpu():
    out = _run_without_gpu("bench.py")
    assert out.returncode != 0
    assert "GPU" in out.stderr
