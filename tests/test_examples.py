"""Smoke-run every ``examples/*.py`` script.

The examples are the first thing a user runs; without coverage they rot
silently against API changes. Each runs as a SUBPROCESS exactly as a user
would invoke it (``python examples/<name>.py``), pinned to the CPU backend
(the suite must not contend for a GPU another process owns), with a
wall-clock bound ~20x their CPU runtimes (8-26 s each).
"""

import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.py")))


def test_every_example_is_covered():
    """The parametrized list below is generated from the directory, so a
    new example is covered the moment it lands."""
    assert EXAMPLES, "examples/ directory is empty?"


@pytest.mark.parametrize(
    "path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_runs(path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO
    env.pop("RLS_TEST_GPU", None)
    proc = subprocess.run(
        [sys.executable, path], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, (
        f"{os.path.basename(path)} failed:\n"
        f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    assert proc.stdout.strip(), "examples narrate what they compute"
