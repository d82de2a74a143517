"""Test environment: run JAX on a virtual 8-device CPU mesh.

Tests exercise the full engine (including mesh/sharding code paths) on the
CPU. Tests marked ``gpu`` need a GPU: they skip elsewhere and run on the card
through ``python chip_smoke.py``, which sets ``RLS_TEST_GPU=1`` and calls
them in its own process (a second JAX process could not reserve the card).
Environment must be set before the first `import jax` anywhere.
"""

import os
import sys

import pytest

ON_GPU = os.environ.get("RLS_TEST_GPU") == "1"

if not ON_GPU:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_GPU:
    # the config (not only the env var) pins the backend: an installed
    # accelerator plugin must not claim the suite
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's backend is a GPU (decided per
    test, at run time -- never while a module is imported)."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; runs on the card through chip_smoke.py")
