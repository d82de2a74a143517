"""Observability utilities tests (SURVEY.md section 6)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from rescan_line_sted_tpu.utils.observability import (
    Timer,
    debug_mode,
    emit_metrics,
    time_fn,
)


def test_timer():
    with Timer() as t:
        _ = sum(range(1000))
    assert t.elapsed > 0


def test_time_fn_separates_compile():
    import jax

    f = jax.jit(lambda x: jnp.sin(x) * 2)
    steady, first = time_fn(f, jnp.ones((64, 64)), iters=3)
    assert steady > 0 and first > 0
    assert first >= steady * 0.1  # first call includes tracing/compile


def test_emit_metrics_jsonl_and_csv(tmp_path):
    path = str(tmp_path / "m.jsonl")
    emit_metrics({"a": 1, "b": 2.5}, path)
    emit_metrics({"a": 3, "b": 4.5}, path)
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["a"] == 1 and lines[1]["b"] == 4.5

    csv_path = str(tmp_path / "m.csv")
    emit_metrics({"x": 1.0, "y": 2.0}, csv_path)
    emit_metrics({"x": 3.0, "y": 4.0}, csv_path)
    rows = open(csv_path).read().strip().splitlines()
    assert rows[0] == "x,y" and len(rows) == 3


def test_debug_mode_catches_nan():
    import jax
    import pytest

    with debug_mode():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0)).block_until_ready()
    # restored afterwards
    out = jax.jit(lambda x: jnp.log(x))(jnp.asarray(-1.0))
    assert np.isnan(np.asarray(out))


def test_trace_writes_profile(tmp_path):
    import jax
    from rescan_line_sted_tpu.utils.observability import trace

    d = str(tmp_path / "prof")
    with trace(d):
        jax.jit(lambda x: x * 2)(jnp.ones((128, 128))).block_until_ready()
    found = []
    for root, _, files in os.walk(d):
        found += files
    assert found  # perfetto/xplane artifacts exist


@pytest.fixture
def restore_cache_config():
    """Put the process-global compilation-cache settings back afterwards,
    so later tests do not write their executables to a pytest tmp dir."""
    import jax

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_enable_compilation_cache_paths(monkeypatch, tmp_path,
                                        restore_cache_config):
    import jax

    from rescan_line_sted_tpu.utils import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    p = enable_compilation_cache(str(tmp_path / "cache"))
    assert p == str(tmp_path / "cache")
    assert jax.config.jax_compilation_cache_dir == p
    # default lands inside the project tree
    assert enable_compilation_cache().endswith(".jax_cache")
    # explicit env var wins; empty string disables
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert enable_compilation_cache() == str(tmp_path / "env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert enable_compilation_cache() == ""


def test_emit_metrics_jsonl_is_rfc_compliant(tmp_path):
    """NaN metrics (the 'no measurable value' contract) must land as JSON
    null in metrics.jsonl, not as bare NaN that jq/JSON.parse reject."""
    path = str(tmp_path / "metrics.jsonl")
    emit_metrics({"fwhm": float("nan"), "ok": 1.5}, path)
    [line] = open(path).read().splitlines()

    def no_const(c):
        raise AssertionError(f"non-RFC constant in metrics.jsonl: {c}")

    rec = json.loads(line, parse_constant=no_const)
    assert rec["fwhm"] is None and rec["ok"] == 1.5
