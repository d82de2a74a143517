"""Tracing, profiling, metrics, and debug utilities (SURVEY.md section 6).

The reference's observability is prints and figures; the rebuild provides:

* ``trace(...)`` -- ``jax.profiler`` Perfetto trace context for device
  timeline inspection;
* ``Timer`` / ``time_fn`` -- wall-clock timing with ``block_until_ready``
  fencing and compile-time separated from steady state;
* ``emit_metrics`` -- structured JSON/CSV metric emission for BASELINE
  tracking;
* ``debug_mode`` -- enables NaN checking (``jax_debug_nans``); on-device race
  detection is N/A by construction (XLA programs are data-race-free), which
  answers the reference's (absent) sanitizer story.
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import os
import time

import jax

logger = logging.getLogger("rescan_line_sted_tpu")


def enable_compilation_cache(path: str | None = None,
                             min_compile_secs: float = 5.0) -> str:
    """Enable JAX's persistent compilation cache and return its path.

    The big scan programs take seconds to compile; the on-disk cache lets
    every later process reuse them. Honors ``JAX_COMPILATION_CACHE_DIR`` if
    set (empty string disables) and sets no other directory then; the
    default location is ``.jax_cache`` next to the package (kept inside the
    project tree, gitignored). Programs that compile faster than
    ``min_compile_secs`` are not cached.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env is not None:
        if env:
            jax.config.update("jax_compilation_cache_dir", env)
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              min_compile_secs)
        return env
    if path is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_mode():
    """NaN-checking debug configuration."""
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


class Timer:
    """Wall-clock timer that fences device work."""

    def __init__(self):
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def time_fn(fn, *args, warmup: int = 1, iters: int = 5):
    """Measure steady-state wall time of ``fn(*args)``.

    Returns ``(seconds_per_call, first_call_seconds)``; the first call
    includes compilation and is reported separately.
    """
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    first = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, first


def json_safe(obj):
    """Map non-finite floats to None, recursively: the metrics contract
    uses NaN for 'no measurable value' (e.g. fwhm_2d on a filled STED
    null), but bare NaN in json.dumps output is not RFC-compliant JSON --
    strict parsers (jq, JSON.parse) reject the whole document."""
    import math

    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, (str, bool, int)) or obj is None:
        return obj
    try:
        f = float(obj)  # Python/numpy/jax float scalars
    except (TypeError, ValueError):
        return obj
    return f if math.isfinite(f) else None


def emit_metrics(metrics: dict, path: str | None = None) -> str:
    """Log a metrics dict and optionally append it to a JSON-lines or CSV
    file. Non-finite floats are sanitized in BOTH formats (see
    ``json_safe``): JSON null in .jsonl, an empty cell in .csv -- so the
    two outputs of the same metrics never diverge."""
    safe = json_safe(metrics)
    line = json.dumps(safe, sort_keys=True, default=float)
    logger.info("metrics %s", line)
    if path:
        if path.endswith(".csv"):
            exists = os.path.exists(path)
            with open(path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=sorted(metrics))
                if not exists:
                    writer.writeheader()
                writer.writerow({k: ("" if v is None else v)
                                 for k, v in safe.items()})
        else:
            with open(path, "a") as f:
                f.write(line + "\n")
    return line
