"""Time the scan routes on the GPU and split traced calls by stage.

    python scripts/time_routes.py [--out DIR] [--quick] [--default-routes]
                                  [--no-precision] [--no-command-buffers]

For every per-step and collapsed cell of the five BASELINE configurations
(point 512^2, line and rescan 512^2 and 2048^2 at R = 2 / b = 1,
R = 2.5 / b = 2 and the theory-optimal irrational R) this times each route
the engine can take -- the windowed pipeline and the full-frame pipeline,
and for the collapsed rescan cell its placements -- as the wall time of one
call fenced with ``block_until_ready`` (minimum and median of the repeats,
after a warm-up call that compiles). One call per 2048^2 route (and per
point route) is traced with ``jax.profiler``; each device kernel is
attributed to the engines' named scopes (``conv``, ``sample``, ``place``)
through the ``op_name`` metadata of the compiled HLO. It also measures what
each ``jax.lax.Precision`` does to a float32 matmul on the card and to the
windowed placement's parity. ``--no-command-buffers`` runs kernels outside
CUDA graphs so that every traced kernel names its HLO instruction.

Writes ``DIR/route_timings.json`` (``route_timings_default.json`` with
``--default-routes``; default DIR ``chiprun_out``) and prints one line per
measurement. Exits nonzero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STAGES = ("conv", "sample", "place")


def wall_times(fn, *args, reps: int):
    """(first_call_s, [warm call seconds])."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return first, out


def hlo_stages(hlo_text: str) -> dict:
    """HLO instruction name -> stage, from the ``op_name`` metadata of the
    compiled module: an instruction (a fusion, a cuBLAS call) belongs to
    the first of ``STAGES`` whose named scope its op_name passes through."""
    out = {}
    for m in re.finditer(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s.*?'
                         r'op_name="([^"]*)"', hlo_text, re.M):
        name, op = m.groups()
        out[name] = next((st for st in STAGES if f"/{st}/" in op), "other")
    return out


def stage_split(trace_dir: str, stage_of: dict) -> dict:
    """Device time by stage, from the newest perfetto trace under
    ``trace_dir``: every complete event on a GPU device process is looked
    up in ``stage_of`` by its ``hlo_op``, then by its kernel name; events
    found under neither count as ``unmapped``. Also the union of device
    busy intervals and the window they span."""
    paths = []
    for root, _, files in os.walk(trace_dir):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith("perfetto_trace.json.gz")]
    if not paths:
        return {"error": "no perfetto trace written"}
    with gzip.open(max(paths, key=os.path.getmtime), "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    pname = {e["pid"]: e.get("args", {}).get("name", "")
             for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev = {p for p, n in pname.items() if "GPU" in n}
    sums = {s: 0.0 for s in STAGES + ("other", "unmapped")}
    spans = []
    names = {}
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev:
            continue
        dur = float(e.get("dur", 0.0)) * 1e-6
        name = e.get("name", "")
        # kernel names spell an instruction's ".N" suffix as "_N"
        stage = (stage_of.get(e.get("args", {}).get("hlo_op", ""))
                 or stage_of.get(name)
                 or stage_of.get(re.sub(r"_(\d+)$", r".\1", name),
                                 "unmapped"))
        sums[stage] += dur
        spans.append((float(e["ts"]) * 1e-6, float(e["ts"]) * 1e-6 + dur))
        names[(name, stage)] = names.get((name, stage), 0.0) + dur
    busy, end = 0.0, -1e30
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) \
        if spans else 0.0
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"stage_s": sums, "device_busy_s": busy, "window_s": window,
            "idle_share": (1.0 - busy / window) if window else None,
            "top_kernels_s": [[n[:60], st, t] for (n, st), t in top]}


def traced_split(fn, args, trace_dir: str) -> dict:
    import jax

    stage_of = hlo_stages(fn.lower(*args).compile().as_text())
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir, create_perfetto_trace=True):
        jax.block_until_ready(fn(*args))
    split = stage_split(trace_dir, stage_of)
    shutil.rmtree(trace_dir, ignore_errors=True)  # keep the reduction only
    return split


@contextlib.contextmanager
def env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def precision_probe() -> list[dict]:
    """What each precision does to a float32 matmul of the engines' shapes
    (relative error against float64, and the wall time), and to the
    windowed rescan placement's parity against the float64 oracle."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from rescan_line_sted_tpu.config import Grid, LineSTEDParams
    from rescan_line_sted_tpu.config import RescanGeometry
    from rescan_line_sted_tpu.imaging import rescan
    from tests.oracle import oracle

    rng = np.random.default_rng(0)
    a = rng.standard_normal((32 * 128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 4096)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    out = []
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        f = jax.jit(lambda x, y, p=prec: jnp.dot(x, y, precision=p))
        got = np.asarray(f(a, b))
        _, t = wall_times(f, a, b, reps=20)
        hlo = f.lower(a, b).compile().as_text()
        algo = sorted({ln.strip()[:160] for ln in hlo.splitlines()
                       if "algorithm" in ln or "tf32" in ln.lower()
                       or "precision_config" in ln})[:4]
        out.append({"what": f"dot [4096,128]@[128,4096] f32 {name}",
                    "rel_err_vs_f64": cs.rel_err(got, want),
                    "min_s": min(t), "compiled_hints": algo})
    size = 512
    params = LineSTEDParams.create(brightness=50.0, **cs.LINE_KW)
    kw = {k: v for k, v in cs.LINE_KW.items() if k != "slit_halfwidth"}
    sample = cs._sample(size)
    for label, r, b_ in cs.rescan_cells(size):
        geom = RescanGeometry(Grid(size, size), rescan_factor=r, binning=b_)
        step = (r - 1.0) / b_
        mode = "rounded" if abs(step - round(step)) < 1e-9 else "subpixel"
        want = oracle.rescanned_line_sted_image(
            np.asarray(sample, np.float64), rescan_factor=r, binning=b_,
            brightness=50.0, reassignment=mode, **kw)
        for name in ("HIGH", "HIGHEST"):
            saved = rescan._PRECISION
            rescan._PRECISION = getattr(jax.lax.Precision, name)
            jax.clear_caches()
            try:
                with env("RLS_RESCAN_STRIPS", "0"):
                    f = jax.jit(lambda s, p, g=geom: rescan._scan(
                        s, p, g, None, windowed=True))
                    got = np.asarray(f(sample, params))
                    _, t = wall_times(f, sample, params, reps=5)
            finally:
                rescan._PRECISION = saved
                jax.clear_caches()
            out.append({"what": f"rescan {size}^2 {label} windowed DFT "
                                f"placement, all matmuls {name}",
                        "rel_err_vs_f64_oracle": cs.rel_err(got, want),
                        "min_s": min(t)})
    return out


def cells(quick: bool):
    """(name, engine, size, noise, extra, {route: kwargs})."""
    import chip_smoke as cs

    out = [("point per-step", "point", 512, "per_step", {},
            {"windowed": dict(windowed=True),
             "full-frame": dict(windowed=False)}),
           ("point collapsed", "point", 512, "collapsed", {},
            {"closed form": {}})]
    for size in (512, 2048):
        out.append(("line per-step", "line", size, "per_step", {},
                    {"windowed": dict(windowed=True),
                     "full-frame": dict(windowed=False)}))
        out.append(("line collapsed", "line", size, "collapsed", {},
                    {"one matmul": {}}))
        for label, r, b in cs.rescan_cells(size):
            out.append((f"rescan per-step {label}", "rescan", size,
                        "per_step", dict(rescan_factor=r, binning=b),
                        {"windowed": dict(windowed=True),
                         "full-frame": dict(windowed=False)}))
        out.append(("rescan collapsed R=2 b=1", "rescan", size, "collapsed",
                    dict(rescan_factor=2.0, binning=1),
                    {"windowed strips": dict(windowed=True),
                     "windowed DFT": dict(windowed=True, strips="0"),
                     "full-frame scatter": dict(windowed=False),
                     "full-frame phases chunk 32": dict(
                         windowed=False, reassignment="subpixel"),
                     "full-frame phases chunk 8": dict(
                         windowed=False, reassignment="subpixel",
                         chunk=8)}))
    if quick:
        out = [c for c in out if c[2] == 512]
    return out


def run_cell(cell, trace_root: str | None, reps: int) -> list[dict]:
    import jax

    import chip_smoke as cs
    from rescan_line_sted_tpu.config import (Grid, LineSTEDGeometry,
                                             LineSTEDParams,
                                             PointSTEDGeometry,
                                             PointSTEDParams, RescanGeometry)
    from rescan_line_sted_tpu.imaging import line_sted, point_sted, rescan

    name, engine, size, noise, extra, routes = cell
    grid = Grid(size, size)
    sample = cs._sample(size)
    key = jax.random.key(7) if noise == "per_step" else None
    results = []
    for route, kw in routes.items():
        kw = dict(kw)
        strips = kw.pop("strips", None)
        chunk = kw.pop("chunk", None)
        if engine == "point":
            params = PointSTEDParams.create(brightness=50.0, **cs.POINT_KW)
            geom = PointSTEDGeometry(grid)
            fn = point_sted._scan
        elif engine == "line":
            params = LineSTEDParams.create(brightness=50.0, **cs.LINE_KW)
            geom = LineSTEDGeometry(grid)
            fn = line_sted._scan
        else:
            params = LineSTEDParams.create(brightness=50.0, **cs.LINE_KW)
            geom = RescanGeometry(grid, chunk=chunk or 32, **extra)
            fn = rescan._scan
        f = jax.jit(lambda s, p, k, fn=fn, g=geom, kw=kw: fn(
            s, p, g, k, noise, **kw))
        with env("RLS_RESCAN_STRIPS", strips or "1"):
            first, t = wall_times(f, sample, params, key, reps=reps)
            rec = {"cell": name, "size": size, "route": route,
                   "compile_plus_first_s": first, "min_s": min(t),
                   "median_s": float(np.median(t)), "reps": len(t)}
            if trace_root and size == 2048 or (trace_root and
                                                engine == "point"):
                tdir = os.path.join(trace_root, f"{engine}_{size}_"
                                    + "".join(c if c.isalnum() else "_"
                                              for c in name + route))
                rec["trace"] = traced_split(f, (sample, params, key), tdir)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    return results


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--quick", action="store_true",
                    help="512^2 cells only")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--default-routes", action="store_true",
                    help="time only the route each engine takes by default")
    ap.add_argument("--no-precision", action="store_true",
                    help="skip the matmul precision probe")
    ap.add_argument("--no-command-buffers", action="store_true",
                    help="run kernels outside CUDA graphs, so every traced "
                         "kernel names its HLO op")
    args = ap.parse_args(argv)
    if args.no_command_buffers:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("no GPU found by JAX; route timings are only taken on the "
              "card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    from rescan_line_sted_tpu.utils.observability import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    os.makedirs(args.out, exist_ok=True)
    report = {"card": smi, "device_kind": dev.device_kind,
              "jax": jax.__version__, "xla_flags":
                  os.environ.get("XLA_FLAGS", ""),
              "precision": [] if args.no_precision else precision_probe()}
    for p in report["precision"]:
        print(json.dumps(p), flush=True)
    report["routes"] = []
    for cell in cells(args.quick):
        if args.default_routes:
            cell = (*cell[:5], dict([next(iter(cell[5].items()))]))
        report["routes"] += run_cell(
            cell, os.path.join(args.out, "traces"), args.reps)
    name = "route_timings_default.json" if args.default_routes \
        else "route_timings.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
