"""Scaling the sweep and the FOV over a device mesh (one card to a cluster).

Three levels, one code path (SURVEY.md section 2.4; the reference is a
single-process numpy script suite with no parallelism):

1. one card            -- the mesh degrades to {"batch": 1}; no change.
2. one host, N cards   -- shard the sweep axis ("batch", DP) and image
                          rows ("space", SP); XLA inserts the collectives
                          (NCCL between GPUs).
3. many hosts          -- ``initialize_multihost()`` first; after it,
                          ``jax.devices()`` is global and the SAME mesh
                          helpers span hosts.

Run: PYTHONPATH=. python examples/scaling.py
(on a box without a GPU it self-provisions 8 virtual CPU devices so the
sharded paths actually run; with a GPU it uses what is there)
"""

import os
import pkgutil

_plat = os.environ.get("JAX_PLATFORMS", "")
# Virtual-mesh fallback when the user explicitly chose CPU, or when no
# CUDA plugin for JAX (``jax_cuda<version>_plugin``) is installed. An UNSET
# platform with the plugin installed is real hardware: leave the
# environment alone so the example uses what is there.
_want_virtual = _plat == "cpu" or (
    _plat == ""
    and not any(m.name.startswith("jax_cuda") and m.name.endswith("_plugin")
                for m in pkgutil.iter_modules()))
if _want_virtual and "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    # Demo fallback: provision a virtual 8-device CPU mesh so the sharded
    # paths actually execute on a box without a GPU (or forced to cpu).
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import rescan_line_sted_tpu as rls
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging import line_sted_image
from rescan_line_sted_tpu.parallel import (
    batch_sharding,
    initialize_multihost,
    make_mesh,
    replicate,
)
from rescan_line_sted_tpu.sweeps import dose_matched_sweep

# Level 3 wiring: no-op here (no cluster env), joins the pod when there is
# one. Safe to call unconditionally.
proc, nprocs = initialize_multihost()
print(f"process {proc}/{nprocs}, devices: {len(jax.devices())}")

n = len(jax.devices())
space = 2 if n % 2 == 0 and n > 1 else 1
mesh = make_mesh({"batch": n // space, "space": space})
print("mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)))

# --- batch axis: the dose-matched sweep, sweep points sharded over chips
size = 64
sample = samples.siemens_star((size, size))
powers = jnp.linspace(0.0, 16.0, 8)
powers = jax.device_put(powers, batch_sharding(mesh, 1))
pgeom = rls.PointSTEDGeometry(rls.Grid(size, size), chunk=size)
lgeom = rls.LineSTEDGeometry(rls.Grid(size, size), chunk=16)
pbase = replicate(mesh, rls.PointSTEDParams.create())
lbase = replicate(mesh, rls.LineSTEDParams.create())
sweep = jax.jit(lambda s, pw: dose_matched_sweep(
    s, pbase, lbase, pgeom, lgeom, pw, dose_budget=100.0))(
        jax.device_put(sample, NamedSharding(mesh, P())), powers)
jax.block_until_ready(sweep)
print("sweep (8 points over the batch axis):")
print("  point FWHM [px]:", np.round(np.asarray(sweep.point.fwhm_x), 2))
print("  line  FWHM [px]:", np.round(np.asarray(sweep.line.fwhm_x), 2))

# --- space axis: one large acquisition, image rows sharded over chips
big = 256
fov_sample = samples.siemens_star((big, big))
fov_sample = jax.device_put(fov_sample, NamedSharding(mesh, P("space", None)))
geom = rls.LineSTEDGeometry(rls.Grid(big, big))
params = replicate(mesh, rls.LineSTEDParams.create(depletion=8.0))
img = jax.jit(lambda s, p: line_sted_image(s, p, geom).image)(
    fov_sample, params)
jax.block_until_ready(img)
print(f"large-FOV {big}^2 rows sharded over 'space': "
      f"sharding={img.sharding.spec}, sum={float(img.sum()):.3e}")
