"""Device-mesh utilities (SURVEY.md sections 2.4 and 6, "Distributed
communication backend").

The reference is a single-process numpy script suite with no parallelism of
any kind; here the communication backend is **XLA/GSPMD collectives**
(NCCL between GPUs on one host), reached by sharding inputs over a
``jax.sharding.Mesh`` and letting jit propagate. These helpers implement
that recipe and degrade gracefully to the single-chip mesh available here:

* ``batch`` axis -- sweep points / orientations / samples (the DP
  equivalent): embarrassingly parallel, no collectives on the forward pass.
* ``space`` axis -- image rows for large-FOV simulation (the SP/CP
  equivalent): XLA shards the FFTs and inserts the all-to-alls/collectives
  itself.

Usage::

    mesh = make_mesh({"batch": 4, "space": 2})
    powers = shard_batch(mesh, powers)           # leading dim over "batch"
    sample = replicate(mesh, sample)             # or shard rows over "space"
    result = jax.jit(sweep_fn)(sample, powers)   # GSPMD does the rest
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axes: dict[str, int] | None = None,
              devices: list | None = None) -> Mesh:
    """Create a mesh over the available devices.

    ``axes`` maps axis name -> size (total must equal the device count);
    ``None`` uses all devices on a single ``"batch"`` axis. Single-chip safe:
    with one device every axis has size 1.
    """
    if devices is None:
        devices = jax.devices()
    if axes is None:
        axes = {"batch": len(devices)}
    sizes = tuple(axes.values())
    if math.prod(sizes) != len(devices):
        raise ValueError(
            f"mesh axes {axes} need {math.prod(sizes)} devices, "
            f"got {len(devices)}")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, tuple(axes.keys()))


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "batch") -> NamedSharding:
    """Shard the leading dim over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree, axis: str = "batch"):
    """device_put every leaf with its leading dim sharded over ``axis``."""
    return jax.tree.map(
        lambda x: jax.device_put(x, batch_sharding(mesh, np.ndim(x), axis)),
        tree)


def replicate(mesh: Mesh, tree):
    """device_put every leaf fully replicated over the mesh."""
    return jax.tree.map(
        lambda x: jax.device_put(x, replicated_sharding(mesh)), tree)
