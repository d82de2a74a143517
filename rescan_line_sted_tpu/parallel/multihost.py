"""Multi-host (multi-process) initialization for pod-scale meshes.

SURVEY.md section 2.4: the reference (single-process numpy figure scripts,
see SURVEY.md section 1) has no distributed story; here the
communication backend is GSPMD over a global mesh. On a multi-host GPU
cluster each host runs one process and sees only its local cards until
``jax.distributed.initialize`` stitches the processes into one runtime --
after that ``jax.devices()`` is global and the ``parallel.mesh`` helpers
(and everything jitted over their meshes) work unchanged, with XLA routing
collectives over ICI within a slice and DCN across slices.

Single-process safe: ``initialize_multihost()`` with no arguments and no
cluster environment is a no-op, so pipelines can call it unconditionally.

Usage (one call per process, before the first backend use)::

    from rescan_line_sted_tpu.parallel import initialize_multihost, make_mesh

    initialize_multihost()                       # env-driven (SLURM/OMPI)
    # or explicitly:
    initialize_multihost("10.0.0.1:8476", num_processes=4, process_id=rank)

    mesh = make_mesh({"batch": 8, "space": 4})   # now spans all hosts
"""

from __future__ import annotations

import jax


def is_initialized() -> bool:
    """True when the process is already part of a distributed runtime."""
    return bool(jax.distributed.is_initialized())


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         **kwargs) -> tuple[int, int]:
    """Join (or create) the distributed runtime; returns
    ``(process_index, process_count)``.

    * With arguments: explicit cluster wiring (coordinator host:port, world
      size, rank) -- any launcher (mpirun, SLURM, k8s) can drive it.
    * Without arguments: ``jax.distributed.initialize`` auto-detects the
      cluster from the environment (SLURM/OMPI vars).
      When auto-detection finds NO cluster at all it raises the specific
      "coordinator_address should be defined" ValueError; that one case is
      treated as single-process and the call is a NO-OP, so single-chip
      runs and multi-host runs share one code path. Every other failure
      (mis-wired cluster, version skew, timeout) propagates -- a real
      cluster must never silently degrade to N independent worlds.
    * Idempotent: a second call returns the existing wiring.
    * Ordering: must run BEFORE the process's first backend use (any
      computation, ``jax.devices()``, ...); jax itself raises a
      RuntimeError otherwise, which propagates unchanged -- swallowing it
      on a pod would silently split the job into per-host worlds.
    """
    if is_initialized():
        return jax.process_index(), jax.process_count()
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kwargs)
    except ValueError as e:
        if (coordinator_address is None and num_processes is None
                and "coordinator_address" in str(e)):
            return 0, 1  # no cluster environment: single process
        raise
    return jax.process_index(), jax.process_count()


def local_device_slice(mesh, axis_name: str) -> tuple[int, int]:
    """Index range ``[lo, hi)`` of ``axis_name`` whose devices this process
    owns -- for host-side work (loading samples, writing per-shard TIFFs)
    that must touch only the shards this host will feed to
    ``jax.make_array_from_single_device_arrays``.

    Ownership is read off the mesh's device array (NOT assumed from the
    process id): an axis index is local when any of its devices is this
    process's. Raises when the local indices are not one contiguous range
    (e.g. the trailing axis of a process-major mesh, where every process
    touches every index) -- a per-index mask, not a slice, is the correct
    tool there.
    """
    import numpy as np

    axis = mesh.axis_names.index(axis_name)
    moved = np.moveaxis(mesh.devices, axis, 0)
    proc = jax.process_index()
    local = [i for i in range(moved.shape[0])
             if any(d.process_index == proc
                    for d in np.atleast_1d(moved[i]).flat)]
    if not local:
        raise ValueError(f"process {proc} owns no devices on {axis_name!r}")
    lo, hi = local[0], local[-1] + 1
    if local != list(range(lo, hi)):
        raise ValueError(
            f"process {proc}'s devices are not contiguous along "
            f"{axis_name!r} (indices {local}); use a per-index ownership "
            "mask instead of a slice")
    return lo, hi
