"""Multi-process initialisation and whole-cluster mesh construction.

The reference is strictly single-process (SURVEY §2: no NCCL/MPI/UCX
anywhere); scaling beyond one process is a new capability of this
framework.  JAX's runtime does the heavy lifting: `jax.distributed.initialize`
forms the process group, `jax.devices()` then spans every device of every
process, and the same `raster_sharded` shard_map
(`dprast.parallel.sharded`) runs unchanged — its `psum` collectives are
compiled by XLA and run over NCCL on GPUs.

One process can drive every card of a host, so a single host needs none
of this.  A multi-host run starts the same script on every host:

    from dprast.parallel import multihost, raster_sharded
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.pod_mesh(points_axis_per_host=True)
    out = raster_sharded(grid, pts, rots, trs, mesh=mesh)
"""

from __future__ import annotations

import os

import jax

from dprast.parallel.sharded import POINTS_AXIS, POSES_AXIS, make_mesh

def _multiprocess_env() -> bool:
    """True when the environment indicates a multi-process launch.  When it
    does (or explicit arguments are given) a failure to form the process
    group is a REAL pod misconfiguration and must surface loudly — silently
    degrading to single-host would have every host compute in isolation."""
    if any(os.environ.get(v) for v in (
            "COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")):
        return True
    for var in ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Form the multi-host process group.

    Must run before any JAX call that initialises the XLA backend (JAX
    requirement) — therefore this function checks
    `jax.distributed.is_initialized()` (pure state read) rather than
    `jax.process_count()` (which would initialise the backend first and
    make group formation impossible).

    Single-process environments (no explicit arguments AND no cluster
    environment variables) return without touching JAX at all.  In a
    configured cluster environment every error from
    `jax.distributed.initialize` propagates — a misconfigured pod must
    fail loudly, not silently degrade to isolated single-host compute.
    """
    if jax.distributed.is_initialized():
        return  # already initialised
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    configured = explicit or _multiprocess_env()
    if not configured:
        return  # single-process run: no group to form, leave JAX untouched
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(points_axis_per_host: bool = True):
    """A ("poses", "points") mesh over every device of every process.

    With `points_axis_per_host` the "points" axis spans the devices WITHIN
    each process (its forward `psum` of partial images stays on the
    host's NVLink) and "poses" spans processes (its gradient psums cross
    the network once per step, amortised over the whole pose batch).
    Within one host every card reaches every other at the same rate, so
    no other topology matters.
    """
    n = jax.device_count()
    local = jax.local_device_count()
    hosts = max(1, n // max(1, local))
    if points_axis_per_host and n % local == 0:
        return make_mesh(hosts, local)
    return make_mesh(n, 1)
