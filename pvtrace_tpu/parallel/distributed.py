"""Multi-host execution: one JAX process per host, one global mesh.

Replaces the reference's only distribution mechanism — a
``multiprocessing.Pool`` over rays with per-worker reseeds
(``pvtrace/scene/scene.py:256-313``) — with the JAX distributed
runtime: every host calls :func:`init_distributed`, after which
``jax.devices()`` spans all processes and the photon mesh from
:func:`global_photon_mesh` covers the full slice/cluster. The sharded
tracers in ``parallel.shard`` are written purely in terms of
collectives (``psum`` tally reduction, ``axis_index`` photon-id
offsets), so the same compiled program runs single-chip, multi-chip
and multi-host; per-photon keys fold the *global* photon index, which
keeps tallies bitwise independent of how many hosts participate.

Host-side glue lives here: process bootstrap, and the host-local <->
global array conversions multi-process jit inputs/outputs require.
"""
import os

import numpy as np

_INITIALIZED = False


def is_multiprocess():
    import jax

    return jax.process_count() > 1


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Join (or create) a multi-process JAX runtime.

    Call once per process before any other JAX API. With no arguments,
    values come from the standard environment (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) or JAX's cluster
    detection; single-process runs (no coordinator anywhere)
    are a no-op, so library code can call this unconditionally.

    Blocks until all ``num_processes`` processes have joined.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single process — nothing to initialise

    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True


def shutdown_distributed():
    """Leave the distributed runtime (safe to call when not joined)."""
    global _INITIALIZED
    if not _INITIALIZED:
        return
    import jax

    jax.distributed.shutdown()
    _INITIALIZED = False


def global_photon_mesh(axis_name="photons"):
    """A 1D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis_name,))


def globalize(mesh, tree, specs):
    """Lift host-local arrays to global arrays for multi-process jit.

    ``specs`` is a PartitionSpec pytree-prefix: ``P()`` marks inputs
    every process passes identically (replicated); ``P(axis)`` marks
    inputs where each process passes its own slice of the global batch.
    Single-process: returns ``tree`` unchanged.
    """
    if not is_multiprocess():
        return tree
    from jax.experimental import multihost_utils

    return multihost_utils.host_local_array_to_global_array(
        tree, mesh, specs
    )


def localize(mesh, tree, specs):
    """The inverse of :func:`globalize` for jit outputs."""
    if not is_multiprocess():
        return tree
    from jax.experimental import multihost_utils

    return multihost_utils.global_array_to_host_local_array(
        tree, mesh, specs
    )
