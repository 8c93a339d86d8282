"""Device-mesh setup for multi-chip encode/decode.

Replaces the reference's "distributed backend" — six OS threads each driving
a Docker container over subprocess `docker exec`, rendezvousing through CSV
files on the host FS (`docker_manager.rs:227-255`, SURVEY §2.3) — with JAX
shardings over a device mesh:

- axis "data":  corpus-level data parallelism (the worker-pool analog);
  each device encodes different images of the batch.
- axis "space": intra-image spatial parallelism (the sequence-parallel
  analog the reference lacks): an image's block columns are sharded, with
  cross-device state (DC prefix sums, histogram reductions) handled by XLA
  collectives inserted at the sharding boundaries.

Multi-host runs call `init_multihost()` once per process before any other
JAX use (wraps `jax.distributed.initialize`); `make_mesh` then sees the
global device set, so the same ("data", "space") shardings scale from one
card to several hosts. The mesh follows the algorithm alone: the four
GPUs of a host are joined all to all by NVLink, so no axis order is
faster than another within a host.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Join (or form) a multi-host JAX process group.

    The reference's multi-"node" story is subprocess + docker exec with CSV
    rendezvous on the host filesystem (`docker_manager.rs:227-255`); here
    it is one SPMD program over all hosts' devices. With no arguments,
    cluster-environment autodetection (SLURM etc.) fills in the
    coordinator where one exists; on a single host this is a no-op-like
    1-process group, so callers can use it unconditionally.

    Call once per process BEFORE any other JAX API. After it returns,
    `jax.devices()` spans the whole slice and `make_mesh()` builds the
    global ("data", "space") mesh.
    """
    import jax

    # Idempotency must NOT go through jax.process_count(): that initializes
    # the XLA backend, after which jax.distributed.initialize refuses to
    # run (the 2-process CPU exercise in tests/test_multihost.py hits this).
    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except (ValueError, RuntimeError) as e:
        # single-process with no coordinator/env: run standalone
        if num_processes not in (None, 1):
            raise
        import logging

        logging.getLogger(__name__).info(
            "jax.distributed.initialize unavailable (%s); single-process run", e
        )


def local_batch_to_global(batch_local: np.ndarray, mesh: Mesh):
    """Assemble a globally-sharded [B, H, W, 3] batch from per-process local
    shards (multi-host DP: each host contributes its own images)."""
    return jax.make_array_from_process_local_data(
        batch_sharding(mesh), batch_local
    )


def make_mesh(n_devices: int | None = None, data: int | None = None, space: int | None = None) -> Mesh:
    """Build a ("data", "space") mesh over the first n_devices devices.

    Defaults: all devices on the data axis (pure corpus DP), space=1.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if data is None and space is None:
        data, space = n_devices, 1
    elif data is None:
        data = n_devices // space
    elif space is None:
        space = n_devices // data
    assert data * space == n_devices, (data, space, n_devices)
    arr = np.array(devs).reshape(data, space)
    return Mesh(arr, ("data", "space"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, H, W, 3] batches: images over "data", width over "space"."""
    return NamedSharding(mesh, P("data", None, "space", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
