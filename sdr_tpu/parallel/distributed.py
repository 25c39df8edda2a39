"""Multi-host runtime initialization.

The reference is strictly single-process (SURVEY.md §2: zero IPC; its
only "backend" is a Qt event loop). Scaling past one host in JAX is
``jax.distributed.initialize`` + building the ("time", "channel") mesh
over ``jax.devices()`` (which then spans all hosts): XLA hands the
collectives to NCCL, over NVLink between the GPUs of one host and the
network between hosts — no collective code exists to write here.

Usage on each host (pass the coordinator, process count and id; only a
scheduler that sets the standard environment lets them be omitted):

    from sdr_tpu.parallel import init_multihost, make_link_mesh
    init_multihost("localhost:12345", n_processes, process_id)
    mesh = make_link_mesh(n_time=hosts, n_channel=devs_per_host)

Every sharded entry point in sdr_tpu.parallel is a plain shard_map
program over the mesh, so nothing else changes between 1 and N hosts —
the bit-exactness invariant (global-index PRNG keying) already makes
results layout-independent.
"""

from __future__ import annotations

import jax


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize the cross-host runtime; returns a topology summary.

    No-op (with a warning-free summary) when only one process is
    configured — safe to call unconditionally at program start.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
