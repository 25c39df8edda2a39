"""Device-mesh construction for the link simulator.

The reference is single-process with zero IPC (SURVEY.md §2 comm
inventory); distribution here is JAX-native: a 2-D logical mesh with
axes

- ``"time"``    — sequence parallelism: contiguous OFDM-symbol blocks
  of each channel's sample stream (halo-coupled via ppermute at the
  multipath seams);
- ``"channel"`` — data parallelism: independent OFDM links.

Collectives are NCCL calls: over NVLink between the GPUs of one host,
over the network between hosts when the mesh spans several processes
(jax.distributed). Every GPU of a host reaches every other at the same
rate, so the mesh shape follows the algorithm alone. BER reduction
is one psum; the halo is one ppermute of L-1 complex samples per block
boundary — O(cp), off the critical path.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_link_mesh(
    n_time: int | None = None,
    n_channel: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ("time", "channel") mesh over the given (or all) devices.

    Defaults: all devices on the channel axis (pure DP) — the right
    layout whenever channels >= devices, since DP needs no halo.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_time is None and n_channel is None:
        n_time, n_channel = 1, n_dev
    elif n_time is None:
        n_time = n_dev // n_channel
    elif n_channel is None:
        n_channel = n_dev // n_time
    if n_time * n_channel != n_dev:
        raise ValueError(
            f"mesh {n_time}x{n_channel} != {n_dev} devices"
        )
    arr = np.asarray(devices).reshape(n_time, n_channel)
    return Mesh(arr, axis_names=("time", "channel"))


def mesh_info(mesh: Mesh) -> str:
    return (
        f"mesh time={mesh.shape['time']} channel={mesh.shape['channel']} "
        f"devices={mesh.devices.size}"
    )
