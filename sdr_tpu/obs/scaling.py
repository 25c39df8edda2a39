"""Weak-scaling benchmark over the device mesh.

North-star requirement: ≥85% weak-scaling efficiency of samples/s on a
2-host slice (BASELINE.json). This driver grows the channel count with
the device count (fixed work per device — weak scaling), runs the
sharded link on each subset, and reports samples/s and efficiency
relative to the single-device rate.

Each rate is the median over ``reps`` calls of the jitted sharded
link, each ending in ``block_until_ready`` (compile and warm-up
excluded).
"""

from __future__ import annotations

import dataclasses

import jax

from sdr_tpu.core.config import LinkConfig
from sdr_tpu.obs.autotune import median_seconds
from sdr_tpu.parallel import make_link_mesh
from sdr_tpu.parallel.shard import make_sharded_simulate_fn


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    n_channels: int
    samples_per_s: float
    efficiency: float  # vs perfect scaling of the first point


def _rate(cfg: LinkConfig, mesh, reps: int) -> float:
    fn = make_sharded_simulate_fn(cfg, mesh)
    sec = median_seconds(fn, (jax.random.PRNGKey(0),), reps)
    return cfg.n_channels * cfg.n_symbols * cfg.samples_per_symbol / sec


def weak_scaling(
    cfg: LinkConfig,
    device_counts=None,
    reps: int = 10,
) -> list:
    """Run the DP-sharded link at each device count; channels scale with
    devices, keeping cfg.n_channels PER DEVICE constant."""
    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    per_dev = cfg.n_channels
    points = []
    base = None
    for k in device_counts:
        mesh = make_link_mesh(1, k, devices=devices[:k])
        cfg_k = dataclasses.replace(cfg, n_channels=per_dev * k)
        rate = _rate(cfg_k, mesh, reps)
        if base is None:
            base = rate
        points.append(
            ScalePoint(
                n_devices=k,
                n_channels=cfg_k.n_channels,
                samples_per_s=rate,
                efficiency=rate / (base * k / device_counts[0]),
            )
        )
    return points
