"""The device a measurement runs on.

A measurement path that finds no GPU fails: it never falls back to the
CPU, whose times say nothing about the accelerator. The card's name and
power limit come from ``nvidia-smi`` (a card set below its maximum
power runs slower under load), read by a child process that stays off
JAX.
"""

from __future__ import annotations

import subprocess
import time


def require_gpu():
    """``jax.devices()`` when JAX's default platform is a GPU; raises
    RuntimeError otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {devices[0].platform!r}"
        )
    return devices


def gpu_name_power() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def call_times(fn, args, reps: int):
    """Run ``fn(*args)`` once (compile and warm-up), then ``reps`` more
    times, each call ending in ``block_until_ready``. Returns the first
    call's output, its host seconds, and the seconds of each later
    call."""
    import jax

    def once():
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        return out, time.perf_counter() - t0

    out, first_s = once()
    return out, first_s, [once()[1] for _ in range(reps)]
