"""Shared set-up for the scripts/bench_*.py timers.

Each timer jits one program, runs it once (compile + warm-up, reported
as set-up), then times ``SDR_BENCH_REPS`` (default 10) calls that each
end in ``block_until_ready`` and reports the median and quartiles. It
refuses to run without a GPU and prints the card's name and power
limit beside every result.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def time_program(fn, args, record: dict, work: float, unit: str) -> None:
    """Time ``fn(*args)``; print ``record`` plus the rate ``work`` per
    median second as one JSON line."""
    from sdr_tpu.obs.device import call_times, gpu_name_power, require_gpu
    from sdr_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    try:
        devices = require_gpu()
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    reps = max(env_int("SDR_BENCH_REPS", 10), 10)
    _, setup_s, times = call_times(fn, args, reps)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    print(json.dumps({
        **record,
        unit: work / med,
        "median_s": med,
        "q1_s": q1,
        "q3_s": q3,
        "reps": reps,
        "compile_and_first_call_s": setup_s,
        "gpu": gpu_name_power(),
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
