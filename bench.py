"""Headline benchmark: complex samples/s through OFDM demod + LLR.

The north-star metric (BASELINE.json): throughput of the receive chain
— CP strip → FFT → MMSE equalize → max-log LLR — on BASELINE config 2
(16-QAM, 256 subcarriers, soft output), measured steady-state on one
GPU. A "sample" is one complex time-domain sample ENTERING the
demodulator (CP included), the honest accounting the survey calls for
(SURVEY.md §7 risk 5).

Timing: ``ops.demod.demod_chain(reduce_sum=True)`` jitted at the
headline shape; each timed call ends in ``block_until_ready``; the
reported time is the median over ``SDR_BENCH_REPS`` (default 10) calls
after a compile + warm-up call, with the quartiles beside it.

Prints the card's ``name, power.limit`` (nvidia-smi) and then ONE JSON
line naming the platform, device kind and device count. Exits non-zero
without a result when JAX finds no GPU.

Sizes: SDR_BENCH_BATCH (channels, default 32768), SDR_BENCH_SYMS
(OFDM symbols per channel, default 64).

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

N_FFT = 256
CP = 64
SYM_LEN = N_FFT + CP
EBNO_DB = 12.0


def main() -> int:
    import jax
    import jax.numpy as jnp

    from sdr_tpu.core.config import Modulation
    from sdr_tpu.obs.device import call_times, gpu_name_power, require_gpu
    from sdr_tpu.ops.channel import ebno_db_to_noise_var
    from sdr_tpu.ops.demod import demod_chain
    from sdr_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for line in gpu_name_power():
        print(f"# gpu: {line}")

    batch = int(os.environ.get("SDR_BENCH_BATCH", "32768"))
    n_syms = int(os.environ.get("SDR_BENCH_SYMS", "64"))
    reps = max(int(os.environ.get("SDR_BENCH_REPS", "10")), 10)
    mod = Modulation.QAM16
    nv = float(ebno_db_to_noise_var(EBNO_DB, mod.bits_per_symbol))

    @jax.jit
    def gen(key):
        """RX samples + a per-link channel response, planar, on device."""
        kr, ki, kh = jax.random.split(key, 3)
        shape = (batch, n_syms, SYM_LEN)
        scale = np.float32(1.0 / np.sqrt(2 * N_FFT))
        re = jax.random.normal(kr, shape, jnp.float32) * scale
        im = jax.random.normal(ki, shape, jnp.float32) * scale
        hs = np.float32(np.sqrt(0.5))
        hr = jax.random.normal(kh, (batch, 1, N_FFT), jnp.float32) * hs
        hi = jax.random.normal(
            jax.random.fold_in(kh, 1), (batch, 1, N_FFT), jnp.float32
        ) * hs
        return re, im, hr, hi

    run = jax.jit(
        lambda re, im, hr, hi: demod_chain(
            re, im, hr, hi, CP, mod, nv, reduce_sum=True
        )
    )
    args = jax.block_until_ready(gen(jax.random.PRNGKey(0)))
    out, compile_s, times = call_times(run, args, reps)
    if not np.isfinite(float(out)):
        print(f"error: non-finite LLR sum {float(out)}", file=sys.stderr)
        return 1
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    samples = batch * n_syms * SYM_LEN
    print(json.dumps({
        "metric": "complex samples/s through 16QAM/256sc OFDM "
                  "demod+MMSE+max-log LLR",
        "value": samples / med,
        "unit": "samples/s",
        "median_s": med,
        "q1_s": q1,
        "q3_s": q3,
        "reps": reps,
        "compile_and_first_call_s": compile_s,
        "batch": batch,
        "n_symbols": n_syms,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
