"""LDPC decoder timer: decoded information bits/s.

Knobs: SDR_BENCH_LDPC_RATE (1/2|2/3|3/4), SDR_BENCH_LDPC_CW (batch of
codewords), SDR_BENCH_LDPC_ITERS (min-sum iterations),
SDR_BENCH_LDPC_SCHEDULE (flooding | layered — about half the
iterations for the same waterfall).
"""

from __future__ import annotations

import os

from _timing import env_int, time_program


def main() -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from sdr_tpu.link.coded import ldpc_code_for
    from sdr_tpu.ops.ldpc import ldpc_decode, ldpc_encode

    rate = os.environ.get("SDR_BENCH_LDPC_RATE", "1/2")
    schedule = os.environ.get("SDR_BENCH_LDPC_SCHEDULE", "flooding")
    n_cw = env_int("SDR_BENCH_LDPC_CW", 256)
    ms_iters = env_int("SDR_BENCH_LDPC_ITERS", 25)
    code = ldpc_code_for(rate)
    rng = np.random.default_rng(0)
    info = jnp.asarray(rng.integers(0, 2, (n_cw, code.k)), jnp.int8)
    cw = ldpc_encode(code, info)
    esno = 10 ** (2.5 / 10.0) * code.rate
    sigma = np.sqrt(1.0 / (2.0 * esno))
    x = 1.0 - 2.0 * np.asarray(cw, np.float32)
    y = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
    llr = jnp.asarray(2.0 * y / sigma**2)
    time_program(
        jax.jit(lambda l: ldpc_decode(
            code, l, iters=ms_iters, schedule=schedule)),
        (llr,),
        {"code": f"qc-ldpc nb=24 z=128 rate {rate}", "schedule": schedule,
         "minsum_iters": ms_iters, "codewords": n_cw},
        n_cw * code.k, "info_bits_per_s",
    )


if __name__ == "__main__":
    main()
