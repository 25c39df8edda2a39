"""CA-SCL polar decoder timer: decoded payload bits/s.

Knobs: SDR_BENCH_POLAR_N (block length), SDR_BENCH_POLAR_LIST,
SDR_BENCH_POLAR_CW (codeword batch), SDR_BENCH_POLAR_DECODER (fast |
scan — fast is the fast-SSCL tree decoder, decision-identical to the
scan).
"""

from __future__ import annotations

import os

from _timing import env_int, time_program


def main() -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from sdr_tpu.ops.polar import (
        make_polar_code,
        polar_decode_scl,
        polar_decode_scl_fast,
        polar_encode_payload,
    )

    N = env_int("SDR_BENCH_POLAR_N", 256)
    L = env_int("SDR_BENCH_POLAR_LIST", 8)
    n_cw = env_int("SDR_BENCH_POLAR_CW", 256)
    which = os.environ.get("SDR_BENCH_POLAR_DECODER", "fast")
    decode = polar_decode_scl_fast if which == "fast" else polar_decode_scl
    code = make_polar_code(N, N // 2, crc="crc11")
    rng = np.random.default_rng(0)
    pay = jnp.asarray(rng.integers(0, 2, (n_cw, code.payload_len)), jnp.int8)
    cw = polar_encode_payload(pay, code)
    esno = 10 ** (2.5 / 10.0) * code.rate
    sigma = np.sqrt(1.0 / (2.0 * esno))
    x = 1.0 - 2.0 * np.asarray(cw, np.float32)
    y = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
    llr = jnp.asarray(2.0 * y / sigma**2)
    time_program(
        jax.jit(lambda l: decode(l, code, list_size=L)),
        (llr,),
        {"code": f"CA-polar ({N},{code.k}) CRC-11 SCL-{L} [{which}]",
         "codewords": n_cw},
        n_cw * code.payload_len, "payload_bits_per_s",
    )


if __name__ == "__main__":
    main()
