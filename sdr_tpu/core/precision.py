"""Precision policy.

The reference templates everything over float/double and manages FP
drift by renormalizing its twiddle recurrence every 32 steps
(/root/reference/lib/inc/fft.hpp:144-150) — a scalar-CPU artifact.
Accelerators have no complex128/float64 fast path, so the explicit
policy is:

- compute dtype: complex64 (float32 re/im) — twiddles are precomputed
  tables, not recurrences, so there is no drift to manage;
- LLR / metric output dtype: float32 by default, bfloat16 optional for
  bandwidth-bound demod outputs;
- accumulation (BER counters, power sums): float32/int32 on device.

Accepted accuracy bound is the reference's own float test tolerance
(abs 1e-5 / rel 1e-6 per component, fft_test.cpp:48-64) plus the north
star's 0.1 dB BER parity bound.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Precision:
    complex_dtype: jnp.dtype = jnp.complex64
    real_dtype: jnp.dtype = jnp.float32
    llr_dtype: jnp.dtype = jnp.float32

    @property
    def bytes_per_complex(self) -> int:
        return jnp.dtype(self.complex_dtype).itemsize


def default_precision() -> Precision:
    return Precision()
