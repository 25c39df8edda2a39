"""FFT/IFFT with the reference's conventions and two backends.

Contract (from /root/reference/lib/inc/fft.hpp):

- forward transform is UNSCALED with kernel e^{-2*pi*i*n*k/N}
  (theta = -2*pi/N, fft.hpp:114 with inverse=false);
- inverse uses theta = +2*pi/N then scales by 1/N (fft.hpp:197-204);
- sizes must be powers of two (fft.hpp:90-92) — enforced here at trace
  time (the JAX analog of the reference's runtime std::expected guard).

These are exactly the numpy/XLA conventions, so the "xla" backend is a
direct ``jnp.fft`` call. The reference's bit-reverse permutation
(fft.hpp:35-51) and twiddle recurrence with periodic renormalization
(fft.hpp:113-150) are scalar-CPU artifacts: backends here use either
XLA's FFT or a Cooley–Tukey *four-step* factorization that runs the
butterflies as dense DFT-matrix products (sdr_tpu/kernels/fft_matmul.py).

Backends (``SDR_TPU_FFT_BACKEND`` sets the process default):
- "xla":    jnp.fft — XLA's FFT (the platform FFT library on a GPU).
- "matmul": matmul DFT (four-step decomposition), batched.
- "auto":   an alias of "xla": no size has been measured at which the
            matmul DFT beats the GPU's FFT library.

All functions operate on the last axis and accept arbitrary leading
batch dims.
"""

from __future__ import annotations

import os
from typing import Literal

import jax.numpy as jnp

Backend = Literal["auto", "xla", "matmul"]

_DEFAULT_BACKEND: Backend = os.environ.get("SDR_TPU_FFT_BACKEND", "auto")  # type: ignore[assignment]
if _DEFAULT_BACKEND not in ("auto", "xla", "matmul"):
    # Fail fast: a typo'd env value would otherwise silently behave as
    # "xla" for every size (the == "matmul" comparison never matches).
    raise ValueError(
        f"SDR_TPU_FFT_BACKEND={_DEFAULT_BACKEND!r} invalid; "
        "expected auto|xla|matmul"
    )

def set_default_backend(backend: Backend) -> None:
    global _DEFAULT_BACKEND
    if backend not in ("auto", "xla", "matmul"):
        raise ValueError(f"unknown FFT backend {backend!r}")
    _DEFAULT_BACKEND = backend


def get_default_backend() -> Backend:
    return _DEFAULT_BACKEND


def _validate(n: int) -> None:
    if n <= 0 or (n & (n - 1)) != 0:
        # Trace-time twin of fft.hpp:91-92 ("must be of powers of 2").
        raise ValueError(f"The sequence size must be a power of 2, got {n}")


def _resolve(backend: Backend | None) -> str:
    b = backend or _DEFAULT_BACKEND
    return "xla" if b == "auto" else b


def fft(x: jnp.ndarray, backend: Backend | None = None) -> jnp.ndarray:
    """Unscaled forward DFT over the last axis (fft::fft2 semantics)."""
    n = x.shape[-1]
    _validate(n)
    x = x.astype(jnp.complex64)
    if _resolve(backend) == "matmul":
        from sdr_tpu.kernels.fft_matmul import matmul_fft

        return matmul_fft(x, inverse=False)
    return jnp.fft.fft(x, axis=-1)


def xla_ifft(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse DFT over the last axis, 1/N-scaled, any length.

    Taken through the forward transform, ifft(x) = conj(fft(conj(x)))/N,
    so the conjugations and the scale are elementwise work XLA fuses.
    XLA's own inverse scales in a separate library call on the GPU
    whose element count overflows from 2^31 elements up: at 524,288 x
    4096 points it returned values off by a factor of thousands
    (measured on an H100), where this form is exact.
    """
    n = x.shape[-1]
    y = jnp.fft.fft(jnp.conj(x), axis=-1)
    return jnp.conj(y) * jnp.asarray(1.0 / n, y.real.dtype)


def ifft(x: jnp.ndarray, backend: Backend | None = None) -> jnp.ndarray:
    """Inverse DFT with 1/N scaling (fft::ifft2 semantics, fft.hpp:194-205)."""
    n = x.shape[-1]
    _validate(n)
    x = x.astype(jnp.complex64)
    if _resolve(backend) == "matmul":
        from sdr_tpu.kernels.fft_matmul import matmul_fft

        return matmul_fft(x, inverse=True)
    return xla_ifft(x)
