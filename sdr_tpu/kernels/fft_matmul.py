"""Matmul DFT: Cooley–Tukey four-step FFT as dense matrix products.

The reference computes FFTs with a scalar radix-2 butterfly loop and a
twiddle recurrence (fft.hpp:87-155). This module is the classic
*four-step* factorization, which turns the transform into matrix
products: for N = N1*N2,

    X[N1*k2 + k1] = sum_n2 W_N2[n2,k2] * ( T[k1,n2] *
                    sum_n1 x[N2*n1 + n2] * W_N1[n1,k1] )

i.e. (1) reshape to (N1, N2), (2) DFT of size N1 down the columns — a
matmul, (3) pointwise twiddle T[k1,n2] = e^{-+2 pi i k1 n2 / N},
(4) DFT of size N2 along the rows — another matmul — then transpose and
flatten. Sub-DFTs <= 128 points are direct DFT-matrix products; larger
factors recurse.

Complex arithmetic runs as real matmuls: with x = xr + i*xi and
W = Wr + i*Wi,   X = (xr@Wr - xi@Wi) + i*(xr@Wi + xi@Wr).
Matmuls use HIGHEST precision (full f32, never TF32 or bf16) to hold the
reference's float tolerance (abs 1e-5 / rel 1e-6, fft_test.cpp:48-64);
twiddles are precomputed float64 tables cast to f32 — no recurrence, so
none of the drift the reference renormalizes against (fft.hpp:144-150).

FLOP cost is O(N*(N1+N2)) complex MACs per transform vs O(N log N) for
radix-2. It is an explicit backend (ops.fft ``backend="matmul"``); the
default transform is the platform FFT library. ``python -m sdr_tpu
autotune`` times both on the current device.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# Largest direct (single-matmul) DFT.
_DIRECT_MAX = 128


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int, inverse: bool):
    """(Wr, Wi) float32 (n, n): W[j,k] = exp(-+2i pi jk / n)."""
    jk = np.outer(np.arange(n), np.arange(n)).astype(np.float64)
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * jk / n)
    return np.real(w).astype(np.float32), np.imag(w).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, inverse: bool):
    """(Tr, Ti) float32 (n1, n2): T[k1,n2] = exp(-+2i pi k1 n2 / (n1 n2))."""
    n = n1 * n2
    k1n2 = np.outer(np.arange(n1), np.arange(n2)).astype(np.float64)
    sign = 2.0 if inverse else -2.0
    t = np.exp(sign * 1j * np.pi * k1n2 / n)
    return np.real(t).astype(np.float32), np.imag(t).astype(np.float32)


def _split(n: int) -> tuple[int, int]:
    """Factor a power of two as n1*n2 with n1 <= n2, n1 maximal <= sqrt."""
    log = n.bit_length() - 1
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


def _cmatmul(xr, xi, wr, wi):
    """Complex (batch..., m, n) @ (n, k) as four real matmuls."""
    dot = functools.partial(
        jnp.matmul, precision=lax.Precision.HIGHEST, preferred_element_type=jnp.float32
    )
    return dot(xr, wr) - dot(xi, wi), dot(xr, wi) + dot(xi, wr)


def _dft_planar(xr, xi, inverse: bool):
    """Unscaled DFT over the last axis of planar real/imag arrays."""
    n = xr.shape[-1]
    if n == 1:
        return xr, xi
    if n <= _DIRECT_MAX:
        wr, wi = _dft_matrix(n, inverse)
        return _cmatmul(xr, xi, jnp.asarray(wr), jnp.asarray(wi))

    n1, n2 = _split(n)
    # Step 1: n = N2*n1 + n2 → rows index n2, columns index n1.
    xr = xr.reshape(*xr.shape[:-1], n1, n2)
    xi = xi.reshape(*xi.shape[:-1], n1, n2)
    # Step 2: size-N1 DFT over the n1 axis (move it last, recurse).
    xr = jnp.swapaxes(xr, -1, -2)  # (..., n2, n1)
    xi = jnp.swapaxes(xi, -1, -2)
    ar, ai = _dft_planar(xr, xi, inverse)  # (..., n2, k1)
    # Step 3: twiddle T[k1, n2] — operate in (..., k1, n2) layout.
    ar = jnp.swapaxes(ar, -1, -2)
    ai = jnp.swapaxes(ai, -1, -2)
    tr, ti = _twiddle(n1, n2, inverse)
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    # Step 4: size-N2 DFT over the n2 axis (already last).
    cr, ci = _dft_planar(br, bi, inverse)  # (..., k1, k2)
    # Output index k = N1*k2 + k1 → transpose to (k2, k1) and flatten.
    cr = jnp.swapaxes(cr, -1, -2).reshape(*cr.shape[:-2], n)
    ci = jnp.swapaxes(ci, -1, -2).reshape(*ci.shape[:-2], n)
    return cr, ci


def matmul_fft(x: jnp.ndarray, inverse: bool = False) -> jnp.ndarray:
    """(I)FFT over the last axis via the matmul DFT.

    Semantics match fft::fft2 / fft::ifft2 (unscaled forward; inverse
    scaled by 1/N, fft.hpp:176-205).
    """
    n = x.shape[-1]
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    yr, yi = _dft_planar(xr, xi, inverse)
    if inverse:
        scale = jnp.float32(1.0 / n)
        yr = yr * scale
        yi = yi * scale
    return lax.complex(yr, yi)
