"""FFT contract tests.

Carries over the reference's test strategy (SURVEY.md §4): round trips
with explicit tolerances (fft_test.cpp:10-65) and the non-power-of-2
error path (fft_test.cpp:67-72), plus backend-agreement and
convention-parity tests the reference couldn't have.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sdr_tpu.ops.fft import fft, ifft
from sdr_tpu.kernels.fft_matmul import matmul_fft

# The reference's float tolerance: abs <= 1e-5 OR rel <= 1e-6 per
# re/im component (fft_test.cpp:48-64).
ABS_TOL = 1e-5
REL_TOL = 1e-6


def assert_ref_float_close(a, b, magnitude=1.0):
    """Reference float tolerance, scaled by the data's natural magnitude.

    The reference applies abs 1e-5 / rel 1e-6 to O(1) round-trip values
    (fft_test.cpp:48-64); raw FFT outputs grow as sqrt(N), so
    ``magnitude`` rescales the absolute term accordingly.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    for part in (np.real, np.imag):
        d = np.abs(part(a) - part(b))
        scale = np.maximum(np.abs(part(a)), np.abs(part(b)))
        ok = (d <= ABS_TOL * magnitude) | (d <= REL_TOL * scale)
        assert ok.all(), f"max abs err {d.max()}"


def _random_complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("backend", ["xla", "matmul"])
@pytest.mark.parametrize("n", [2, 8, 64, 256, 1024, 4096])
def test_roundtrip_identity(rng, backend, n):
    """ifft(fft(x)) ≈ x — the reference's core invariant (fft_test.cpp:10-38)."""
    x = _random_complex(rng, (n,))
    y = ifft(fft(jnp.asarray(x), backend=backend), backend=backend)
    assert_ref_float_close(np.asarray(y), x)


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_matches_numpy_conventions(rng, backend):
    """Forward unscaled e^{-2πi}, inverse 1/N — fft.hpp:114, 197-204.

    numpy.fft uses identical conventions, so it is a direct oracle.
    """
    n = 128
    x = _random_complex(rng, (n,))
    got_f = np.asarray(fft(jnp.asarray(x), backend=backend))
    got_i = np.asarray(ifft(jnp.asarray(x), backend=backend))
    assert_ref_float_close(got_f, np.fft.fft(x), magnitude=np.sqrt(128))
    assert_ref_float_close(got_i, np.fft.ifft(x))


def test_backends_agree(rng):
    x = _random_complex(rng, (16, 512))
    a = np.asarray(fft(jnp.asarray(x), backend="xla"))
    b = np.asarray(fft(jnp.asarray(x), backend="matmul"))
    assert_ref_float_close(a, b, magnitude=np.sqrt(512))


@pytest.mark.parametrize("n", [3, 6, 100, 1000])
def test_non_power_of_two_rejected(n):
    """Trace-time twin of fft.hpp:91-92's std::expected error."""
    x = jnp.zeros((n,), jnp.complex64)
    with pytest.raises(ValueError, match="power"):
        fft(x)
    with pytest.raises(ValueError, match="power"):
        ifft(x)


def test_batched_shapes(rng):
    x = _random_complex(rng, (3, 5, 64))
    y = np.asarray(fft(jnp.asarray(x)))
    assert y.shape == x.shape
    assert_ref_float_close(y, np.fft.fft(x, axis=-1), magnitude=np.sqrt(64))


def test_matmul_fft_large_recursive(rng):
    """Sizes > 128 go through the four-step factorization (and recurse)."""
    x = _random_complex(rng, (4, 8192))
    got = np.asarray(matmul_fft(jnp.asarray(x)))
    assert_ref_float_close(got, np.fft.fft(x, axis=-1), magnitude=np.sqrt(8192))


def test_known_impulse():
    """FFT of a unit impulse is all-ones (textbook check, unscaled fwd)."""
    x = np.zeros(64, np.complex64)
    x[0] = 1.0
    for backend in ("xla", "matmul"):
        y = np.asarray(fft(jnp.asarray(x), backend=backend))
        assert_ref_float_close(y, np.ones(64, np.complex64))


@pytest.mark.parametrize("n", [12, 64, 4096])
def test_xla_ifft_matches_numpy(n, rng):
    """The forward-transform inverse (conj∘fft∘conj / N) equals numpy's
    ifft at any length, batched over leading axes."""
    from sdr_tpu.ops.fft import xla_ifft

    x = (rng.standard_normal((3, 2, n)) + 1j * rng.standard_normal((3, 2, n)))
    got = np.asarray(xla_ifft(jnp.asarray(x, jnp.complex64)))
    want = np.fft.ifft(x, axis=-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(x).max())
