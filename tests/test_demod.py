"""The receive chain (ops.demod) against a float64 numpy reference.

One implementation, compiled by XLA: CP strip → FFT → MMSE → max-log
LLR, with the count and reduce_sum terminals. Each case builds a real
link (Gray map → IDFT + CP → channel → noise) in numpy, demodulates it
with the library and with tests/_np_ref.py, and compares:

- LLRs to float32 accuracy relative to the largest LLR;
- hard decisions exactly, except where the reference LLR is within that
  tolerance of zero (a float32 chain may flip those);
- error counts from the count terminal equal counts taken on the
  library's own LLRs.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import _np_ref as ref
from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.channel import ebno_db_to_noise_var
from sdr_tpu.ops.demod import demod_chain, demod_count_chain

TOL = 2e-5  # of max|LLR|: float32 FFT + arithmetic vs float64


def _link(rng, mod, n_fft, cp, h_layout, batch=2, n_syms=3, ebno=10.0,
          despread=False):
    """Transmitted indices, received planar samples and channel plane."""
    bps = mod.bits_per_symbol
    nv = float(ebno_db_to_noise_var(ebno, bps))
    idx = rng.integers(0, 1 << bps, (batch, n_syms, n_fft))
    pts = ref.constellation(mod)[idx]
    if despread:  # full-grid SC-FDMA: the waveform is the symbol stream
        x = pts / np.sqrt(n_fft)
        x = np.concatenate([x[..., n_fft - cp:], x], axis=-1)
    else:
        x = ref.ofdm_tx(pts, cp)
    h_shape = {
        "link": (batch, 1, n_fft),
        "symbol": (batch, n_syms, n_fft),
        "flat": (batch, 1, 1),
    }[h_layout]
    h = (rng.standard_normal(h_shape) + 1j * rng.standard_normal(h_shape))
    h = h * np.sqrt(0.5)
    # Per-subcarrier response applied in the frequency domain: the
    # circulant channel a CP longer than the delay spread produces.
    xf = np.fft.fft(x[..., cp:], axis=-1) * h
    xt = np.fft.ifft(xf, axis=-1)
    y = np.concatenate([xt[..., n_fft - cp:], xt], axis=-1)
    noise = (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    y = y + noise * np.sqrt(nv / n_fft / 2)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    return (idx, nv, f32(y.real), f32(y.imag),
            f32(np.real(h)), f32(np.imag(h)))


def _check_llrs(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    decided = np.abs(want) > TOL * scale
    assert np.array_equal((got < 0)[decided], (want < 0)[decided])


@pytest.mark.parametrize("h_layout", ["link", "symbol"])
@pytest.mark.parametrize(
    "mod,n_fft,cp",
    [
        (Modulation.BPSK, 64, 16),
        (Modulation.QPSK, 128, 32),
        (Modulation.QAM16, 256, 64),
        (Modulation.QAM64, 256, 16),
        (Modulation.QAM256, 512, 128),
        (Modulation.QAM1024, 128, 32),
        (Modulation.QPSK, 1024, 128),
        (Modulation.QAM16, 2048, 256),
        (Modulation.QAM16, 4096, 512),
    ],
)
def test_llrs_match_numpy(rng, mod, n_fft, cp, h_layout):
    idx, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, h_layout)
    got = demod_chain(re, im, hr, hi, cp, mod, nv)
    assert got.shape == (2, 3, n_fft * mod.bits_per_symbol)
    assert got.dtype == jnp.float32
    _check_llrs(got, ref.demod(re, im, hr, hi, cp, mod, nv))


def test_flat_channel_broadcasts(rng):
    """A (batch, 1, 1) channel plane broadcasts over the grid."""
    mod, n_fft, cp = Modulation.QAM16, 256, 64
    idx, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, "flat")
    got = demod_chain(re, im, hr, hi, cp, mod, nv)
    _check_llrs(got, ref.demod(re, im, hr, hi, cp, mod, nv))


@pytest.mark.parametrize(
    "mod",
    [Modulation.BPSK, Modulation.QPSK, Modulation.QAM16, Modulation.QAM64,
     Modulation.QAM256, Modulation.QAM1024],
)
def test_count_matches_numpy_decisions(rng, mod):
    """The count terminal == bit errors of the reference hard decisions
    (up to reference LLRs at the float32 decision margin)."""
    n_fft, cp = 256, 64
    idx, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, "link", ebno=6.0)
    got = np.asarray(demod_count_chain(
        re, im, hr, hi, jnp.asarray(idx, jnp.int32), cp, mod, nv))
    want_llr = ref.demod(re, im, hr, hi, cp, mod, nv)
    bits = ref.bits_of(idx, mod.bits_per_symbol)
    want = ((want_llr < 0) != bits).sum(axis=(1, 2))
    margin = (np.abs(want_llr) < TOL * np.abs(want_llr).max()).sum((1, 2))
    assert got.dtype == np.int32 and got.shape == (2,)
    assert np.all(np.abs(got - want) <= margin)
    assert want.sum() > 0  # the case has errors to count


def test_count_equals_counting_own_llrs(rng):
    """Decision-identical terminals: count == sign errors of the LLRs."""
    mod, n_fft, cp = Modulation.QAM16, 512, 64
    idx, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, "symbol", ebno=6.0)
    llr = np.asarray(demod_chain(re, im, hr, hi, cp, mod, nv))
    bits = ref.bits_of(idx, mod.bits_per_symbol)
    got = demod_count_chain(re, im, hr, hi, jnp.asarray(idx), cp, mod, nv)
    np.testing.assert_array_equal(
        np.asarray(got), ((llr < 0) != bits).sum(axis=(1, 2))
    )


@pytest.mark.parametrize("n_fft,cp", [(256, 64), (4096, 512)])
def test_reduce_sum_matches_full(rng, n_fft, cp):
    mod = Modulation.QAM16
    _, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, "link")
    full = np.asarray(demod_chain(re, im, hr, hi, cp, mod, nv), np.float64)
    red = float(demod_chain(re, im, hr, hi, cp, mod, nv, reduce_sum=True))
    assert abs(red - full.sum()) <= 1e-5 * np.abs(full).sum()


def test_noiseless_flat_link_decodes_exactly(rng):
    """Zero noise through a unit channel: every decision is right."""
    mod, n_fft, cp = Modulation.QAM64, 256, 32
    idx = rng.integers(0, 64, (2, 4, n_fft))
    x = ref.ofdm_tx(ref.constellation(mod)[idx], cp)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ones = jnp.ones((2, 1, n_fft), jnp.float32)
    errs = demod_count_chain(f32(x.real), f32(x.imag), ones, 0 * ones,
                             jnp.asarray(idx), cp, mod, 1e-6)
    np.testing.assert_array_equal(np.asarray(errs), [0, 0])


@pytest.mark.parametrize(
    "mod,n_fft,cp",
    [(Modulation.QPSK, 64, 16), (Modulation.QAM16, 256, 64),
     (Modulation.QAM64, 1024, 128)],
)
def test_scfde_llrs_match_numpy(rng, mod, n_fft, cp):
    """SC-FDE receive (despread=True) against the numpy MMSE-FDE."""
    idx, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, "link",
                                    despread=True)
    got = demod_chain(re, im, hr, hi, cp, mod, nv, despread=True)
    _check_llrs(got, ref.demod(re, im, hr, hi, cp, mod, nv, despread=True))


def test_scfde_count_matches_numpy(rng):
    mod, n_fft, cp = Modulation.QAM16, 256, 64
    idx, nv, re, im, hr, hi = _link(rng, mod, n_fft, cp, "link", ebno=8.0,
                                    despread=True)
    got = np.asarray(demod_count_chain(
        re, im, hr, hi, jnp.asarray(idx), cp, mod, nv, despread=True))
    want_llr = ref.demod(re, im, hr, hi, cp, mod, nv, despread=True)
    want = ((want_llr < 0) != ref.bits_of(idx, 4)).sum(axis=(1, 2))
    margin = (np.abs(want_llr) < TOL * np.abs(want_llr).max()).sum((1, 2))
    assert np.all(np.abs(got - want) <= margin)
