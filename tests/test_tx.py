"""The fast engine's TX stage (link.fast._tx) against float64 numpy:
Gray map → 1/N-scaled IDFT → cyclic prefix, per modulation, n_fft and
CP, and the full-grid SC-FDMA waveform (DFT precode and IDFT cancel:
the constellation sequence itself, scaled by N^-1/2, plus its CP)."""

import numpy as np
import jax.numpy as jnp
import pytest

import _np_ref as ref
from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.fast import _tx


def _cfg(mod, n_fft, cp, dft_spread=False):
    return LinkConfig(
        modulation=mod,
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
        n_symbols=3,
        n_channels=2,
        dft_spread=dft_spread,
    )


@pytest.mark.parametrize(
    "mod,n_fft,cp",
    [
        (Modulation.BPSK, 64, 16),
        (Modulation.QPSK, 128, 32),
        (Modulation.QAM16, 256, 64),
        (Modulation.QAM64, 128, 0),
        (Modulation.QAM256, 512, 128),
        (Modulation.QAM1024, 128, 32),
        (Modulation.QPSK, 1024, 128),
        (Modulation.QAM16, 2048, 256),
        (Modulation.QAM16, 4096, 512),
    ],
)
def test_ofdm_tx_matches_numpy(rng, mod, n_fft, cp):
    idx = rng.integers(0, 1 << mod.bits_per_symbol, (2, 3, n_fft))
    re, im = _tx(_cfg(mod, n_fft, cp), jnp.asarray(idx, jnp.int32))
    want = ref.ofdm_tx(ref.constellation(mod)[idx], cp)
    assert re.shape == im.shape == (2, 3, n_fft + cp)
    assert re.dtype == jnp.float32
    got = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    # Unit-energy points → time samples of RMS N^-1/2; float32 IDFT.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize(
    "mod,n_fft,cp",
    [(Modulation.QPSK, 64, 16), (Modulation.QAM16, 256, 64),
     (Modulation.QAM16, 4096, 512)],
)
def test_scfdma_tx_matches_numpy(rng, mod, n_fft, cp):
    idx = rng.integers(0, 1 << mod.bits_per_symbol, (2, 3, n_fft))
    re, im = _tx(_cfg(mod, n_fft, cp, dft_spread=True), jnp.asarray(idx))
    pts = ref.constellation(mod)[idx] / np.sqrt(n_fft)
    want = np.concatenate([pts[..., n_fft - cp:], pts], axis=-1)
    got = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_cp_is_tail_copy(rng):
    mod, n_fft, cp = Modulation.QAM16, 256, 64
    idx = rng.integers(0, 16, (2, 3, n_fft))
    re, im = _tx(_cfg(mod, n_fft, cp), jnp.asarray(idx))
    re, im = np.asarray(re), np.asarray(im)
    np.testing.assert_array_equal(re[..., :cp], re[..., -cp:])
    np.testing.assert_array_equal(im[..., :cp], im[..., -cp:])
