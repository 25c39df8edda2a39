"""Fast batched link (link.fast) — statistical and parity checks."""

import numpy as np
import jax
import pytest

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.ber import ber_awgn_exact
from sdr_tpu.link.fast import fast_simulate, make_fast_fn


def _ber(errors, counted) -> float:
    return float(np.asarray(errors).sum()) / float(np.asarray(counted).sum())


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16])
def test_fast_awgn_ber_matches_theory(mod):
    cfg = LinkConfig(
        modulation=mod,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=6.0),
        n_symbols=32,
        n_channels=16,
    )
    errors, counted = make_fast_fn(cfg)(jax.random.PRNGKey(0))
    ber = _ber(errors, counted)
    th = ber_awgn_exact(mod, 6.0)
    assert 0.85 * th < ber < 1.15 * th  # ~65k+ bits, loose statistical gate


def test_fast_rician_ber_matches_theory():
    from sdr_tpu.link.ber import ber_rician_exact

    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.RICIAN, ebno_db=8.0, k_factor=4.0
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=4,
        n_channels=2048,  # fades are the statistical unit, not bits
    )
    errors, counted = make_fast_fn(cfg)(jax.random.PRNGKey(0))
    ber = _ber(errors, counted)
    th = ber_rician_exact(Modulation.QAM16, 8.0, 4.0)
    assert 0.88 * th < ber < 1.12 * th


def test_fast_identity_is_error_free():
    cfg = LinkConfig(
        modulation=Modulation.QAM64,
        ofdm=OFDMConfig(n_fft=128, cp_len=32),
        channel=ChannelConfig(model=ChannelModel.IDENTITY),
        n_symbols=8,
        n_channels=4,
    )
    errors, counted = fast_simulate(cfg, jax.random.PRNGKey(1))
    assert int(np.asarray(errors).sum()) == 0
    assert int(np.asarray(counted).sum()) == cfg.bits_total


def test_fast_multipath_mmse_decodes_at_high_snr():
    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=30.0, pdp=(1.0, 0.4, 0.2)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=16,
        n_channels=8,
    )
    errors, counted = fast_simulate(cfg, jax.random.PRNGKey(2))
    # CP >= delay spread + one-tap MMSE at 30 dB: essentially error-free
    # up to deep per-channel fades; allow a small residue.
    assert _ber(errors, counted) < 5e-3


def test_fast_counts_match_numpy_demod():
    """The engine's error counts == the float64 numpy receiver's
    decisions on the engine's own TX + channel output (up to reference
    LLRs at the float32 decision margin)."""
    import _np_ref

    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=128, cp_len=32),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
        n_symbols=8,
        n_channels=2,
    )
    key = jax.random.PRNGKey(3)
    e, c = fast_simulate(cfg, key)
    want, margin = _np_ref.fast_engine_counts(cfg, key)
    assert np.all(np.abs(np.asarray(e) - want) <= margin)
    assert int(np.sum(c)) == 2 * 8 * 128 * 4


def test_fast_rayleigh_time_is_fading_not_awgn():
    """Regression: a Doppler config on the fast path used to fall
    through to AWGN silently. The fast path must now produce Rayleigh
    fading BER — statistically equal to pipeline.simulate's (same
    model, independent PRNG streams) and far above the AWGN theory
    level at the same Eb/N0."""
    from sdr_tpu.link.pipeline import simulate

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(n_fft=64, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_TIME, ebno_db=10.0, doppler_norm=0.05
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=32,
        n_channels=256,  # BER variance is fading-realization-dominated
    )
    e_f, c_f = fast_simulate(cfg, jax.random.PRNGKey(5))
    ber_fast = _ber(e_f, c_f)
    res = simulate(cfg, jax.random.PRNGKey(7))
    ber_pipe = _ber(res.bit_errors, res.bits_counted)
    # Each run averages ~256 independent Jakes realizations whose deep
    # fades dominate the BER; the ratio of two such averages needs a
    # generous band even at this sample size.
    assert 0.6 * ber_pipe < ber_fast < 1.6 * ber_pipe
    # Rayleigh @ 10 dB QPSK is ~2e-2; AWGN theory is ~4e-6.
    assert ber_fast > 100 * ber_awgn_exact(Modulation.QPSK, 10.0)


def test_fast_rayleigh_time_counts_match_numpy_demod():
    """Per-symbol h planes: counts == the numpy receiver's decisions."""
    import _np_ref

    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=128, cp_len=32),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_TIME, ebno_db=12.0, doppler_norm=0.02
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=8,
        n_channels=2,
    )
    key = jax.random.PRNGKey(6)
    e, _ = fast_simulate(cfg, key)
    want, margin = _np_ref.fast_engine_counts(cfg, key)
    assert np.all(np.abs(np.asarray(e) - want) <= margin)


def test_fast_scfdma_full_grid():
    """Round 3: full-grid SC-FDMA runs on the THROUGHPUT engine.

    The precode and IFFT cancel (single-carrier with CP), so TX is a
    scale + CP concat and RX is SC-FDE (per-tone equalize + IDFT). On
    AWGN the SC-FDE link sits on the same exact theory as OFDM; under
    multipath it runs the same bias-corrected MMSE-FDE receiver the
    pipeline uses."""
    from sdr_tpu.link.ber import ber_awgn_exact

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=6.0),
        equalizer=Equalizer.MMSE,
        n_symbols=32,
        n_channels=256,
        dft_spread=True,
    )
    e, c = fast_simulate(cfg, jax.random.PRNGKey(3))
    ber = float(np.asarray(e).sum()) / float(np.asarray(c).sum())
    th = ber_awgn_exact(Modulation.QPSK, 6.0)
    assert 0.85 * th < ber < 1.15 * th, (ber, th)
    # Block-pilot SC-FDMA still routes to the pipeline.
    import dataclasses
    import pytest as _pytest

    piloted = dataclasses.replace(cfg, pilot_spacing=8)
    with _pytest.raises(NotImplementedError):
        fast_simulate(piloted, jax.random.PRNGKey(0))


def test_fast_scfdma_sharded_bit_exact():
    """The SC-FDMA fast path under channel DP: bit-exact vs unsharded
    (the same global-channel-id keying invariant as OFDM)."""
    from sdr_tpu.parallel import make_link_mesh, make_sharded_fast_fn

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=10.0, pdp=(1.0, 0.3)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=8,
        n_channels=8,
        dft_spread=True,
    )
    import functools

    key = jax.random.PRNGKey(11)
    mesh = make_link_mesh(1, 4, devices=jax.devices()[:4])
    e_sh, _ = make_sharded_fast_fn(cfg, mesh)(key)
    e_ref, _ = jax.jit(functools.partial(fast_simulate, cfg))(key)
    np.testing.assert_array_equal(np.asarray(e_sh), np.asarray(e_ref))
