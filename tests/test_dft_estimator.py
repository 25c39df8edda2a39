"""DFT (CP-subspace) channel estimation: exactness, denoising, link BER.

Transform-domain denoising of the comb-pilot LS estimate: invert the
pilot samples to the impulse response, keep only the cp_len+1 taps the
CP contract (reference ofdm.hpp:21) allows the channel to occupy, and
re-evaluate on the full grid — one precomputed matmul.
Beats LS + linear interpolation twice over: the interpolation is exact
for any in-CP channel, and out-of-subspace estimation noise is
discarded (error scales by ~n_taps/n_pilots).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
    link_config_from_dict,
    link_config_to_dict,
)
from sdr_tpu.link.pipeline import make_simulate_fn
from sdr_tpu.ops import channel as chan
from sdr_tpu.ops.pilots import (
    PILOT_VALUE,
    dft_n_taps,
    estimate_dft_comb,
    estimate_ls_comb,
    pilot_indices,
)


def _pilot_grid_observation(key, n_fft, spacing, n_sym, taps, nv):
    """Post-FFT grid y = H·X + noise with pilots inserted, plus genie H."""
    from sdr_tpu.ops.pilots import insert_pilots

    h = chan.freq_response(taps, n_fft)
    kd, kn = jax.random.split(key)
    # Random proper data on the data subcarriers.
    n_data = n_fft - len(pilot_indices(n_fft, spacing))
    x = chan.cgauss(kd, (n_sym, n_data))
    grid = insert_pilots(x, n_fft, spacing)
    y = grid * h[None, :] + chan.cgauss(kn, (n_sym, n_fft), var=nv)
    return y, h


def test_dft_estimate_exact_noiseless():
    """Any channel within the tap budget is reproduced EXACTLY on every
    subcarrier (linear interpolation is not exact between pilots)."""
    n_fft, spacing, L = 128, 4, 9
    taps = chan.multipath_taps(
        jax.random.PRNGKey(0), tuple(np.exp(-0.4 * np.arange(L)))
    )
    y, h = _pilot_grid_observation(
        jax.random.PRNGKey(1), n_fft, spacing, 8, taps, nv=0.0
    )
    n_taps = dft_n_taps(n_fft, 16, spacing)
    assert n_taps == 17 and n_taps >= L
    h_dft = np.asarray(estimate_dft_comb(y, spacing, n_taps))[0]
    h_ls = np.asarray(estimate_ls_comb(y, spacing))[0]
    np.testing.assert_allclose(h_dft, np.asarray(h), atol=2e-5)
    # The lerp estimator has real interpolation error on this channel.
    assert np.max(np.abs(h_ls - np.asarray(h))) > 1e-2


def test_dft_estimate_denoises():
    """At finite SNR the subspace projection cuts the estimation MSE by
    roughly n_taps/n_pilots vs per-pilot LS (here 17/32 ≈ −2.7 dB,
    plus the lerp's interpolation error on top)."""
    n_fft, spacing, L = 128, 4, 9
    taps = chan.multipath_taps(
        jax.random.PRNGKey(2), tuple(np.exp(-0.4 * np.arange(L)))
    )
    y, h = _pilot_grid_observation(
        jax.random.PRNGKey(3), n_fft, spacing, 4, taps, nv=0.05
    )
    n_taps = dft_n_taps(n_fft, 16, spacing)
    h_np = np.asarray(h)

    def mse(est):
        return float(np.mean(np.abs(np.asarray(est)[0] - h_np) ** 2))

    m_dft = mse(estimate_dft_comb(y, spacing, n_taps))
    m_ls = mse(estimate_ls_comb(y, spacing))
    assert m_dft < 0.75 * m_ls, (m_dft, m_ls)


def _cfg(estimator, ebno=10.0, **kw):
    return LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH,
            ebno_db=ebno,
            pdp=tuple(float(np.exp(-0.4 * i)) for i in range(9)),
            **kw,
        ),
        equalizer=Equalizer.MMSE,
        pilot_spacing=4,
        estimator=estimator,
        n_symbols=32,
        n_channels=64,
    )


def _ber(cfg, seed=7):
    res = make_simulate_fn(cfg)(jax.random.PRNGKey(seed))
    return float(np.asarray(res.bit_errors).sum()) / float(
        np.asarray(res.bits_counted).sum()
    )


def test_dft_link_beats_ls_and_nears_genie():
    """Estimated-CSI BER ordering on a 9-tap channel: DFT < LS, and DFT
    within 1.6x of genie CSI (same realizations)."""
    ber_dft = _ber(_cfg(ChannelEstimator.DFT))
    ber_ls = _ber(_cfg(ChannelEstimator.LS))
    genie = dataclasses.replace(
        _cfg(ChannelEstimator.LS), pilot_spacing=0,
        estimator=ChannelEstimator.LS,
    )
    ber_gen = _ber(genie)
    assert ber_dft < ber_ls, (ber_dft, ber_ls)
    assert ber_dft < 1.6 * ber_gen + 2e-4, (ber_dft, ber_gen)


def test_dft_composes_with_phase_tracking():
    """estimator=DFT under LO phase noise: the tracked estimator runs
    the DFT projection on the derotated grid; BER stays near the
    clean-LO DFT BER."""
    noisy = _ber(_cfg(ChannelEstimator.DFT, phase_noise_std=0.008))
    clean = _ber(_cfg(ChannelEstimator.DFT))
    assert noisy < 3.0 * clean + 2e-3, (noisy, clean)


def test_dft_per_symbol_time_varying():
    """estimator=DFT with RAYLEIGH_TIME uses per-symbol projection."""
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_TIME, ebno_db=14.0, doppler_norm=0.05
        ),
        equalizer=Equalizer.MMSE,
        pilot_spacing=4,
        estimator=ChannelEstimator.DFT,
        n_symbols=32,
        n_channels=64,
    )
    ber = _ber(cfg)
    genie = dataclasses.replace(cfg, pilot_spacing=0)
    ber_gen = _ber(genie)
    assert ber < 3.0 * ber_gen + 1e-3, (ber, ber_gen)


def test_estimator_json_round_trip():
    cfg = _cfg(ChannelEstimator.DFT)
    assert link_config_from_dict(link_config_to_dict(cfg)) == cfg
    # Legacy dicts without the key default to LS.
    d = link_config_to_dict(cfg)
    del d["estimator"]
    assert link_config_from_dict(d).estimator == ChannelEstimator.LS
