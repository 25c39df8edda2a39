"""PA nonlinearity (ops.pa) and DFT-spread OFDM (SC-FDMA) tests.

Physics being asserted, not just plumbing:
- the Rapp AM/AM and its exact inverse (DPD) cascade to an ideal
  peak limiter;
- DFT spreading collapses the OFDM waveform's PAPR (for full-grid QPSK
  the Nyquist-rate waveform is constant-modulus — PAPR ≈ 0 dB);
- BER is unchanged by the unitary precode in AWGN (exact theory);
- PA backoff trades efficiency against a distortion floor: deep
  backoff reproduces the linear link, hard compression destroys it,
  predistortion recovers most of the loss, and the single-carrier
  waveform tolerates a given backoff far better than OFDM — the
  reason SC-FDMA exists.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.ber import ber_awgn_exact
from sdr_tpu.link.pipeline import generate_bits, make_simulate_fn, tx_chain
from sdr_tpu.ops import pa
from sdr_tpu.obs.waveform import papr_db


def _run(cfg, seed=0):
    res = make_simulate_fn(cfg)(jax.random.PRNGKey(seed))
    return int(np.sum(np.asarray(res.bit_errors))), int(
        np.sum(np.asarray(res.bits_counted))
    )


def test_rapp_am_am_properties():
    sat, p = 1.0, 2.0
    r = jnp.linspace(0.0, 5.0, 256)
    x = r.astype(jnp.complex64)
    g = jnp.abs(pa.apply_rapp(x, sat, p))
    g = np.asarray(g)
    # Small-signal: unit gain.
    assert abs(g[1] / float(r[1]) - 1.0) < 1e-3
    # Large-signal: saturates at A_sat from below.
    assert g[-1] < sat + 1e-6 and g[-1] > 0.95 * sat
    # Monotone non-decreasing output amplitude.
    assert np.all(np.diff(g) >= -1e-7)
    # Phase is preserved (no AM/PM).
    xc = jnp.asarray([0.5 + 0.5j, -1.0 + 2.0j], jnp.complex64)
    yc = pa.apply_rapp(xc, sat, p)
    assert np.allclose(np.angle(np.asarray(yc)), np.angle(np.asarray(xc)), atol=1e-6)


def test_dpd_cascade_is_ideal_limiter():
    sat, p = 0.7, 2.0
    rng = np.random.default_rng(3)
    x = (rng.normal(size=512) + 1j * rng.normal(size=512)).astype(np.complex64) * 0.3
    y = pa.apply_rapp(pa.rapp_predistort(jnp.asarray(x), sat, p), sat, p)
    y = np.asarray(y)
    a = np.abs(x)
    below = a <= 0.99 * sat * 0.999
    # Exact pass-through below the clip point...
    assert np.max(np.abs(y[below] - x[below])) < 2e-3
    # ...and a pure amplitude clip (phase kept) above it.
    above = a > 0.99 * sat
    if np.any(above):
        assert np.allclose(np.abs(y[above]), 0.99 * sat, atol=2e-3)
        assert np.allclose(np.angle(y[above]), np.angle(x[above]), atol=1e-3)


def test_dft_spread_qpsk_waveform_is_constant_modulus():
    """Full-grid QPSK SC-FDMA at Nyquist sampling: the spread-DFT and the
    OFDM IFFT cancel (both over n_fft), leaving the constant-modulus
    QPSK points as time samples — PAPR of the data part ≈ 0 dB, vs
    ~8-11 dB for plain OFDM."""
    cfg_ofdm = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(256, 0),
        n_symbols=64,
    )
    cfg_sc = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(256, 0),
        n_symbols=64,
        dft_spread=True,
    )
    key = jax.random.PRNGKey(7)
    bits = generate_bits(cfg_ofdm, key)
    p_ofdm = np.asarray(papr_db(tx_chain(cfg_ofdm, bits)))
    p_sc = np.asarray(papr_db(tx_chain(cfg_sc, bits)))
    assert np.max(p_sc) < 0.1  # constant modulus
    assert np.percentile(p_ofdm, 50) > 6.0
    # TX power is untouched by the unitary precode.
    tx_o = np.asarray(tx_chain(cfg_ofdm, bits))
    tx_s = np.asarray(tx_chain(cfg_sc, bits))
    assert math.isclose(
        float(np.mean(np.abs(tx_o) ** 2)),
        float(np.mean(np.abs(tx_s) ** 2)),
        rel_tol=1e-5,
    )


def test_dft_spread_awgn_ber_matches_exact_theory():
    """The unitary precode must not move the AWGN BER (16-QAM, exact
    Cho-Yoon curve, Poisson 4-sigma band)."""
    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(256, 64),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
        n_symbols=32,
        n_channels=8,
        dft_spread=True,
    )
    errors, total = _run(cfg)
    p = ber_awgn_exact(Modulation.QAM16, 8.0)
    expect = p * total
    assert abs(errors - expect) <= 4.0 * math.sqrt(expect) + 2.0


def test_dft_spread_block_pilots_track_genie_over_multipath():
    """The Zadoff-Chu block-pilot estimate (time-multiplexed, LTE-style)
    decodes a frequency-selective channel close to genie CSI.

    (Uncoded SC-FDMA is legitimately WORSE than uncoded OFDM over
    selective fades — MMSE-FDE smears each deep-fade tone's damage
    across every despread symbol instead of concentrating it; its wins
    are the PA test below and coded operation — so the comparison here
    is estimated-vs-genie on the SAME waveform, not SC-vs-OFDM.)"""
    from sdr_tpu.core.config import ChannelEstimator

    common = dict(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(128, 16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH,
            ebno_db=12.0,
            pdp=(1.0, 0.5, 0.25),
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=32,
        n_channels=48,
        dft_spread=True,
    )
    e_est, t_est = _run(
        LinkConfig(
            pilot_spacing=8, estimator=ChannelEstimator.DFT, **common
        )
    )
    e_gen, t_gen = _run(LinkConfig(pilot_spacing=0, **common))
    # Equal payload REs by construction here: 28 full-grid data symbols
    # (4 of 32 spent on pilots) vs 32 symbols — scale genie's count.
    assert e_est / t_est < 1.6 * max(e_gen / t_gen, 1e-6)


def test_pa_deep_backoff_is_linear_and_compression_bites():
    """IBO 20 dB ≈ the PA-less link; IBO 0 dB is far worse."""
    def cfg_at(ibo):
        return LinkConfig(
            modulation=Modulation.QAM16,
            ofdm=OFDMConfig(128, 16),
            channel=ChannelConfig(
                model=ChannelModel.AWGN, ebno_db=10.0, pa_ibo_db=ibo
            ),
            equalizer=Equalizer.MMSE,
            pilot_spacing=8,
            n_symbols=32,
            n_channels=32,
        )

    e_lin, t = _run(
        LinkConfig(
            modulation=Modulation.QAM16,
            ofdm=OFDMConfig(128, 16),
            channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
            equalizer=Equalizer.MMSE,
            pilot_spacing=8,
            n_symbols=32,
            n_channels=32,
        )
    )
    e_deep, _ = _run(cfg_at(20.0))
    e_hard, _ = _run(cfg_at(0.0))
    # Deep backoff: within the Poisson band of the linear link's count.
    assert abs(e_deep - e_lin) <= 4.0 * math.sqrt(max(e_lin, 1)) + 10.0
    # Hard compression: a distortion floor far above it.
    assert e_hard > 5 * max(e_lin, 1)


def test_dpd_recovers_moderate_backoff():
    """At a moderate IBO the Rapp compression distorts the whole
    constellation; ideal DPD converts it to rare peak clipping."""
    def cfg_at(dpd):
        return LinkConfig(
            modulation=Modulation.QAM16,
            ofdm=OFDMConfig(128, 16),
            channel=ChannelConfig(
                model=ChannelModel.AWGN,
                ebno_db=10.0,
                pa_ibo_db=5.0,
                pa_dpd=dpd,
            ),
            equalizer=Equalizer.MMSE,
            pilot_spacing=8,
            n_symbols=32,
            n_channels=32,
        )

    e_raw, _ = _run(cfg_at(False))
    e_dpd, _ = _run(cfg_at(True))
    assert e_dpd < e_raw


def test_scfdma_tolerates_pa_backoff_ofdm_cannot():
    """The reason SC-FDMA exists: at a low IBO the near-constant-modulus
    spread waveform sails through the PA while OFDM's peaks clip."""
    def cfg_at(spread):
        return LinkConfig(
            modulation=Modulation.QPSK,
            ofdm=OFDMConfig(128, 16),
            channel=ChannelConfig(
                model=ChannelModel.AWGN, ebno_db=9.0, pa_ibo_db=3.0
            ),
            equalizer=Equalizer.MMSE,
            pilot_spacing=8,
            n_symbols=32,
            n_channels=32,
            dft_spread=spread,
        )

    e_sc, _ = _run(cfg_at(True))
    e_of, _ = _run(cfg_at(False))
    assert e_sc < e_of


def test_pa_composes_with_blind_acquisition():
    """Delay + CFO + PA in one link: the S&C metric survives the
    memoryless nonlinearity and the link still decodes."""
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(128, 32),
        channel=ChannelConfig(
            model=ChannelModel.AWGN,
            ebno_db=12.0,
            cfo_subcarriers=1.7,
            timing_offset=41,
            pa_ibo_db=6.0,
        ),
        equalizer=Equalizer.MMSE,
        pilot_spacing=8,
        n_symbols=16,
        n_channels=8,
    )
    errors, total = _run(cfg)
    assert errors / total < 5e-3


def test_pa_composes_with_mimo():
    """Round-3 gate removal: one Rapp PA per TX antenna. The preamble
    radiates a PN QPSK grid at the per-antenna DATA power in PA mode
    (a constant grid is a time impulse the PA clips; matched envelope
    statistics give the pilot the same Bussgang gain the data sees),
    and the per-pair LS absorbs the common compression — so a 2x2
    Alamouti link with an 8 dB-backoff PA stays within a small factor
    of the PA-free link, and DPD at 4 dB matches 6 dB without.
    Genie CSI (no amplifier knowledge) stays rejected."""
    from sdr_tpu.core.config import MIMOConfig, MIMOScheme
    from sdr_tpu.link.pipeline import make_simulate_fn

    def mk(ibo=None, dpd=False):
        return LinkConfig(
            modulation=Modulation.QPSK,
            ofdm=OFDMConfig(64, 16),
            channel=ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0,
                pa_ibo_db=ibo, pa_dpd=dpd,
            ),
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
            equalizer=Equalizer.MMSE,
            n_symbols=16,
            n_channels=512,
        )

    def ber(cfg):
        r = make_simulate_fn(cfg)(jax.random.PRNGKey(2))
        import numpy as np

        return float(np.asarray(r.bit_errors).sum()) / float(
            np.asarray(r.bits_counted).sum()
        )

    b_lin = ber(mk())
    b_pa8 = ber(mk(8.0))
    b_dpd4 = ber(mk(4.0, True))
    # Measured: 1.2e-3 / 4.0e-3 / 4.6e-3 — the residual is the PA's
    # in-band clipping distortion, not estimator bias (which read
    # ~100x worse with the impulse preamble).
    assert b_pa8 < 6.0 * max(b_lin, 1e-4), (b_pa8, b_lin)
    assert b_dpd4 < 8.0 * max(b_lin, 1e-4), (b_dpd4, b_lin)
    with pytest.raises(ValueError, match="preamble"):
        LinkConfig(
            modulation=Modulation.QPSK,
            ofdm=OFDMConfig(64, 16),
            channel=ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0,
                pa_ibo_db=6.0,
            ),
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="genie"),
            n_symbols=16,
        )


def test_pa_and_spread_config_gates():
    with pytest.raises(ValueError, match="pilot_spacing"):
        LinkConfig(
            channel=ChannelConfig(model=ChannelModel.AWGN, pa_ibo_db=6.0)
        )
    with pytest.raises(ValueError, match="pa_dpd"):
        ChannelConfig(pa_dpd=True)
    with pytest.raises(ValueError, match="pa_ibo_db"):
        ChannelConfig(pa_ibo_db=99.0)

    from sdr_tpu.link.fast import fast_simulate
    from sdr_tpu.link.stream import stream_simulate
    from sdr_tpu.link.mc import mc_simulate
    from sdr_tpu.link.mc import supported

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(128, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
        n_symbols=8,
        n_channels=8,
        dft_spread=True,
    )
    # FULL-GRID SC-FDMA runs on EVERY engine — fast (SC-FDE receive),
    # stream (per-symbol spread/despread, seams untouched), and MC.
    e, c = fast_simulate(cfg, jax.random.PRNGKey(0))
    assert int(np.asarray(c).sum()) == cfg.bits_total
    e2, c2 = stream_simulate(cfg, jax.random.PRNGKey(0), n_blocks=2)
    assert np.asarray(e2).shape == (cfg.n_channels,)
    assert supported(cfg)
    import dataclasses

    wide = dataclasses.replace(
        cfg, ofdm=OFDMConfig(4096, 512), n_symbols=8
    )
    # Wideband SC-FDMA runs on MC too: it is the fast engine per pass.
    assert supported(wide)
    e3, c3 = mc_simulate(wide, seed=1)
    assert int(np.asarray(c3).sum()) == (
        wide.n_channels * wide.n_symbols * 4096 * 2
    )


def test_config_dict_round_trip_new_fields():
    from sdr_tpu.core.config import link_config_from_dict, link_config_to_dict

    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(128, 16),
        channel=ChannelConfig(
            model=ChannelModel.AWGN,
            ebno_db=9.0,
            pa_ibo_db=5.5,
            pa_smoothness=3.0,
            pa_dpd=True,
        ),
        equalizer=Equalizer.MMSE,
        pilot_spacing=8,
        dft_spread=True,
    )
    assert link_config_from_dict(link_config_to_dict(cfg)) == cfg
