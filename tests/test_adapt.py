"""Link adaptation (link.adapt): calibrated thresholds + selection.

Validation: thresholds measured on the real coded chain are monotone
in efficiency, selection follows the greedy rule exactly, and the
adaptive link delivers more per subcarrier use at high SNR while
keeping BER at/below the calibration target.
"""

import dataclasses

import jax
import numpy as np
import pytest

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.adapt import (
    MCSThreshold,
    calibrate,
    ebno_from_esno,
    efficiency,
    esno_from_ebno,
    select_mcs,
    simulate_adaptive,
)

_BASE = LinkConfig(
    modulation=Modulation.QPSK,
    ofdm=OFDMConfig(n_fft=64, cp_len=16),
    channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
    equalizer=Equalizer.NONE,
    n_symbols=16,
    n_channels=8,
)

_LADDER = (
    (Modulation.QPSK, "1/2"),
    (Modulation.QPSK, "3/4"),
    (Modulation.QAM16, "1/2"),
    (Modulation.QAM16, "3/4"),
)


@pytest.fixture(scope="module")
def table():
    return calibrate(
        _BASE,
        jax.random.PRNGKey(0),
        target_ber=1e-3,
        esno_grid=np.arange(-2.0, 20.0, 2.0),
        ladder=_LADDER,
    )


def test_esno_ebno_roundtrip():
    for mod, rate in _LADDER:
        e = esno_from_ebno(7.0, mod, rate)
        np.testing.assert_allclose(ebno_from_esno(e, mod, rate), 7.0)
    assert efficiency(Modulation.QAM16, "3/4") == 3.0


def test_calibrated_thresholds_monotone(table):
    """More efficient rungs need more SNR; every rung met the target."""
    assert len(table) == len(_LADDER)
    effs = [t.efficiency for t in table]
    ths = [t.esno_db for t in table]
    assert effs == sorted(effs)
    for a, b in zip(ths, ths[1:]):
        assert b >= a, (ths)
    for t in table:
        assert t.measured_ber <= 1e-3


def test_select_mcs_greedy(table):
    """Selection picks the best feasible rung; margin shifts it down;
    hopeless SNR selects nothing."""
    top = max(t.efficiency for t in table)
    assert select_mcs(30.0, table).efficiency == top
    lowest = table[0]
    assert select_mcs(lowest.esno_db, table) is not None
    assert select_mcs(lowest.esno_db - 0.1, table) is None
    # A big margin at mid SNR selects a more robust rung than no margin.
    mid = table[-1].esno_db
    no_m = select_mcs(mid, table)
    with_m = select_mcs(mid, table, margin_db=6.0)
    assert with_m is None or with_m.efficiency <= no_m.efficiency


def test_adaptive_link_tracks_profile(table):
    """Low-SNR channels pick robust rungs (or silence), high-SNR pick
    dense ones; the aggregate BER stays near the calibration target and
    achieved efficiency grows with the profile."""
    lo = simulate_adaptive(
        _BASE, jax.random.PRNGKey(1), np.full(8, 4.0), table
    )
    hi = simulate_adaptive(
        _BASE, jax.random.PRNGKey(1), np.full(8, 18.0), table
    )
    assert hi["achieved_efficiency"] > 2.0 * lo["achieved_efficiency"]
    mixed = simulate_adaptive(
        _BASE,
        jax.random.PRNGKey(2),
        np.array([-6.0, 2.0, 6.0, 10.0, 14.0, 18.0, 18.0, 2.0]),
        table,
    )
    eff = mixed["efficiency_per_channel"]
    assert eff[0] == 0.0  # below the most robust threshold -> silent
    assert eff[5] >= eff[3] >= eff[1]
    total_ber = mixed["bit_errors"].sum() / max(mixed["info_bits"].sum(), 1)
    assert total_ber < 5e-3, total_ber


# ---------------------------------------------------------------------------
# Mixed-family ladder (v2): conv / LDPC / polar rungs coexist.

_MIXED_BASE = LinkConfig(
    modulation=Modulation.QPSK,
    ofdm=OFDMConfig(n_fft=128, cp_len=16),
    channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=10.0),
    equalizer=Equalizer.NONE,
    n_symbols=16,  # 4096-bit QPSK frame: fits one LDPC codeword
    n_channels=4,
)

_MIXED_LADDER = (
    (Modulation.QPSK, "conv", "1/2"),
    (Modulation.QPSK, "ldpc", "1/2"),
    (Modulation.QPSK, "polar", "1/2"),
)


@pytest.fixture(scope="module")
def mixed_table():
    return calibrate(
        _MIXED_BASE,
        jax.random.PRNGKey(3),
        target_ber=1e-3,
        esno_grid=np.arange(-2.0, 14.0, 1.0),
        ladder=_MIXED_LADDER,
    )


def test_mixed_family_calibration(mixed_table):
    """All three families calibrate on the same chain; the block codes
    (LDPC at nominal rate, polar despite its CRC overhead) must not be
    WEAKER than the conv rung — the ladder exists because they win."""
    fams = {t.family: t for t in mixed_table}
    assert set(fams) == {"conv", "ldpc", "polar"}
    assert fams["ldpc"].esno_db <= fams["conv"].esno_db
    assert fams["polar"].esno_db <= fams["conv"].esno_db + 1.0


def test_select_prefers_stronger_family_on_tie():
    """Equal-efficiency rungs: the lower calibrated threshold wins."""
    from sdr_tpu.link.adapt import MCSThreshold

    t_conv = MCSThreshold(Modulation.QPSK, "1/2", 1.0, 4.0, 1e-4, "conv")
    t_ldpc = MCSThreshold(Modulation.QPSK, "1/2", 1.0, 2.0, 1e-4, "ldpc")
    pick = select_mcs(10.0, [t_conv, t_ldpc])
    assert pick.family == "ldpc"
    # Below the LDPC threshold neither is feasible.
    assert select_mcs(1.0, [t_conv, t_ldpc]) is None


def test_adaptive_uses_block_codes_where_they_win(mixed_table):
    """Between the block-code and conv thresholds, the adaptive link
    must transmit with the stronger family (a mixed-family staircase),
    and report the family per channel."""
    ordered = sorted(mixed_table, key=lambda t: t.esno_db)
    best, runner_up = ordered[0], ordered[1]
    if best.family == "conv" or best.esno_db == runner_up.esno_db:
        pytest.skip("no SNR window where a block code wins alone")
    snr = (best.esno_db + runner_up.esno_db) / 2.0
    # All channels inside the window where ONLY the strongest family
    # clears its threshold.
    res = simulate_adaptive(
        _MIXED_BASE, jax.random.PRNGKey(4), np.full(4, snr), mixed_table
    )
    assert set(res["family_per_channel"]) == {best.family}


def test_dense_rungs_calibrate_and_extend_staircase():
    """Round-4 v3: 256/1024-QAM rungs calibrate at high SNR and rank
    above the QAM64 rungs — the staircase spans the full reference
    roster (modulation.hpp:13-14, 70-72)."""
    from sdr_tpu.link.adapt import DEFAULT_LADDER

    mods = {r[0] for r in DEFAULT_LADDER}
    assert Modulation.QAM256 in mods and Modulation.QAM1024 in mods
    dense = (
        (Modulation.QAM64, "conv", "3/4"),
        (Modulation.QAM256, "ldpc", "3/4"),
        (Modulation.QAM1024, "ldpc", "3/4"),
    )
    base = dataclasses.replace(_BASE, equalizer=Equalizer.NONE, n_symbols=32)
    tab = calibrate(
        base,
        jax.random.PRNGKey(1),
        target_ber=1e-3,
        esno_grid=np.arange(14.0, 37.0, 2.0),
        ladder=dense,
    )
    by_mod = {t.modulation: t for t in tab}
    assert Modulation.QAM256 in by_mod and Modulation.QAM1024 in by_mod
    assert (
        by_mod[Modulation.QAM64].esno_db
        < by_mod[Modulation.QAM256].esno_db
        < by_mod[Modulation.QAM1024].esno_db
    )
    assert (
        by_mod[Modulation.QAM64].efficiency
        < by_mod[Modulation.QAM256].efficiency
        < by_mod[Modulation.QAM1024].efficiency
    )


def test_waveform_dimension_flips_under_pa():
    """Under a low-backoff PA the SC-FDMA twin of a rung calibrates to
    a LOWER threshold than its OFDM twin (constant modulus ⇒ less
    clipping distortion), and the greedy tie-break therefore selects
    the SC-FDMA waveform — the round-4 ladder dimension."""
    from sdr_tpu.core.config import ChannelEstimator
    from sdr_tpu.link.adapt import waveform_ladder

    base = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.AWGN, ebno_db=10.0, pa_ibo_db=2.0
        ),
        equalizer=Equalizer.MMSE,
        pilot_spacing=8,
        estimator=ChannelEstimator.DFT,
        n_symbols=32,
        n_channels=16,
    )
    ladder = waveform_ladder(((Modulation.QAM16, "conv", "1/2"),))
    assert ladder == (
        (Modulation.QAM16, "conv", "1/2", "ofdm"),
        (Modulation.QAM16, "conv", "1/2", "scfdma"),
    )
    tab = calibrate(
        base,
        jax.random.PRNGKey(2),
        target_ber=1e-3,
        esno_grid=np.arange(5.0, 30.0, 1.0),
        ladder=ladder,
    )
    by_wave = {t.waveform: t for t in tab}
    assert "scfdma" in by_wave, tab
    if "ofdm" in by_wave:
        assert by_wave["scfdma"].esno_db < by_wave["ofdm"].esno_db, tab
    pick = select_mcs(30.0, tab)
    assert pick.waveform == "scfdma"
