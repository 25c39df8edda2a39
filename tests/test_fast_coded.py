"""Coded fast engine (link/fast_coded.py).

The throughput LDPC link: batched encode → TX → channel → LLR demod →
(de)interleave → min-sum decode (flooding or layered).
"""

from __future__ import annotations

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
from sdr_tpu.link.fast_coded import ldpc_fast_simulate


def _cfg(n_ch=128, n_syms=6, ebno=9.0, n_fft=128):
    return LinkConfig(
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=n_fft // 4),
        modulation=Modulation.QAM16,
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_FLAT, ebno_db=ebno
        ),
        equalizer=Equalizer.MMSE,
        n_channels=n_ch,
        n_symbols=n_syms,
    )


def test_noiseless_link_decodes_exactly():
    """Identity channel: every codeword decodes to its info bits."""
    cfg = LinkConfig(
        ofdm=OFDMConfig(n_fft=128, cp_len=32),
        modulation=Modulation.QAM16,
        channel=ChannelConfig(model=ChannelModel.IDENTITY, ebno_db=30.0),
        n_channels=4,
        n_symbols=6,
    )
    e, c = jax.jit(lambda k: ldpc_fast_simulate(cfg, k, iters=5))(
        jax.random.PRNGKey(1))
    assert int(np.asarray(e).sum()) == 0
    assert int(np.asarray(c).sum()) == 4 * 1536


def test_schedules_agree():
    """Layered x13 decodes the same link to about the error count of
    flooding x25 (same waterfall, half the iterations)."""
    cfg = _cfg()
    key = jax.random.PRNGKey(1)
    e_f, c = jax.jit(lambda k: ldpc_fast_simulate(cfg, k))(key)
    e_l, _ = jax.jit(
        lambda k: ldpc_fast_simulate(cfg, k, iters=13, schedule="layered")
    )(key)
    tot = int(np.asarray(c).sum())
    df, dl = int(np.asarray(e_f).sum()), int(np.asarray(e_l).sum())
    assert 0 < df < tot // 10
    assert abs(df - dl) <= max(64, df // 4)


def test_coded_beats_uncoded():
    """At the same Eb/N0 the coded link's info-bit BER is far below
    the uncoded fast link's. AWGN (not per-link flat fading, where a
    deep fade erases whole codewords regardless of the code)."""
    from sdr_tpu.link.fast import fast_simulate

    cfg = LinkConfig(
        ofdm=OFDMConfig(n_fft=128, cp_len=32),
        modulation=Modulation.QAM16,
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=6.0),
        equalizer=Equalizer.MMSE,
        n_channels=128,
        n_symbols=6,
    )
    key = jax.random.PRNGKey(2)
    e_c, c_c = jax.jit(lambda k: ldpc_fast_simulate(cfg, k))(key)
    ber_c = float(np.asarray(e_c).sum()) / float(np.asarray(c_c).sum())
    e_u, c_u = jax.jit(lambda k: fast_simulate(cfg, k))(key)
    ber_u = float(np.asarray(e_u).sum()) / float(np.asarray(c_u).sum())
    assert ber_c < ber_u / 3


def test_split_equals_full():
    """Global-channel-id keying: computing the batch in two parts is
    bit-exact vs one call (the sharding contract). Every draw is one
    threefry stream of (key, role, channel id) on every platform, so the
    split point need not be a multiple of anything: 40 + 88."""
    cfg = _cfg()
    key = jax.random.PRNGKey(3)
    e, _ = jax.jit(lambda k: ldpc_fast_simulate(cfg, k))(key)
    e_lo, _ = jax.jit(
        lambda k: ldpc_fast_simulate(cfg, k, ch_ids=jnp.arange(0, 40))
    )(key)
    e_hi, _ = jax.jit(
        lambda k: ldpc_fast_simulate(cfg, k, ch_ids=jnp.arange(40, 128))
    )(key)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(e_lo), np.asarray(e_hi)]), np.asarray(e)
    )


def test_layered_schedule_runs():
    cfg = _cfg()
    e, c = jax.jit(
        lambda k: ldpc_fast_simulate(cfg, k, iters=13, schedule="layered")
    )(jax.random.PRNGKey(4))
    assert 0 < int(np.asarray(e).sum()) < int(np.asarray(c).sum()) // 8


def test_unsupported_configs_raise():
    cfg = _cfg()
    bad = LinkConfig(
        ofdm=cfg.ofdm, modulation=cfg.modulation, channel=cfg.channel,
        equalizer=cfg.equalizer, n_channels=cfg.n_channels,
        n_symbols=cfg.n_symbols, dft_spread=True,
    )
    with pytest.raises(NotImplementedError):
        ldpc_fast_simulate(bad, jax.random.PRNGKey(0))


def test_sharded_coded_fast_bit_exact():
    """Sharded coded fast engine == unsharded, bit-exact (channel-DP
    over the batched coded chain; the coded analog of the fast-path
    sharding contract)."""
    from sdr_tpu.parallel import make_link_mesh, make_sharded_coded_fast_fn

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    cfg = _cfg(n_ch=8 * 16, n_syms=6)
    mesh = make_link_mesh(2, 4)
    key = jax.random.PRNGKey(5)
    e_sh, c_sh = make_sharded_coded_fast_fn(cfg, mesh)(key)
    e_un, _ = jax.jit(lambda k: ldpc_fast_simulate(cfg, k))(key)
    np.testing.assert_array_equal(np.asarray(e_sh), np.asarray(e_un))
    assert int(np.asarray(c_sh).sum()) > 0
