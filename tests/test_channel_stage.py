"""The fast engine's channel stage (link.fast.apply_channel_fast).

- Fading, FIR and noise arithmetic against float64 numpy, with the
  fading state and noise recomputed from the same (key, role, channel
  id) draws.
- Noise and fading statistics.
- The single RNG stream: every draw is a pure function of (key, role,
  global channel id), so running any split of the channel batch —
  including shard sizes that are not a multiple of 128 — reproduces the
  full batch bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.fast import (
    _fade_state,
    _role_keys,
    apply_channel_fast,
    fast_core,
    tx_channel_core,
)
from sdr_tpu.ops.channel import cgauss


def _cfg(model, n_channels=4, n_symbols=3, n_fft=64, cp=16, ebno=8.0):
    return LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
        channel=ChannelConfig(
            model=model,
            ebno_db=ebno,
            pdp=(1.0, 0.5, 0.25)
            if model in (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME)
            else (1.0,),
            doppler_norm=0.05,
            k_factor=3.0,
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=n_symbols,
        n_channels=n_channels,
    )


def _wave(rng, cfg):
    shape = (cfg.n_channels, cfg.n_symbols, cfg.ofdm.symbol_len)
    re = rng.standard_normal(shape).astype(np.float32) * 0.1
    im = rng.standard_normal(shape).astype(np.float32) * 0.1
    return jnp.asarray(re), jnp.asarray(im)


def _noise(cfg, key, ids, shape):
    """The stage's noise, redrawn from its keys: CN(0, nv/N)."""
    _, k_noise, _ = _role_keys(key, ids)
    bps = cfg.modulation.bits_per_symbol
    tvar = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * bps) / cfg.ofdm.n_fft
    n = jax.vmap(lambda k: cgauss(k, shape[1:]))(k_noise)
    return np.asarray(n, np.complex128) * np.sqrt(np.float32(tvar))


@pytest.mark.parametrize(
    "model",
    [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT, ChannelModel.RICIAN,
     ChannelModel.RAYLEIGH_TIME],
)
def test_flat_models_match_numpy(rng, model):
    cfg = _cfg(model)
    key, ids = jax.random.PRNGKey(1), jnp.arange(cfg.n_channels)
    re, im = _wave(rng, cfg)
    yr, yi = apply_channel_fast(cfg, key, ids, re, im)
    x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    h, _ = _fade_state(cfg, _role_keys(key, ids)[2])
    h = 1.0 if h is None else np.asarray(h, np.complex128)
    want = h * x + _noise(cfg, key, ids, x.shape)
    got = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_multipath_fir_matches_numpy(rng):
    """Static TDL: one causal FIR over each channel's whole stream."""
    cfg = _cfg(ChannelModel.MULTIPATH)
    key, ids = jax.random.PRNGKey(2), jnp.arange(cfg.n_channels)
    re, im = _wave(rng, cfg)
    yr, yi = apply_channel_fast(cfg, key, ids, re, im)
    x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    _, taps = _fade_state(cfg, _role_keys(key, ids)[2])
    taps = np.asarray(taps, np.complex128)
    stream = x.reshape(cfg.n_channels, -1)
    fir = np.stack([np.convolve(s, t)[: s.size]
                    for s, t in zip(stream, taps)])
    want = fir.reshape(x.shape) + _noise(cfg, key, ids, x.shape)
    got = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_multipath_time_fir_matches_numpy(rng):
    """Per-tap-Jakes TDL: each symbol through its own taps, with the
    previous symbol's tail as FIR history."""
    cfg = _cfg(ChannelModel.MULTIPATH_TIME)
    key, ids = jax.random.PRNGKey(3), jnp.arange(cfg.n_channels)
    re, im = _wave(rng, cfg)
    yr, yi = apply_channel_fast(cfg, key, ids, re, im)
    x = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    _, taps = _fade_state(cfg, _role_keys(key, ids)[2])
    taps = np.asarray(taps, np.complex128)  # (B, S, L)
    L, n = taps.shape[-1], x.shape[-1]
    want = np.zeros_like(x)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            prev = x[b, s - 1, n - (L - 1):] if s else np.zeros(L - 1)
            ext = np.concatenate([prev, x[b, s]])
            want[b, s] = np.convolve(ext, taps[b, s])[L - 1: L - 1 + n]
    want = want + _noise(cfg, key, ids, x.shape)
    got = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_identity_is_transparent(rng):
    cfg = _cfg(ChannelModel.IDENTITY)
    re, im = _wave(rng, cfg)
    yr, yi = apply_channel_fast(cfg, jax.random.PRNGKey(0),
                                jnp.arange(cfg.n_channels), re, im)
    np.testing.assert_array_equal(np.asarray(yr), np.asarray(re))
    np.testing.assert_array_equal(np.asarray(yi), np.asarray(im))


@pytest.mark.parametrize(
    "model",
    [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT, ChannelModel.MULTIPATH],
)
def test_noise_and_fading_statistics(model):
    """Noise variance nv/N per time sample, unit mean fading power."""
    cfg = _cfg(model, n_channels=512, n_symbols=4)
    key, ids = jax.random.PRNGKey(4), jnp.arange(cfg.n_channels)
    shape = (cfg.n_channels, cfg.n_symbols, cfg.ofdm.symbol_len)
    zero = jnp.zeros(shape, jnp.float32)
    yr, yi = apply_channel_fast(cfg, key, ids, zero, zero)
    tvar = 1.0 / (10 ** 0.8 * 4) / cfg.ofdm.n_fft
    var = float(np.mean(np.asarray(yr) ** 2 + np.asarray(yi) ** 2))
    assert abs(var / tvar - 1.0) < 0.01
    h, taps = _fade_state(cfg, _role_keys(key, ids)[2])
    if h is not None:
        power = float(np.mean(np.abs(np.asarray(h)) ** 2))
        assert abs(power - 1.0) < 0.1


@pytest.mark.parametrize(
    "model,split",
    [
        (ChannelModel.AWGN, (72, 128)),
        (ChannelModel.AWGN, (1, 199)),
        (ChannelModel.RAYLEIGH_FLAT, (72, 128)),
        (ChannelModel.RICIAN, (72, 128)),
        (ChannelModel.RAYLEIGH_TIME, (72, 128)),
        (ChannelModel.MULTIPATH, (72, 128)),
        (ChannelModel.MULTIPATH_TIME, (72, 128)),
    ],
)
def test_split_batch_equals_full_batch(model, split):
    """One stream on every platform: a batch split at any size (72
    channels is no multiple of 128) draws what the full batch draws."""
    a, b = split
    cfg = _cfg(model, n_channels=a + b, n_symbols=2)
    key = jax.random.PRNGKey(5)
    ids = jnp.arange(a + b)
    full = tx_channel_core(cfg, key, ids)
    parts = [tx_channel_core(cfg, key, ids[:a]),
             tx_channel_core(cfg, key, ids[a:])]
    for k in range(2):
        np.testing.assert_array_equal(
            np.asarray(full[k]),
            np.concatenate([np.asarray(p[k]) for p in parts]),
        )
    errs, _ = fast_core(cfg, key, ids)
    split_errs = np.concatenate(
        [np.asarray(fast_core(cfg, key, ids[:a])[0]),
         np.asarray(fast_core(cfg, key, ids[a:])[0])]
    )
    np.testing.assert_array_equal(np.asarray(errs), split_errs)
