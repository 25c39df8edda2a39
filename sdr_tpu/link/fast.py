"""Fast batched link: TX → channel → RX at batch level.

The production throughput path. Where link.pipeline composes per-channel
ops under vmap (maximum flexibility, arbitrary shapes), this module runs
the whole link at BATCH level on 3-D (n_channels, n_symbols, ·) arrays,
so XLA sees each stage (payload draw, TX transform, channel, demod,
count) as one batched operation over every channel.

Note: this path draws source SYMBOL INDICES directly (uniform over the
constellation — the same distribution as i.i.d. bits, but a different
PRNG stream than pipeline.generate_bits), so its BER is validated
statistically against theory rather than bit-exactly against
link.pipeline (tests/test_fast.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sdr_tpu.core import prng
from sdr_tpu.core.config import ChannelModel, LinkConfig
from sdr_tpu.ops import channel as chan
from sdr_tpu.ops.demod import demod_count_chain
from sdr_tpu.ops.modulation import _ints_to_bits, modulate
from sdr_tpu.ops.ofdm import ofdm_tx


def _tx(cfg: LinkConfig, idx: jnp.ndarray):
    """(B,S,N) indices → planar (re, im) (B,S,sym_len): Gray map, IDFT
    and CP insert."""
    bits = _ints_to_bits(idx, cfg.modulation.bits_per_symbol)
    pts = modulate(bits, cfg.modulation)
    if cfg.dft_spread:
        # Full-grid SC-FDMA: the DFT precode and the IFFT cancel — the
        # time-domain waveform IS the constellation sequence scaled by
        # N^-1/2 (single-carrier with CP). No transform: one gather +
        # scale + CP concat.
        pts = pts * jnp.complex64(cfg.ofdm.n_fft ** -0.5)
        x = jnp.concatenate([pts[..., -cfg.ofdm.cp_len:], pts], axis=-1)
    else:
        x = ofdm_tx(pts, cfg.ofdm.cp_len)
    return jnp.real(x), jnp.imag(x)


def _role_keys(key: jax.Array, ch_ids: jnp.ndarray):
    ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(ch_ids)
    k_idx = jax.vmap(lambda k: prng.role_key(k, prng.ROLE_PAYLOAD))(ch_keys)
    k_noise = jax.vmap(lambda k: prng.role_key(k, prng.ROLE_NOISE))(ch_keys)
    k_fade = jax.vmap(lambda k: prng.role_key(k, prng.ROLE_FADING))(ch_keys)
    return k_idx, k_noise, k_fade


def _draw_idx(cfg: LinkConfig, key: jax.Array, ch_ids: jnp.ndarray):
    """Per-channel transmitted symbol indices, (B, S, N) int32.

    One threefry draw per channel, keyed by fold_in(key, global channel
    id): the TX side, the RX side's recompute and any shard of any size
    draw IDENTICAL indices (the pp/shard bit-exactness contract)."""
    S, N = cfg.n_symbols, cfg.ofdm.n_fft
    bps = cfg.modulation.bits_per_symbol
    k_idx, _, _ = _role_keys(key, ch_ids)
    return jax.vmap(
        lambda k: jax.random.randint(k, (S, N), 0, 1 << bps, jnp.int32)
    )(k_idx)


def _fade_state(cfg: LinkConfig, k_fade: jnp.ndarray):
    """Per-channel fading state from keys: (h, taps); either may be None.

    Pure function of the keys, so the TX side (which applies the
    channel) and the RX side (which equalizes against it) can each
    recompute it independently — what lets the pipelined link
    (parallel.pp) ship only the impaired samples between stages.
    """
    model = cfg.channel.model
    S, N = cfg.n_symbols, cfg.ofdm.n_fft
    h = taps = None
    if model == ChannelModel.RAYLEIGH_FLAT:
        h = jax.vmap(lambda k: chan.rayleigh_flat(k, (1, 1)))(k_fade)  # (B,1,1)
    elif model == ChannelModel.RICIAN:
        h = jax.vmap(
            lambda k: chan.rician_flat(k, (1, 1), cfg.channel.k_factor)
        )(k_fade)  # (B,1,1)
    elif model == ChannelModel.MULTIPATH:
        taps = jax.vmap(lambda k: chan.multipath_taps(k, cfg.channel.pdp))(k_fade)
        h = chan.freq_response(taps, N)[:, None, :]  # (B,1,N)
    elif model == ChannelModel.RAYLEIGH_TIME:
        # Per-symbol Jakes block fading: one flat gain per OFDM symbol,
        # correlated across the frame (same model as pipeline.apply_channel).
        g = jax.vmap(
            lambda k: chan.jakes_gains(k, S, cfg.channel.doppler_norm)
        )(k_fade)  # (B, S)
        h = g[:, :, None]  # (B, S, 1)
    elif model == ChannelModel.MULTIPATH_TIME:
        # Per-tap-Jakes TDL: per-symbol taps (TX side) AND per-symbol
        # frequency response (B, S, N) — the h_syms = n_symbols
        # channel-plane form the demod takes.
        taps = jax.vmap(
            lambda k: chan.multipath_time_taps(
                k, cfg.channel.pdp, S, cfg.channel.doppler_norm
            )
        )(k_fade)  # (B, S, L)
        h = chan.freq_response(taps, N)  # (B, S, N)
    elif model not in (ChannelModel.IDENTITY, ChannelModel.AWGN):
        raise NotImplementedError(
            f"fast_simulate has no dispatch for channel model {model}"
        )
    return h, taps


def tx_channel_core(cfg: LinkConfig, key: jax.Array, ch_ids: jnp.ndarray):
    """TX + channel for explicit global channel ids → impaired planar
    (re, im), each (B, n_symbols, sym_len) float32. First pipeline
    stage of parallel.pp; fast_core composes it with rx_count_core."""
    with jax.named_scope("payload"):
        idx = _draw_idx(cfg, key, ch_ids)
    return tx_with_channel(cfg, key, ch_ids, idx)


def tx_with_channel(cfg: LinkConfig, key: jax.Array, ch_ids: jnp.ndarray,
                    idx: jnp.ndarray):
    """TX + channel over EXPLICIT indices (shared by the uncoded and
    coded fast engines)."""
    with jax.named_scope("tx"):
        re, im = _tx(cfg, idx)
    return apply_channel_fast(cfg, key, ch_ids, re, im)


def apply_channel_fast(cfg: LinkConfig, key: jax.Array, ch_ids: jnp.ndarray,
                       re: jnp.ndarray, im: jnp.ndarray):
    """The fast engine's channel stage over an externally-built
    waveform: fading + AWGN, every draw keyed by (key, role, global
    channel id) so the stream does not depend on the batch split."""
    B = ch_ids.shape[0]
    bps = cfg.modulation.bits_per_symbol
    nv = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * bps)
    tvar = nv / cfg.ofdm.n_fft
    model = cfg.channel.model

    with jax.named_scope("channel"):
        _, k_noise, k_fade = _role_keys(key, ch_ids)
        h, taps = _fade_state(cfg, k_fade)
        x = jax.lax.complex(re, im)
        if model == ChannelModel.MULTIPATH:
            stream = x.reshape(B, -1)
            x = chan.apply_multipath(stream, taps).reshape(x.shape)
        elif model == ChannelModel.MULTIPATH_TIME:
            # Each symbol through its own taps, previous symbol's tail as
            # FIR history (identical to pipeline.apply_channel's model).
            x = chan.apply_multipath(
                x, taps, history=chan.symbol_history(x, taps.shape[-1])
            )
        elif model in (
            ChannelModel.RAYLEIGH_FLAT,
            ChannelModel.RAYLEIGH_TIME,
            ChannelModel.RICIAN,
        ):
            x = x * h
        if model != ChannelModel.IDENTITY:
            x = jax.vmap(lambda k, xc: chan.awgn(k, xc, tvar))(k_noise, x)
        return jnp.real(x), jnp.imag(x)


def rx_count_core(cfg: LinkConfig, key: jax.Array, ch_ids: jnp.ndarray,
                  re: jnp.ndarray, im: jnp.ndarray):
    """Demod + error count over impaired planar samples.

    Recomputes the channel plane AND the transmitted bits from the
    channel-id keys (both are pure functions of them), so the only
    data dependency on the TX side is the impaired samples — the
    pipeline payload. Returns per-channel (bit_errors, bits_counted).
    """
    B = ch_ids.shape[0]
    S, N = cfg.n_symbols, cfg.ofdm.n_fft
    mod = cfg.modulation
    bps = mod.bits_per_symbol
    nv = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * bps)

    _, _, k_fade = _role_keys(key, ch_ids)
    h, _ = _fade_state(cfg, k_fade)
    if h is None:
        hb = jnp.broadcast_to(jnp.complex64(1.0), (B, 1, N))
    else:
        # Per-symbol fading keeps the symbol axis (B,S,N); static models
        # broadcast to the canonical per-link (B,1,N) channel plane.
        hb = jnp.broadcast_to(h, (B, h.shape[1], N)).astype(jnp.complex64)

    with jax.named_scope("payload"):
        idx = _draw_idx(cfg, key, ch_ids)
    errors = demod_count_chain(
        re, im,
        jnp.real(hb), jnp.imag(hb),
        idx, cfg.ofdm.cp_len, mod, max(nv, 1e-12),
        # SC-FDE receive (full-grid SC-FDMA): idx indexes the
        # TIME-domain constellation symbols.
        despread=cfg.dft_spread,
    )
    counted = jnp.full((B,), S * N * bps, jnp.int32)
    return errors, counted


def fast_core(cfg: LinkConfig, key: jax.Array, ch_ids: jnp.ndarray):
    """The batched link over explicit GLOBAL channel ids.

    Every random draw is keyed by fold_in(key, channel_id) — the same
    discipline as link.pipeline — so the result for a channel does not
    depend on which device (or batch slice) computes it. That is what
    makes the sharded fast path (parallel.shard.make_sharded_fast_fn)
    bit-exact vs the unsharded one for any shard size. Returns
    per-channel (bit_errors, bits_counted), both (len(ch_ids),) int32.
    """
    re, im = tx_channel_core(cfg, key, ch_ids)
    return rx_count_core(cfg, key, ch_ids, re, im)


def fast_simulate(cfg: LinkConfig, key: jax.Array):
    """Full link over (n_channels, n_symbols) as one batched program.

    Returns (bit_errors (n_channels,) int32, bits_counted (n_channels,)).
    """
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "fast_simulate is the full-grid throughput path; pilot-based "
            "estimation lives in link.pipeline.simulate (pilot_spacing=0 here)"
        )
    if cfg.mimo is not None:
        raise NotImplementedError(
            "fast_simulate is SISO; MIMO links run in "
            "link.pipeline.simulate (set mimo=None here)"
        )
    # FULL-GRID SC-FDMA (cfg.dft_spread) runs here too: single-carrier
    # with CP at TX, SC-FDE receive. The pilot_spacing gate above routes
    # block-pilot SC-FDMA to link.pipeline.
    return fast_core(cfg, key, jnp.arange(cfg.n_channels))


def make_fast_fn(cfg: LinkConfig):
    """Jitted fast link with cfg closed over."""
    return jax.jit(functools.partial(fast_simulate, cfg))
