"""Blocked stream simulation — the sequence-parallel link.

The reference processes exactly one OFDM symbol per call (ofdm.hpp:
14-24); "streaming" is its GUI timer loop appending to a ring buffer
(QFDemoWindow.cpp:229). The north star scales this to long sample
streams: a frame of ``n_symbols`` OFDM symbols per channel is split
into ``n_blocks`` contiguous time blocks, and blocks are distributed
across devices (sdr_tpu.parallel). The only cross-block coupling in
the whole chain is the multipath FIR's L-1 sample history at each
block seam — the halo that ``ppermute`` exchanges when sharded.

This module is the UNSHARDED oracle for that computation: it uses the
identical per-(channel, block) key folding and identical blockwise
channel application, so the sharded path (sdr_tpu.parallel.shard) must
match it BIT-exactly — the north star's seam requirement, asserted in
tests/test_parallel.py.

Canonical keying (must match parallel/shard.py):
    payload bits of (c, b): block_key(root, ROLE_PAYLOAD, c, b)
    noise of (c, b):        block_key(root, ROLE_NOISE, c, b)
    fading taps of c:       channel_key(root, ROLE_FADING, c)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sdr_tpu.core import prng
from sdr_tpu.core.config import ChannelModel, Equalizer, LinkConfig
from sdr_tpu.ops import channel as chan
from sdr_tpu.ops import equalize as eq
from sdr_tpu.ops.fft import xla_ifft
from sdr_tpu.ops.llr import llr_maxlog, llr_to_hard_bits
from sdr_tpu.ops.modulation import modulate
from sdr_tpu.ops.ofdm import ofdm_rx, ofdm_tx


def _check_blocking(cfg: LinkConfig, n_blocks: int) -> int:
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "the blocked-stream path simulates full-grid links; pilot-based "
            "estimation lives in link.pipeline.simulate (pilot_spacing=0 here)"
        )
    if cfg.mimo is not None:
        raise NotImplementedError(
            "the blocked-stream path is SISO; MIMO links run in "
            "link.pipeline.simulate (set mimo=None here)"
        )
    if cfg.n_symbols % n_blocks != 0:
        raise ValueError(
            f"n_symbols={cfg.n_symbols} not divisible by n_blocks={n_blocks}"
        )
    return cfg.n_symbols // n_blocks


def _block_tx(cfg: LinkConfig, root: jax.Array, c, b, sym_per_block: int):
    """TX for one block: bits + serialized time-domain stream."""
    kbits = prng.block_key(root, prng.ROLE_PAYLOAD, c, b)
    bits = jax.random.bernoulli(
        kbits, 0.5, (sym_per_block, cfg.bits_per_ofdm_symbol)
    ).astype(jnp.int8)
    points = modulate(bits, cfg.modulation)
    if cfg.dft_spread:
        # Full-grid SC-FDMA: unitary DFT precode per symbol (the same
        # convention as pipeline.tx_chain) — block-local, so the SP
        # seam/halo story is untouched.
        m = points.shape[-1]
        points = (jnp.fft.fft(points, axis=-1) * jnp.float32(m**-0.5)).astype(
            jnp.complex64
        )
    tx = ofdm_tx(points, cfg.ofdm.cp_len)  # (sym_per_block, sym_len)
    return bits, tx.reshape(-1)  # serialized block stream


def _channel_taps(cfg: LinkConfig, root: jax.Array, c):
    """Per-channel fading state: (taps|None, h_freq|None, jakes|None).

    The third element is the (theta, phi) Jakes path state for
    RAYLEIGH_TIME — a block evaluates its own symbols' gains from it at
    ABSOLUTE symbol indices (ops.channel.jakes_eval), which is what
    keeps time-sharded streams bit-exact vs this oracle.
    """
    model = cfg.channel.model
    kf = prng.channel_key(root, prng.ROLE_FADING, c)
    if model == ChannelModel.MULTIPATH:
        taps = chan.multipath_taps(kf, cfg.channel.pdp)
        return taps, chan.freq_response(taps, cfg.ofdm.n_fft), None
    if model == ChannelModel.RAYLEIGH_FLAT:
        h = chan.rayleigh_flat(kf, ())
        return None, h, None
    if model == ChannelModel.RICIAN:
        h = chan.rician_flat(kf, (), cfg.channel.k_factor)
        return None, h, None
    if model == ChannelModel.RAYLEIGH_TIME:
        return None, None, chan.jakes_params(kf)
    if model == ChannelModel.MULTIPATH_TIME:
        # Per-tap Jakes state (theta, phi, amps): blocks evaluate their
        # own symbols' taps at absolute indices, like RAYLEIGH_TIME.
        return None, None, chan.multipath_time_params(kf, cfg.channel.pdp)
    return None, None, None


def _block_rx(
    cfg: LinkConfig,
    root: jax.Array,
    c,
    b,
    stream: jnp.ndarray,
    taps,
    h_freq,
    jakes,
    sym_per_block: int,
    halo: jnp.ndarray | None,
):
    """Channel + receiver for one serialized block; returns hard bits."""
    model = cfg.channel.model
    nv = chan.ebno_db_to_noise_var(cfg.channel.ebno_db, cfg.modulation.bits_per_symbol)
    tvar = chan.time_noise_var(nv, cfg.ofdm.n_fft)
    knoise = prng.block_key(root, prng.ROLE_NOISE, c, b)

    if model == ChannelModel.RAYLEIGH_TIME:
        # Per-symbol block fading at ABSOLUTE symbol indices — a block
        # at any shard position applies exactly the gains the unsharded
        # frame does for those symbols (b may be a traced scan index).
        theta, phi = jakes
        t_idx = b * sym_per_block + jnp.arange(sym_per_block)
        g = chan.jakes_eval(theta, phi, t_idx, cfg.channel.doppler_norm)
        stream = (
            stream.reshape(sym_per_block, cfg.ofdm.symbol_len) * g[:, None]
        ).reshape(-1)
        h_freq = g[:, None]  # (spb, 1): flat per symbol for equalization
    elif model == ChannelModel.MULTIPATH:
        stream = chan.apply_multipath(stream, taps, history=halo)
    elif model == ChannelModel.MULTIPATH_TIME:
        # Per-tap-Jakes TDL at ABSOLUTE symbol indices: each symbol is
        # convolved with its own taps; in-block history is the previous
        # symbol's tail, and the first symbol takes the block HALO (the
        # left neighbor's tail under sharding) — so the seam is
        # bit-exact vs the unsharded frame, like the static MULTIPATH
        # halo but with the taps evolving.
        theta, phi, amps = jakes
        t_idx = b * sym_per_block + jnp.arange(sym_per_block)
        taps_t = chan.multipath_time_taps_at(
            theta, phi, amps, t_idx, cfg.channel.doppler_norm
        )  # (spb, L)
        L = taps_t.shape[-1]
        grid = stream.reshape(sym_per_block, cfg.ofdm.symbol_len)
        hist = chan.symbol_history(grid, L)
        if hist is not None and halo is not None:
            hist = hist.at[0].set(halo[-(L - 1):])
        stream = chan.apply_multipath(grid, taps_t, history=hist).reshape(-1)
        h_freq = chan.freq_response(taps_t, cfg.ofdm.n_fft)  # (spb, n_fft)
    elif model in (ChannelModel.RAYLEIGH_FLAT, ChannelModel.RICIAN):
        stream = stream * h_freq  # flat gain
    if model != ChannelModel.IDENTITY:
        stream = chan.awgn(knoise, stream, tvar)

    rx = stream.reshape(sym_per_block, cfg.ofdm.symbol_len)
    y = ofdm_rx(rx, cfg.ofdm.cp_len)
    nv_f = jnp.maximum(jnp.asarray(nv, jnp.float32), 1e-12)
    despread_done = False
    if h_freq is not None and cfg.equalizer != Equalizer.NONE:
        if cfg.equalizer == Equalizer.ZF:
            s, eff = eq.equalize_zf(y, h_freq, nv_f)
        elif cfg.dft_spread:
            # SC-FDE MMSE with bias correction — despreads internally;
            # per-symbol, so block seams are unaffected.
            s, eff = eq.equalize_mmse_fde(y, h_freq, nv_f)
            despread_done = True
        else:
            s, eff = eq.equalize_mmse(y, h_freq, nv_f)
    else:
        s, eff = y, nv_f
    if cfg.dft_spread and not despread_done:
        # ZF / unequalized despread: per-symbol, seams unaffected.
        m = s.shape[-1]
        eff = jnp.mean(
            jnp.broadcast_to(eff, s.shape), axis=-1, keepdims=True
        )
        s = (xla_ifft(s) * jnp.float32(m**0.5)).astype(
            jnp.complex64
        )
    return llr_to_hard_bits(llr_maxlog(s, cfg.modulation, eff))


def _halo_len(cfg: LinkConfig) -> int:
    if cfg.channel.model in (
        ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME
    ):
        return max(len(cfg.channel.pdp) - 1, 0)
    return 0


def _one_channel_blocked(cfg: LinkConfig, root: jax.Array, c, n_blocks: int):
    """All blocks of one channel, sequential halo threading (oracle)."""
    spb = cfg.n_symbols // n_blocks
    taps, h_freq, jakes = _channel_taps(cfg, root, c)
    L_halo = _halo_len(cfg)
    errors = jnp.int32(0)
    halo = jnp.zeros((L_halo,), jnp.complex64) if L_halo else None
    for b in range(n_blocks):
        bits, stream = _block_tx(cfg, root, c, b, spb)
        hard = _block_rx(cfg, root, c, b, stream, taps, h_freq, jakes, spb, halo)
        errors = errors + jnp.sum((hard != bits).astype(jnp.int32))
        if L_halo:
            halo = stream[-L_halo:]
    return errors


def stream_simulate(cfg: LinkConfig, key: jax.Array, n_blocks: int):
    """Unsharded blocked-stream link over all channels.

    Returns (bit_errors (n_channels,) int32, bits_counted (n_channels,)).
    The sharded twin (parallel.shard.make_sharded_stream_fn) must match
    this bit-exactly for any device layout.
    """
    _check_blocking(cfg, n_blocks)
    fn = functools.partial(_one_channel_blocked, cfg, key, n_blocks=n_blocks)
    errors = jax.vmap(lambda c: fn(c))(jnp.arange(cfg.n_channels))
    counted = jnp.full((cfg.n_channels,), cfg.n_symbols * cfg.bits_per_ofdm_symbol,
                       jnp.int32)
    return errors, counted
