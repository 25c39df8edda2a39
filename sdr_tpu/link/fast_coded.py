"""Coded fast engine: batched LDPC link on the fast-engine path.

link.coded.simulate_ldpc composes the coded chain per channel under
vmap through link.pipeline — maximal flexibility (pilots, MIMO, every
channel model). This module is the THROUGHPUT coded path: the whole
batch runs as batched arrays through the fast engine's stages —

  info bits → QC-LDPC encode → frame interleave → Gray map indices →
  TX → channel → LLR demod → deinterleave → min-sum decode →
  per-channel info-bit errors.

Randomness discipline: every draw is keyed by fold_in(key, global
channel id) (payload via ROLE_PAYLOAD — the same derivation as
link.coded's per-channel draws), so the sharded composition is
bit-exact vs unsharded, like link.fast.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sdr_tpu.core import prng
from sdr_tpu.core.config import LinkConfig
from sdr_tpu.link.coded import ldpc_code_for, ldpc_codewords_per_channel
from sdr_tpu.link.fast import _fade_state, _role_keys, tx_with_channel
from sdr_tpu.ops.demod import demod_chain
from sdr_tpu.ops.interleave import deinterleave, interleave
from sdr_tpu.ops.ldpc import ldpc_decode, ldpc_encode


def _frame_to_idx(frame_bits: jnp.ndarray, bps: int):
    """(B, S·N·bps) int8 coded bits → (B, S, N) symbol indices,
    MSB-first per symbol (the _ints_to_bits convention)."""
    B, total = frame_bits.shape
    b = frame_bits.reshape(B, total // bps, bps).astype(jnp.int32)
    w = jnp.asarray([1 << (bps - 1 - j) for j in range(bps)], jnp.int32)
    return jnp.sum(b * w, axis=-1)


def ldpc_fast_llrs(
    cfg: LinkConfig,
    key: jax.Array,
    rate: str = "1/2",
    ch_ids: jnp.ndarray | None = None,
):
    """Everything before the decoder: per channel the info bits
    (B, n_cw, k) int8, and the deinterleaved decoder input LLRs
    (B·n_cw, n) float32."""
    if cfg.pilot_spacing or cfg.mimo is not None or cfg.dft_spread:
        raise NotImplementedError(
            "the coded fast engine runs full-grid SISO OFDM; pilots/"
            "MIMO/SC-FDMA coded links run in link.coded"
        )
    if ch_ids is None:
        ch_ids = jnp.arange(cfg.n_channels)
    B = ch_ids.shape[0]
    S, N = cfg.n_symbols, cfg.ofdm.n_fft
    mod = cfg.modulation
    bps = mod.bits_per_symbol
    code = ldpc_code_for(rate)
    n_cw = ldpc_codewords_per_channel(cfg, code)
    frame_bits = S * N * bps
    sent = n_cw * code.n
    nv = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * bps)

    # --- TX side -----------------------------------------------------
    with jax.named_scope("payload"):
        ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(ch_ids)
        k_bits = jax.vmap(
            lambda k: prng.role_key(k, prng.ROLE_PAYLOAD)
        )(ch_keys)
        info = jax.vmap(
            lambda k: jax.random.bernoulli(k, 0.5, (n_cw, code.k))
        )(k_bits).astype(jnp.int8)
    with jax.named_scope("encode"):
        cw = ldpc_encode(code, info).reshape(B, sent)
        frame = jnp.zeros((B, frame_bits), jnp.int8).at[:, :sent].set(cw)
        frame = interleave(frame)
        idx = _frame_to_idx(frame, bps).reshape(B, S, N)
    re, im = tx_with_channel(cfg, key, ch_ids, idx)

    # --- RX side -----------------------------------------------------
    _, _, k_fade = _role_keys(key, ch_ids)
    h, _ = _fade_state(cfg, k_fade)
    if h is None:
        hb = jnp.broadcast_to(jnp.complex64(1.0), (B, 1, N))
    else:
        hb = jnp.broadcast_to(h, (B, h.shape[1], N)).astype(jnp.complex64)
    llr = demod_chain(
        re, im, jnp.real(hb), jnp.imag(hb), cfg.ofdm.cp_len, mod,
        max(nv, 1e-12),
    ).reshape(B, frame_bits)
    with jax.named_scope("decode"):
        llr_cw = deinterleave(llr)[:, :sent].reshape(B * n_cw, code.n)
    return info, llr_cw


def ldpc_fast_simulate(
    cfg: LinkConfig,
    key: jax.Array,
    rate: str = "1/2",
    iters: int = 25,
    schedule: str = "flooding",
    ch_ids: jnp.ndarray | None = None,
):
    """Batched LDPC-coded link; returns per-channel
    (info_bit_errors, info_bits_counted), both (B,) int32."""
    code = ldpc_code_for(rate)
    info, llr_cw = ldpc_fast_llrs(cfg, key, rate, ch_ids)
    B, n_cw = info.shape[:2]
    with jax.named_scope("decode"):
        decoded = ldpc_decode(
            code, llr_cw, iters=iters, schedule=schedule
        ).reshape(B, n_cw, code.n)
        errors = jnp.sum(
            (decoded[:, :, : code.k] != info).astype(jnp.int32), axis=(1, 2)
        )
    counted = jnp.full((B,), n_cw * code.k, jnp.int32)
    return errors, counted


def make_ldpc_fast_fn(cfg: LinkConfig, rate: str = "1/2", iters: int = 25,
                      schedule: str = "flooding"):
    """Jitted coded fast link with cfg closed over."""
    return jax.jit(
        functools.partial(
            ldpc_fast_simulate, cfg, rate=rate, iters=iters,
            schedule=schedule,
        )
    )
