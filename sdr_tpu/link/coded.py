"""Coded link: FEC → interleave → OFDM link → LLR → soft decode.

The end-to-end consumer of the soft demapper, with two code families:
convolutional K=7 (171,133) with 802.11a puncturing and the soft-input
Viterbi decoder (``simulate_coded``), and the QC-LDPC family with the
min-sum decoder (``simulate_ldpc``, ops/ldpc.py). Either way the bits
are bit-interleaved across the frame (ops.interleave), carried over
the full OFDM link (link.pipeline's TX / channel / RX stages — or the
multi-antenna chain via pipeline.mimo_llr_link when cfg.mimo is set,
so FEC composes with STBC/MRC/spatial-mux and estimated CSI), and the
deinterleaved LLRs drive the decoder. BER is counted on INFORMATION
bits.

Frame fit: the coded+tail bit count must fill the frame exactly, so the
information payload per channel is derived from the config:
``info_bits_per_channel(cfg)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sdr_tpu.core import prng
from sdr_tpu.core.config import LinkConfig
from sdr_tpu.link.pipeline import apply_channel, rx_chain, tx_chain
from sdr_tpu.ops.fec import (
    DEFAULT_K,
    DEFAULT_POLYS,
    conv_encode,
    depuncture,
    puncture,
    punctured_len,
    viterbi_decode,
)
from sdr_tpu.ops.interleave import deinterleave, interleave


def info_bits_per_channel(
    cfg: LinkConfig, polys=DEFAULT_POLYS, K: int = DEFAULT_K,
    rate: str = "1/2",
) -> int:
    """Largest info payload whose terminated, punctured codeword fits
    one frame (``rate``: "1/2", "2/3" or "3/4" — the 802.11a family).
    MIMO frames carry n_streams x the bits (bits_per_ofdm_symbol
    already accounts for it)."""
    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    R = len(polys)
    # Upper bound from the average punctured rate, then trim exactly.
    n_info = (frame_bits * int(rate[0])) // int(rate[2]) - (K - 1)
    while n_info > 0 and punctured_len(n_info, rate, polys, K) > frame_bits:
        n_info -= 1
    if n_info < 1:
        raise ValueError(
            f"frame of {frame_bits} coded bits cannot fit a terminated "
            f"rate-{rate} K={K} codeword"
        )
    return n_info


def _frame_llrs(cfg: LinkConfig, key: jax.Array, frame: jnp.ndarray):
    """Carry one interleaved frame of coded bits over the link and
    return its LLR vector (frame_bits,). SISO goes through
    tx_chain/apply_channel/rx_chain; MIMO through pipeline.mimo_llr_link
    (spatial streams are leading frame segments — the same reshape on
    both sides keeps TX and RX bit order identical)."""
    frame_bits = frame.shape[0]
    if cfg.mimo is not None:
        from sdr_tpu.link.pipeline import mimo_llr_link

        bits = frame.reshape(cfg.mimo.n_streams, cfg.n_symbols, -1)
        return mimo_llr_link(cfg, key, bits).reshape(-1)
    tx = tx_chain(cfg, frame.reshape(cfg.n_data_symbols, cfg.bits_per_ofdm_symbol))
    rx, h_freq, nv = apply_channel(cfg, key, tx)
    llrs, _ = rx_chain(cfg, rx, h_freq, nv)
    return llrs.reshape(-1)[:frame_bits]


def _coded_one(cfg: LinkConfig, key: jax.Array, n_info: int, polys, K, rate):
    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    n_steps = n_info + K - 1
    sent = punctured_len(n_info, rate, polys, K)

    kbits = prng.role_key(key, prng.ROLE_PAYLOAD)
    info = jax.random.bernoulli(kbits, 0.5, (n_info,)).astype(jnp.int8)
    cw = puncture(conv_encode(info, polys, K), rate)
    # Pad to the frame, then interleave the WHOLE frame — the RX
    # deinterleaves the whole frame too, so the permutation lengths
    # always match (a punctured codeword rarely fills the frame
    # exactly; interleaving only the codeword would desynchronize).
    frame = interleave(jnp.zeros((frame_bits,), jnp.int8).at[:sent].set(cw))
    llr_sent = deinterleave(_frame_llrs(cfg, key, frame))[:sent]
    # Punctured positions re-enter the trellis as zero LLRs.
    llr_cw = depuncture(llr_sent, rate, n_steps)
    decoded = viterbi_decode(llr_cw, n_info, polys, K)
    errors = jnp.sum((decoded != info).astype(jnp.int32))
    return errors, jnp.int32(n_info)


def simulate_coded(
    cfg: LinkConfig,
    key: jax.Array,
    polys=DEFAULT_POLYS,
    K: int = DEFAULT_K,
    rate: str = "1/2",
):
    """Coded link over cfg.n_channels; returns (errors, counted) per
    channel, counting INFORMATION bits."""
    n_info = info_bits_per_channel(cfg, polys, K, rate)
    ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(cfg.n_channels)
    )
    return jax.vmap(
        functools.partial(
            _coded_one, cfg, n_info=n_info, polys=polys, K=K, rate=rate
        )
    )(ch_keys)


def make_coded_fn(
    cfg: LinkConfig, polys=DEFAULT_POLYS, K: int = DEFAULT_K, rate: str = "1/2"
):
    return jax.jit(
        functools.partial(simulate_coded, cfg, polys=polys, K=K, rate=rate)
    )


# ---------------------------------------------------------------------------
# LDPC-coded link (ops/ldpc.py): modern block FEC on the same chain.

_LDPC_MB = {"1/2": 12, "2/3": 8, "3/4": 6}  # nb=24 base, rate=(nb-mb)/nb


def ldpc_code_for(rate: str = "1/2", z: int = 128):
    """The framework's stock QC-LDPC code family (nb=24, Z=128)."""
    from sdr_tpu.ops.ldpc import make_qc_ldpc

    if rate not in _LDPC_MB:
        raise ValueError(f"LDPC rate must be one of {sorted(_LDPC_MB)}")
    return make_qc_ldpc(nb=24, mb=_LDPC_MB[rate], z=z)


def ldpc_codewords_per_channel(cfg: LinkConfig, code) -> int:
    """Whole codewords per frame (the remainder of the frame is zero
    padding — known bits the receiver never counts)."""
    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    n_cw = frame_bits // code.n
    if n_cw < 1:
        raise ValueError(
            f"frame of {frame_bits} bits cannot fit an n={code.n} codeword"
        )
    return n_cw


def _ldpc_one(cfg: LinkConfig, key: jax.Array, code, n_cw: int, iters: int):
    from sdr_tpu.ops.ldpc import ldpc_decode, ldpc_encode

    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    sent = n_cw * code.n

    kbits = prng.role_key(key, prng.ROLE_PAYLOAD)
    info = jax.random.bernoulli(kbits, 0.5, (n_cw, code.k)).astype(jnp.int8)
    cw = ldpc_encode(code, info).reshape(-1)
    # Same whole-frame interleave convention as the convolutional path:
    # pad to the frame, permute the frame, depermute at RX.
    frame = interleave(jnp.zeros((frame_bits,), jnp.int8).at[:sent].set(cw))
    llr_cw = deinterleave(_frame_llrs(cfg, key, frame))[:sent]
    decoded = ldpc_decode(code, llr_cw.reshape(n_cw, code.n), iters=iters)
    errors = jnp.sum(
        (decoded[:, : code.k] != info).astype(jnp.int32)
    )
    return errors, jnp.int32(n_cw * code.k)


def simulate_ldpc(
    cfg: LinkConfig,
    key: jax.Array,
    rate: str = "1/2",
    iters: int = 25,
    z: int = 128,
):
    """LDPC-coded link over cfg.n_channels; returns (errors, counted)
    per channel, counting INFORMATION bits (systematic prefix)."""
    code = ldpc_code_for(rate, z)
    n_cw = ldpc_codewords_per_channel(cfg, code)
    ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(cfg.n_channels)
    )
    return jax.vmap(
        functools.partial(_ldpc_one, cfg, code=code, n_cw=n_cw, iters=iters)
    )(ch_keys)


def make_ldpc_fn(
    cfg: LinkConfig, rate: str = "1/2", iters: int = 25, z: int = 128
):
    return jax.jit(
        functools.partial(simulate_ldpc, cfg, rate=rate, iters=iters, z=z)
    )


def polar_params(rate: str = "1/2", block_len: int = 256):
    """(block_len, k) for a nominal rate from the 802.11a-style rate
    strings the other code families use; non-dyadic rates round to the
    nearest k (actual rate printed by the CLI is k/block_len)."""
    num, den = int(rate[0]), int(rate[2])
    k = max(1, round(block_len * num / den))
    return block_len, k


def polar_codewords_per_channel(cfg: LinkConfig, block_len: int) -> int:
    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    n_cw = frame_bits // block_len
    if n_cw < 1:
        raise ValueError(
            f"frame of {frame_bits} bits cannot fit an N={block_len} "
            "polar codeword"
        )
    return n_cw


def polar_llrs(cfg: LinkConfig, key: jax.Array, code, n_cw: int):
    """Everything before the decoder, for one channel: its payload
    (n_cw, payload_len) int8 and the deinterleaved decoder input LLRs
    (n_cw, block_len)."""
    from sdr_tpu.ops.polar import polar_encode_payload

    frame_bits = cfg.n_data_symbols * cfg.bits_per_ofdm_symbol
    sent = n_cw * code.block_len

    kbits = prng.role_key(key, prng.ROLE_PAYLOAD)
    payload = jax.random.bernoulli(
        kbits, 0.5, (n_cw, code.payload_len)
    ).astype(jnp.int8)
    cw = polar_encode_payload(payload, code).reshape(-1)
    # Whole-frame interleave, same convention as the conv/LDPC paths.
    frame = interleave(jnp.zeros((frame_bits,), jnp.int8).at[:sent].set(cw))
    llr_cw = deinterleave(_frame_llrs(cfg, key, frame))[:sent]
    return payload, llr_cw.reshape(n_cw, code.block_len)


def polar_decode(llr_cw: jnp.ndarray, code, list_size: int) -> jnp.ndarray:
    """CA-SCL decode of (..., block_len) LLRs → (..., payload_len) bits.

    Default: the fast-SSCL tree decoder — decision-identical to the
    scan decoder (tests/test_polar.py) in far fewer sequential steps.
    SDR_TPU_POLAR_DECODER=scan selects the scan decoder."""
    import os

    from sdr_tpu.ops.polar import polar_decode_scl, polar_decode_scl_fast

    decode = (
        polar_decode_scl
        if os.environ.get("SDR_TPU_POLAR_DECODER", "fast") == "scan"
        else polar_decode_scl_fast
    )
    return decode(llr_cw, code, list_size=list_size)


def _polar_one(cfg: LinkConfig, key: jax.Array, code, n_cw: int,
               list_size: int):
    payload, llr_cw = polar_llrs(cfg, key, code, n_cw)
    decoded = polar_decode(llr_cw, code, list_size)
    errors = jnp.sum((decoded != payload).astype(jnp.int32))
    return errors, jnp.int32(n_cw * code.payload_len)


def polar_code_for(rate: str = "1/2", block_len: int = 256,
                   crc: str | None = "crc11"):
    """The framework's stock CA-polar code for a nominal rate string.

    k counts info POSITIONS (payload + CRC); the realized info rate is
    (k - crc_len)/block_len — the CRC overhead is the price of list
    selection, exactly as in 5G control channels."""
    from sdr_tpu.ops.polar import make_polar_code

    block_len, k = polar_params(rate, block_len)
    return make_polar_code(block_len, k, crc=crc)


def simulate_polar(
    cfg: LinkConfig,
    key: jax.Array,
    rate: str = "1/2",
    block_len: int = 256,
    list_size: int = 8,
    crc: str | None = "crc11",
):
    """Polar-coded link (CRC-aided SC-list decoding) over
    cfg.n_channels; returns (errors, counted) per channel, counting
    PAYLOAD bits (info positions minus the CRC)."""
    code = polar_code_for(rate, block_len, crc)
    n_cw = polar_codewords_per_channel(cfg, code.block_len)
    ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(cfg.n_channels)
    )
    return jax.vmap(
        functools.partial(
            _polar_one, cfg, code=code, n_cw=n_cw, list_size=list_size
        )
    )(ch_keys)


def make_polar_fn(
    cfg: LinkConfig,
    rate: str = "1/2",
    block_len: int = 256,
    list_size: int = 8,
    crc: str | None = "crc11",
):
    return jax.jit(
        functools.partial(
            simulate_polar, cfg, rate=rate, block_len=block_len,
            list_size=list_size, crc=crc,
        )
    )


# ---------------------------------------------------------------------------
# Family dispatch: one entry point over the three code families, used
# by the adapt ladder, the sweep engine, and the CLI.

CODE_FAMILIES = ("conv", "ldpc", "polar")


def family_info_rate(family: str, rate: str, block_len: int = 256) -> float:
    """The REALIZED info rate of a family at a nominal rate string —
    what efficiency calculations must use. conv/LDPC realize the
    nominal exactly; polar pays the CRC-11 overhead
    ((k - 11)/block_len)."""
    nominal = int(rate[0]) / int(rate[2])
    if family in ("conv", "ldpc"):
        return nominal
    if family == "polar":
        return polar_code_for(rate, block_len).rate
    raise ValueError(f"family must be one of {CODE_FAMILIES}, got {family!r}")


def make_family_fn(cfg: LinkConfig, family: str, rate: str = "1/2", **kw):
    """Jitted (errors, counted) coded-link fn for any code family.

    kw passes through family-specific knobs: conv (polys, K), ldpc
    (iters, z), polar (block_len, list_size, crc). Raises ValueError
    when the frame cannot fit the family's codeword — callers
    (calibrate) treat that as an infeasible rung."""
    if family == "conv":
        info_bits_per_channel(cfg, rate=rate)  # eager frame-fit check
        return make_coded_fn(cfg, rate=rate, **kw)
    if family == "ldpc":
        ldpc_codewords_per_channel(cfg, ldpc_code_for(rate, kw.get("z", 128)))
        return make_ldpc_fn(cfg, rate=rate, **kw)
    if family == "polar":
        code = polar_code_for(rate, kw.get("block_len", 256), kw.get("crc", "crc11"))
        polar_codewords_per_channel(cfg, code.block_len)
        return make_polar_fn(cfg, rate=rate, **kw)
    raise ValueError(f"family must be one of {CODE_FAMILIES}, got {family!r}")
