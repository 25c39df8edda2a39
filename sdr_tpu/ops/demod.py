"""Receive chain: CP strip → FFT → MMSE equalize → max-log LLR.

This is the hot path of the whole framework — the chain the north-star
throughput metric counts (BASELINE.json). The reference's equivalent is
``ofdm::rx`` followed by the hard-decision nearest scan
(/root/reference/lib/inc/ofdm.hpp:37-54, modulation.hpp:50-67); here the
demapper is soft (max-log LLR) and the chain is batched over
(batch, n_syms, sym_len) planar float32 inputs.

One implementation: the composition of the public ops, compiled by XLA
(the transform goes to the platform FFT library, the CP strip,
equalizer, LLR and error count fuse around it). The same function is
the reference the on-device checks compare against, run on the CPU.

Inputs are PLANAR (separate re/im float32); complex exists only inside.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.equalize import equalize_mmse, equalize_mmse_fde
from sdr_tpu.ops.llr import llr_maxlog
from sdr_tpu.ops.modulation import _ints_to_bits
from sdr_tpu.ops.ofdm import ofdm_rx


def demod_chain(
    re: jnp.ndarray,
    im: jnp.ndarray,
    hr: jnp.ndarray,
    hi: jnp.ndarray,
    cp_len: int,
    mod: Modulation,
    noise_var: float,
    reduce_sum: bool = False,
    despread: bool = False,
) -> jnp.ndarray:
    """Demod chain over (..., n_syms, sym_len) planar inputs.

    hr/hi broadcast against the post-FFT grid (..., n_syms, n_fft).
    Returns LLRs (..., n_syms, n_fft * bits_per_symbol) float32, or
    their scalar sum when ``reduce_sum`` (bench/reduction use).

    ``despread``: SC-FDE (full-grid SC-FDMA) — the biased per-tone
    MMSE with symbol-level bias correction (ops.equalize.
    equalize_mmse_fde; fewer errors than ZF-FDE on faded links — a
    notch's ZF noise enhancement despreads over EVERY symbol).
    """
    with jax.named_scope("demod_fft"):
        y = ofdm_rx(jax.lax.complex(re, im), cp_len)
    with jax.named_scope("demod_tail"):
        h = jax.lax.complex(hr, hi)
        if despread:
            s, eff = equalize_mmse_fde(y, h, noise_var)
        else:
            s, eff = equalize_mmse(y, h, noise_var)
        llr = llr_maxlog(s, mod, eff)
        if reduce_sum:
            return jnp.sum(llr, dtype=jnp.float32)
        return llr


def demod_count_chain(
    re: jnp.ndarray,
    im: jnp.ndarray,
    hr: jnp.ndarray,
    hi: jnp.ndarray,
    idx: jnp.ndarray,
    cp_len: int,
    mod: Modulation,
    noise_var: float,
    despread: bool = False,
) -> jnp.ndarray:
    """Demod + hard-decision bit-error count vs transmitted indices.

    The BER-counting terminal of the receive chain: hard decisions are
    the LLR signs (bit = 1 iff LLR < 0), compared against the bits of
    ``idx`` (batch, n_syms, n_fft) and summed per channel. Returns
    (batch,) int32 error counts.
    """
    llr = demod_chain(
        re, im, hr, hi, cp_len, mod, noise_var, despread=despread
    )
    with jax.named_scope("count"):
        hard = (llr < 0).astype(jnp.int8)
        bits = _ints_to_bits(idx, mod.bits_per_symbol)
        return jnp.sum((hard != bits).astype(jnp.int32), axis=(1, 2))
