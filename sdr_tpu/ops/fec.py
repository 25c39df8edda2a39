"""Convolutional FEC: encoder + soft-input max-log Viterbi decoder.

The reference's Gray-coding comment motivates its constellation with
Viterbi decoding efficiency (modulation.hpp:25-27) but ships no code;
the LLR soft output this framework produces exists precisely to feed a
soft decoder. Default code: the ubiquitous K=7, rate-1/2
(171, 133)_octal code (802.11a — the same numerology family as the
reference's OFDM comment, ofdm.hpp:2-3).

Vectorized formulation: the trellis is fully vectorized over states —
the add-compare-select step is a gather over two static predecessor
tables + elementwise max across the whole (batch, 64-state) front, one
``lax.scan`` step per information bit; traceback is a reverse scan over
the stored decision bits. No data-dependent control flow anywhere.

Register convention (shared by encoder and decoder tables):
    r_t = (b_t << (K-1)) | s_{t-1}      (s = previous K-1 bits)
    out_j = popcount(r_t & poly_j) & 1
    s_t = r_t >> 1                       (MSB of s_t is b_t)
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

DEFAULT_POLYS = (0o171, 0o133)
DEFAULT_K = 7

# 802.11a puncturing patterns (the rate family the reference's own
# numerology comment names, ofdm.hpp:2-3): per encoder step, which of
# the (A, B) = (171, 133) outputs survive, cycling over the period.
PUNCTURE_PATTERNS = {
    "1/2": ((1, 1),),
    "2/3": ((1, 1), (1, 0)),
    "3/4": ((1, 1), (1, 0), (0, 1)),
}


def coded_len(n_info: int, polys=DEFAULT_POLYS, K: int = DEFAULT_K) -> int:
    """Coded bits for n_info information bits with zero-tail termination."""
    return (n_info + K - 1) * len(polys)


@functools.lru_cache(maxsize=None)
def _puncture_indices(n_steps: int, rate: str, R: int = 2):
    """Static kept-bit indices into the (n_steps·R,) coded stream."""
    pattern = PUNCTURE_PATTERNS[rate]
    mask = np.array(
        [pattern[t % len(pattern)][j] for t in range(n_steps) for j in range(R)],
        bool,
    )
    return np.where(mask)[0].astype(np.int32)


def punctured_len(
    n_info: int, rate: str, polys=DEFAULT_POLYS, K: int = DEFAULT_K
) -> int:
    """Transmitted bits after puncturing a terminated codeword."""
    steps = n_info + K - 1
    return len(_puncture_indices(steps, rate, len(polys)))


def puncture(coded: jnp.ndarray, rate: str, R: int = 2) -> jnp.ndarray:
    """Drop the pattern's zero positions: (..., T·R) → (..., kept).

    A static gather — the indices are trace-time constants.
    """
    idx = _puncture_indices(coded.shape[-1] // R, rate, R)
    return coded[..., jnp.asarray(idx)]


def depuncture(llrs: jnp.ndarray, rate: str, n_steps: int, R: int = 2) -> jnp.ndarray:
    """Re-expand received LLRs to the full (..., n_steps·R) lattice.

    Punctured positions get LLR 0 — "no information", the correct
    neutral metric for max-log Viterbi (the branch metric contribution
    of an unobserved coded bit is identically zero).
    """
    idx = jnp.asarray(_puncture_indices(n_steps, rate, R))
    full = jnp.zeros(llrs.shape[:-1] + (n_steps * R,), llrs.dtype)
    return full.at[..., idx].set(llrs)


@functools.lru_cache(maxsize=None)
def _tables(polys: tuple, K: int):
    """Static trellis tables over S = 2^(K-1) states.

    Returns (prev_state (S,2), prev_bit (S,2), prev_out (S,2,R),
    enc_out (S,2,R), next_state (S,2)): for each state, its two
    predecessors (decoder view) and its two successors (encoder view).
    """
    S = 1 << (K - 1)
    R = len(polys)
    next_state = np.zeros((S, 2), np.int32)
    enc_out = np.zeros((S, 2, R), np.int32)
    for s in range(S):
        for b in (0, 1):
            r = (b << (K - 1)) | s
            next_state[s, b] = r >> 1
            for j, p in enumerate(polys):
                enc_out[s, b, j] = bin(r & p).count("1") & 1
    prev_state = np.zeros((S, 2), np.int32)
    prev_bit = np.zeros((S, 2), np.int32)
    prev_out = np.zeros((S, 2, R), np.int32)
    fill = np.zeros(S, np.int32)
    for s in range(S):
        for b in (0, 1):
            ns = next_state[s, b]
            k = fill[ns]
            prev_state[ns, k] = s
            prev_bit[ns, k] = b
            prev_out[ns, k] = enc_out[s, b]
            fill[ns] += 1
    assert (fill == 2).all()
    return prev_state, prev_bit, prev_out, enc_out, next_state


def conv_encode(
    bits: jnp.ndarray, polys=DEFAULT_POLYS, K: int = DEFAULT_K
) -> jnp.ndarray:
    """Zero-tail-terminated rate-1/R encode.

    bits: (..., n_info) in {0,1}. Returns (..., (n_info+K-1)·R) int8,
    per-step outputs [c_0 .. c_{R-1}] in polynomial order.
    """
    _, _, _, enc_out, next_state = _tables(tuple(polys), K)
    enc_out_j = jnp.asarray(enc_out, jnp.int8)  # (S, 2, R)
    next_j = jnp.asarray(next_state)

    tail = jnp.zeros(bits.shape[:-1] + (K - 1,), bits.dtype)
    seq = jnp.concatenate([bits, tail], axis=-1).astype(jnp.int32)
    seq_t = jnp.moveaxis(seq, -1, 0)  # (T, ...)

    def step(state, b):
        out = enc_out_j[state, b]  # (..., R)
        return next_j[state, b], out

    state0 = jnp.zeros(bits.shape[:-1], jnp.int32)
    _, outs = lax.scan(step, state0, seq_t)  # (T, ..., R)
    outs = jnp.moveaxis(outs, 0, -2)  # (..., T, R)
    return outs.reshape(*bits.shape[:-1], -1).astype(jnp.int8)


def viterbi_decode(
    llrs: jnp.ndarray,
    n_info: int,
    polys=DEFAULT_POLYS,
    K: int = DEFAULT_K,
) -> jnp.ndarray:
    """Soft-input max-log Viterbi decode of zero-tail-terminated LLRs.

    llrs: (..., (n_info+K-1)·R) float32 with the framework's sign
    convention (positive ⇒ bit 0 more likely, ops.llr). Returns the
    decoded information bits (..., n_info) int8.
    """
    polys = tuple(polys)
    R = len(polys)
    S = 1 << (K - 1)
    T = n_info + K - 1
    if llrs.shape[-1] != T * R:
        raise ValueError(
            f"llr length {llrs.shape[-1]} != (n_info + K - 1)·R = {T * R}"
        )
    prev_state, prev_bit, prev_out, _, _ = _tables(polys, K)
    prev_state_j = jnp.asarray(prev_state)  # (S, 2)
    prev_bit_j = jnp.asarray(prev_bit)
    # Branch sign per coded bit: metric contribution of coded bit c
    # against LLR L is +L/2 for c=0, −L/2 for c=1 → sign = 1 − 2c.
    prev_sign = jnp.asarray(1.0 - 2.0 * prev_out, jnp.float32)  # (S, 2, R)

    batch_shape = llrs.shape[:-1]
    llr_t = jnp.moveaxis(
        llrs.reshape(*batch_shape, T, R).astype(jnp.float32), -2, 0
    )  # (T, ..., R)

    NEG = jnp.float32(-1e30)
    pm0 = jnp.full(batch_shape + (S,), NEG).at[..., 0].set(0.0)

    def fwd(pm, l):
        # l: (..., R). Branch metrics for each (next_state, pred slot):
        bm = jnp.einsum(
            "...r,spr->...sp", 0.5 * l, prev_sign,
            precision=lax.Precision.HIGHEST,
        )  # (..., S, 2)
        cand = pm[..., prev_state_j] + bm  # (..., S, 2)
        take1 = cand[..., 1] > cand[..., 0]  # (..., S) bool decision
        npm = jnp.where(take1, cand[..., 1], cand[..., 0])
        return npm, take1

    pm_final, decisions = lax.scan(fwd, pm0, llr_t)  # decisions: (T, ..., S)

    # Traceback from state 0 (zero-tail termination).
    def bwd(state, dec):
        slot = jnp.take_along_axis(
            dec, state[..., None], axis=-1
        )[..., 0].astype(jnp.int32)  # (...,)
        bit = prev_bit_j[state, slot]
        pred = prev_state_j[state, slot]
        return pred, bit

    state_T = jnp.zeros(batch_shape, jnp.int32)
    _, bits_rev = lax.scan(bwd, state_T, decisions, reverse=True)
    # reverse=True scans t = T-1..0 but emits in forward order: bits_rev[t]
    # is the input bit of step t.
    bits = jnp.moveaxis(bits_rev, 0, -1)  # (..., T)
    return bits[..., :n_info].astype(jnp.int8)
