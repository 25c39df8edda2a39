"""Max-log LLR soft demapper.

The reference has hard decisions only — a brute-force nearest-point
scan (modulation.hpp:50-67); the north star replaces that inner loop
with a max-log LLR soft output. For Gray-coded SQUARE constellations
the 2-D max-log metric separates exactly into two independent PAM
problems (I bits depend only on Re, Q bits only on Im), so the
per-symbol cost is O(2*L) instead of O(M=L^2) — this is the per-
subcarrier inner loop the north star names, and it vectorizes directly
over every subcarrier of the batch.

Definition (natural log, noise ~ CN(0, noise_var) per symbol):

    LLR(b) = log P(b=0|y) - log P(b=1|y)
           ~ ( min_{a: b=1} (y-a)^2 - min_{a: b=0} (y-a)^2 ) / noise_var

Positive LLR ⇒ bit 0 more likely; hard bit = (LLR < 0). With this sign
convention hard decisions from LLRs coincide with
``demodulate_hard`` for every finite-noise input (tested).

Bit order matches ``modulate``: MSB-first, I-axis bits then Q-axis.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.modulation import _tables  # shared static tables


@functools.lru_cache(maxsize=None)
def _axis_bit_masks(mod: Modulation):
    """bool (m, L): mask[j, g] = bit j (MSB-first) of Gray index g."""
    m = mod.bits_per_axis
    L = mod.levels_per_axis
    g = np.arange(L)
    masks = np.stack([((g >> (m - 1 - j)) & 1).astype(bool) for j in range(m)])
    return masks


def _axis_llr(y: jnp.ndarray, mod: Modulation, noise_var) -> jnp.ndarray:
    """Per-axis max-log LLRs.

    y: (...,) real, in NORMALIZED units. Returns (..., m) LLRs for the
    axis bits, MSB first.
    """
    _, pam, norm, _ = _tables(mod)
    levels = jnp.asarray(pam) * norm  # normalized level amplitudes, (L,)
    d2 = (y[..., None] - levels) ** 2  # (..., L)
    masks = _axis_bit_masks(mod)  # (m, L) numpy bool
    inf = jnp.float32(np.inf)
    outs = []
    for j in range(mod.bits_per_axis):
        mask = jnp.asarray(masks[j])
        d1 = jnp.min(jnp.where(mask, d2, inf), axis=-1)
        d0 = jnp.min(jnp.where(mask, inf, d2), axis=-1)
        outs.append(d1 - d0)
    llr = jnp.stack(outs, axis=-1)  # (..., m)
    return llr / jnp.asarray(noise_var, jnp.float32)[..., None]


def llr_maxlog(
    points: jnp.ndarray, mod: Modulation, noise_var
) -> jnp.ndarray:
    """Max-log LLRs for (..., n_sym) normalized points.

    noise_var broadcasts against ``points`` (pass the per-subcarrier
    effective variance from the equalizer for fading channels).
    Returns float32 (..., n_sym * bits_per_symbol), MSB-first per
    symbol, ordering identical to ``modulate``'s input bits.
    """
    nv = jnp.broadcast_to(jnp.asarray(noise_var, jnp.float32), points.shape)
    if mod is Modulation.BPSK:
        llr = _axis_llr(jnp.real(points), mod, nv)
        return llr.reshape(*points.shape[:-1], points.shape[-1])
    llr_i = _axis_llr(jnp.real(points), mod, nv)  # (..., n_sym, m)
    llr_q = _axis_llr(jnp.imag(points), mod, nv)
    llr = jnp.concatenate([llr_i, llr_q], axis=-1)  # (..., n_sym, bps)
    return llr.reshape(*points.shape[:-1], points.shape[-1] * mod.bits_per_symbol)


def _axis_llr_exact(y: jnp.ndarray, mod: Modulation, noise_var) -> jnp.ndarray:
    """Exact per-axis LLRs via log-sum-exp over the level sets."""
    _, pam, norm, _ = _tables(mod)
    levels = jnp.asarray(pam) * norm
    nv = jnp.asarray(noise_var, jnp.float32)[..., None]
    ll = -((y[..., None] - levels) ** 2) / nv  # (..., L) log-likelihoods
    masks = _axis_bit_masks(mod)
    neg = jnp.float32(-3.4e38)
    outs = []
    for j in range(mod.bits_per_axis):
        mask = jnp.asarray(masks[j])
        lse0 = jax.nn.logsumexp(jnp.where(mask, neg, ll), axis=-1)
        lse1 = jax.nn.logsumexp(jnp.where(mask, ll, neg), axis=-1)
        outs.append(lse0 - lse1)
    return jnp.stack(outs, axis=-1)


def llr_exact(points: jnp.ndarray, mod: Modulation, noise_var) -> jnp.ndarray:
    """Exact (true-MAP) LLRs — same signature/ordering as llr_maxlog.

    Log-sum-exp over each bit's level set instead of the max-log min.
    Costs ~2 transcendentals per level; use when LLR fidelity to the
    true posterior matters (e.g. feeding an iterative decoder). The
    max-log version is the hot-path default; both agree as noise_var → 0 (tested).
    """
    nv = jnp.broadcast_to(jnp.asarray(noise_var, jnp.float32), points.shape)
    if mod is Modulation.BPSK:
        llr = _axis_llr_exact(jnp.real(points), mod, nv)
        return llr.reshape(*points.shape[:-1], points.shape[-1])
    llr_i = _axis_llr_exact(jnp.real(points), mod, nv)
    llr_q = _axis_llr_exact(jnp.imag(points), mod, nv)
    llr = jnp.concatenate([llr_i, llr_q], axis=-1)
    return llr.reshape(*points.shape[:-1], points.shape[-1] * mod.bits_per_symbol)


def llr_to_hard_bits(llr: jnp.ndarray) -> jnp.ndarray:
    """Hard decisions from LLRs: bit = 1 iff LLR < 0."""
    return (llr < 0).astype(jnp.int8)
