"""Float64 numpy reference of the link stages, for the CPU tests.

Written from the stage definitions, not from the library code: Gray
square-QAM constellation (per-axis binary-reflected Gray, I from the
MSB half of the symbol index), 1/N-scaled IDFT + cyclic prefix at TX,
CP strip + unscaled DFT at RX, unbiased one-tap MMSE, and max-log LLRs
taken by brute force over the whole 2-D constellation (the library
separates the axes; this does not).
"""

from __future__ import annotations

import numpy as np


def constellation(mod) -> np.ndarray:
    """complex128 (M,), unit average energy, indexed by symbol integer."""
    m = mod.bits_per_axis
    L = 1 << m
    g = np.arange(L)
    b = g.copy()  # Gray → binary by prefix XOR
    s = 1
    while s < m:
        b = b ^ (b >> s)
        s <<= 1
    level = (2 * b - (L - 1)).astype(np.float64)  # level[gray index]
    if mod.bits_per_symbol == 1:
        pts = level.astype(np.complex128)
    else:
        idx = np.arange(1 << mod.bits_per_symbol)
        pts = level[idx >> m] + 1j * level[idx & (L - 1)]
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


def bits_of(idx: np.ndarray, bps: int) -> np.ndarray:
    """(..., n) symbol integers → (..., n·bps) bits, MSB first."""
    shifts = np.arange(bps - 1, -1, -1)
    bits = (np.asarray(idx)[..., None] >> shifts) & 1
    return bits.reshape(*bits.shape[:-2], -1)


def ofdm_tx(points: np.ndarray, cp: int) -> np.ndarray:
    x = np.fft.ifft(points, axis=-1)
    return np.concatenate([x[..., x.shape[-1] - cp:], x], axis=-1)


def ofdm_rx(samples: np.ndarray, cp: int) -> np.ndarray:
    return np.fft.fft(samples[..., cp:], axis=-1)


def mmse(y, h, nv):
    """Unbiased one-tap MMSE: (symbol estimates, effective noise var)."""
    h2 = np.abs(h) ** 2
    s = (np.conj(h) * y / (h2 + nv)) / (h2 / (h2 + nv))
    return s, np.broadcast_to(nv / h2, s.shape)


def mmse_fde(y, h, nv):
    """SC-FDE: per-tone biased MMSE, unitary despread, symbol-level
    bias correction; effective variance (1 - b) / b per symbol."""
    h2 = np.abs(h) ** 2
    sf = np.conj(h) * y / (h2 + nv)
    b = np.mean(np.broadcast_to(h2 / (h2 + nv), y.shape), axis=-1,
                keepdims=True)
    n = y.shape[-1]
    st = np.fft.ifft(sf, axis=-1) * np.sqrt(n) / b
    return st, np.broadcast_to((1.0 - b) / b, st.shape)


def llr_maxlog(s, mod, eff):
    """Brute-force max-log LLRs, (..., n) points → (..., n·bps)."""
    pts = constellation(mod)
    bps = mod.bits_per_symbol
    lab = bits_of(np.arange(pts.size)[:, None], bps)  # (M, bps)
    d2 = np.abs(s[..., None] - pts) ** 2  # (..., n, M)
    out = np.empty(s.shape + (bps,))
    for j in range(bps):
        one = lab[:, j] == 1
        out[..., j] = (d2[..., one].min(-1) - d2[..., ~one].min(-1))
    out /= np.asarray(eff)[..., None]
    return out.reshape(*s.shape[:-1], -1)


def demod(re, im, hr, hi, cp, mod, nv, despread=False):
    y = ofdm_rx(np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64),
                cp)
    h = np.asarray(hr, np.float64) + 1j * np.asarray(hi, np.float64)
    s, eff = (mmse_fde if despread else mmse)(y, h, nv)
    return llr_maxlog(s, mod, eff)


def fast_engine_counts(cfg, key, tol=2e-5):
    """Per-channel error counts of the fast engine's own TX + channel
    output, demodulated by this reference; with the per-channel number
    of reference LLRs within ``tol`` x max|LLR| of zero (decisions a
    float32 chain may take the other way)."""
    import jax.numpy as jnp

    from sdr_tpu.link.fast import (
        _draw_idx, _fade_state, _role_keys, tx_channel_core,
    )

    ids = jnp.arange(cfg.n_channels)
    re, im = tx_channel_core(cfg, key, ids)
    h, _ = _fade_state(cfg, _role_keys(key, ids)[2])
    n = cfg.ofdm.n_fft
    h = (np.ones((cfg.n_channels, 1, n)) if h is None
         else np.broadcast_to(np.asarray(h), (cfg.n_channels, h.shape[1], n)))
    bps = cfg.modulation.bits_per_symbol
    nv = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * bps)
    llr = demod(re, im, h.real, h.imag, cfg.ofdm.cp_len, cfg.modulation, nv,
                despread=cfg.dft_spread)
    bits = bits_of(np.asarray(_draw_idx(cfg, key, ids)), bps)
    errs = ((llr < 0) != bits).sum(axis=(1, 2))
    margin = (np.abs(llr) < tol * np.abs(llr).max()).sum(axis=(1, 2))
    return errs, margin
