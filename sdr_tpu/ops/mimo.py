"""MIMO processing: Alamouti STBC, receive MRC, spatial-mux detection.

The reference is strictly SISO (one `ofdm::tx` stream into one
`ofdm::rx`, /root/reference/lib/inc/ofdm.hpp:13-54); multi-antenna
operation is new capability in this framework. Everything here is a
pure batched array program over the post-/pre-FFT OFDM grids the rest
of the framework already uses:

- antenna axes are ordinary leading array axes (vmap/shard-map
  friendly — a channel-batched MIMO link is one fused XLA program);
- per-subcarrier detection is einsum over tiny (n_rx, n_tx) matrices,
  batched over (symbols, subcarriers) — XLA vectorizes over the
  batch; no loops, no dynamic shapes;
- the spatial-mux MMSE filter needs one small Hermitian inverse per
  subcarrier: n_tx = 2 uses the closed-form 2x2 inverse (pure
  elementwise arithmetic), larger arrays fall back to
  jnp.linalg.inv on the (..., n_tx, n_tx) batch.

Power convention: total transmitted energy per subcarrier per symbol
period is 1 regardless of n_tx (the per-antenna amplitude scale is
1/sqrt(n_tx)), so Eb/N0 accounting stays comparable with SISO: the
noise variance is computed against the TOTAL bits carried per
subcarrier use (n_streams * bits_per_symbol for spatial mux).

Measured-theory anchors (link.ber): Alamouti over flat Rayleigh is
exactly 2*n_rx-branch MRC at half per-branch SNR (ber_alamouti_exact),
receive MRC is n_rx-branch MRC at full SNR (ber_mrc_exact) — both
validated statistically in tests/test_mimo.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.modulation import _tables  # shared static tables

# Detection is small complex products (2x2 to 8x8 per subcarrier); full
# f32 keeps a GPU from running them in TF32.
_HI = jax.lax.Precision.HIGHEST


def _abs2(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.real(x) ** 2 + jnp.imag(x) ** 2


# ---------------------------------------------------------------------------
# Alamouti space-time block code (G2), per subcarrier across symbol pairs
# ---------------------------------------------------------------------------


def alamouti_encode(x: jnp.ndarray) -> jnp.ndarray:
    """G2 STBC encode one stream onto two TX antennas.

    x: (..., n_symbols, n_fft) constellation grid, n_symbols even.
    Returns (..., 2, n_symbols, n_fft): for each symbol pair (x0, x1)
    antenna 0 transmits [x0, -conj(x1)] and antenna 1 [x1, conj(x0)]
    over the two symbol periods (Alamouti 1998), scaled by 1/sqrt(2) so
    total radiated energy per subcarrier per period stays 1.
    """
    s = x.shape[-2]
    if s % 2:
        raise ValueError(f"Alamouti needs an even symbol count, got {s}")
    n = x.shape[-1]
    xp = x.reshape(x.shape[:-2] + (s // 2, 2, n))
    x0, x1 = xp[..., 0, :], xp[..., 1, :]
    ant0 = jnp.stack([x0, -jnp.conj(x1)], axis=-2)  # (..., P, 2, N)
    ant1 = jnp.stack([x1, jnp.conj(x0)], axis=-2)
    out = jnp.stack([ant0, ant1], axis=-4)  # (..., 2, P, 2, N)
    out = out.reshape(x.shape[:-2] + (2, s, n))
    return (out * jnp.float32(2.0 ** -0.5)).astype(x.dtype)


def alamouti_combine(y: jnp.ndarray, h: jnp.ndarray, noise_var):
    """Alamouti maximum-ratio combiner with genie/estimated CSI.

    y: (..., n_rx, n_symbols, n_fft) post-FFT observations;
    h: (..., n_rx, 2, n_fft) or (..., n_rx, 2, 1) per-subcarrier
    responses, assumed static over each symbol pair (frame-static
    models). Returns (s, eff_var): the unbiased per-symbol estimates
    (..., n_symbols, n_fft) and their effective noise variance —
    combining 2*n_rx diversity branches yields SINR = g/(2*nv) with
    g = sum |h_rt|^2, i.e. eff_var = 2*nv/g (the 1/2 is the TX power
    split the scheme pays for transmit diversity).
    """
    s = y.shape[-2]
    n = y.shape[-1]
    yp = y.reshape(y.shape[:-2] + (s // 2, 2, n))
    r0, r1 = yp[..., 0, :], yp[..., 1, :]  # (..., n_rx, P, N)
    h0 = h[..., 0, :][..., None, :]  # (..., n_rx, 1, N-or-1)
    h1 = h[..., 1, :][..., None, :]
    # x0_hat = sum_r conj(h_r0) r0 + h_r1 conj(r1)
    # x1_hat = sum_r conj(h_r1) r0 - h_r0 conj(r1)
    x0 = jnp.sum(jnp.conj(h0) * r0 + h1 * jnp.conj(r1), axis=-3)
    x1 = jnp.sum(jnp.conj(h1) * r0 - h0 * jnp.conj(r1), axis=-3)
    g = jnp.sum(_abs2(h), axis=-3)  # (..., 2, N') summed over rx
    g = jnp.sum(g, axis=-2)[..., None, :]  # (..., 1, N') summed over tx
    scale = jnp.float32(2.0 ** 0.5) / jnp.maximum(g, 1e-12)
    est = jnp.stack([x0 * scale, x1 * scale], axis=-2)  # (..., P, 2, N)
    est = est.reshape(y.shape[:-3] + (s, n))
    nv = jnp.asarray(noise_var, jnp.float32)
    eff_var = 2.0 * nv / jnp.maximum(g, 1e-12)  # (..., 1, N')
    return est, jnp.broadcast_to(eff_var, est.shape[:-2] + (1, eff_var.shape[-1]))


# ---------------------------------------------------------------------------
# Receive MRC (1 x n_rx)
# ---------------------------------------------------------------------------


def mrc_combine(y: jnp.ndarray, h: jnp.ndarray, noise_var):
    """Maximum-ratio combining across receive antennas (n_tx = 1).

    y: (..., n_rx, n_symbols, n_fft); h: (..., n_rx, 1, n_fft) or
    (..., n_rx, 1, 1). s = sum_r conj(h_r) y_r / g with g = sum |h_r|^2
    — the matched filter; eff_var = nv/g (SINR adds across branches).
    """
    hh = h[..., 0, :][..., None, :]  # (..., n_rx, 1, N')
    num = jnp.sum(jnp.conj(hh) * y, axis=-3)  # (..., S, N)
    g = jnp.sum(_abs2(hh), axis=-3)  # (..., 1, N')
    s = num / jnp.maximum(g, 1e-12)
    nv = jnp.asarray(noise_var, jnp.float32)
    return s, nv / jnp.maximum(g, 1e-12)


# ---------------------------------------------------------------------------
# Spatial multiplexing (V-BLAST): linear MMSE / ZF detection
# ---------------------------------------------------------------------------


def mux_encode(x: jnp.ndarray) -> jnp.ndarray:
    """Scale n_tx independent streams to total unit power.

    x: (..., n_tx, n_symbols, n_fft) → same shape * 1/sqrt(n_tx).
    """
    n_tx = x.shape[-3]
    return (x * jnp.float32(n_tx ** -0.5)).astype(x.dtype)


def _inv_hermitian(m: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of small Hermitian positive-definite matrices.

    m: (..., k, k) complex. k = 1, 2 use closed forms (elementwise
    arithmetic — no linalg lowering); larger k uses jnp.linalg.inv.
    """
    k = m.shape[-1]
    if k == 1:
        return 1.0 / m
    if k == 2:
        a = m[..., 0, 0]
        b = m[..., 0, 1]
        c = m[..., 1, 0]
        d = m[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack(
            [
                jnp.stack([d, -b], axis=-1),
                jnp.stack([-c, a], axis=-1),
            ],
            axis=-2,
        )
        return inv / det[..., None, None]
    return jnp.linalg.inv(m)


def _mux_detect(y: jnp.ndarray, h: jnp.ndarray, noise_var, zf: bool):
    n_tx = h.shape[-2]
    nv = jnp.asarray(noise_var, jnp.float32)
    # Effective channel includes the TX power split.
    a = (h * jnp.float32(n_tx ** -0.5)).astype(jnp.complex64)
    # Rearrange to (..., N', n_rx, n_tx) so matrices batch per subcarrier.
    am = jnp.moveaxis(a, -1, -3)
    gram = jnp.einsum("...rt,...rs->...ts", jnp.conj(am), am, precision=_HI)
    eye = jnp.eye(n_tx, dtype=gram.dtype)
    reg = jnp.complex64(1e-12) if zf else (nv.astype(jnp.complex64))
    w = _inv_hermitian(gram + reg * eye)  # (..., N', n_tx, n_tx)
    # z = A^H y per subcarrier: y is (..., n_rx, S, N) → (..., N, S, n_rx)
    ym = jnp.swapaxes(jnp.moveaxis(y, -3, -1), -3, -2)
    z = jnp.einsum("...rt,...sr->...st", jnp.conj(am), ym, precision=_HI)  # (..., N', S, n_tx)
    xb = jnp.einsum("...ts,...is->...it", w, z, precision=_HI)  # biased estimates (..., N', S, n_tx)
    wkk = jnp.real(jnp.einsum("...tt->...t", w))  # (..., N', n_tx)
    if zf:
        # ZF fully inverts: unbiased already; eff_var_k = nv * [(A^H A)^-1]_kk.
        est = xb
        eff = nv * wkk
    else:
        # Unbiased MMSE: bias_k = 1 - nv*W_kk; SINR_k = 1/(nv W_kk) - 1.
        bias = jnp.maximum(1.0 - nv * wkk, 1e-12)
        est = xb / bias[..., None, :]
        eff = nv * wkk / bias
    # Back to (..., n_tx, S, N) and (..., n_tx, 1, N).
    est = jnp.moveaxis(jnp.moveaxis(est, -1, -3), -1, -2)  # (..., n_tx, S, N')
    eff = jnp.moveaxis(eff, -1, -2)[..., None, :]  # (..., n_tx, 1, N')
    return est, eff


def mux_detect_mmse(y: jnp.ndarray, h: jnp.ndarray, noise_var):
    """Linear MMSE detection of n_tx spatially-multiplexed streams.

    y: (..., n_rx, n_symbols, n_fft); h: (..., n_rx, n_tx, n_fft) or
    (..., n_rx, n_tx, 1). Returns (s, eff_var) with s
    (..., n_tx, n_symbols, n_fft): the UNBIASED MMSE estimates
    x_hat = (A^H A + nv I)^-1 A^H y / bias and the per-stream effective
    noise variance 1/SINR_k with the standard unbiased-MMSE SINR
    1/(nv [(A^H A + nv I)^-1]_kk) - 1 (A = H/sqrt(n_tx)). Residual
    inter-stream interference is treated as Gaussian for LLR scaling —
    the standard soft-output linear detector.
    """
    return _mux_detect(y, h, noise_var, zf=False)


def mux_detect_zf(y: jnp.ndarray, h: jnp.ndarray, noise_var):
    """Zero-forcing detection (n_rx >= n_tx): exact interference
    inversion; eff_var_k = nv [(A^H A)^-1]_kk (noise enhancement)."""
    return _mux_detect(y, h, noise_var, zf=True)


# ---------------------------------------------------------------------------
# Spatial multiplexing: ordered MMSE-SIC (V-BLAST)
# ---------------------------------------------------------------------------


def mux_detect_sic(y: jnp.ndarray, h: jnp.ndarray, noise_var, mod: Modulation):
    """Ordered MMSE successive interference cancellation (V-BLAST,
    Wolniansky et al. 1998): n_tx unrolled rounds of {MMSE filter on
    the still-active streams, detect the highest-post-SINR one, slice
    to the nearest constellation point, subtract its contribution}.

    Sits between linear MMSE (diversity n_rx - n_tx + 1) and joint ML
    (diversity n_rx) in both BER and cost, and is the practical soft
    detector when the ML candidate budget is exceeded (e.g. 4x4
    64-QAM = 16.7M candidates). Error propagation through wrong slices
    is real and simulated — nothing genie-aided.

    Array mapping: n_tx is static so the SIC loop fully unrolls; the
    per-subcarrier ordering is data-dependent but expressed as argmax +
    one-hot masking over the static stream axis — no gather/scatter
    with dynamic shapes, every step is batched einsums + a masked
    n_tx x n_tx inverse over all subcarriers at once.

    Interface matches the linear detectors: y (..., n_rx, S, n_fft),
    h (..., n_rx, n_tx, n_fft|1); returns (s, eff_var) with s
    (..., n_tx, S, n_fft) unbiased estimates (each stream's estimate
    taken at its detection round) and eff_var (..., n_tx, 1, n_fft)
    the unbiased-MMSE 1/SINR at that round.
    """
    from sdr_tpu.ops.modulation import constellation, nearest_symbol

    n_tx = h.shape[-2]
    nv = jnp.asarray(noise_var, jnp.float32)
    a = (h * jnp.float32(n_tx ** -0.5)).astype(jnp.complex64)
    am = jnp.moveaxis(a, -1, -3)  # (..., N', n_rx, n_tx); N'=1 for flat h
    ym = jnp.swapaxes(jnp.moveaxis(y, -3, -1), -3, -2)  # (..., N, S, n_rx)
    # Flat channels keep N'=1 through the filter derivation (one Gram/
    # inverse/ordering, shared by every subcarrier — same economy as
    # _mux_detect); only the data-dependent slice/subtract terms
    # broadcast up to the full N.
    const = constellation(mod)
    active = jnp.ones(am.shape[:-2] + (n_tx,), jnp.float32)  # (..., N', n_tx)
    resid = ym
    est = jnp.zeros(ym.shape[:-1] + (n_tx,), jnp.complex64)  # (..., N, S, n_tx)
    effv = jnp.zeros(active.shape, jnp.float32)  # (..., N', n_tx)
    eye = jnp.eye(n_tx, dtype=jnp.complex64)
    for _ in range(n_tx):
        a_act = am * active[..., None, :]
        gram = jnp.einsum(
            "...rt,...rs->...ts", jnp.conj(a_act), a_act, precision=_HI
        )
        # Inactive streams get a unit diagonal so the inverse exists;
        # their rows/cols are masked out of the selection below.
        pad = jnp.einsum(
            "...t,ts->...ts", 1.0 - active, eye
        )
        w = _inv_hermitian(gram + nv.astype(jnp.complex64) * eye + pad)
        wkk = jnp.real(jnp.einsum("...tt->...t", w))  # (..., N', n_tx)
        sinr = 1.0 / jnp.maximum(nv * wkk, 1e-12) - 1.0
        sinr = jnp.where(active > 0.5, sinr, -jnp.inf)
        pick = jnp.argmax(sinr, axis=-1)  # (..., N')
        onehot = jax.nn.one_hot(pick, n_tx, dtype=jnp.float32)
        z = jnp.einsum(
            "...rt,...sr->...st", jnp.conj(a_act), resid, precision=_HI
        )
        xb = jnp.einsum("...ts,...is->...it", w, z, precision=_HI)  # (..., N', S, n_tx)
        wkk_p = jnp.sum(wkk * onehot, axis=-1)  # (..., N')
        bias = jnp.maximum(1.0 - nv * wkk_p, 1e-12)[..., None]
        x_p = jnp.sum(xb * onehot[..., None, :], axis=-1) / bias  # (..., N, S)
        # Slice, subtract, retire the stream.
        s_hard = const[nearest_symbol(x_p, mod)]
        a_p = jnp.sum(am * onehot[..., None, :], axis=-1)  # (..., N', n_rx)
        resid = resid - s_hard[..., None] * a_p[..., None, :]
        est = est + x_p[..., None] * onehot[..., None, :]
        effv = effv + (nv * wkk_p / bias[..., 0])[..., None] * onehot
        active = active - onehot
    est = jnp.moveaxis(jnp.moveaxis(est, -1, -3), -1, -2)  # (..., n_tx, S, N)
    effv = jnp.moveaxis(effv, -1, -2)[..., None, :]  # (..., n_tx, 1, N')
    return est, effv


# ---------------------------------------------------------------------------
# Spatial multiplexing: max-log ML joint detection (soft output)
# ---------------------------------------------------------------------------


ML_MAX_CANDIDATES = 4096  # n_tx=2 up to 64-QAM; the joint-search budget


@functools.lru_cache(maxsize=None)
def _ml_tables(mod: Modulation, n_tx: int):
    """Joint-candidate tables for max-log ML detection.

    Returns (cand (C, n_tx) complex64 normalized points,
    bit_masks (n_tx*bps, C) bool) with C = M**n_tx. Candidate c is the
    tuple of per-stream constellation points whose MSB-first bits,
    stream 0 first, are given by column c of bit_masks — the same bit
    order ``modulate`` consumes, so ML LLRs drop into the pipeline
    where the per-stream max-log demapper output would go.
    """
    const, _, _, _ = _tables(mod)  # (M,) complex64
    M = const.shape[0]
    bps = mod.bits_per_symbol
    if M ** n_tx > ML_MAX_CANDIDATES:
        raise ValueError(
            f"ML joint search over {M}^{n_tx} candidates exceeds the "
            f"{ML_MAX_CANDIDATES}-candidate budget"
        )
    idx = np.indices((M,) * n_tx).reshape(n_tx, -1)  # (n_tx, C)
    cand = const[idx.T]  # (C, n_tx)
    masks = np.concatenate(
        [
            ((idx[t][None, :] >> np.arange(bps - 1, -1, -1)[:, None]) & 1)
            for t in range(n_tx)
        ],
        axis=0,
    ).astype(bool)  # (n_tx*bps, C)
    return cand.astype(np.complex64), masks


def mux_detect_ml(y: jnp.ndarray, h: jnp.ndarray, noise_var, mod: Modulation):
    """Max-log ML joint detection of spatially-multiplexed streams.

    The optimum (per-bit max-log) detector: enumerate all M**n_tx joint
    candidates s_c and take per-bit metric differences of
    ||y - A s_c||^2 (A = H/sqrt(n_tx)). Against linear ZF/MMSE this
    recovers the full receive diversity order n_rx instead of
    n_rx - n_tx + 1 — the curves cross decades apart at high SNR
    (docs/figures/ber_mux.png).

    Array mapping: the candidate metric splits as
    q_c - 2 Re(z^H s_c) with z = A^H y per resource element and
    q_c = s_c^H G s_c per subcarrier (G = A^H A) — the ||y||^2 term is
    candidate-independent and dropped. Both terms are batched einsums
    with the (C, n_tx) candidate table as one operand: the cross term
    is a (S*N', C) x (C-contraction over n_tx) matmul XLA
    vectorizes over ALL resource elements at once; no per-candidate
    loop, no dynamic shapes.

    y: (..., n_rx, n_symbols, n_fft); h: (..., n_rx, n_tx, n_fft) or
    (..., n_rx, n_tx, 1); noise_var scalar. Returns float32 LLRs
    (..., n_tx, n_symbols, n_fft * bits_per_symbol), sign convention as
    ops.llr (positive => bit 0, hard bit = LLR < 0), bit order matching
    ``modulate``.
    """
    n_tx = h.shape[-2]
    bps = mod.bits_per_symbol
    cand_np, masks_np = _ml_tables(mod, n_tx)
    cand = jnp.asarray(cand_np)  # (C, n_tx)
    nv = jnp.asarray(noise_var, jnp.float32)
    a = (h * jnp.float32(n_tx ** -0.5)).astype(jnp.complex64)
    am = jnp.moveaxis(a, -1, -3)  # (..., N', n_rx, n_tx)
    gram = jnp.einsum("...rt,...rs->...ts", jnp.conj(am), am, precision=_HI)
    # q_c = s_c^H G s_c, real by hermiticity: (..., N', C)
    q = jnp.real(jnp.einsum(
        "ct,...tu,cu->...c", jnp.conj(cand), gram, cand, precision=_HI
    ))
    ym = jnp.swapaxes(jnp.moveaxis(y, -3, -1), -3, -2)  # (..., N', S, n_rx)
    z = jnp.einsum("...rt,...sr->...st", jnp.conj(am), ym, precision=_HI)  # (..., N', S, n_tx)
    cross = jnp.real(jnp.einsum(
        "...st,ct->...sc", z, jnp.conj(cand), precision=_HI
    ))
    metric = q[..., None, :] - 2.0 * cross  # (..., N', S, C)
    inf = jnp.float32(np.inf)
    llrs = []
    for j in range(n_tx * bps):
        mask = jnp.asarray(masks_np[j])
        d1 = jnp.min(jnp.where(mask, metric, inf), axis=-1)
        d0 = jnp.min(jnp.where(mask, inf, metric), axis=-1)
        llrs.append(d1 - d0)
    llr = jnp.stack(llrs, axis=-1) / nv  # (..., N', S, n_tx*bps)
    # → (..., n_tx, S, N' * bps) in modulate's per-subcarrier bit order.
    n_sc, n_sym = llr.shape[-3], llr.shape[-2]
    llr = llr.reshape(llr.shape[:-1] + (n_tx, bps))  # (..., N', S, n_tx, bps)
    llr = jnp.moveaxis(llr, -2, -4)  # (..., n_tx, N', S, bps)
    llr = jnp.swapaxes(llr, -3, -2)  # (..., n_tx, S, N', bps)
    return llr.reshape(llr.shape[:-2] + (n_sc * bps,))
