"""Comb pilots and LS channel estimation.

Neither the reference (pure noiseless loopback, no channel — ofdm.hpp)
nor perfect-CSI simulation needs this; a deployable receiver does. The
scheme is the standard OFDM comb: every ``spacing``-th subcarrier
carries a known pilot point; the receiver least-squares-estimates the
channel at the pilots (averaging over the frame's symbols — block
fading) and linearly interpolates across subcarriers.

All index/weight tables are computed at trace time from the static
(n_fft, spacing), so the estimator is a gather + lerp — fully batched,
jit/vmap/shard-safe.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# DFT-subspace projections are f32 estimates, not tensor-core work: full
# f32 keeps a GPU from running them in TF32.
_HI = jax.lax.Precision.HIGHEST

# Unit-power pilot point (45° QPSK corner) — known at both ends.
PILOT_VALUE = complex(2 ** -0.5, 2 ** -0.5)


@functools.lru_cache(maxsize=None)
def zadoff_chu(n: int, root: int = 1) -> np.ndarray:
    """Length-n Zadoff-Chu sequence (unit power per element), complex64.

    x[k] = exp(-jπ·u·k²/n) for even n (all our grids are powers of 2);
    exp(-jπ·u·k(k+1)/n) for odd n. CAZAC: constant amplitude in BOTH
    domains (its DFT is again a scaled chirp), which is exactly what a
    full-grid SC-FDMA reference symbol needs — every subcarrier
    observed at unit power for LS estimation, while the time-domain
    waveform stays constant-modulus through the PA. NUMPY result (see
    _dft_projection_full's tracer note).
    """
    k = np.arange(n, dtype=np.float64)
    quad = k * k if n % 2 == 0 else k * (k + 1)
    return np.exp(-1j * np.pi * root * quad / n).astype(np.complex64)


def estimate_block_pilots(y_pil: jnp.ndarray, n_taps: int = 0) -> jnp.ndarray:
    """LS channel estimate from full-grid Zadoff-Chu pilot SYMBOLS.

    y_pil: (..., n_blocks, n_fft) received reference symbols (one per
    SC-FDMA pilot block). Per-tone LS against the known chirp, averaged
    over the blocks (frame-static channels — config validation gates
    time-varying models out of this mode), optionally projected onto
    the n_taps-tap impulse-response subspace (the DFT denoiser —
    estimation noise outside the delay spread is discarded).
    Returns (..., n_fft).
    """
    zc = jnp.asarray(zadoff_chu(y_pil.shape[-1]))
    h = jnp.mean(y_pil * jnp.conj(zc), axis=-2)  # |zc|=1: conj == divide
    if n_taps:
        h = jnp.matmul(
            h, jnp.asarray(_dft_projection_full(h.shape[-1], n_taps)),
            precision=_HI,
        )
    return h


def estimate_block_pilots_interp_full(
    y_pil: jnp.ndarray, spacing: int
) -> jnp.ndarray:
    """Block-pilot estimate for SELECTIVE time-varying fading
    (MULTIPATH_TIME): per-TONE complex chord interpolation between
    consecutive pilot-block LS estimates.

    Under a per-tap-Jakes TDL every tone's complex gain evolves at the
    Doppler rate but with its OWN trajectory (taps fade independently),
    so the flat-Jakes factorization shape × scalar
    (``estimate_block_pilots_interp``) no longer holds — the estimate
    must interpolate each tone separately: data symbol (block b,
    offset o) takes (1−o/p)·h_b(k) + (o/p)·h_{b+1}(k), the last block
    extrapolating along its previous chord. Valid under the same
    coherence gate (pilot_spacing·doppler_norm ≤ 0.25, config-enforced)
    since each tone moves at the same Doppler rate as the flat case.
    The price vs the flat estimator is estimation noise: no averaging
    across blocks or tones is possible for a channel that varies in
    both. y_pil: (..., B, n_fft) → (..., B, spacing−1, n_fft).
    """
    p = int(spacing)
    zc = jnp.asarray(zadoff_chu(y_pil.shape[-1]))
    hb = y_pil * jnp.conj(zc)  # (..., B, n_fft) per-block per-tone LS
    B = hb.shape[-2]
    if B > 1:
        h_next = jnp.concatenate(
            [hb[..., 1:, :], 2.0 * hb[..., -1:, :] - hb[..., -2:-1, :]],
            axis=-2,
        )
    else:
        h_next = hb
    w = (jnp.arange(1, p, dtype=jnp.float32) / p)[:, None]  # (p-1, 1)
    return (1.0 - w) * hb[..., :, None, :] + w * h_next[..., :, None, :]


def estimate_block_pilots_interp(
    y_pil: jnp.ndarray, spacing: int
) -> jnp.ndarray:
    """Block-pilot estimate for FLAT time-varying fading (Jakes):
    frame-averaged SHAPE × per-block complex SCALAR, the scalar
    linearly interpolated per data symbol.

    Jakes in this framework is flat per OFDM symbol — but the
    RECEIVED frame's frequency response is not exactly flat: a
    residual timing shift (e.g. the acquired path's CP backoff)
    multiplies every tone by a LINEAR phase, so naively averaging the
    per-tone LS across the grid sums a rotating phasor and collapses
    (measured ~50× amplitude loss at a 2-sample shift on a 64-FFT).
    Instead:

    1. per-block raw LS h_b = y_pil·conj(ZC) (..., B, n_fft);
    2. chain the per-block common phases (the tracked-estimator
       logic) and average the derotated blocks into ONE per-tone
       SHAPE — the static part: timing phase × mean gain;
    3. per-block complex scalar c_b = ⟨h_b, shape⟩/‖shape‖² — the
       fading trajectory relative to the shape (amplitude AND phase);
    4. data symbol (block b, offset o) takes the chord
       (1−o/p)·c_b + (o/p)·c_{b+1} (last block extrapolates along its
       previous chord); returns shape × interpolated scalar.

    Valid while the pilot period stays inside the coherence time
    (p ≲ 1/(4·fD·T), config-gated); composes with residual CFO (the
    rotation rides the chained phases/scalars). y_pil: (..., B, n_fft)
    → (..., B, spacing-1, n_fft) aligned with the data symbols.
    """
    p = int(spacing)
    zc = jnp.asarray(zadoff_chu(y_pil.shape[-1]))
    hb = y_pil * jnp.conj(zc)  # (..., B, n_fft)
    B = hb.shape[-2]
    if B > 1:
        d = jnp.sum(hb[..., 1:, :] * jnp.conj(hb[..., :-1, :]), axis=-1)
        dphi = jnp.angle(d)
        phi = jnp.concatenate(
            [jnp.zeros_like(dphi[..., :1]), jnp.cumsum(dphi, axis=-1)],
            axis=-1,
        )
    else:
        phi = jnp.zeros(hb.shape[:-1], jnp.float32)
    rot = jnp.exp(jax.lax.complex(jnp.zeros_like(phi), -phi))[..., None]
    shape = jnp.mean(hb * rot, axis=-2)  # (..., n_fft) static part
    denom = jnp.maximum(
        jnp.sum(jnp.abs(shape) ** 2, axis=-1, keepdims=True), 1e-30
    )
    c = (
        jnp.sum(hb * jnp.conj(shape)[..., None, :], axis=-1)
        / denom
    )  # (..., B) complex fading trajectory at the pilot instants
    if B > 1:
        c_next = jnp.concatenate(
            [c[..., 1:], (2.0 * c[..., -1:] - c[..., -2:-1])], axis=-1
        )
    else:
        c_next = c
    w = jnp.arange(1, p, dtype=jnp.float32) / p  # (p-1,)
    ci = (1.0 - w) * c[..., :, None] + w * c_next[..., :, None]
    return ci[..., None] * shape[..., None, None, :]


@functools.lru_cache(maxsize=None)
def pn_preamble_grid(n_fft: int, seed: int = 0xA11) -> np.ndarray:
    """Unit-power pseudo-random QPSK pilot grid (n_fft,), complex64.

    The PA-safe alternative to a constant pilot grid: a constant grid
    IFFTs to a time-domain IMPULSE (all energy in one sample) that a
    nonlinear PA clips catastrophically, while a PN grid's time
    waveform has the same complex-Gaussian statistics as a data OFDM
    symbol — so the pilot experiences the SAME Bussgang compression
    the data does and the LS estimate absorbs the right gain. NUMPY
    (static table)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, n_fft)
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * q)).astype(np.complex64)


def estimate_block_pilots_tracked(
    y_pil: jnp.ndarray, spacing: int, n_taps: int = 0
) -> jnp.ndarray:
    """Block-pilot LS estimate + per-symbol common-phase tracking.

    The SC-FDMA twin of estimate_ls_comb_tracked: after blind
    acquisition a residual CFO (~1e-2 subcarriers) rotates every tone
    by the same phase, a little more each symbol — but SC-FDMA pilots
    are whole SYMBOLS every ``spacing`` periods, so the phase between
    them must be INTERPOLATED, not differenced per symbol:

    1. per-block raw LS h_b = y_pil·conj(ZC) (..., B, n_fft);
    2. differential phase between consecutive pilot blocks
       Δφ_b = angle(Σ_k h_{b+1}[k]·conj(h_b[k])) — the channel shape
       cancels; Δφ_b spans ``spacing`` symbol periods, so tracking is
       unambiguous while the residual CFO stays under
       1/(2·spacing·(1+cp/n)) subcarriers (far above the acquisition
       residual);
    3. cumulative pilot phases φ_b; derotate, average ALL blocks →
       one noise-averaged channel shape (optional n_taps DFT
       projection);
    4. each data symbol (block b, offset o = 1..spacing-1) gets
       h = shape · e^{i(φ_b + o·Δφ_b/spacing)} — linear interpolation
       of the common phase, the exact model for a constant residual
       CFO (the last block reuses the previous slope).

    y_pil: (..., B, n_fft). Returns (..., B, spacing-1, n_fft) aligned
    with the data symbols of each block.
    """
    p = int(spacing)
    zc = jnp.asarray(zadoff_chu(y_pil.shape[-1]))
    hb = y_pil * jnp.conj(zc)  # (..., B, n_fft)
    B = hb.shape[-2]
    if B > 1:
        d = jnp.sum(hb[..., 1:, :] * jnp.conj(hb[..., :-1, :]), axis=-1)
        dphi = jnp.angle(d)  # (..., B-1) phase per p symbol periods
        phi = jnp.concatenate(
            [jnp.zeros_like(dphi[..., :1]), jnp.cumsum(dphi, axis=-1)],
            axis=-1,
        )  # (..., B)
        slope = jnp.concatenate([dphi, dphi[..., -1:]], axis=-1) / p
    else:
        phi = jnp.zeros(hb.shape[:-1], jnp.float32)
        slope = jnp.zeros_like(phi)
    rot = jnp.exp(jax.lax.complex(jnp.zeros_like(phi), -phi))[..., None]
    shape = jnp.mean(hb * rot, axis=-2)  # (..., n_fft)
    if n_taps:
        shape = jnp.matmul(
            shape, jnp.asarray(_dft_projection_full(shape.shape[-1], n_taps)),
            precision=_HI,
        )
    offs = jnp.arange(1, p, dtype=jnp.float32)  # (p-1,)
    ph = phi[..., :, None] + slope[..., :, None] * offs  # (..., B, p-1)
    track = jnp.exp(jax.lax.complex(jnp.zeros_like(ph), ph))
    return shape[..., None, None, :] * track[..., None]


@functools.lru_cache(maxsize=None)
def pilot_indices(n_fft: int, spacing: int) -> tuple:
    """Static comb indices 0, spacing, 2·spacing, ... (< n_fft)."""
    if spacing < 2:
        raise ValueError(f"pilot spacing must be >= 2, got {spacing}")
    return tuple(range(0, n_fft, spacing))


@functools.lru_cache(maxsize=None)
def data_indices(n_fft: int, spacing: int) -> tuple:
    pil = set(pilot_indices(n_fft, spacing))
    return tuple(k for k in range(n_fft) if k not in pil)


def n_data_subcarriers(n_fft: int, spacing: int) -> int:
    return len(data_indices(n_fft, spacing))


@functools.lru_cache(maxsize=None)
def _interp_tables(n_fft: int, spacing: int):
    """(left_idx, right_idx, weight) per subcarrier for pilot lerp."""
    pil = np.asarray(pilot_indices(n_fft, spacing))
    k = np.arange(n_fft)
    left = np.clip((k // spacing), 0, len(pil) - 1)
    right = np.clip(left + 1, 0, len(pil) - 1)
    denom = np.maximum(pil[right] - pil[left], 1)
    w = np.clip((k - pil[left]) / denom, 0.0, 1.0)
    return left.astype(np.int32), right.astype(np.int32), w.astype(np.float32)


def insert_pilots(
    data_points: jnp.ndarray, n_fft: int, spacing: int
) -> jnp.ndarray:
    """Data points (..., n_data) → full grid (..., n_fft) with pilots."""
    didx = jnp.asarray(data_indices(n_fft, spacing), jnp.int32)
    pidx = jnp.asarray(pilot_indices(n_fft, spacing), jnp.int32)
    grid = jnp.zeros(data_points.shape[:-1] + (n_fft,), data_points.dtype)
    grid = grid.at[..., didx].set(data_points)
    return grid.at[..., pidx].set(jnp.asarray(PILOT_VALUE, data_points.dtype))


def extract_data(grid: jnp.ndarray, spacing: int) -> jnp.ndarray:
    """Full grid (..., n_fft) → data subcarriers (..., n_data)."""
    n_fft = grid.shape[-1]
    return grid[..., jnp.asarray(data_indices(n_fft, spacing), jnp.int32)]


@functools.lru_cache(maxsize=None)
def _dft_projection(n_fft: int, spacing: int, n_taps: int):
    """(n_pilots, n_fft) matrix projecting pilot LS samples onto the
    n_taps-tap impulse-response subspace, evaluated on the full grid.

    ĥ_full = h_pilots @ W, W = (IDFT_{n_pil} rows < n_taps) @ DFT rows.
    One complex matmul — the dense form of transform-domain
    channel-estimate denoising.
    """
    pil = np.asarray(pilot_indices(n_fft, spacing), np.float64)
    n_pil = len(pil)
    l = np.arange(n_taps)[None, :]  # (1, n_taps)
    # IDFT over the pilot comb: pilots sit at k = p·spacing, so the
    # steering phase is e^{+j2π·(p·spacing)·l/n_fft} / n_pil.
    E = np.exp(2j * np.pi * pil[:, None] * l / n_fft) / n_pil  # (n_pil, L)
    k = np.arange(n_fft)[None, :]
    D = np.exp(-2j * np.pi * l.T * k / n_fft)  # (n_taps, n_fft)
    # NUMPY result: converting inside the lru_cache would capture a
    # tracer when the first call happens under jit.
    return (E @ D).astype(np.complex64)


def dft_n_taps(n_fft: int, cp_len: int, spacing: int) -> int:
    """Denoising tap budget: the CP bounds the legal delay spread
    (cp_len+1 taps); the comb's alias-free span bounds what n_pilots
    samples can resolve."""
    return min(cp_len + 1, len(pilot_indices(n_fft, spacing)))


def estimate_dft_comb(
    y: jnp.ndarray,
    spacing: int,
    n_taps: int,
    per_symbol: bool = False,
) -> jnp.ndarray:
    """Transform-domain denoised channel estimate from comb pilots.

    LS at the pilots, then a single (n_pil, n_fft) matmul that inverts
    to the impulse response, keeps only the first ``n_taps`` taps (the
    CP guarantees the true channel lives there — ofdm.hpp:21's
    ISI-free contract is exactly this bound), and re-evaluates on the
    full grid. Noise outside the tap subspace is discarded: the
    estimation error drops by ~n_taps/n_pilots vs per-pilot LS, and
    the interpolation is exact for ANY channel within the delay
    spread (linear interpolation is not).
    """
    n_fft = y.shape[-1]
    pidx = jnp.asarray(pilot_indices(n_fft, spacing), jnp.int32)
    if per_symbol:
        y_p = y[..., pidx]
    else:
        y_p = jnp.mean(y[..., pidx], axis=-2, keepdims=True)
    h_p = y_p / jnp.asarray(PILOT_VALUE, y.dtype)
    return jnp.matmul(
        h_p, jnp.asarray(_dft_projection(n_fft, spacing, n_taps)),
        precision=_HI,
    )


@functools.lru_cache(maxsize=None)
def _dft_projection_full(n_fft: int, n_taps: int):
    """(n_fft, n_fft) projector onto the n_taps-tap impulse-response
    subspace for FULL-GRID estimates (the preamble case: every
    subcarrier observed, spacing = 1). Same construction as
    _dft_projection with the pilot comb replaced by the whole grid."""
    k = np.arange(n_fft, dtype=np.float64)
    l = np.arange(n_taps)[None, :]
    E = np.exp(2j * np.pi * k[:, None] * l / n_fft) / n_fft  # (n_fft, L)
    D = np.exp(-2j * np.pi * l.T * k[None, :] / n_fft)  # (L, n_fft)
    # NUMPY result: converting inside the lru_cache would capture a
    # tracer when the first call happens under jit.
    return (E @ D).astype(np.complex64)


def estimate_mimo_preamble(
    y_pre: jnp.ndarray, n_taps: int = 0
) -> jnp.ndarray:
    """Per-antenna-pair LS channel estimate from a time-orthogonal
    MIMO preamble, optionally DFT/CP-subspace denoised.

    The preamble is n_tx full-grid pilot OFDM symbols at the head of
    the frame; during symbol t ONLY TX antenna t radiates (at unit
    power — no spatial split while alone), so the post-FFT observation
    at RX antenna r during symbol t is H_rt[k]·p + noise and LS is one
    complex divide per subcarrier — the cross-antenna separation the
    SISO comb (estimate_ls_comb) cannot provide. With ``n_taps > 0``
    each (r, t) estimate is additionally projected onto the CP-bounded
    impulse-response subspace (one (n_fft, n_fft) matmul per pair,
    batched) — noise outside the subspace is discarded,
    cutting estimation error by ~n_taps/n_fft.

    y_pre: (..., n_rx, n_tx, n_fft) — the first n_tx received OFDM
    symbols, symbol axis == TX-antenna axis. Returns ĥ of the same
    shape, consumable by every detector in ops.mimo.
    """
    h = y_pre / jnp.asarray(PILOT_VALUE, y_pre.dtype)
    if n_taps > 0:
        h = jnp.matmul(
            h, jnp.asarray(_dft_projection_full(y_pre.shape[-1], n_taps)),
            precision=_HI,
        )
    return h


def estimate_ls_comb_tracked(
    y: jnp.ndarray, spacing: int, base=None
) -> jnp.ndarray:
    """Frame-averaged LS estimate + per-symbol common-phase tracking.

    The receiver for residual carrier offset: after blind acquisition a
    leftover CFO of ~1e-2 subcarriers rotates every subcarrier by the
    same phase, a little more each symbol. Estimating per symbol
    (``per_symbol=True``) tracks it but forfeits the frame's noise
    averaging; this estimator keeps both:

    1. differential phase between consecutive symbols' pilot vectors
       Δφ_s = angle(Σ_p y_{s+1}[p]·conj(y_s[p])) — the channel cancels
       in the product, so no estimate is needed yet;
    2. cumulative phase track φ_s = Σ_{u<s} Δφ_u; derotate the grid;
    3. frame-averaged LS on the derotated grid (full noise averaging);
    4. re-apply e^{iφ_s} → per-symbol h (..., n_syms, n_fft).

    Assumes the channel is static over the frame up to the common
    rotation (frame-static models + front-end CFO); use
    ``per_symbol=True`` for genuinely time-varying fading.

    ``base`` is the frame-averaged shape estimator run on the derotated
    grid (default: estimate_ls_comb; pass a denoising estimator like
    estimate_dft_comb via functools.partial to compose tracking with
    transform-domain denoising).
    """
    if base is None:
        base = estimate_ls_comb
    pidx = jnp.asarray(pilot_indices(y.shape[-1], spacing), jnp.int32)
    yp = y[..., pidx]  # (..., n_syms, n_pilots)
    d = jnp.sum(yp[..., 1:, :] * jnp.conj(yp[..., :-1, :]), axis=-1)
    dphi = jnp.angle(d)  # (..., n_syms-1)
    phi = jnp.concatenate(
        [jnp.zeros_like(dphi[..., :1]), jnp.cumsum(dphi, axis=-1)], axis=-1
    )  # (..., n_syms)
    rot = jnp.exp(jax.lax.complex(jnp.zeros_like(phi), -phi))[..., None]
    h_avg = base(y * rot, spacing)  # (..., 1, n_fft)
    return h_avg * jnp.conj(rot)


def estimate_ls_comb(
    y: jnp.ndarray, spacing: int, per_symbol: bool = False
) -> jnp.ndarray:
    """LS channel estimate from comb pilots with linear interpolation.

    y: post-FFT grid (..., n_syms, n_fft). Pilot observations are
    averaged over the symbol axis (block fading — the frame-static
    channel models) unless ``per_symbol``, in which case each OFDM
    symbol keeps its own estimate (required for time-varying fading:
    averaging a Doppler channel over the frame decorrelates the
    estimate — link.pipeline passes per_symbol for RAYLEIGH_TIME).
    Estimates are divided by the known pilot, then lerped across
    subcarriers. Returns h (..., 1, n_fft) or (..., n_syms, n_fft).
    """
    n_fft = y.shape[-1]
    pidx = jnp.asarray(pilot_indices(n_fft, spacing), jnp.int32)
    if per_symbol:
        y_p = y[..., pidx]  # (..., n_syms, n_pil)
    else:
        y_p = jnp.mean(y[..., pidx], axis=-2, keepdims=True)  # (..., 1, n_pil)
    h_p = y_p / jnp.asarray(PILOT_VALUE, y.dtype)
    left, right, w = _interp_tables(n_fft, spacing)
    wl = jnp.asarray(1.0 - w)
    wr = jnp.asarray(w)
    return h_p[..., jnp.asarray(left)] * wl + h_p[..., jnp.asarray(right)] * wr
