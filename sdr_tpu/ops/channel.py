"""Channel models: AWGN, flat Rayleigh, tapped-delay-line multipath.

The reference has NO channel at all — its demo feeds TX straight into
RX (QFDemoWindow.cpp:213-218) and decodes exactly every frame. The
north star (BASELINE.json) requires AWGN/fading. All models here are
pure functions of an explicit PRNG key (sdr_tpu.core.prng discipline),
batched over leading dims.

Noise calibration
-----------------
Constellations are unit-average-power (Es = 1 per subcarrier). With the
reference's FFT scaling (unscaled forward / 1/N inverse, fft.hpp:
176-205), a unit-power frequency-domain symbol becomes a time-domain
signal of average power Es/N, and the RX forward FFT multiplies noise
power by N. ``time_noise_var`` therefore divides by n_fft so that the
post-FFT per-subcarrier SNR equals the requested Es/N0 exactly; tests
verify the measured subcarrier SNR against the request.

Eb/N0 accounting: Es/N0 = bits_per_symbol * Eb/N0 (CP overhead is
excluded, the standard convention for OFDM BER curves).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def ebno_db_to_noise_var(ebno_db: float | jnp.ndarray, bits_per_symbol: int):
    """Eb/N0 [dB] → complex noise variance N0 at the subcarrier (Es=1)."""
    esno = 10.0 ** (jnp.asarray(ebno_db, jnp.float32) / 10.0) * bits_per_symbol
    return 1.0 / esno


def time_noise_var(noise_var, n_fft: int):
    """Subcarrier noise variance → time-domain (pre-FFT) variance."""
    return jnp.asarray(noise_var, jnp.float32) / n_fft


def cgauss(key: jax.Array, shape, var=1.0) -> jnp.ndarray:
    """Circularly-symmetric complex Gaussian CN(0, var), complex64."""
    kr, ki = jax.random.split(key)
    std = jnp.sqrt(jnp.asarray(var, jnp.float32) * 0.5)
    re = jax.random.normal(kr, shape, jnp.float32) * std
    im = jax.random.normal(ki, shape, jnp.float32) * std
    return jax.lax.complex(re, im)


def awgn(key: jax.Array, x: jnp.ndarray, noise_var) -> jnp.ndarray:
    """y = x + CN(0, noise_var); noise_var broadcasts against x."""
    return x + cgauss(key, x.shape, var=1.0) * jnp.sqrt(
        jnp.asarray(noise_var, jnp.float32)
    ).astype(jnp.float32)


def rayleigh_flat(key: jax.Array, shape) -> jnp.ndarray:
    """Flat Rayleigh fading gains h ~ CN(0, 1), E|h|^2 = 1."""
    return cgauss(key, shape, var=1.0)


def wiener_phase(key: jax.Array, n: int, std: float) -> jnp.ndarray:
    """RX-LO phase-noise rotation e^{jθ[n]}, θ a Wiener walk.

    θ[n] = Σ_{k≤n} N(0, std²) — the standard free-running-oscillator
    model; ``std`` is the per-sample phase increment in radians
    (variance grows linearly in time, so the common phase drifts
    across OFDM symbols while staying nearly constant within one for
    std·√sym_len ≪ 1 — the regime the per-symbol tracked pilot
    estimator corrects). Returns (n,) complex64 unit-magnitude.
    """
    dth = jax.random.normal(key, (n,), jnp.float32) * jnp.float32(std)
    theta = jnp.cumsum(dth)
    return jax.lax.complex(jnp.cos(theta), jnp.sin(theta))


def iq_imbalance_coeffs(gain: float, phase_rad: float):
    """Widely-linear mixer coefficients (μ, ν) for y = μ·x + ν·x*.

    The standard complex-baseband model of an I/Q demodulator whose Q
    branch has amplitude ratio ``gain`` and phase skew ``phase_rad``
    relative to I: μ = (1 + g·e^{jφ})/2, ν = (1 − g·e^{jφ})/2. Matched
    hardware (g=1, φ=0) gives μ=1, ν=0; the image-rejection ratio is
    IRR = |μ|²/|ν|². Returns python complex (trace-time constants).
    """
    ge = gain * complex(math.cos(phase_rad), math.sin(phase_rad))
    return (1.0 + ge) / 2.0, (1.0 - ge) / 2.0


def apply_iq_imbalance(
    x: jnp.ndarray, gain: float, phase_rad: float
) -> jnp.ndarray:
    """RX front-end I/Q mismatch: y = μ·x + ν·conj(x).

    Applied AFTER noise (antenna/LNA noise passes through the same
    imperfect mixer), so the blind compensator sees — and corrects —
    the imaged noise too. In OFDM this leaks a scaled conjugate of the
    mirror subcarrier into every tone (the image interference that
    bounds uncompensated BER).
    """
    mu, nu = iq_imbalance_coeffs(gain, phase_rad)
    return x * jnp.complex64(mu) + jnp.conj(x) * jnp.complex64(nu)


def iq_compensate(
    r: jnp.ndarray, diff_axis: int | None = None, diff_lag: int = 0
) -> jnp.ndarray:
    """Blind I/Q-image cancellation by exact properization.

    A proper (circularly-symmetric) signal has E[s²] = 0; the imbalance
    y = μs + νs* makes the pseudo-variance c = E[y²] = 2μν·E[|s|²]
    nonzero. Choosing w as the minimal-|w| root of the properization
    quadratic  c̄·w² − 2p·w + c = 0  (p = E[|y|²]) gives exactly
    w = ν/μ*, so z = y − w·y* = ((|μ|²−|ν|²)/μ*)·s — the image is
    removed EXACTLY in the infinite-sample limit, independent of the
    propagation channel, SNR, CFO or LO phase (all preserve
    properness). Finite frames leave a residual image of order
    1/√n_samples; the leftover complex direct gain is absorbed by the
    pilot LS estimate (LinkConfig validation requires pilots).

    ``diff_axis`` handles DETERMINISTIC signal components, which bias
    the sample pseudo-variance (the comb pilots all carry the same
    point P, so their time-domain component contributes ΣP²-type terms
    that do not average out — measured: a biased w is worse than no
    compensation at all). With an OFDM symbol axis given, the moments
    are estimated on consecutive-symbol DIFFERENCES: the frame-periodic
    deterministic part cancels exactly (static channel), while the
    data/noise parts stay proper with the same ν/μ* solution — the
    imbalance coefficients survive the differencing untouched because
    conj distributes over it.

    ``diff_lag`` is the 1-D-stream analog for a SERIALIZED signal with
    a sym_len-periodic deterministic component (the acquired path's
    raw stream, where no symbol axis exists yet): moments come from
    r[n+lag] - r[n]. At zero CFO the periodic part cancels exactly; at
    larger CFO it only rotates (and the bias self-averages anyway).
    """
    if diff_lag:
        m = (r[..., diff_lag:] - r[..., :-diff_lag]) * jnp.float32(2 ** -0.5)
    elif diff_axis is None:
        m = r
    else:
        n = r.shape[diff_axis]
        if n < 2:
            raise ValueError("diff_axis needs >= 2 symbols to difference")
        hi = jax.lax.slice_in_dim(r, 1, n, axis=diff_axis)
        lo = jax.lax.slice_in_dim(r, 0, n - 1, axis=diff_axis)
        m = (hi - lo) * jnp.float32(2 ** -0.5)
    c = jnp.mean(m * m)  # pseudo-variance E[y²]
    p = jnp.mean(jnp.abs(m) ** 2).astype(jnp.float32)
    disc = jnp.sqrt(jnp.maximum(p * p - jnp.abs(c) ** 2, 0.0))
    # Minimal-|w| root; guard the matched-hardware case (c = 0 → w = 0).
    denom = jnp.where(jnp.abs(c) > 0, jnp.conj(c), jnp.complex64(1.0))
    w = jnp.where(jnp.abs(c) > 0, (p - disc) / denom, jnp.complex64(0.0))
    return r - w * jnp.conj(r)


def rician_flat(key: jax.Array, shape, k_factor: float) -> jnp.ndarray:
    """Flat Rician fading gains with linear K-factor, E|h|² = 1.

    h = √(K/(K+1))·e^{jφ} + √(1/(K+1))·CN(0,1) with φ ~ U[0, 2π) per
    draw (the LOS phase is unknown to a non-coherent deployment; BER
    with genie or estimated CSI is phase-invariant, and a random phase
    keeps |h| statistics exact). K = 0 reduces to ``rayleigh_flat``'s
    distribution; K → ∞ approaches a pure phase rotation.
    """
    k_los, k_dif = jax.random.split(key)
    K = jnp.float32(k_factor)
    phase = jax.random.uniform(
        k_los, shape, jnp.float32, 0.0, 2.0 * math.pi
    )
    los = jnp.sqrt(K / (K + 1.0)) * jax.lax.complex(
        jnp.cos(phase), jnp.sin(phase)
    )
    return los + cgauss(k_dif, shape, var=1.0 / (K + 1.0))


def jakes_params(
    key: jax.Array, n_paths: int = 16, batch_shape=()
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Draw the Jakes sum-of-sinusoids state: (theta, phi) path arrays.

    The state is the full fading realization: gains at ANY time index
    follow deterministically via ``jakes_eval``, which is what makes
    time-sharded streams bit-exact — a device that owns symbols
    [t0, t1) evaluates the same sinusoid sum the unsharded run does at
    those absolute indices (no sequential recursion to replay).
    """
    k_th, k_ph = jax.random.split(key)
    shape = tuple(batch_shape) + (n_paths,)
    theta = jax.random.uniform(k_th, shape, jnp.float32, 0.0, 2.0 * math.pi)
    phi = jax.random.uniform(k_ph, shape, jnp.float32, 0.0, 2.0 * math.pi)
    return theta, phi


def jakes_eval(
    theta: jnp.ndarray, phi: jnp.ndarray, t: jnp.ndarray, doppler_norm: float
) -> jnp.ndarray:
    """Evaluate Jakes gains at (possibly offset) time indices ``t``.

    g[t] = (1/√P) Σ_p exp(i(2π·fd·t·cosθ_p + φ_p)). Returns
    broadcast(batch, t)-shaped complex64 with E|g|² = 1.
    """
    t = jnp.asarray(t, jnp.float32)
    n_paths = theta.shape[-1]
    ang = (
        2.0 * math.pi * doppler_norm * t[..., :, None] * jnp.cos(theta)[..., None, :]
        + phi[..., None, :]
    )  # (..., n_steps, n_paths)
    g = jnp.sum(jax.lax.complex(jnp.cos(ang), jnp.sin(ang)), axis=-1)
    return (g / math.sqrt(n_paths)).astype(jnp.complex64)


def jakes_gains(
    key: jax.Array,
    n_steps: int,
    doppler_norm: float,
    n_paths: int = 16,
    batch_shape=(),
) -> jnp.ndarray:
    """Time-varying Rayleigh gains via the sum-of-sinusoids Jakes model.

    g[t] = (1/√P) Σ_p exp(i(2π·fd·t·cosθ_p + φ_p)) with uniform random
    arrival angles θ_p and phases φ_p; ``doppler_norm`` = fd·T_step (the
    Doppler shift normalized to the step rate — use steps = OFDM symbols
    for block-per-symbol fading). E|g|² = 1; the autocorrelation
    approaches J₀(2π·fd·Δt) as n_paths grows (tested). Returns
    batch_shape + (n_steps,) complex64.

    Equal to ``jakes_eval(*jakes_params(key, ...), arange(n_steps), fd)``
    — the split form the blocked/sharded stream paths use.
    """
    theta, phi = jakes_params(key, n_paths, batch_shape)
    return jakes_eval(theta, phi, jnp.arange(n_steps), doppler_norm)


def multipath_taps(key: jax.Array, pdp, batch_shape=()) -> jnp.ndarray:
    """Random Rayleigh taps for a power-delay profile.

    pdp: per-tap linear powers (any positive scale; normalized to sum 1
    so total channel energy is 1 on average). Returns complex64 taps of
    shape batch_shape + (len(pdp),).
    """
    p = jnp.asarray(pdp, jnp.float32)
    p = p / jnp.sum(p)
    taps = cgauss(key, tuple(batch_shape) + (p.shape[0],), var=1.0)
    return taps * jnp.sqrt(p)


def multipath_time_params(
    key: jax.Array, pdp, n_paths: int = 16, batch_shape=()
):
    """Jakes state for a TIME-VARYING tapped-delay line (TDL).

    The mobile radio channel proper: each PDP tap carries an
    INDEPENDENT Jakes process (ITU/3GPP TDL construction), so the
    channel is simultaneously frequency-selective (delay spread) and
    time-varying (Doppler). Returns (theta, phi, amps): per-tap
    sum-of-sinusoids state of shape batch_shape + (L, n_paths) and the
    static tap amplitudes √(pdp/Σpdp) of shape (L,). Like
    ``jakes_params``, the state IS the realization — gains at any
    absolute time follow via ``multipath_time_taps_at``, which is what
    keeps time-sharded streams bit-exact.
    """
    p = jnp.asarray(pdp, jnp.float32)
    p = p / jnp.sum(p)
    theta, phi = jakes_params(
        key, n_paths, tuple(batch_shape) + (p.shape[0],)
    )
    return theta, phi, jnp.sqrt(p)


def multipath_time_taps_at(
    theta: jnp.ndarray,
    phi: jnp.ndarray,
    amps: jnp.ndarray,
    t: jnp.ndarray,
    doppler_norm: float,
) -> jnp.ndarray:
    """Evaluate TDL taps at (possibly offset) step indices ``t``.

    c_l[t] = √p_l · g_l[t] with independent per-tap Jakes g_l
    (E|c_l|² = p_l, total energy 1). ``doppler_norm`` = fd·T_step; use
    steps = OFDM symbols for the block-fading-per-symbol convention
    (taps constant within a symbol — the same coherence assumption
    RAYLEIGH_TIME makes, valid for fd·T_sym ≪ 1). Returns
    batch_shape + (n_steps, L) complex64.
    """
    g = jakes_eval(theta, phi, t, doppler_norm)  # (..., L, n_steps)
    return jnp.swapaxes(g, -1, -2) * amps


def multipath_time_taps(
    key: jax.Array,
    pdp,
    n_steps: int,
    doppler_norm: float,
    n_paths: int = 16,
    batch_shape=(),
) -> jnp.ndarray:
    """Per-tap-Jakes TDL taps for steps 0..n_steps-1: the convenience
    form of ``multipath_time_params`` + ``multipath_time_taps_at``.
    Returns batch_shape + (n_steps, L) complex64. The slow-fade limit
    (doppler_norm → 0) is distributed like ``multipath_taps`` held
    constant over the frame (tested); the per-symbol frequency
    response is ``freq_response(taps, n_fft)`` → (..., n_steps, n_fft).
    """
    theta, phi, amps = multipath_time_params(key, pdp, n_paths, batch_shape)
    return multipath_time_taps_at(
        theta, phi, amps, jnp.arange(n_steps), doppler_norm
    )


def symbol_history(x: jnp.ndarray, L: int) -> jnp.ndarray:
    """Per-symbol FIR history for a (.., n_symbols, sym_len) grid.

    Row s gets the last L−1 samples of row s−1 (zeros for s=0) — the
    inter-symbol memory a time-varying TDL needs when each symbol is
    convolved with its OWN taps (``apply_multipath``'s batched form).
    """
    if L <= 1:
        return None
    tails = x[..., :-1, -(L - 1):]
    zeros = jnp.zeros(x.shape[:-2] + (1, L - 1), x.dtype)
    return jnp.concatenate([zeros, tails], axis=-2)


def apply_multipath(
    samples: jnp.ndarray, taps: jnp.ndarray, history: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Causal FIR channel along the last (time) axis.

    y[n] = sum_l taps[..., l] * x[n - l], with x[n<0] taken from
    ``history`` (the last L-1 samples of the preceding block) or zeros.
    ``history`` is the sequence-parallel halo hook: a time-sharded
    stream passes its left neighbor's tail here and the seam is
    bit-exact vs the unsharded stream (tests/test_parallel.py).

    Implemented as an L-term shift-and-add (L <= cp_len+1 by config
    validation) — fuses into a handful of elementwise ops, no gather.
    """
    L = taps.shape[-1]
    n = samples.shape[-1]
    if history is None:
        history = jnp.zeros(samples.shape[:-1] + (L - 1,), samples.dtype)
    elif L > 1:
        history = history[..., -(L - 1) :]
    if L == 1:
        return samples * taps[..., 0:1]
    ext = jnp.concatenate([history, samples], axis=-1)  # (..., L-1+n)
    y = jnp.zeros_like(samples)
    for l in range(L):
        y = y + taps[..., l : l + 1] * jax.lax.dynamic_slice_in_dim(
            ext, L - 1 - l, n, axis=-1
        )
    return y


def freq_response(taps: jnp.ndarray, n_fft: int) -> jnp.ndarray:
    """Per-subcarrier channel response H = FFT_N(taps zero-padded).

    With CP >= L-1 the FIR channel is circulant per OFDM symbol, so the
    frequency-domain model is Y = H * X + N — used by the one-tap
    equalizers (sdr_tpu.ops.equalize).
    """
    L = taps.shape[-1]
    pad = [(0, 0)] * (taps.ndim - 1) + [(0, n_fft - L)]
    from sdr_tpu.ops.fft import fft as _fft_op

    return _fft_op(jnp.pad(taps, pad))
