"""Waveform-domain analysis: PAPR, EVM, and Welch PSD.

The reference renders its TX waveform visually (time-domain Re/Im in
QFDemoWindow.cpp:29-163) but computes no waveform statistics; a
deployable SDR stack needs the standard three:

- **PAPR** — peak-to-average power ratio of the OFDM time waveform and
  its CCDF (the quantity PA back-off is budgeted against; OFDM's
  Gaussian-sum behavior makes it grow ~log(n_fft)).
- **EVM** — RMS error-vector magnitude between equalized RX points and
  the nearest (or known) constellation points, the standards-compliance
  metric (3GPP/802.11 report %EVM per MCS). For an AWGN-limited link
  EVM^2 -> noise_var exactly, asserted in tests.
- **PSD** — Welch-averaged periodogram of the serialized waveform; the
  occupied band of a CP-OFDM signal is flat over the loaded subcarriers
  and the CP adds no spectral lines.

All three are pure jnp reductions over arbitrary batch axes — they run
jit-compiled on the accelerator next to the link itself (FFTs for the PSD segments
batch onto the same transform machinery the modem uses) and are exact,
not sampled.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.modulation import constellation, nearest_symbol


def _power(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.real(x) ** 2 + jnp.imag(x) ** 2


def papr_db(waveform: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Peak-to-average power ratio in dB along ``axis``.

    waveform: complex time-domain samples; each slice along ``axis`` is
    one PAPR measurement unit (conventionally one OFDM symbol).
    """
    p = _power(waveform)
    peak = jnp.max(p, axis=axis)
    mean = jnp.mean(p, axis=axis)
    return 10.0 * jnp.log10(peak / jnp.maximum(mean, 1e-30))


def papr_ccdf(papr_samples_db: jnp.ndarray, grid_db: jnp.ndarray) -> jnp.ndarray:
    """CCDF Pr[PAPR > x] evaluated on ``grid_db`` from measured
    per-symbol PAPRs (any shape, flattened)."""
    s = papr_samples_db.reshape(-1)
    return jnp.mean(
        (s[None, :] > grid_db[:, None]).astype(jnp.float32), axis=1
    )


def evm_rms(
    rx_points: jnp.ndarray,
    mod: Modulation,
    ref_points: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """RMS EVM (linear fraction of the unit constellation RMS).

    With ``ref_points`` given, the error vector is measured against the
    known transmitted points (data-aided, the exact definition); without
    it, against the nearest constellation point per sample (blind — the
    practical receiver-side estimate, biased low once errors occur).
    Multiply by 100 for %EVM; the constellation is unit average power so
    no extra normalization term appears.
    """
    if ref_points is None:
        # nearest_symbol returns hard indices; look the points back up.
        ref_points = constellation(mod)[nearest_symbol(rx_points, mod)]
    err = jnp.mean(_power(rx_points - ref_points))
    return jnp.sqrt(err)


def psd_welch(
    waveform: jnp.ndarray, nperseg: int = 256, overlap: int = 128
) -> jnp.ndarray:
    """Welch-averaged power spectral density (Hann window, fftshifted).

    waveform: (..., n_samples) complex; batch axes average together
    with the segments. Returns (nperseg,) float32, normalized so the
    mean PSD equals the mean sample power (Parseval, asserted in
    tests). Segmenting is a static reshape + strided slice — one
    batched FFT, no Python loop over segments.
    """
    x = waveform.reshape(-1)
    n = x.shape[0]
    step = nperseg - overlap
    if step <= 0:
        raise ValueError(f"overlap {overlap} must be < nperseg {nperseg}")
    n_seg = (n - nperseg) // step + 1
    if n_seg < 1:
        raise ValueError(
            f"waveform of {n} samples too short for nperseg={nperseg}"
        )
    idx = (
        np.arange(n_seg)[:, None] * step + np.arange(nperseg)[None, :]
    )  # static (n_seg, nperseg) gather table
    segs = x[jnp.asarray(idx)]
    win = jnp.asarray(np.hanning(nperseg).astype(np.float32))
    scale = 1.0 / float(np.mean(np.hanning(nperseg) ** 2))
    spec = jnp.fft.fftshift(
        jnp.mean(_power(jnp.fft.fft(segs * win, axis=-1)), axis=0)
    )
    return (spec * scale / nperseg).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def papr_ccdf_theory(n_fft: int):
    """Classic OFDM CCDF approximation Pr[PAPR > x] = 1 - (1 - e^{-x})^N
    for N i.i.d. complex-Gaussian samples (van Nee & de Wild 1998) —
    the overlay reference for measured CCDFs. Returns f(grid_db)."""

    def f(grid_db: np.ndarray) -> np.ndarray:
        x = 10.0 ** (np.asarray(grid_db, np.float64) / 10.0)
        return 1.0 - (1.0 - np.exp(-x)) ** n_fft

    return f
