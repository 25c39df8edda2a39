"""Power-amplifier nonlinearity (Rapp SSPA model) and ideal predistortion.

The reference simulates an ideal transmitter — its demo feeds the IFFT
output straight into the receiver (QFDemoWindow.cpp:213-218). A real
OFDM transmitter runs through a power amplifier whose compression is
THE reason PAPR (obs.waveform) matters: the amplifier is memoryless in
amplitude, so the high-PAPR OFDM waveform either backs off (wasting PA
efficiency) or clips (creating nonlinear distortion and a BER floor).

Model: the Rapp solid-state PA AM/AM characteristic

    g(r) = r / (1 + (r/A_sat)^(2p))^(1/(2p))

with smoothness ``p`` (p → ∞ is an ideal soft limiter; p ≈ 2 is the
canonical SSPA fit) and no AM/PM (the standard Rapp assumption for
solid-state amplifiers; TWTA-style phase distortion is out of scope).
Operating point is set by the INPUT BACKOFF in dB relative to the
nominal mean input power: IBO = 10·log10(A_sat² / P_in).

Everything is elementwise over the complex waveform — pure elementwise work
that XLA fuses into the surrounding TX chain; batching/sharding are
inherited from the callers.

Receiver-side view (Bussgang): the memoryless nonlinearity decomposes
as y = α·x + d with d uncorrelated with x, so the pilot LS channel
estimate absorbs α·h automatically and the residual distortion power
appears as an SNR floor — which is why LinkConfig requires
pilot_spacing > 0 with a PA (genie CSI has no access to α).
"""

from __future__ import annotations

import jax.numpy as jnp


def rapp_sat_amplitude(ibo_db: float, signal_power: float) -> float:
    """Saturation amplitude A_sat for an input backoff over ``signal_power``.

    ``signal_power`` is the NOMINAL mean power of the PA input (for this
    framework's TX convention — unit-power subcarriers through the
    reference's 1/N inverse FFT, fft.hpp:197-204 — that is 1/n_fft).
    Using the design power rather than a per-frame sample mean keeps the
    PA characteristic deterministic and sharding-invariant.
    """
    return float((signal_power * 10.0 ** (ibo_db / 10.0)) ** 0.5)


def apply_rapp(
    x: jnp.ndarray, sat_amplitude: float, smoothness: float = 2.0
) -> jnp.ndarray:
    """Rapp AM/AM applied to a complex waveform (any shape), elementwise.

    g(r) = r / (1 + (r/A_sat)^(2p))^(1/(2p)); the phase is preserved
    (no AM/PM). Exact at r = 0 (gain factor → 1, no 0/0)."""
    p2 = 2.0 * float(smoothness)
    r2 = (jnp.real(x) ** 2 + jnp.imag(x) ** 2) / jnp.float32(
        sat_amplitude**2
    )
    # (1 + (r/A)^{2p})^{-1/(2p)} computed from r² to stay even & smooth.
    gain = (1.0 + r2 ** (p2 / 2.0)) ** (-1.0 / p2)
    return x * gain.astype(jnp.float32)


def rapp_predistort(
    x: jnp.ndarray,
    sat_amplitude: float,
    smoothness: float = 2.0,
    max_out: float = 0.99,
) -> jnp.ndarray:
    """Ideal digital predistortion for the Rapp AM/AM (exact inverse).

    Solving g(r) = a for the required input gives
    r = a / (1 − (a/A_sat)^(2p))^(1/(2p)), defined for a < A_sat. The
    desired output amplitude is limited to ``max_out``·A_sat first (the
    inverse blows up at saturation — no finite drive reaches it), so the
    cascade PA(DPD(x)) is EXACTLY x wherever |x| ≤ max_out·A_sat and an
    ideal limiter at max_out·A_sat beyond: predistortion converts the
    Rapp PA's gradual compression of the whole constellation into pure
    peak clipping (tests assert the cascade identity).
    """
    p2 = 2.0 * float(smoothness)
    a = jnp.sqrt(jnp.real(x) ** 2 + jnp.imag(x) ** 2)
    cap = jnp.float32(max_out * sat_amplitude)
    a_clip = jnp.minimum(a, cap)
    # Unit-phase clip: scale x down to the cap where it exceeds it.
    scale = jnp.where(a > cap, cap / jnp.maximum(a, 1e-30), 1.0)
    u = (a_clip / jnp.float32(sat_amplitude)) ** p2
    boost = (1.0 - u) ** (-1.0 / p2)
    return x * (scale * boost).astype(jnp.float32)


def apply_pa(
    x: jnp.ndarray,
    ibo_db: float,
    signal_power: float,
    smoothness: float = 2.0,
    dpd: bool = False,
) -> jnp.ndarray:
    """The configured TX front-end: optional DPD, then the Rapp PA."""
    sat = rapp_sat_amplitude(ibo_db, signal_power)
    if dpd:
        x = rapp_predistort(x, sat, smoothness)
    return apply_rapp(x, sat, smoothness)
