"""End-to-end link pipeline: bits → TX → channel → RX → LLR → BER.

The jitted, batched, shardable analog of the reference demo's frame
loop (QFDemoWindow.cpp:201-224: to_constl → ofdm::tx → ofdm::rx →
from_constl), extended with the channel/equalizer/soft-demap stages the
reference lacks. One ``simulate`` call processes
(n_channels, n_symbols) OFDM symbols as a single fused XLA program;
``vmap`` provides the channel batch, and the same function runs under
``shard_map`` for multi-chip execution (sdr_tpu.parallel).

Randomness is keyed per channel via fold_in (sdr_tpu.core.prng), so
results are invariant to how channels are batched or sharded.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from sdr_tpu.core import prng
from sdr_tpu.core.config import (
    TIME_VARYING_MODELS,
    ChannelEstimator,
    ChannelModel,
    Equalizer,
    LinkConfig,
)
from sdr_tpu.ops import channel as chan
from sdr_tpu.ops import equalize as eq
from sdr_tpu.ops.fft import xla_ifft
from sdr_tpu.ops.llr import llr_maxlog, llr_to_hard_bits
from sdr_tpu.ops.modulation import modulate
from sdr_tpu.ops.ofdm import ofdm_rx, ofdm_tx

# The MIMO channel products and the DFT projection are small f32
# products, not tensor-core work: full f32 keeps a GPU from running
# them in TF32.
_HI = jax.lax.Precision.HIGHEST

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LinkResult:
    """Per-invocation link statistics (device arrays)."""

    bit_errors: jnp.ndarray  # (n_channels,) int32
    bits_counted: jnp.ndarray  # (n_channels,) int32
    llrs: jnp.ndarray | None = None  # (n_channels, n_symbols, bits/sym) or None

    @property
    def ber(self) -> jnp.ndarray:
        return self.bit_errors.astype(jnp.float32) / jnp.maximum(
            self.bits_counted.astype(jnp.float32), 1.0
        )


def generate_bits(cfg: LinkConfig, key: jax.Array) -> jnp.ndarray:
    """Source bits (n_data_symbols, bits_per_ofdm_symbol), int8, for ONE
    channel (n_data_symbols == n_symbols except for SC-FDMA block-pilot
    frames, whose reference symbols carry no payload)."""
    shape = (cfg.n_data_symbols, cfg.bits_per_ofdm_symbol)
    return jax.random.bernoulli(key, 0.5, shape).astype(jnp.int8)


def tx_chain(cfg: LinkConfig, bits: jnp.ndarray) -> jnp.ndarray:
    """Bits (..., n_symbols, bits/sym) → time samples (..., n_symbols, sym_len).

    With ``cfg.pilot_spacing`` set, data points fill the non-pilot
    subcarriers and the known comb pilot occupies the rest
    (ops.pilots) — bits/sym shrinks accordingly (cfg.bits_per_ofdm_symbol).

    With ``cfg.dft_spread`` (SC-FDMA), the data points are DFT-precoded
    across the data set first (unitary scaling, so Es stays 1 and the
    noise calibration is untouched); pilots are NOT spread — they are
    known per-subcarrier references. The precoder is a plain unitary
    DFT over however many data positions exist (any length — this is
    not the reference-contract OFDM transform, which stays power-of-2).
    """
    points = modulate(bits, cfg.modulation)  # (..., n_data_symbols, n_data)
    if cfg.dft_spread:
        m = points.shape[-1]
        points = (jnp.fft.fft(points, axis=-1) * jnp.float32(m**-0.5)).astype(
            jnp.complex64
        )
        if cfg.pilot_spacing:
            # Time-multiplexed reference symbols: each block is
            # [Zadoff-Chu pilot | pilot_spacing-1 spread-data symbols].
            # The chirp is CAZAC, so the pilot symbol is just as
            # constant-modulus through the PA as the data symbols —
            # a frequency comb here would re-inject the impulse-train
            # peaks the precode removes (and its clipping products land
            # exactly back on the comb tones, biasing the estimate).
            from sdr_tpu.ops.pilots import zadoff_chu

            p = cfg.pilot_spacing
            B = cfg.n_symbols // p
            n_fft = cfg.ofdm.n_fft
            batch = points.shape[:-2]
            blocks = points.reshape(batch + (B, p - 1, n_fft))
            zc = jnp.broadcast_to(
                jnp.asarray(zadoff_chu(n_fft)), batch + (B, 1, n_fft)
            )
            points = jnp.concatenate([zc, blocks], axis=-2).reshape(
                batch + (cfg.n_symbols, n_fft)
            )
    elif cfg.pilot_spacing:
        from sdr_tpu.ops.pilots import insert_pilots

        points = insert_pilots(points, cfg.ofdm.n_fft, cfg.pilot_spacing)
    return ofdm_tx(points, cfg.ofdm.cp_len)


def apply_channel(cfg: LinkConfig, key: jax.Array, tx: jnp.ndarray):
    """Channel for ONE link: (n_symbols, sym_len) → (rx, h_freq, noise_var).

    h_freq is the per-subcarrier response (broadcastable against the
    post-FFT grid) or None for non-fading channels; noise_var is the
    per-subcarrier complex noise variance (scalar).

    With ``cfg.channel.phase_noise_std`` the received stream is rotated
    by a Wiener LO phase walk (ops.channel.wiener_phase) AFTER the
    propagation channel — the rotation of the already-added circularly-
    symmetric noise is statistically identity, so post-noise rotation
    is exact. Config validation guarantees pilots are present to track
    the resulting common phase.
    """
    if cfg.channel.has_pa:
        # TX front-end runs BEFORE the air: Rapp compression (optionally
        # predistorted) of the time-domain waveform. Nominal input power
        # is 1/n_fft — unit-power subcarriers through the reference's
        # 1/N inverse FFT (fft.hpp:197-204) — a static design constant,
        # so the PA characteristic is sharding/batching-invariant.
        from sdr_tpu.ops import pa

        tx = pa.apply_pa(
            tx,
            cfg.channel.pa_ibo_db,
            1.0 / cfg.ofdm.n_fft,
            cfg.channel.pa_smoothness,
            cfg.channel.pa_dpd,
        )
    rx, h_freq, nv = _apply_channel_model(cfg, key, tx)
    std = cfg.channel.phase_noise_std
    if std:
        k_pn = prng.role_key(key, prng.ROLE_PHASE)
        ph = chan.wiener_phase(k_pn, rx.size, std)
        rx = (rx.reshape(-1) * ph).reshape(rx.shape)
    if cfg.channel.iq_imbalanced:
        # The mixer is the LAST analog stage: it images the faded
        # signal, the noise, and the LO rotation alike.
        rx = chan.apply_iq_imbalance(
            rx, cfg.channel.iq_gain, cfg.channel.iq_phase_rad
        )
    return rx, h_freq, nv


def _apply_channel_model(cfg: LinkConfig, key: jax.Array, tx: jnp.ndarray):
    model = cfg.channel.model
    nv = chan.ebno_db_to_noise_var(cfg.channel.ebno_db, cfg.modulation.bits_per_symbol)
    k_noise = prng.role_key(key, prng.ROLE_NOISE)
    k_fade = prng.role_key(key, prng.ROLE_FADING)

    if model == ChannelModel.IDENTITY:
        return tx, None, jnp.float32(0.0)

    tvar = chan.time_noise_var(nv, cfg.ofdm.n_fft)
    if model == ChannelModel.AWGN:
        return chan.awgn(k_noise, tx, tvar), None, nv

    if model == ChannelModel.RAYLEIGH_FLAT:
        h = chan.rayleigh_flat(k_fade, ())  # one gain per link per frame
        rx = chan.awgn(k_noise, tx * h, tvar)
        return rx, h, nv

    if model == ChannelModel.RICIAN:
        h = chan.rician_flat(k_fade, (), cfg.channel.k_factor)
        rx = chan.awgn(k_noise, tx * h, tvar)
        return rx, h, nv

    if model == ChannelModel.RAYLEIGH_TIME:
        # Per-symbol Jakes gains: constant within a symbol (fd·T << 1),
        # correlated across the frame. h broadcasts (n_symbols, 1).
        g = chan.jakes_gains(k_fade, cfg.n_symbols, cfg.channel.doppler_norm)
        rx = chan.awgn(k_noise, tx * g[:, None], tvar)
        return rx, g[:, None], nv

    if model == ChannelModel.MULTIPATH:
        taps = chan.multipath_taps(k_fade, cfg.channel.pdp)
        stream = tx.reshape(-1)  # serialize symbols to a sample stream
        faded = chan.apply_multipath(stream, taps)
        rx = chan.awgn(k_noise, faded, tvar).reshape(tx.shape)
        h_freq = chan.freq_response(taps, cfg.ofdm.n_fft)  # (n_fft,)
        return rx, h_freq, nv

    if model == ChannelModel.MULTIPATH_TIME:
        # Per-tap-Jakes TDL: every PDP tap evolves as an independent
        # Jakes process, block-constant per OFDM symbol. Each symbol is
        # convolved with its OWN taps, with the previous symbol's tail
        # as FIR history (the inter-symbol memory the serialized static
        # path gets for free), and the per-symbol frequency response
        # (n_symbols, n_fft) feeds per-symbol equalization — the
        # channel family the reference's RX (ofdm.hpp:37-54) never
        # faces and the north star's estimators exist for.
        taps = chan.multipath_time_taps(
            k_fade, cfg.channel.pdp, cfg.n_symbols, cfg.channel.doppler_norm
        )  # (n_symbols, L)
        faded = chan.apply_multipath(
            tx, taps, history=chan.symbol_history(tx, taps.shape[-1])
        )
        rx = chan.awgn(k_noise, faded, tvar)
        h_freq = chan.freq_response(taps, cfg.ofdm.n_fft)  # (S, n_fft)
        return rx, h_freq, nv

    raise ValueError(f"unhandled channel model {model}")


def rx_chain(
    cfg: LinkConfig,
    rx_samples: jnp.ndarray,
    h_freq: jnp.ndarray | None,
    noise_var,
    skip_iq: bool = False,
    track_phase: bool = False,
):
    """Receiver: samples → (llrs, hard_bits).

    CP strip + FFT (ofdm.hpp:37-43 semantics) → one-tap equalizer →
    max-log LLR. noise_var is floored so the IDENTITY channel (the
    reference's loopback) yields ±inf-free LLRs with correct signs.

    With ``cfg.pilot_spacing``, the channel is LS-estimated from the
    comb pilots (ops.pilots.estimate_ls_comb) instead of using the
    genie ``h_freq``, and only data subcarriers are demapped.
    """
    if cfg.channel.iq_imbalanced and not skip_iq:
        # Blind image cancellation on the raw stream (before the FFT).
        # Moments come from consecutive-symbol differences so the
        # frame-periodic deterministic pilot component cannot bias the
        # pseudo-variance (see ops.channel.iq_compensate). skip_iq is
        # set by callers that already compensated (the acquired path
        # properizes the pre-correction serialized stream).
        if cfg.dft_spread and cfg.pilot_spacing:
            # SC-FDMA's deterministic part is the Zadoff-Chu pilot
            # SYMBOL, periodic at the BLOCK (p symbols), not at the
            # symbol — difference consecutive blocks so pilot-minus-
            # pilot cancels it exactly while data stays proper.
            p = cfg.pilot_spacing
            shp = rx_samples.shape
            rx_samples = chan.iq_compensate(
                rx_samples.reshape(
                    shp[:-2] + (shp[-2] // p, p, shp[-1])
                ),
                diff_axis=-3,
            ).reshape(shp)
        else:
            rx_samples = chan.iq_compensate(rx_samples, diff_axis=-2)
    if cfg.dft_spread and cfg.pilot_spacing and cfg.channel.impaired:
        # CP-based residual-CFO refinement BEFORE the FFT: the S&C
        # fractional estimate can leave ~0.05-subcarrier residuals,
        # whose per-block pilot phase (p symbol periods apart) would
        # exceed the tracker's ±π wrap limit; the van de Beek
        # correlation over all symbols × cp samples shrinks the
        # residual two orders below it (ops.sync.cp_residual_cfo).
        from sdr_tpu.ops.sync import correct_residual_cfo

        rx_samples = correct_residual_cfo(
            rx_samples, cfg.ofdm.n_fft, cfg.ofdm.cp_len
        )
    y = ofdm_rx(rx_samples, cfg.ofdm.cp_len)  # (..., n_symbols, n_fft)
    nv = jnp.maximum(jnp.asarray(noise_var, jnp.float32), 1e-12)
    despread_done = False  # set by the MMSE SC-FDE paths below

    if cfg.pilot_spacing and cfg.dft_spread:
        # SC-FDMA block pilots: strip the Zadoff-Chu reference symbols,
        # LS-estimate from them (ops.pilots.estimate_block_pilots), and
        # equalize the full-grid data symbols with the frame estimate.
        from sdr_tpu.ops.pilots import (
            estimate_block_pilots,
            estimate_block_pilots_interp,
            estimate_block_pilots_interp_full,
            estimate_block_pilots_tracked,
        )

        p = cfg.pilot_spacing
        B = cfg.n_symbols // p
        n_fft = y.shape[-1]
        batch = y.shape[:-2]
        yb = y.reshape(batch + (B, p, n_fft))
        y_pil = yb[..., 0, :]
        y = yb[..., 1:, :].reshape(batch + (cfg.n_data_symbols, n_fft))
        n_taps = (
            min(cfg.ofdm.cp_len + 1, n_fft)
            if cfg.estimator == ChannelEstimator.DFT
            else 0
        )
        if cfg.channel.model == ChannelModel.RAYLEIGH_TIME:
            # Flat Jakes: frame-averaged per-tone shape (absorbs any
            # residual timing phase) × per-block complex scalar,
            # interpolated per data symbol (the MIMO-midamble pattern
            # — composes with residual CFO since the scalar chord is
            # complex).
            h_est = estimate_block_pilots_interp(y_pil, p).reshape(
                batch + (cfg.n_data_symbols, n_fft)
            )
        elif cfg.channel.model == ChannelModel.MULTIPATH_TIME:
            # Selective time-varying fading: tones move independently,
            # so interpolate each tone's complex chord between pilot
            # blocks (no shape × scalar factorization exists).
            h_est = estimate_block_pilots_interp_full(y_pil, p).reshape(
                batch + (cfg.n_data_symbols, n_fft)
            )
        elif cfg.channel.impaired or cfg.channel.phase_noise_std:
            # Residual post-acquisition CFO rotates the whole grid a
            # little more each symbol (linear — tracked exactly), and
            # a slow LO Wiener walk is locally linear between pilot
            # symbols (deviation from the per-block chord is a
            # Brownian bridge, std·sqrt(p·sym_len)/2 rad — small for
            # per-sample std ≲ 5e-3); the tracked estimator
            # interpolates the common phase between pilot symbols
            # (LTE-uplink composition: SC-FDMA + blind acquisition).
            h_est = estimate_block_pilots_tracked(y_pil, p, n_taps).reshape(
                batch + (cfg.n_data_symbols, n_fft)
            )
        else:
            h_est = estimate_block_pilots(y_pil, n_taps)[..., None, :]
        if cfg.equalizer == Equalizer.ZF:
            s, eff_var = eq.equalize_zf(y, h_est, nv)
        else:
            # SC-FDE MMSE with symbol-level bias correction (measured
            # 3x fewer errors than ZF-FDE on faded SC-FDMA — the
            # biased per-tone weight keeps a notch from amplifying
            # noise across every despread symbol). Returns TIME-domain
            # symbols: despreading is already done.
            s, eff_var = eq.equalize_mmse_fde(y, h_est, nv)
            despread_done = True
    elif cfg.pilot_spacing:
        from sdr_tpu.ops.pilots import (
            dft_n_taps,
            estimate_dft_comb,
            estimate_ls_comb,
            estimate_ls_comb_tracked,
            extract_data,
        )

        if cfg.estimator == ChannelEstimator.DFT:
            base = functools.partial(
                estimate_dft_comb,
                n_taps=dft_n_taps(
                    cfg.ofdm.n_fft, cfg.ofdm.cp_len, cfg.pilot_spacing
                ),
            )
        else:
            base = estimate_ls_comb
        if cfg.channel.model in TIME_VARYING_MODELS:
            # Time-varying fading must be estimated per symbol; frame
            # averaging is only valid for the frame-static models. The
            # per-symbol estimate also absorbs any residual timing/CFO
            # phase, so this branch covers the acquired case too.
            # MULTIPATH_TIME rides the same branch: the comb LS (or
            # DFT-subspace projection) per symbol captures each
            # symbol's full selective response.
            h_est = base(y, cfg.pilot_spacing, per_symbol=True)
        elif (
            cfg.channel.impaired
            or cfg.channel.phase_noise_std
            or track_phase
        ):
            # Blind acquisition leaves a residual CFO (1e-2-scale
            # subcarriers), and LO phase noise a Wiener walk — either
            # way the constellation rotates a little more each symbol.
            # The tracked estimator follows that common phase per
            # symbol while keeping the frame's full noise averaging on
            # the channel shape. ``track_phase`` requests the same
            # treatment when the config itself carries no impairment
            # flags — the packet modem's internal LinkConfig, whose
            # post-acquisition residual rotates LONG bursts right out
            # of the frame-averaged estimate (a 0.017-subcarrier
            # residual turns ±1.9 rad across a 28-symbol LDPC burst).
            h_est = estimate_ls_comb_tracked(y, cfg.pilot_spacing, base=base)
        else:
            h_est = base(y, cfg.pilot_spacing, per_symbol=False)
        if cfg.equalizer == Equalizer.ZF:
            s, eff_var = eq.equalize_zf(y, h_est, nv)
        else:
            s, eff_var = eq.equalize_mmse(y, h_est, nv)
        s = extract_data(s, cfg.pilot_spacing)
        eff_var = extract_data(
            jnp.broadcast_to(eff_var, y.shape), cfg.pilot_spacing
        )
    elif h_freq is not None and cfg.equalizer != Equalizer.NONE:
        if cfg.equalizer == Equalizer.ZF:
            s, eff_var = eq.equalize_zf(y, h_freq, nv)
        elif cfg.dft_spread:
            s, eff_var = eq.equalize_mmse_fde(y, h_freq, nv)
            despread_done = True
        else:
            s, eff_var = eq.equalize_mmse(y, h_freq, nv)
    else:
        s, eff_var = y, nv

    if cfg.dft_spread and not despread_done:
        # SC-FDMA de-spread (ZF / unequalized paths; the MMSE path
        # despreads inside equalize_mmse_fde with bias correction):
        # unitary IDFT over the equalized data set. The despread noise
        # variance is EXACTLY the mean of the per-subcarrier
        # post-equalizer variances (each IDFT row has uniform
        # magnitude 1/sqrt(M) and subcarrier noise is independent) —
        # the classic SC-FDMA noise-averaging behavior that trades
        # OFDM's per-tone outage for a uniform floor.
        m = s.shape[-1]
        eff_var = jnp.mean(
            jnp.broadcast_to(eff_var, s.shape), axis=-1, keepdims=True
        )
        s = (xla_ifft(s) * jnp.float32(m**0.5)).astype(
            jnp.complex64
        )

    llrs = llr_maxlog(s, cfg.modulation, eff_var)
    return llrs, llr_to_hard_bits(llrs)


def _simulate_one_acquired(cfg: LinkConfig, key: jax.Array, want_llrs: bool):
    """One channel's link under front-end impairments (blind RX).

    TX prepends the two-symbol S&C preamble and serializes; the air
    applies the unknown delay, fading, the carrier frequency offset,
    and noise over the WHOLE stream (preamble included — the
    synchronizer sees the same SNR as the payload); the RX runs
    ops.sync.acquire (coarse+fractional+integer CFO+fine timing),
    slices the payload at the recovered start, and proceeds through
    the pilot-estimating rx_chain — the LS estimate absorbs whatever
    residual timing phase acquisition leaves. Supersedes the
    reference's perfectly-aligned loopback (ofdm.hpp:37-54).
    """
    from sdr_tpu.ops.sync import acquire, acquisition_preamble, apply_cfo

    n_fft, cp = cfg.ofdm.n_fft, cfg.ofdm.cp_len
    sym_len = cfg.ofdm.symbol_len
    bits = generate_bits(cfg, prng.role_key(key, prng.ROLE_PAYLOAD))
    body = tx_chain(cfg, bits).reshape(-1)
    stream = jnp.concatenate(
        [
            jnp.zeros((cfg.channel.timing_offset,), jnp.complex64),
            acquisition_preamble(n_fft, cp),
            body,
            # Tail margin keeps the payload slice in range for any
            # fine-timing outcome within the preamble span.
            jnp.zeros((sym_len,), jnp.complex64),
        ]
    )
    if cfg.channel.has_pa:
        # The PA compresses everything the antenna radiates — the S&C
        # preamble included (its half-symbol repetition survives any
        # memoryless nonlinearity, so acquisition still locks). The
        # zero-padding stretches map to zero through the odd AM/AM.
        from sdr_tpu.ops import pa

        stream = pa.apply_pa(
            stream,
            cfg.channel.pa_ibo_db,
            1.0 / n_fft,
            cfg.channel.pa_smoothness,
            cfg.channel.pa_dpd,
        )

    model = cfg.channel.model
    nv = chan.ebno_db_to_noise_var(cfg.channel.ebno_db, cfg.modulation.bits_per_symbol)
    k_noise = prng.role_key(key, prng.ROLE_NOISE)
    k_fade = prng.role_key(key, prng.ROLE_FADING)
    if model == ChannelModel.MULTIPATH:
        taps = chan.multipath_taps(k_fade, cfg.channel.pdp)
        stream = chan.apply_multipath(stream, taps)
    elif model == ChannelModel.MULTIPATH_TIME:
        # Per-tap-Jakes TDL on the serialized stream: the TX layout
        # (delay | preamble | payload | tail) is known here, so the
        # symbol grid gets per-symbol taps (block fading, like the
        # RAYLEIGH_TIME branch below) with the previous symbol's tail
        # as FIR history; the leading delay is silent (zeros through
        # any FIR) and the tail margin is convolved with the last
        # symbol's taps so the delay-spread smear past the frame edge
        # is preserved. The receiver knows none of this — it
        # estimates per symbol from the comb after acquisition.
        taps_t = chan.multipath_time_taps(
            k_fade, cfg.channel.pdp, 2 + cfg.n_symbols,
            cfg.channel.doppler_norm,
        )  # (2 + n_symbols, L)
        L = taps_t.shape[-1]
        off = cfg.channel.timing_offset
        body_len = (2 + cfg.n_symbols) * sym_len
        grid = stream[off : off + body_len].reshape(-1, sym_len)
        faded_grid = chan.apply_multipath(
            grid, taps_t, history=chan.symbol_history(grid, L)
        )
        tail = stream[off + body_len :]
        tail_faded = chan.apply_multipath(
            tail, taps_t[-1],
            history=grid[-1, -(L - 1):] if L > 1 else None,
        )
        stream = jnp.concatenate(
            [stream[:off], faded_grid.reshape(-1), tail_faded]
        )
    elif model == ChannelModel.RAYLEIGH_FLAT:
        stream = stream * chan.rayleigh_flat(k_fade, ())
    elif model == ChannelModel.RICIAN:
        stream = stream * chan.rician_flat(k_fade, (), cfg.channel.k_factor)
    elif model == ChannelModel.RAYLEIGH_TIME:
        # Per-symbol Jakes gains laid onto the serialized stream: the
        # TX layout (delay | preamble | payload | tail) is known here,
        # so each emitted OFDM symbol gets its block gain; the silent
        # delay/tail stretches carry no signal to fade. The receiver
        # knows none of this — it estimates per symbol from the comb
        # after acquisition (rx_chain's RAYLEIGH_TIME branch).
        g = chan.jakes_gains(
            k_fade, 2 + cfg.n_symbols, cfg.channel.doppler_norm
        )  # (2 + n_symbols,)
        gains = jnp.concatenate(
            [
                jnp.ones((cfg.channel.timing_offset,), jnp.complex64),
                jnp.repeat(g.astype(jnp.complex64), sym_len),
                jnp.ones((sym_len,), jnp.complex64),
            ]
        )
        stream = stream * gains
    stream = apply_cfo(stream, cfg.channel.cfo_subcarriers, n_fft)
    if model != ChannelModel.IDENTITY:
        stream = chan.awgn(k_noise, stream, chan.time_noise_var(nv, n_fft))
    if cfg.channel.phase_noise_std:
        # RX-LO Wiener walk over the WHOLE stream (preamble included —
        # the synchronizer faces it too); the tracked pilot estimator
        # absorbs the per-symbol common phase after acquisition.
        k_pn = prng.role_key(key, prng.ROLE_PHASE)
        stream = stream * chan.wiener_phase(
            k_pn, stream.shape[0], cfg.channel.phase_noise_std
        )
    if cfg.channel.iq_imbalanced:
        stream = chan.apply_iq_imbalance(
            stream, cfg.channel.iq_gain, cfg.channel.iq_phase_rad
        )
        # Compensate on the RAW stream, BEFORE CFO correction: the
        # image model y = g1·x + g2·conj(x) only matches the blind
        # properization moments while x is the as-received (still
        # CFO-rotated, still proper) signal — correcting the carrier
        # first would spin the conj term against the estimate. Moments
        # come from lag differences so the frame-periodic deterministic
        # part cannot bias the pseudo-variance at near-zero CFO (same
        # guard rx_chain's diff_axis provides on the aligned grid):
        # comb pilots repeat every SYMBOL; SC-FDMA's Zadoff-Chu pilot
        # symbols repeat every BLOCK (pilot_spacing symbols).
        lag = sym_len * (
            cfg.pilot_spacing if cfg.dft_spread and cfg.pilot_spacing else 1
        )
        stream = chan.iq_compensate(stream, diff_lag=lag)

    start, _cfo_hat, rx_c = acquire(stream, n_fft, cp)
    # Timing backoff: under multipath the matched filter sometimes
    # peaks one sample LATE (a strong second tap), which slides the
    # FFT window into the next symbol — ISI on every symbol of that
    # channel. Starting 2 samples EARLY instead lands inside the CP's
    # ISI-free region (delay spread ≤ cp−2 is config-validated), a
    # pure circular shift. ONLY the full-grid pilot modes can afford
    # it: the shift's linear phase (2π·2k/n_fft across tones) is
    # measured at EVERY tone by the SC-FDMA Zadoff-Chu symbols, but a
    # comb estimator must INTERPOLATE it between pilots — at spacing 8
    # on a 64-FFT the phase turns ~90° per pilot gap and the lerp
    # breaks down, costing far more than the late-lock ISI it avoids.
    backoff = 2 if (cfg.dft_spread and cp >= 4) else 0
    payload = jax.lax.dynamic_slice_in_dim(
        rx_c, jnp.maximum(start - backoff, 0), cfg.n_symbols * sym_len
    ).reshape(cfg.n_symbols, sym_len)
    # skip_iq: the stream was already properized above; re-running the
    # compensator on the CFO-corrected payload would estimate a
    # spurious O(1/sqrt(n)) w from an already-proper signal.
    llrs, hard = rx_chain(cfg, payload, None, nv, skip_iq=True)
    errors = jnp.sum((hard != bits).astype(jnp.int32))
    counted = jnp.int32(bits.size)
    return errors, counted, (llrs if want_llrs else None)


def _simulate_one_mimo(cfg: LinkConfig, key: jax.Array, want_llrs: bool):
    """One channel's multi-antenna link (cfg.mimo set).

    Antenna axes are leading array axes: the TX grid is
    (n_tx, n_symbols, n_fft), the channel a per-link (n_rx, n_tx)
    matrix (flat models) or per-pair FIR taps (MULTIPATH, giving an
    (n_rx, n_tx, n_fft) frequency response), and the RX grid
    (n_rx, n_symbols, n_fft) — everything batches through the same
    ofdm_tx/ofdm_rx used by SISO (ofdm.hpp:13-54 semantics). Detection
    is ops.mimo (Alamouti combiner / MRC / linear ZF-MMSE / max-log
    joint ML). CSI is genie or estimated from a time-orthogonal
    preamble (mimo.csi='preamble': n_tx extra pilot symbols at the
    frame head, per-pair LS via ops.pilots.estimate_mimo_preamble,
    DFT/CP-subspace denoised when cfg.estimator is DFT). Noise is
    calibrated against the TOTAL bits per subcarrier use, so Eb/N0 is
    an info-bit quantity comparable with SISO curves; the preamble is
    frame overhead, not counted in Eb.
    """
    mc = cfg.mimo
    bits = jax.random.bernoulli(
        prng.role_key(key, prng.ROLE_PAYLOAD),
        0.5,
        (mc.n_streams, cfg.n_symbols, cfg.ofdm.n_fft * cfg.modulation.bits_per_symbol),
    ).astype(jnp.int8)
    llrs = mimo_llr_link(cfg, key, bits)
    hard = llr_to_hard_bits(llrs)
    errors = jnp.sum((hard != bits).astype(jnp.int32))
    counted = jnp.int32(bits.size)
    return errors, counted, (llrs if want_llrs else None)


def mimo_llr_link(cfg: LinkConfig, key: jax.Array, bits: jnp.ndarray):
    """The MIMO link as bits → LLRs (the coded link's building block).

    bits: int8 (n_streams, n_symbols, n_fft * bits_per_symbol). Returns
    float32 LLRs of the same shape/bit order. Error counting stays with
    the callers (_simulate_one_mimo / link.coded)."""
    from sdr_tpu.ops import mimo as mo
    from sdr_tpu.ops import pilots as pi
    from sdr_tpu.core.config import ChannelEstimator, MIMOScheme

    mc = cfg.mimo
    n_fft, cp = cfg.ofdm.n_fft, cfg.ofdm.cp_len
    bps = cfg.modulation.bits_per_symbol
    points = modulate(bits, cfg.modulation)  # (streams, S, N)
    if cfg.dft_spread:
        # SC-FDMA MIMO: DFT-precode each STREAM's constellation grid
        # (unitary, Es preserved) BEFORE the space-time encoding. The
        # STBC's per-tone conj/negate and the mux's scaling act on the
        # spread symbols and are undone per tone by the linear
        # detectors, so one IDFT per stream after detection recovers
        # the data (despreading in _mimo_llrs). Constant modulus per
        # antenna is preserved (conj/scale of a CM waveform is CM).
        points = (
            jnp.fft.fft(points, axis=-1) * jnp.float32(n_fft**-0.5)
        ).astype(jnp.complex64)
    if mc.scheme == MIMOScheme.ALAMOUTI:
        ant = mo.alamouti_encode(points[0])  # (2, S, N)
    elif mc.scheme == MIMOScheme.MRC:
        ant = points  # (1, S, N)
    else:
        ant = mo.mux_encode(points)  # (n_tx, S, N)
    midamble = mc.csi == "preamble" and (
        cfg.channel.model in TIME_VARYING_MODELS
        or bool(cfg.channel.phase_noise_std)
        or cfg.channel.impaired
    )
    # Per-antenna subcarrier power of the DATA symbols: the encoders
    # split total unit power across antennas (1/n_tx for Alamouti and
    # spatial mux; MRC's single antenna radiates at 1).
    ant_pwr = 1.0 / mc.n_tx if mc.scheme != MIMOScheme.MRC else 1.0
    if cfg.dft_spread:
        # SC-FDMA: the preamble must keep the waveform's constant
        # modulus (the point of the precode) — a Zadoff-Chu grid is
        # CM in BOTH domains; scale to data power when a PA is on so
        # the Bussgang gain matches (CM pilot, CM data — consistent).
        scale = ant_pwr**0.5 if cfg.channel.has_pa else 1.0
        pre_ref = jnp.asarray(pi.zadoff_chu(n_fft) * scale, ant.dtype)
    elif cfg.channel.has_pa:
        # PA mode: the preamble must drive the amplifier EXACTLY like
        # a data symbol — same per-antenna power (scale to ant_pwr)
        # AND the same time-domain amplitude statistics (a PN QPSK
        # grid; the constant grid is a time impulse the PA clips, and
        # Bussgang gain depends on the envelope distribution). The
        # known reference pre_ref divides back out at the estimators.
        pre_ref = jnp.asarray(
            pi.pn_preamble_grid(n_fft) * ant_pwr**0.5, ant.dtype
        )  # (n_fft,)
    else:
        # Linear front end: the full-power constant pilot maximizes
        # estimation SNR (no envelope concerns).
        pre_ref = jnp.asarray(pi.PILOT_VALUE, ant.dtype)
    pre = (
        jnp.eye(mc.n_tx, dtype=ant.dtype)[:, :, None] * pre_ref
    )  # time-orthogonal: symbol t radiates the full pilot grid from
    # antenna t ALONE; (n_tx, n_tx, n_fft or 1)
    if midamble:
        # Re-insert the preamble every midamble_period data symbols:
        # [pre | K data] x B blocks. Estimates are interpolated across
        # blocks below — the tracking schedule for time variation.
        K = mc.midamble_period
        B = cfg.n_symbols // K
        blocks = jnp.concatenate(
            [
                jnp.broadcast_to(pre[:, None], (mc.n_tx, B, mc.n_tx, n_fft)),
                ant.reshape(mc.n_tx, B, K, n_fft),
            ],
            axis=2,
        )  # (n_tx, B, n_tx+K, N)
        ant = blocks.reshape(mc.n_tx, B * (mc.n_tx + K), n_fft)
        n_pre = 0
    else:
        n_pre = mc.n_tx if mc.csi == "preamble" else 0
        if n_pre:
            ant = jnp.concatenate(
                [jnp.broadcast_to(pre, (mc.n_tx, n_pre, n_fft)), ant],
                axis=-2,
            )
    n_syms_tx = ant.shape[-2]
    tx = ofdm_tx(ant, cp)  # (n_tx, n_syms_tx, sym_len)
    sym_len = cfg.ofdm.symbol_len

    impaired = cfg.channel.impaired
    if impaired:
        # Blind-acquisition mode: antenna 0 transmits the two-symbol
        # S&C preamble ALONE ahead of the MIMO body (one sync reference
        # suffices — timing and carrier are common to the array), with
        # the unknown delay and a tail margin around everything.
        from sdr_tpu.ops.sync import acquisition_preamble

        sync_pre = acquisition_preamble(n_fft, cp)
        head = jnp.zeros((mc.n_tx, sync_pre.shape[0]), jnp.complex64)
        head = head.at[0].set(sync_pre)
        tx_flat = jnp.concatenate(
            [
                jnp.zeros((mc.n_tx, cfg.channel.timing_offset), jnp.complex64),
                head,
                tx.reshape(mc.n_tx, -1),
                jnp.zeros((mc.n_tx, sym_len), jnp.complex64),
            ],
            axis=-1,
        )
    else:
        tx_flat = tx.reshape(mc.n_tx, -1)

    if cfg.channel.has_pa:
        # One PA per TX antenna, identical characteristics: nominal
        # input power is the true per-antenna time power ant_pwr/n_fft
        # (the encoders split unit subcarrier power 1/n_tx ways), and
        # the preamble was scaled to that same power above, so the
        # Bussgang gain is common across antennas and symbols — the
        # per-pair preamble LS absorbs it exactly like the SISO pilot
        # LS does (config requires csi='preamble'). The sync preamble
        # and silent stretches compress/zero-map through the same odd
        # AM/AM.
        from sdr_tpu.ops import pa

        tx_flat = pa.apply_pa(
            tx_flat,
            cfg.channel.pa_ibo_db,
            ant_pwr / n_fft,
            cfg.channel.pa_smoothness,
            cfg.channel.pa_dpd,
        )
        if cfg.channel.model in TIME_VARYING_MODELS and not impaired:
            # The un-impaired time-varying branches fade `tx`
            # (symbol-shaped), not tx_flat — keep them consistent.
            tx = tx_flat.reshape(tx.shape)

    nv = chan.ebno_db_to_noise_var(
        cfg.channel.ebno_db, bps * mc.n_streams
    )
    k_noise = prng.role_key(key, prng.ROLE_NOISE)
    k_fade = prng.role_key(key, prng.ROLE_FADING)
    h_t = None  # per-symbol (S, n_rx, n_tx, 1) genie CSI (RAYLEIGH_TIME)
    if cfg.channel.model == ChannelModel.MULTIPATH:
        taps = chan.multipath_taps(
            k_fade, cfg.channel.pdp, batch_shape=(mc.n_rx, mc.n_tx)
        )  # (n_rx, n_tx, L) — i.i.d. PDP per antenna pair
        rx_t = jnp.sum(chan.apply_multipath(tx_flat[None], taps), axis=1)
        h = chan.freq_response(taps, n_fft)  # (n_rx, n_tx, n_fft)
    elif cfg.channel.model == ChannelModel.MULTIPATH_TIME:
        # Per-tap-Jakes TDL per antenna pair: i.i.d. PDP across pairs
        # (the MULTIPATH MIMO convention) with each tap evolving as an
        # independent Jakes process (the RAYLEIGH_TIME convention) —
        # selective AND time-varying MIMO. Per-symbol convolution with
        # the previous symbol's tail as FIR history; genie CSI is the
        # per-symbol per-tone (S, n_rx, n_tx, n_fft) response, which
        # rides the same _mimo_detect_per_symbol path the midamble
        # estimates use.
        n_gain = n_syms_tx + (2 if impaired else 0)
        taps_t = chan.multipath_time_taps(
            k_fade, cfg.channel.pdp, n_gain, cfg.channel.doppler_norm,
            batch_shape=(mc.n_rx, mc.n_tx),
        )  # (n_rx, n_tx, n_gain, L)
        L = taps_t.shape[-1]
        if impaired:
            # Serialized stream [delay | preamble | body | tail]: the
            # symbol grid convolves with per-symbol taps (preamble
            # included — the synchronizer faces the same channel), the
            # silent delay passes through, and the tail margin smears
            # with the last symbol's taps.
            off = cfg.channel.timing_offset
            body_len = n_gain * sym_len
            grid = tx_flat[:, off : off + body_len].reshape(
                mc.n_tx, n_gain, sym_len
            )
            hist = chan.symbol_history(grid, L)
            y_rt = chan.apply_multipath(
                grid[None], taps_t,
                history=None if hist is None else hist[None],
            )  # (n_rx, n_tx, n_gain, sym_len)
            tail = tx_flat[:, off + body_len :]
            tail_y = chan.apply_multipath(
                tail[None], taps_t[:, :, -1],
                history=grid[None, :, -1, -(L - 1):] if L > 1 else None,
            )
            rx_t = jnp.concatenate(
                [
                    jnp.zeros((mc.n_rx, off), jnp.complex64),
                    jnp.sum(y_rt, axis=1).reshape(mc.n_rx, -1),
                    jnp.sum(tail_y, axis=1),
                ],
                axis=-1,
            )
            Ht_taps = taps_t[:, :, 2:]  # payload symbols' taps
        else:
            hist = chan.symbol_history(tx, L)  # tx: (n_tx, S, sym_len)
            y_rt = chan.apply_multipath(
                tx[None], taps_t,
                history=None if hist is None else hist[None],
            )  # (n_rx, n_tx, S, sym_len)
            rx_t = jnp.sum(y_rt, axis=1).reshape(mc.n_rx, -1)
            Ht_taps = taps_t
        h_t = jnp.moveaxis(
            chan.freq_response(Ht_taps, n_fft), 2, 0
        )  # (S, n_rx, n_tx, n_fft)
        h = None
    elif cfg.channel.model == ChannelModel.RAYLEIGH_TIME:
        # Jakes Doppler per antenna pair, block fading per OFDM symbol
        # (the SISO RAYLEIGH_TIME convention): H varies across symbols,
        # the gain multiplies the whole CP-bearing symbol.
        n_gain = n_syms_tx + (2 if impaired else 0)
        Ht_full = chan.jakes_gains(
            k_fade, n_gain, cfg.channel.doppler_norm,
            batch_shape=(mc.n_rx, mc.n_tx),
        )  # (n_rx, n_tx, n_gain)
        if impaired:
            # The acquired stream carries [delay | sync preamble (2
            # symbols, antenna 0) | body | tail]: lay each emitted
            # symbol's block gain onto the serialized samples (the
            # SISO _simulate_one_acquired convention) — the preamble
            # fades with the first two gains, so the synchronizer
            # faces the same fading the payload does; the silent
            # delay/tail stretches carry no signal to fade.
            g_samp = jnp.repeat(
                Ht_full.astype(jnp.complex64), sym_len, axis=-1
            )
            ones = lambda n: jnp.ones((mc.n_rx, mc.n_tx, n), jnp.complex64)
            G = jnp.concatenate(
                [ones(cfg.channel.timing_offset), g_samp, ones(sym_len)],
                axis=-1,
            )
            rx_t = jnp.sum(G * tx_flat[None, :, :], axis=1)
            Ht = Ht_full[..., 2:]
        else:
            Ht = Ht_full
            rx_t = jnp.einsum(
                "rts,tsn->rsn", Ht, tx, precision=_HI
            ).reshape(mc.n_rx, -1)
        h_t = jnp.moveaxis(Ht, -1, 0)[..., None]  # (S, n_rx, n_tx, 1)
        h = None
    else:
        if cfg.channel.model == ChannelModel.RAYLEIGH_FLAT:
            H = chan.rayleigh_flat(k_fade, (mc.n_rx, mc.n_tx))
        else:
            H = chan.rician_flat(
                k_fade, (mc.n_rx, mc.n_tx), cfg.channel.k_factor
            )
        rx_t = jnp.einsum(
            "rt,tn->rn", H, tx_flat, precision=_HI
        )
        h = H[..., None]  # flat: (n_rx, n_tx, 1) broadcasts over n_fft
    if impaired:
        from sdr_tpu.ops.sync import apply_cfo

        rx_t = apply_cfo(rx_t, cfg.channel.cfo_subcarriers, n_fft)
    rx_t = chan.awgn(k_noise, rx_t, chan.time_noise_var(nv, n_fft))
    if cfg.channel.phase_noise_std:
        # Shared RX LO: ONE Wiener walk rotates every antenna alike
        # (post-noise rotation of circularly-symmetric noise is
        # statistically exact, as in the SISO path). The walk rides the
        # composite channel the midamble estimates interpolate — config
        # validation requires the midamble schedule here.
        k_pn = prng.role_key(key, prng.ROLE_PHASE)
        ph = chan.wiener_phase(
            k_pn, rx_t.shape[-1], cfg.channel.phase_noise_std
        )
        rx_t = rx_t * ph[None, :]
    if cfg.channel.iq_imbalanced:
        # Each RX antenna owns a mixer: image + blind properization per
        # antenna (moment-based, needs no reference). The residual
        # complex direct gain per antenna is absorbed by the preamble
        # estimate (config validation requires csi='preamble').
        rx_t = chan.apply_iq_imbalance(
            rx_t, cfg.channel.iq_gain, cfg.channel.iq_phase_rad
        )
        if impaired:
            # The stream is not symbol-aligned yet (unknown delay);
            # moments come from lag-sym_len differences, the SISO
            # acquired-path convention — compensation must run on the
            # RAW stream BEFORE the synchronizer's CFO correction
            # (the conj-image model only matches while the carrier
            # still rotates the signal as received).
            rx_t = jax.vmap(
                lambda r: chan.iq_compensate(r, diff_lag=sym_len)
            )(rx_t)
        else:
            rx_t = jax.vmap(
                lambda r: chan.iq_compensate(
                    r.reshape(n_syms_tx, cfg.ofdm.symbol_len),
                    diff_axis=-2,
                ).reshape(-1)
            )(rx_t)
    if impaired:
        # Array acquisition: metrics combine across RX antennas (see
        # ops.sync.acquire_array); the slice realigns every antenna at
        # once, and the MIMO preamble estimate downstream absorbs the
        # residual timing phase (csi='preamble' enforced by config).
        from sdr_tpu.ops.sync import acquire_array

        start, _cfo_hat, rx_c = acquire_array(rx_t, n_fft, cp)
        rx_t = jax.lax.dynamic_slice_in_dim(
            rx_c, start, n_syms_tx * sym_len, axis=-1
        )
    y = ofdm_rx(
        rx_t.reshape(mc.n_rx, n_syms_tx, cfg.ofdm.symbol_len), cp
    )  # (n_rx, n_syms_tx, N)
    if midamble:
        import numpy as np

        K = mc.midamble_period
        B = cfg.n_symbols // K
        period = mc.n_tx + K
        yb = y.reshape(mc.n_rx, B, period, n_fft)
        raw = yb[:, :, : mc.n_tx] / pre_ref  # (n_rx, B, n_tx, N)
        # per-block LS (pre_ref folds out the PA-mode PN grid/power)
        if cfg.channel.model == ChannelModel.RAYLEIGH_TIME:
            # Jakes is flat: averaging over subcarriers cuts estimation
            # noise n_fft-fold (the 1-tap analog of the DFT projection).
            h_b = jnp.mean(raw, axis=-1, keepdims=True)  # (..., 1)
        elif cfg.estimator == ChannelEstimator.DFT:
            # Frequency-selective composite (e.g. multipath + LO phase
            # noise): keep the shape, denoise onto the CP subspace.
            h_b = jnp.matmul(
                raw,
                jnp.asarray(pi._dft_projection_full(n_fft, min(cp + 1, n_fft))),
                precision=_HI,
            )
        else:
            h_b = raw  # (..., N) raw per-subcarrier LS
        h_b = jnp.moveaxis(h_b, 1, 0)  # (B, n_rx, n_tx, N')
        y = yb[:, :, mc.n_tx :].reshape(mc.n_rx, cfg.n_symbols, n_fft)
        # Common-phase slope across midambles (residual CFO after
        # acquisition, or the mean LO drift): the channel cancels in
        # the block-to-block conj product, leaving the per-period
        # rotation. Derotate the estimates before interpolating (the
        # interpolation then only has to track the SLOW channel part)
        # and re-apply the exact per-symbol phase — this also
        # extrapolates the final block instead of holding it stale.
        if B >= 2:
            dphi = jnp.angle(
                jnp.sum(h_b[1:] * jnp.conj(h_b[:-1]))
            )  # rad per period
        else:
            dphi = jnp.float32(0.0)
        h_b = h_b * jnp.exp(
            jax.lax.complex(
                jnp.zeros((B,), jnp.float32),
                -dphi * jnp.arange(B, dtype=jnp.float32),
            )
        )[:, None, None, None]
        # The time-orthogonal preamble measures TX antenna t one symbol
        # later than antenna t-1, so each estimate carries a t-slot
        # phase skew of dphi/period — which would break the combiners'
        # inter-antenna phase relations (Alamouti orthogonality decays
        # with the skew). Align every antenna's estimate to slot 0.
        slot = jnp.arange(mc.n_tx, dtype=jnp.float32) * (dphi / period)
        h_b = h_b * jnp.exp(
            jax.lax.complex(jnp.zeros_like(slot), -slot)
        )[None, None, :, None]
        # Linear interpolation between consecutive midamble estimates
        # (taken at each preamble's center symbol); the final block
        # holds its own estimate. All index math is static.
        s_idx = np.arange(cfg.n_symbols)
        b_of = s_idx // K
        g = b_of * period + mc.n_tx + (s_idx % K)  # global symbol index
        # Slot-0 reference: the slot-skew derotation above aligned every
        # antenna's estimate to its block's FIRST preamble symbol.
        t_b = b_of * period + 0.0
        w = np.clip((g - t_b) / period, 0.0, 1.0).astype(np.float32)
        b_next = np.minimum(b_of + 1, B - 1)
        wj = jnp.asarray(w)[:, None, None, None]
        h_t = (1.0 - wj) * h_b[jnp.asarray(b_of)] + wj * h_b[
            jnp.asarray(b_next)
        ]  # (S, n_rx, n_tx, N') — overrides any genie track
        # Exact per-symbol common phase (slope fitted above): evaluated
        # at the symbol's own time, including past the last midamble.
        phi_s = dphi * jnp.asarray((g - t_b[0]) / period, jnp.float32)
        h_t = h_t * jnp.exp(
            jax.lax.complex(jnp.zeros_like(phi_s), phi_s)
        )[:, None, None, None]
    elif n_pre:
        n_taps = (
            min(cp + 1, n_fft)
            if cfg.estimator == ChannelEstimator.DFT
            else 0
        )
        # Normalize the received preamble so the estimator's internal
        # PILOT_VALUE division yields y/pre_ref (identity without PA).
        y_pre = y[:, :n_pre] * (jnp.asarray(pi.PILOT_VALUE, y.dtype) / pre_ref)
        h = pi.estimate_mimo_preamble(y_pre, n_taps)
        y = y[:, n_pre:]  # (n_rx, S, N)

    nvf = jnp.maximum(jnp.asarray(nv, jnp.float32), 1e-12)
    if h_t is not None:
        return _mimo_detect_per_symbol(cfg, y, h_t, nvf)
    if mc.scheme == MIMOScheme.ALAMOUTI:
        s, eff_var = mo.alamouti_combine(y, h, nvf)
    elif mc.scheme == MIMOScheme.MRC:
        s, eff_var = mo.mrc_combine(y, h, nvf)
    elif mc.detector == "ml":
        llrs = mo.mux_detect_ml(y, h, nvf, cfg.modulation)
        s = None
    elif mc.detector == "sic":
        s, eff_var = mo.mux_detect_sic(y, h, nvf, cfg.modulation)
    elif cfg.equalizer == Equalizer.ZF:
        s, eff_var = mo.mux_detect_zf(y, h, nvf)
    else:
        s, eff_var = mo.mux_detect_mmse(y, h, nvf)
    if s is not None:
        llrs = _mimo_llrs(cfg, s, eff_var)
    if mc.n_streams == 1 and llrs.ndim == 2:
        llrs = llrs[None]  # combiners collapse the stream axis; restore it
    return llrs  # (n_streams, S, N*bps), bit order matching ``bits``


def _mimo_llrs(cfg: LinkConfig, s, eff_var):
    """Per-tone symbol estimates → LLRs, despreading first when the
    link is SC-FDMA (one unitary IDFT per stream per symbol; the
    despread noise variance is the tone-mean of the post-detection
    variances — each IDFT row has uniform magnitude and tone noise is
    independent, the same averaging the SISO rx_chain applies)."""
    if cfg.dft_spread:
        m = s.shape[-1]
        eff_var = jnp.mean(
            jnp.broadcast_to(eff_var, s.shape), axis=-1, keepdims=True
        )
        s = (xla_ifft(s) * jnp.float32(m**0.5)).astype(
            jnp.complex64
        )
    return llr_maxlog(s, cfg.modulation, eff_var)


def _mimo_detect_per_symbol(cfg: LinkConfig, y, h_t, nvf):
    """Detection under per-symbol fading (RAYLEIGH_TIME MIMO).

    y: (n_rx, S, N); h_t: (S, n_rx, n_tx, 1) per-symbol genie CSI.
    The symbol axis becomes a vmap batch over the same detectors the
    frame-static path uses (their leading ``...`` dims). Alamouti
    combines per symbol PAIR with the pair's mean H — the quasi-static
    receiver assumption, so intra-pair channel motion shows up as the
    real Doppler error floor rather than being genie-corrected away.
    Returns LLRs (n_streams, S, N*bps).
    """
    from sdr_tpu.ops import mimo as mo
    from sdr_tpu.core.config import MIMOScheme

    mc = cfg.mimo
    n_rx, S, N = y.shape
    if mc.scheme == MIMOScheme.ALAMOUTI:
        yp = y.reshape(n_rx, S // 2, 2, N)
        yp = jnp.moveaxis(yp, 1, 0)  # (P, n_rx, 2, N)
        h_pair = jnp.mean(h_t.reshape(S // 2, 2, n_rx, 2, -1), axis=1)
        s, eff = jax.vmap(lambda yy, hh: mo.alamouti_combine(yy, hh, nvf))(
            yp, h_pair
        )  # s (P, 2, N), eff (P, 1, N')
        llrs = _mimo_llrs(cfg, s, eff)  # (P, 2, N*bps)
        return llrs.reshape(1, S, -1)
    if mc.scheme == MIMOScheme.MRC:
        ys = jnp.moveaxis(y, 1, 0)[:, :, None, :]  # (S, n_rx, 1, N)
        s, eff = jax.vmap(lambda yy, hh: mo.mrc_combine(yy, hh, nvf))(
            ys, h_t
        )  # s (S, 1, N), eff (S, 1, N')
        llrs = _mimo_llrs(cfg, s[:, 0], eff[:, 0])  # (S, N*bps)
        return llrs[None]
    ys = jnp.moveaxis(y, 1, 0)[:, :, None, :]  # (S, n_rx, 1, N)
    if mc.detector == "ml":
        llrs = jax.vmap(
            lambda yy, hh: mo.mux_detect_ml(yy, hh, nvf, cfg.modulation)
        )(ys, h_t)  # (S, n_tx, 1, N*bps)
        return jnp.moveaxis(llrs[:, :, 0], 0, 1)
    if mc.detector == "sic":
        det = lambda yy, hh: mo.mux_detect_sic(yy, hh, nvf, cfg.modulation)
    elif cfg.equalizer == Equalizer.ZF:
        det = lambda yy, hh: mo.mux_detect_zf(yy, hh, nvf)
    else:
        det = lambda yy, hh: mo.mux_detect_mmse(yy, hh, nvf)
    s, eff = jax.vmap(det)(ys, h_t)  # s (S, n_tx, 1, N), eff (S, n_tx, 1, N')
    s = jnp.moveaxis(s[:, :, 0], 0, 1)  # (n_tx, S, N)
    eff = jnp.moveaxis(eff[:, :, 0], 0, 1)  # (n_tx, S, N')
    return _mimo_llrs(cfg, s, eff)


def _simulate_one(cfg: LinkConfig, key: jax.Array, want_llrs: bool):
    """One channel's link, keyed; returns (errors, counted, llrs|None)."""
    if cfg.mimo is not None:
        return _simulate_one_mimo(cfg, key, want_llrs)
    if cfg.channel.impaired:
        return _simulate_one_acquired(cfg, key, want_llrs)
    bits = generate_bits(cfg, prng.role_key(key, prng.ROLE_PAYLOAD))
    tx = tx_chain(cfg, bits)
    rx, h_freq, nv = apply_channel(cfg, key, tx)
    llrs, hard = rx_chain(cfg, rx, h_freq, nv)
    errors = jnp.sum((hard != bits).astype(jnp.int32))
    counted = jnp.int32(bits.size)
    return errors, counted, (llrs if want_llrs else None)


def simulate(cfg: LinkConfig, key: jax.Array, want_llrs: bool = False) -> LinkResult:
    """Run cfg.n_channels independent links, vmapped; returns LinkResult.

    Per-channel keys come from fold_in(channel_index) so the result is
    identical however the channel axis is later sharded.
    """
    ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jnp.arange(cfg.n_channels)
    )
    errors, counted, llrs = jax.vmap(
        functools.partial(_simulate_one, cfg, want_llrs=want_llrs)
    )(ch_keys)
    return LinkResult(bit_errors=errors, bits_counted=counted, llrs=llrs)


def make_simulate_fn(cfg: LinkConfig, want_llrs: bool = False):
    """Jitted simulate with cfg closed over (cfg is static/hashable)."""
    return jax.jit(functools.partial(simulate, cfg, want_llrs=want_llrs))
