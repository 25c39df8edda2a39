"""Static configuration layer.

The reference has no config system at all — every parameter is a
compile-time template argument or hard-coded literal (see SURVEY.md §5:
/root/reference/app/QFDemoWindow.cpp:204-218 hard-codes cp=8 and 4
bytes/frame). Here configuration is first-class: frozen dataclasses that
are hashable, so they can be passed as static arguments to ``jax.jit``
and participate in trace-time validation (the JAX analog of the
reference's runtime ``std::expected`` size guards, fft.hpp:90-92).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple


class Modulation(enum.Enum):
    """Modulation scheme roster.

    The reference names this exact roster as type tags
    (/root/reference/lib/inc/modulation.hpp:13-14, 70-72) but implements
    only 16-QAM. All are implemented here as Gray-coded square
    constellations; the 16-QAM table reproduces
    modulation.hpp:29-47 point-for-point (validated in
    tests/test_modulation.py).
    """

    BPSK = "bpsk"
    QPSK = "qpsk"
    QAM16 = "16qam"
    QAM64 = "64qam"
    QAM256 = "256qam"
    QAM1024 = "1024qam"

    @property
    def bits_per_symbol(self) -> int:
        return _BITS[self]

    @property
    def bits_per_axis(self) -> int:
        """Bits mapped onto each of the I/Q axes (0 for Q on BPSK)."""
        if self is Modulation.BPSK:
            return 1
        return self.bits_per_symbol // 2

    @property
    def levels_per_axis(self) -> int:
        """Number of PAM levels per axis (2 for BPSK's real axis)."""
        return 1 << self.bits_per_axis

    @property
    def unit_energy_scale(self) -> float:
        """1/sqrt(Es) normalization making average symbol power 1.

        For square M-QAM with per-axis levels {±1, ±3, ..., ±(L-1)}:
        Es = 2*(L²-1)/3. For 16-QAM this is 1/sqrt(10), matching the
        reference's ``norm`` (modulation.hpp:18-20).
        """
        L = self.levels_per_axis
        if self is Modulation.BPSK:
            es = float(L * L - 1) / 3.0  # one axis only
        else:
            es = 2.0 * float(L * L - 1) / 3.0
        return 1.0 / math.sqrt(es)


_BITS = {
    Modulation.BPSK: 1,
    Modulation.QPSK: 2,
    Modulation.QAM16: 4,
    Modulation.QAM64: 6,
    Modulation.QAM256: 8,
    Modulation.QAM1024: 10,
}


def _require_power_of_two(name: str, value: int) -> None:
    # Trace-time analog of the reference's runtime guard (fft.hpp:91-92).
    if value <= 0 or (value & (value - 1)) != 0:
        raise ValueError(f"{name} must be a power of 2, got {value}")


@dataclasses.dataclass(frozen=True)
class OFDMConfig:
    """OFDM numerology: FFT size and cyclic-prefix length.

    The reference fixes numerology implicitly per call (ofdm.hpp:13-54:
    N = in.size(), cp_size an argument). Symbol layout matches the
    reference exactly: a transmitted symbol is ``n_fft + cp_len``
    samples, the CP being a copy of the LAST ``cp_len`` time-domain
    samples placed FIRST (ofdm.hpp:21).
    """

    n_fft: int = 64
    cp_len: int = 16

    def __post_init__(self) -> None:
        _require_power_of_two("n_fft", self.n_fft)
        if not 0 <= self.cp_len <= self.n_fft:
            raise ValueError(
                f"cp_len must be in [0, n_fft], got {self.cp_len} (n_fft={self.n_fft})"
            )

    @property
    def symbol_len(self) -> int:
        return self.n_fft + self.cp_len


class ChannelModel(enum.Enum):
    IDENTITY = "identity"  # the reference's loopback "channel" (QFDemoWindow.cpp:213-218)
    AWGN = "awgn"
    RAYLEIGH_FLAT = "rayleigh_flat"
    MULTIPATH = "multipath"  # tapped-delay-line, frequency selective
    RAYLEIGH_TIME = "rayleigh_time"  # Jakes Doppler, per-symbol block fading
    RICIAN = "rician"  # flat fading with a LOS component (k_factor)
    # Per-tap-Jakes TDL (round 4): the composition of MULTIPATH and
    # RAYLEIGH_TIME — every PDP tap carries an independent Jakes
    # process (the ITU/3GPP TDL construction), so the channel is
    # frequency-selective AND time-varying. Taps are block-constant
    # per OFDM symbol (the same fd·T_sym ≪ 1 coherence assumption
    # RAYLEIGH_TIME makes); the per-symbol frequency response feeds
    # per-symbol equalization/estimation.
    MULTIPATH_TIME = "multipath_time"


# Models whose fading evolves across the frame (per-symbol channel
# planes; estimators must track, frame averaging is invalid).
TIME_VARYING_MODELS = frozenset(
    (ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME)
)
# Models with delay spread (FIR taps; delay spread must fit the CP).
SELECTIVE_MODELS = frozenset(
    (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME)
)


class Equalizer(enum.Enum):
    NONE = "none"
    ZF = "zf"
    MMSE = "mmse"


class ChannelEstimator(enum.Enum):
    """Pilot-based channel-estimation backend (with pilot_spacing > 0).

    LS: per-pilot least squares + linear interpolation across
    subcarriers. DFT: LS at the pilots projected onto the CP-bounded
    impulse-response subspace (ops.pilots.estimate_dft_comb) — one
    matmul; discards the estimation noise outside the delay spread and
    interpolates exactly for any in-CP channel.
    """

    LS = "ls"
    DFT = "dft"


class MIMOScheme(enum.Enum):
    """Multi-antenna processing scheme (ops.mimo).

    ALAMOUTI: 2-TX space-time block code (G2) — transmit diversity at
    SISO rate; n_rx combining branches. MRC: 1-TX receive diversity
    (maximum-ratio combining). SPATIAL_MUX: n_tx independent streams
    detected with linear ZF/MMSE (the LinkConfig equalizer selects) —
    n_tx× the SISO rate.
    """

    ALAMOUTI = "alamouti"
    MRC = "mrc"
    SPATIAL_MUX = "mux"


@dataclasses.dataclass(frozen=True)
class MIMOConfig:
    """Antenna configuration. The reference is strictly SISO
    (ofdm.hpp:13-54 processes one stream); this is new framework
    capability — antenna axes are ordinary batch axes in the array
    program."""

    scheme: MIMOScheme = MIMOScheme.ALAMOUTI
    n_tx: int = 2
    n_rx: int = 1
    # CSI at the receiver: "genie" (perfect, the simulation baseline) or
    # "preamble" (n_tx time-orthogonal full-grid pilot symbols prepended
    # to the frame; per-pair LS, denoised per LinkConfig.estimator).
    csi: str = "genie"
    # SPATIAL_MUX detector: "linear" (the LinkConfig equalizer picks
    # ZF/MMSE), "sic" (ordered MMSE successive cancellation — V-BLAST)
    # or "ml" (max-log joint search — optimal, full diversity;
    # candidate budget caps modulation at 64-QAM for n_tx=2).
    detector: str = "linear"
    # With csi='preamble' under RAYLEIGH_TIME: re-insert the orthogonal
    # preamble every `midamble_period` data symbols and track the
    # channel by linear interpolation between midamble estimates.
    # 0 = single head preamble (frame-static models only).
    midamble_period: int = 0

    def __post_init__(self) -> None:
        if not (1 <= self.n_tx <= 8 and 1 <= self.n_rx <= 8):
            raise ValueError(
                f"n_tx/n_rx must be in [1, 8], got {self.n_tx}x{self.n_rx}"
            )
        if self.csi not in ("genie", "preamble"):
            raise ValueError(f"csi must be 'genie' or 'preamble', got {self.csi!r}")
        if self.detector not in ("linear", "sic", "ml"):
            raise ValueError(
                f"detector must be 'linear', 'sic' or 'ml', got {self.detector!r}"
            )
        if self.midamble_period < 0:
            raise ValueError("midamble_period must be >= 0")
        if self.midamble_period and self.csi != "preamble":
            raise ValueError(
                "midamble_period needs csi='preamble' (it is a preamble "
                "repetition schedule)"
            )
        if self.detector != "linear" and self.scheme != MIMOScheme.SPATIAL_MUX:
            raise ValueError(
                f"detector={self.detector!r} applies to spatial multiplexing "
                "only; Alamouti/MRC combining is already ML for those schemes"
            )
        if self.scheme == MIMOScheme.ALAMOUTI and self.n_tx != 2:
            raise ValueError("Alamouti (G2) requires exactly n_tx=2")
        if self.scheme == MIMOScheme.MRC:
            if self.n_tx != 1:
                raise ValueError("MRC is receive-only diversity: n_tx must be 1")
            if self.n_rx < 2:
                raise ValueError("MRC needs n_rx >= 2 (n_rx=1 is SISO)")
        if self.scheme == MIMOScheme.SPATIAL_MUX:
            if self.n_tx < 2:
                raise ValueError("spatial multiplexing needs n_tx >= 2")
            if self.n_rx < self.n_tx:
                raise ValueError(
                    "linear spatial-mux detection needs n_rx >= n_tx, got "
                    f"{self.n_rx} < {self.n_tx}"
                )

    @property
    def n_streams(self) -> int:
        """Independent data streams per subcarrier use."""
        return self.n_tx if self.scheme == MIMOScheme.SPATIAL_MUX else 1


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    model: ChannelModel = ChannelModel.AWGN
    ebno_db: float = 10.0
    # Power-delay profile for MULTIPATH, as a tuple of per-tap linear
    # powers (normalized internally). Length must be <= cp_len + 1 for
    # ISI-free operation — validated against the OFDMConfig in LinkConfig.
    pdp: Tuple[float, ...] = (1.0,)
    # RAYLEIGH_TIME: Doppler shift normalized to the OFDM symbol rate
    # (fd * T_symbol); the gain is constant within a symbol and evolves
    # across symbols per the Jakes model (ops.channel.jakes_gains).
    doppler_norm: float = 0.01
    # Receiver impairments (front-end, not propagation): a carrier
    # frequency offset in subcarrier spacings and an unknown frame
    # delay in samples. Nonzero values switch link.pipeline into
    # ACQUISITION mode: the TX prepends the two-symbol S&C preamble and
    # the RX blindly recovers timing and CFO (ops.sync.acquire) — the
    # receiver the reference never needed (its demo feeds TX straight
    # into RX, QFDemoWindow.cpp:213-218).
    cfo_subcarriers: float = 0.0
    timing_offset: int = 0
    # RICIAN: linear K-factor — the LOS-to-diffuse power ratio. K=0
    # degenerates to RAYLEIGH_FLAT statistics; K→∞ approaches AWGN with
    # a random carrier phase. E|h|² = 1 at every K.
    k_factor: float = 4.0
    # RX-LO phase noise: per-sample Wiener phase increment std in
    # radians (0 = ideal oscillator). Nonzero values require
    # pilot_spacing — the random common phase is unknowable to genie
    # CSI; the per-symbol tracked LS estimator corrects it.
    phase_noise_std: float = 0.0
    # RX I/Q mismatch: Q-branch amplitude ratio (1 = matched) and phase
    # skew in radians (0 = matched). Nonzero mismatch images the mirror
    # subcarrier into every tone; the receiver runs the blind
    # properization compensator (ops.channel.iq_compensate) and the
    # pilot LS estimate absorbs the residual direct gain — so
    # pilot_spacing is required (validated in LinkConfig).
    iq_gain: float = 1.0
    iq_phase_rad: float = 0.0
    # TX power-amplifier nonlinearity (ops.pa, Rapp SSPA model): input
    # backoff in dB over the nominal mean TX power (None = ideal linear
    # transmitter, the reference's implicit assumption). Lower IBO =
    # more compression = more nonlinear distortion. ``pa_smoothness``
    # is the Rapp p parameter (p → ∞ is an ideal limiter);
    # ``pa_dpd`` enables ideal digital predistortion (the exact Rapp
    # inverse — the cascade becomes a pure peak clipper).
    pa_ibo_db: float | None = None
    pa_smoothness: float = 2.0
    pa_dpd: bool = False

    def __post_init__(self) -> None:
        if len(self.pdp) < 1:
            raise ValueError("pdp needs at least one tap")
        if any(p < 0 for p in self.pdp):
            raise ValueError("pdp powers must be non-negative")
        if self.model in (
            ChannelModel.RAYLEIGH_TIME, ChannelModel.MULTIPATH_TIME
        ) and not 0 <= self.doppler_norm < 0.5:
            raise ValueError(
                f"doppler_norm must be in [0, 0.5), got {self.doppler_norm}"
            )
        if self.model == ChannelModel.RICIAN and self.k_factor < 0:
            raise ValueError(f"k_factor must be >= 0, got {self.k_factor}")
        if not 0.0 <= self.phase_noise_std <= 0.1:
            # Above ~0.1 rad/sample the intra-symbol ICI dominates and
            # no common-phase correction is meaningful.
            raise ValueError(
                f"phase_noise_std must be in [0, 0.1], got {self.phase_noise_std}"
            )
        if self.timing_offset < 0:
            raise ValueError(
                f"timing_offset must be >= 0, got {self.timing_offset}"
            )
        if not 0.5 <= self.iq_gain <= 2.0:
            raise ValueError(
                f"iq_gain must be in [0.5, 2.0], got {self.iq_gain}"
            )
        if abs(self.iq_phase_rad) > 0.5:
            raise ValueError(
                f"|iq_phase_rad| must be <= 0.5, got {self.iq_phase_rad}"
            )
        if self.pa_ibo_db is not None and not -10.0 <= self.pa_ibo_db <= 30.0:
            raise ValueError(
                f"pa_ibo_db must be in [-10, 30] dB, got {self.pa_ibo_db}"
            )
        if not 0.5 <= self.pa_smoothness <= 16.0:
            raise ValueError(
                f"pa_smoothness must be in [0.5, 16], got {self.pa_smoothness}"
            )
        if self.pa_dpd and self.pa_ibo_db is None:
            raise ValueError(
                "pa_dpd is predistortion FOR the PA: set pa_ibo_db too"
            )
        if abs(self.cfo_subcarriers) > 4.99:
            # Fractional estimator covers +-1; the even-integer search
            # covers +-4 with the default window (ops.sync.acquire).
            raise ValueError(
                f"|cfo_subcarriers| must be < 5, got {self.cfo_subcarriers}"
            )

    @property
    def impaired(self) -> bool:
        return bool(self.cfo_subcarriers) or bool(self.timing_offset)

    @property
    def has_pa(self) -> bool:
        return self.pa_ibo_db is not None

    @property
    def iq_imbalanced(self) -> bool:
        return self.iq_gain != 1.0 or self.iq_phase_rad != 0.0


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Full link: modulation + OFDM + channel + receiver options."""

    modulation: Modulation = Modulation.QPSK
    ofdm: OFDMConfig = OFDMConfig()
    channel: ChannelConfig = ChannelConfig()
    equalizer: Equalizer = Equalizer.NONE
    # Number of OFDM symbols processed per link invocation.
    n_symbols: int = 16
    # Leading batch of independent links (vmapped / mesh-sharded).
    n_channels: int = 1
    # Comb-pilot spacing for LS channel estimation (ops.pilots); 0 =
    # perfect CSI at the receiver (the pure-simulation default).
    pilot_spacing: int = 0
    # Estimation backend when pilot_spacing > 0 (ignored otherwise).
    estimator: ChannelEstimator = ChannelEstimator.LS
    # Multi-antenna configuration; None = SISO (the reference's mode).
    mimo: MIMOConfig | None = None
    # DFT-spread OFDM (SC-FDMA, the LTE-uplink waveform): data points
    # are DFT-precoded across the full grid before mapping, and
    # de-spread after equalization. Single-carrier statistics cut the
    # waveform's PAPR by several dB (obs.waveform), which is what makes
    # it the PA-friendly (pa_ibo_db) uplink choice. With
    # ``pilot_spacing`` set, pilots are TIME-multiplexed (LTE-style):
    # every pilot_spacing-th OFDM symbol is a full-grid constant-modulus
    # Zadoff-Chu reference symbol — a frequency comb would re-inject
    # the impulse-train peaks the precode exists to remove.
    dft_spread: bool = False

    def __post_init__(self) -> None:
        if self.pilot_spacing:
            if self.dft_spread:
                # Time-multiplexed pilot SYMBOLS: spacing counts OFDM
                # symbols, one reference symbol leading each block.
                if self.pilot_spacing < 2 or self.n_symbols % self.pilot_spacing:
                    raise ValueError(
                        "with dft_spread, pilot_spacing is the pilot-"
                        "SYMBOL period: need >= 2 and n_symbols % "
                        f"pilot_spacing == 0, got {self.pilot_spacing} "
                        f"(n_symbols={self.n_symbols})"
                    )
            elif self.pilot_spacing < 2 or self.pilot_spacing > self.ofdm.n_fft:
                raise ValueError(
                    f"pilot_spacing must be 0 or in [2, n_fft], got {self.pilot_spacing}"
                )
            if self.equalizer == Equalizer.NONE:
                raise ValueError(
                    "pilot_spacing requires an equalizer (ZF or MMSE): "
                    "estimated CSI is only used through equalization"
                )
        if self.channel.has_pa:
            if self.mimo is not None:
                if self.mimo.csi != "preamble":
                    raise ValueError(
                        "pa_ibo_db + MIMO needs mimo.csi='preamble': "
                        "the per-pair preamble LS absorbs each "
                        "antenna PA's Bussgang gain — genie CSI has "
                        "no access to the amplifiers' compression"
                    )
            elif not self.pilot_spacing:
                raise ValueError(
                    "pa_ibo_db needs estimated CSI (pilot_spacing > 0): "
                    "the pilot LS absorbs the PA's Bussgang gain — genie "
                    "CSI has no access to the amplifier's compression"
                )
        if self.dft_spread and self.mimo is not None:
            # SC-FDMA MIMO: streams are DFT-precoded before the
            # space-time encoding and despread after LINEAR per-tone
            # detection (combiners/ZF/MMSE). ML and SIC slice per-tone
            # samples against the constellation — meaningless for
            # spread symbols (they are sums of all data points):
            if self.mimo.detector in ("ml", "sic"):
                raise ValueError(
                    "dft_spread + MIMO needs a LINEAR detector "
                    "(Alamouti/MRC combining or ZF/MMSE mux): ML and "
                    "SIC make per-tone constellation decisions, which "
                    "do not exist for DFT-spread symbols — despreading "
                    "happens after detection"
                )
        if self.dft_spread and self.pilot_spacing:
            # Block pilots estimate once per pilot_spacing symbols.
            # CFO/timing acquisition IS supported: the residual CFO's
            # per-symbol common phase is LINEAR, so the tracked
            # block-pilot estimator interpolates it between pilot
            # symbols exactly (ops.pilots.estimate_block_pilots_tracked
            # — the LTE-uplink composition). What the interpolation
            # cannot represent is variation that is NOT linear within
            # a block:
            # LO phase noise composes (a Wiener walk is locally linear
            # between pilot symbols), and flat Jakes fading composes
            # too (per-block scalar gains, complex-chord interpolation
            # — estimate_block_pilots_interp). Validity needs the
            # pilot period inside the coherence time:
            # MULTIPATH_TIME composes the same way, per TONE: each
            # tone's complex gain moves at the same Doppler rate, so
            # the per-tone chord interpolation between pilot blocks
            # (estimate_block_pilots_interp_full) carries it under the
            # identical coherence bound.
            if self.channel.model in TIME_VARYING_MODELS:
                if self.pilot_spacing * self.channel.doppler_norm > 0.25:
                    raise ValueError(
                        "SC-FDMA block pilots cannot track fading "
                        "faster than their own period: need "
                        "pilot_spacing·doppler_norm <= 0.25, got "
                        f"{self.pilot_spacing}·{self.channel.doppler_norm}"
                    )
            # I/Q imbalance composes too: the properization moments
            # difference at the BLOCK period (pilot symbols repeat
            # every pilot_spacing symbols), cancelling the Zadoff-Chu
            # deterministic component exactly; the residual direct
            # gain lands in the block-pilot estimate as usual. Needs
            # at least two blocks to difference:
            if self.channel.iq_imbalanced and (
                self.n_symbols // self.pilot_spacing
            ) < 2:
                raise ValueError(
                    "dft_spread + I/Q imbalance needs >= 2 pilot "
                    "blocks (the blind properization differences "
                    "consecutive blocks to cancel the Zadoff-Chu "
                    "pilot symbols)"
                )
        if self.channel.model in SELECTIVE_MODELS:
            if len(self.channel.pdp) > self.ofdm.cp_len + 1:
                raise ValueError(
                    "multipath delay spread exceeds cyclic prefix: "
                    f"{len(self.channel.pdp)} taps > cp_len+1={self.ofdm.cp_len + 1}"
                )
        if self.n_symbols < 1 or self.n_channels < 1:
            raise ValueError("n_symbols and n_channels must be >= 1")
        if self.channel.phase_noise_std:
            tracked = bool(self.pilot_spacing) or (
                self.mimo is not None
                and self.mimo.csi == "preamble"
                and self.mimo.midamble_period
            )
            if not tracked:
                raise ValueError(
                    "phase_noise_std > 0 needs a phase-tracking estimate "
                    "(pilot_spacing > 0, or a MIMO midamble schedule): "
                    "the oscillator's random common phase is unknowable "
                    "to genie CSI"
                )
        if self.channel.iq_imbalanced:
            has_estimated_csi = bool(self.pilot_spacing) or (
                self.mimo is not None and self.mimo.csi == "preamble"
            )
            if not has_estimated_csi:
                raise ValueError(
                    "I/Q imbalance needs estimated CSI (pilot_spacing > 0, "
                    "or mimo.csi='preamble'): the blind compensator leaves "
                    "a residual complex direct gain that only an estimated "
                    "channel can absorb — genie CSI has no access to the "
                    "mixer"
                )
        if self.channel.impaired:
            has_estimated_csi = bool(self.pilot_spacing) or (
                self.mimo is not None and self.mimo.csi == "preamble"
            )
            if not has_estimated_csi:
                raise ValueError(
                    "timing/CFO impairments need estimated CSI "
                    "(pilot_spacing > 0, or mimo.csi='preamble'): after "
                    "blind acquisition the channel estimate must absorb "
                    "the residual timing phase — genie CSI has no access "
                    "to it"
                )
        if self.mimo is not None:
            if self.channel.model not in (
                ChannelModel.RAYLEIGH_FLAT,
                ChannelModel.RICIAN,
                ChannelModel.MULTIPATH,
                ChannelModel.RAYLEIGH_TIME,
                ChannelModel.MULTIPATH_TIME,
            ):
                raise ValueError(
                    "MIMO needs a fading channel defining the (n_rx, n_tx) "
                    "matrix: RAYLEIGH_FLAT, RICIAN, MULTIPATH, "
                    "RAYLEIGH_TIME or MULTIPATH_TIME — got "
                    f"{self.channel.model.value}"
                )
            if self.mimo.midamble_period and not (
                self.channel.model in TIME_VARYING_MODELS
                or self.channel.phase_noise_std
                or self.channel.impaired
            ):
                raise ValueError(
                    "midamble_period is the TRACKING schedule for a "
                    "time-varying composite channel (Jakes fading, LO "
                    "phase noise, or residual CFO after acquisition); a "
                    "frame-static link uses the single head preamble "
                    "(set midamble_period=0) — got "
                    f"{self.channel.model.value} with no phase noise or "
                    "impairments"
                )
            if (
                self.channel.model in TIME_VARYING_MODELS
                and self.mimo.csi == "preamble"
            ):
                if not self.mimo.midamble_period:
                    raise ValueError(
                        "a single head preamble is stale by the first data "
                        "symbol under time-varying fading: set "
                        "mimo.midamble_period (periodic re-estimation with "
                        "interpolation) or csi='genie'"
                    )
                if self.n_symbols % self.mimo.midamble_period:
                    raise ValueError(
                        "n_symbols must be a multiple of midamble_period, "
                        f"got {self.n_symbols} % {self.mimo.midamble_period}"
                    )
            if self.pilot_spacing:
                raise ValueError(
                    "comb pilots (pilot_spacing) are the SISO estimation "
                    "mechanism; MIMO estimation uses the time-orthogonal "
                    "preamble — set mimo.csi='preamble' and pilot_spacing=0"
                )
            if self.mimo.detector == "ml":
                n_cand = (1 << self.modulation.bits_per_symbol) ** self.mimo.n_tx
                if n_cand > 4096:
                    raise ValueError(
                        "ML joint detection enumerates M**n_tx = "
                        f"{n_cand} candidates (> 4096 budget); use a "
                        "smaller constellation/n_tx or detector='linear'"
                    )
            if self.channel.impaired:
                if not (
                    self.mimo.csi == "preamble" and self.mimo.midamble_period
                ):
                    raise ValueError(
                        "MIMO + CFO/timing acquisition needs "
                        "csi='preamble' WITH a midamble_period: the "
                        "residual post-acquisition CFO (~1e-2 "
                        "subcarriers) rotates the constellation a little "
                        "more each symbol, and only the interpolated "
                        "midamble estimates track it — genie CSI or a "
                        "single head preamble cannot"
                    )
                # Mixer impairments compose: per-antenna blind I/Q
                # properization runs on the raw stream (lag-sym_len
                # moments) before the synchronizer, and the midamble
                # schedule — already required here — tracks the LO
                # walk and residual-CFO common phase afterwards.
            if self.channel.phase_noise_std and not (
                self.mimo.csi == "preamble" and self.mimo.midamble_period
            ):
                raise ValueError(
                    "MIMO + LO phase noise needs csi='preamble' with a "
                    "midamble_period: the shared-LO Wiener walk rides the "
                    "per-block channel estimates (interpolated between "
                    "midambles) — genie CSI has no access to the "
                    "oscillator"
                )
            if self.channel.iq_imbalanced and self.mimo.csi != "preamble":
                raise ValueError(
                    "MIMO + I/Q imbalance needs csi='preamble': the blind "
                    "per-antenna properization leaves a residual complex "
                    "direct gain only an estimated channel can absorb — "
                    "genie CSI has no access to the mixer"
                )
            if self.mimo.scheme == MIMOScheme.ALAMOUTI and self.n_symbols % 2:
                raise ValueError(
                    "Alamouti codes symbol PAIRS: n_symbols must be even, "
                    f"got {self.n_symbols}"
                )
            if (
                self.mimo.scheme == MIMOScheme.SPATIAL_MUX
                and self.equalizer == Equalizer.NONE
            ):
                raise ValueError(
                    "spatial multiplexing needs a linear detector: set "
                    "equalizer to ZF or MMSE"
                )

    @property
    def n_streams(self) -> int:
        """Independent spatial streams (1 for SISO/diversity schemes)."""
        return 1 if self.mimo is None else self.mimo.n_streams

    @property
    def n_data_subcarriers(self) -> int:
        """Subcarriers carrying payload (n_fft minus the pilot comb).

        DFT-spread frames multiplex pilots in TIME (whole Zadoff-Chu
        symbols), so their data symbols always load the full grid."""
        n = self.ofdm.n_fft
        if self.dft_spread or not self.pilot_spacing:
            return n
        n_pilots = (n + self.pilot_spacing - 1) // self.pilot_spacing
        return n - n_pilots

    @property
    def n_pilot_symbols(self) -> int:
        """Whole OFDM symbols spent on reference signals (SC-FDMA block
        pilots); comb-pilot frames spend subcarriers instead."""
        if self.dft_spread and self.pilot_spacing:
            return self.n_symbols // self.pilot_spacing
        return 0

    @property
    def n_data_symbols(self) -> int:
        """OFDM symbols carrying payload out of the n_symbols frame."""
        return self.n_symbols - self.n_pilot_symbols

    @property
    def bits_per_ofdm_symbol(self) -> int:
        """Payload bits per DATA symbol period (all spatial streams)."""
        return (
            self.n_data_subcarriers
            * self.modulation.bits_per_symbol
            * self.n_streams
        )

    @property
    def bits_total(self) -> int:
        return self.n_channels * self.n_data_symbols * self.bits_per_ofdm_symbol

    @property
    def samples_per_symbol(self) -> int:
        return self.ofdm.symbol_len


def link_config_to_dict(cfg: LinkConfig) -> dict:
    """JSON-ready dict (enums as their string values)."""
    return {
        "modulation": cfg.modulation.value,
        "ofdm": {"n_fft": cfg.ofdm.n_fft, "cp_len": cfg.ofdm.cp_len},
        "channel": {
            "model": cfg.channel.model.value,
            "ebno_db": cfg.channel.ebno_db,
            "pdp": list(cfg.channel.pdp),
            "doppler_norm": cfg.channel.doppler_norm,
            "cfo_subcarriers": cfg.channel.cfo_subcarriers,
            "timing_offset": cfg.channel.timing_offset,
            "k_factor": cfg.channel.k_factor,
            "phase_noise_std": cfg.channel.phase_noise_std,
            "iq_gain": cfg.channel.iq_gain,
            "iq_phase_rad": cfg.channel.iq_phase_rad,
            "pa_ibo_db": cfg.channel.pa_ibo_db,
            "pa_smoothness": cfg.channel.pa_smoothness,
            "pa_dpd": cfg.channel.pa_dpd,
        },
        "dft_spread": cfg.dft_spread,
        "equalizer": cfg.equalizer.value,
        "estimator": cfg.estimator.value,
        "n_symbols": cfg.n_symbols,
        "n_channels": cfg.n_channels,
        "pilot_spacing": cfg.pilot_spacing,
        "mimo": (
            None
            if cfg.mimo is None
            else {
                "scheme": cfg.mimo.scheme.value,
                "n_tx": cfg.mimo.n_tx,
                "n_rx": cfg.mimo.n_rx,
                "csi": cfg.mimo.csi,
                "detector": cfg.mimo.detector,
                "midamble_period": cfg.mimo.midamble_period,
            }
        ),
    }


def link_config_from_dict(d: dict) -> LinkConfig:
    """Inverse of link_config_to_dict; validation runs in __post_init__
    exactly as for programmatic construction (the trace-time analog of
    the reference's runtime guards)."""
    ch = d.get("channel", {})
    mm = d.get("mimo")
    mimo = (
        None
        if mm is None
        else MIMOConfig(
            scheme=MIMOScheme(mm.get("scheme", "alamouti")),
            n_tx=mm.get("n_tx", 2),
            n_rx=mm.get("n_rx", 1),
            csi=mm.get("csi", "genie"),
            detector=mm.get("detector", "linear"),
            midamble_period=mm.get("midamble_period", 0),
        )
    )
    return LinkConfig(
        modulation=Modulation(d.get("modulation", "qpsk")),
        ofdm=OFDMConfig(**d.get("ofdm", {})),
        channel=ChannelConfig(
            model=ChannelModel(ch.get("model", "awgn")),
            ebno_db=ch.get("ebno_db", 10.0),
            pdp=tuple(ch.get("pdp", (1.0,))),
            doppler_norm=ch.get("doppler_norm", 0.01),
            cfo_subcarriers=ch.get("cfo_subcarriers", 0.0),
            timing_offset=ch.get("timing_offset", 0),
            k_factor=ch.get("k_factor", 4.0),
            phase_noise_std=ch.get("phase_noise_std", 0.0),
            iq_gain=ch.get("iq_gain", 1.0),
            iq_phase_rad=ch.get("iq_phase_rad", 0.0),
            pa_ibo_db=ch.get("pa_ibo_db"),
            pa_smoothness=ch.get("pa_smoothness", 2.0),
            pa_dpd=ch.get("pa_dpd", False),
        ),
        dft_spread=d.get("dft_spread", False),
        equalizer=Equalizer(d.get("equalizer", "none")),
        estimator=ChannelEstimator(d.get("estimator", "ls")),
        n_symbols=d.get("n_symbols", 16),
        n_channels=d.get("n_channels", 1),
        pilot_spacing=d.get("pilot_spacing", 0),
        mimo=mimo,
    )
