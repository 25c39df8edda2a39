"""MIMO: Alamouti STBC, receive MRC, spatial-mux detection (ops.mimo).

New capability over the strictly-SISO reference (ofdm.hpp:13-54).
Validation tiers follow the repo's standard pattern: exact algebraic
identities for the combiners (the noiseless analog of the reference's
round-trip tests), statistical BER against the exact diversity theory
(link.ber.ber_alamouti_exact / ber_mrc_exact — MGF-averaged Cho–Yoon),
and config-surface guards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    MIMOConfig,
    MIMOScheme,
    Modulation,
    OFDMConfig,
    link_config_from_dict,
    link_config_to_dict,
)
from sdr_tpu.link.ber import (
    ber_alamouti_exact,
    ber_mrc_exact,
    ber_rayleigh_exact,
)
from sdr_tpu.link.pipeline import make_simulate_fn
from sdr_tpu.ops import mimo as mo


def _cgauss(key, shape):
    kr, ki = jax.random.split(key)
    return jax.lax.complex(
        jax.random.normal(kr, shape), jax.random.normal(ki, shape)
    ) * jnp.float32(2.0 ** -0.5)


# ---------------------------------------------------------------------------
# Exact combiner algebra (noiseless identities)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_rx", [1, 2, 4])
def test_alamouti_noiseless_exact(n_rx):
    """Encode → flat channel → combine recovers the symbols exactly."""
    key = jax.random.PRNGKey(0)
    kx, kh = jax.random.split(key)
    S, N = 8, 16
    x = _cgauss(kx, (S, N))
    H = _cgauss(kh, (n_rx, 2))
    ant = mo.alamouti_encode(x)  # (2, S, N)
    y = jnp.einsum("rt,tsn->rsn", H, ant)  # noiseless
    s, eff = mo.alamouti_combine(y, H[..., None], 1e-3)
    np.testing.assert_allclose(
        np.asarray(s), np.asarray(x), rtol=2e-5, atol=2e-5
    )
    # eff_var = 2 nv / sum|h|^2 exactly.
    g = float(jnp.sum(jnp.abs(H) ** 2))
    np.testing.assert_allclose(
        np.asarray(eff).ravel()[0], 2e-3 / g, rtol=1e-5
    )


def test_alamouti_energy_preserved():
    """The G2 encode radiates total unit energy per subcarrier use."""
    x = _cgauss(jax.random.PRNGKey(1), (16, 32))
    ant = mo.alamouti_encode(x)
    ex = float(jnp.mean(jnp.abs(x) ** 2))
    ea = float(jnp.sum(jnp.mean(jnp.abs(ant) ** 2, axis=(1, 2))))
    np.testing.assert_allclose(ea, ex, rtol=1e-5)


@pytest.mark.parametrize("n_rx", [2, 4])
def test_mrc_noiseless_exact(n_rx):
    key = jax.random.PRNGKey(2)
    kx, kh = jax.random.split(key)
    S, N = 4, 8
    x = _cgauss(kx, (S, N))
    h = _cgauss(kh, (n_rx, 1))
    y = h[:, :, None] * x[None]  # (n_rx, S, N)
    s, eff = mo.mrc_combine(y, h[..., None], 0.5)
    np.testing.assert_allclose(np.asarray(s), np.asarray(x), rtol=2e-5, atol=2e-5)
    g = float(jnp.sum(jnp.abs(h) ** 2))
    np.testing.assert_allclose(np.asarray(eff).ravel()[0], 0.5 / g, rtol=1e-5)


@pytest.mark.parametrize("zf", [True, False])
@pytest.mark.parametrize("n_tx,n_rx", [(2, 2), (2, 4), (3, 4)])
def test_mux_noiseless_exact(n_tx, n_rx, zf):
    """ZF inverts exactly; MMSE converges to ZF as nv → 0."""
    key = jax.random.PRNGKey(3)
    kx, kh = jax.random.split(key)
    S, N = 4, 8
    x = _cgauss(kx, (n_tx, S, N))
    xs = mo.mux_encode(x)
    H = _cgauss(kh, (n_rx, n_tx))
    y = jnp.einsum("rt,tsn->rsn", H, xs)
    det = mo.mux_detect_zf if zf else mo.mux_detect_mmse
    s, eff = det(y, H[..., None], 1e-9)
    np.testing.assert_allclose(
        np.asarray(s), np.asarray(x), rtol=2e-4, atol=2e-4
    )


def test_mux_detect_per_subcarrier_channel():
    """Frequency-selective H (distinct per subcarrier) detects exactly."""
    key = jax.random.PRNGKey(4)
    kx, kh = jax.random.split(key)
    n_tx, n_rx, S, N = 2, 2, 4, 8
    x = _cgauss(kx, (n_tx, S, N))
    xs = mo.mux_encode(x)
    H = _cgauss(kh, (n_rx, n_tx, N))
    y = jnp.einsum("rtn,tsn->rsn", H, xs)
    s, _ = mo.mux_detect_zf(y, H, 1e-9)
    np.testing.assert_allclose(np.asarray(s), np.asarray(x), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Exact theory self-consistency
# ---------------------------------------------------------------------------


def test_mrc_theory_reduces_to_rayleigh():
    for mod in (Modulation.QPSK, Modulation.QAM16):
        for e in (0.0, 5.0, 10.0, 15.0):
            np.testing.assert_allclose(
                ber_mrc_exact(mod, e, 1), ber_rayleigh_exact(mod, e), rtol=1e-6
            )


def test_diversity_theory_ordering():
    e = 12.0
    siso = ber_rayleigh_exact(Modulation.QPSK, e)
    a21 = ber_alamouti_exact(Modulation.QPSK, e, 1)
    a22 = ber_alamouti_exact(Modulation.QPSK, e, 2)
    mrc2 = ber_mrc_exact(Modulation.QPSK, e, 2)
    # Diversity strictly helps; MRC-2 beats Alamouti 2x1 (no power split).
    assert siso > a21 > a22
    assert a21 > mrc2 > a22


# ---------------------------------------------------------------------------
# End-to-end statistical BER vs exact theory
# ---------------------------------------------------------------------------


def _run_ber(cfg: LinkConfig, n_seeds: int = 2) -> float:
    fn = make_simulate_fn(cfg)
    e = b = 0
    for s in range(n_seeds):
        r = fn(jax.random.PRNGKey(s))
        e += int(r.bit_errors.sum())
        b += int(r.bits_counted.sum())
    return e / b


_BASE = dict(
    modulation=Modulation.QPSK,
    ofdm=OFDMConfig(n_fft=64, cp_len=16),
    channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=5.0),
    equalizer=Equalizer.MMSE,
    n_symbols=16,
    n_channels=2048,
)


@pytest.mark.parametrize(
    "mimo,theory",
    [
        (
            MIMOConfig(MIMOScheme.ALAMOUTI, 2, 1),
            lambda: ber_alamouti_exact(Modulation.QPSK, 5.0, 1),
        ),
        (
            MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
            lambda: ber_alamouti_exact(Modulation.QPSK, 5.0, 2),
        ),
        (
            MIMOConfig(MIMOScheme.MRC, 1, 2),
            lambda: ber_mrc_exact(Modulation.QPSK, 5.0, 2),
        ),
    ],
)
def test_mimo_ber_vs_exact_theory(mimo, theory):
    """Measured BER within 10% of the exact MGF-averaged theory
    (4096 fade draws → fade-realization std ~2-3%; 10% ≈ 3-4σ)."""
    ber = _run_ber(LinkConfig(**_BASE, mimo=mimo))
    th = theory()
    assert th * 0.90 < ber < th * 1.10, (ber, th)


def test_mux_ber_sane():
    """2x2 MMSE mux carries 2x the bits; its BER lands between SISO
    Rayleigh (it enjoys some rx diversity per stream after MMSE) and
    the 2x4 case (more rx diversity → much better)."""
    cfg22 = LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2))
    cfg24 = LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 4))
    b22, b24 = _run_ber(cfg22, 1), _run_ber(cfg24, 1)
    assert b24 < b22 * 0.25
    # Rate check: counted bits double the SISO frame.
    r = make_simulate_fn(cfg22)(jax.random.PRNGKey(0))
    assert int(r.bits_counted[0]) == 2 * 16 * 64 * 2


def test_mimo_multipath_frequency_selective():
    """MIMO over per-pair multipath: genie-CSI mux detection works on a
    frequency-selective channel (CP-bounded taps, per-subcarrier H)."""
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(n_fft=64, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH,
            ebno_db=30.0,
            pdp=(1.0, 0.5, 0.25),
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=16,
        n_channels=256,
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
    )
    ber = _run_ber(cfg, 1)
    # 30 dB with 4-branch diversity: essentially error-free.
    assert ber < 1e-4, ber
    cfg_mux = LinkConfig(
        **{
            **{f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()},
            "mimo": MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 4),
        }
    )
    assert _run_ber(cfg_mux, 1) < 1e-3


def test_mimo_rician():
    """Rician MIMO runs and beats Rayleigh MIMO at the same Eb/N0 (the
    LOS component adds deterministic energy)."""
    ray = LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 1))
    ric = LinkConfig(
        **{**_BASE, "channel": ChannelConfig(model=ChannelModel.RICIAN, ebno_db=5.0, k_factor=10.0)},
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 1),
    )
    assert _run_ber(ric, 1) < _run_ber(ray, 1)


# ---------------------------------------------------------------------------
# Max-log ML joint detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16])
def test_ml_matches_bruteforce(mod):
    """Hard bits from the max-log LLRs equal exhaustive joint ML.

    The per-bit max-log decision is the bit of the global-minimum
    candidate, so this checks metric construction, candidate/bit
    tables, and output ordering all at once against a plain numpy
    double loop."""
    from sdr_tpu.ops.llr import llr_to_hard_bits
    from sdr_tpu.ops.modulation import constellation

    rng = np.random.default_rng(7)
    n_tx = n_rx = 2
    S, N = 3, 4
    bps = mod.bits_per_symbol
    M = 1 << bps
    const = np.asarray(constellation(mod))
    H = (rng.normal(size=(n_rx, n_tx, N)) + 1j * rng.normal(size=(n_rx, n_tx, N))) / np.sqrt(2)
    idx_true = rng.integers(0, M, size=(n_tx, S, N))
    x = const[idx_true] / np.sqrt(n_tx)
    noise = (rng.normal(size=(n_rx, S, N)) + 1j * rng.normal(size=(n_rx, S, N))) * 0.15
    y = np.einsum("rtn,tsn->rsn", H, x) + noise
    got = np.asarray(
        llr_to_hard_bits(
            mo.mux_detect_ml(
                jnp.asarray(y, jnp.complex64),
                jnp.asarray(H, jnp.complex64),
                0.045,
                mod,
            )
        )
    )  # (n_tx, S, N*bps)
    # Exhaustive ML per resource element.
    want = np.zeros_like(got)
    for s in range(S):
        for n in range(N):
            best, bm = None, np.inf
            for i0 in range(M):
                for i1 in range(M):
                    cand = np.array([const[i0], const[i1]]) / np.sqrt(n_tx)
                    m = np.sum(np.abs(y[:, s, n] - H[:, :, n] @ cand) ** 2)
                    if m < bm:
                        bm, best = m, (i0, i1)
            for t in range(n_tx):
                bits = [(best[t] >> (bps - 1 - j)) & 1 for j in range(bps)]
                want[t, s, n * bps:(n + 1) * bps] = bits
    np.testing.assert_array_equal(got, want)


def test_ml_beats_linear_mmse():
    """2x2 mux over flat Rayleigh: joint ML recovers full n_rx=2
    diversity; linear MMSE is diversity 1 — a wide BER gap at 10 dB."""
    base = {**_BASE, "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0)}
    lin = LinkConfig(**base, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2))
    ml = LinkConfig(
        **base, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml")
    )
    b_lin, b_ml = _run_ber(lin, 1), _run_ber(ml, 1)
    assert b_ml < 0.5 * b_lin, (b_ml, b_lin)


def test_ml_multipath_high_snr_error_free():
    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=64, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=35.0, pdp=(1.0, 0.5)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=8,
        n_channels=64,
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 3, detector="ml"),
    )
    assert _run_ber(cfg, 1) < 1e-3


# ---------------------------------------------------------------------------
# Ordered MMSE-SIC (V-BLAST)
# ---------------------------------------------------------------------------


def test_sic_noiseless_exact():
    """With nv -> 0 every slice is correct and SIC returns the exact
    transmitted points (per-subcarrier frequency-selective channel)."""
    from sdr_tpu.ops.modulation import modulate

    rng = np.random.default_rng(21)
    n_tx, n_rx, S, N = 3, 4, 4, 8
    mod = Modulation.QAM16
    bits = jnp.asarray(
        rng.integers(0, 2, size=(n_tx, S, N * 4)), jnp.int8
    )
    x = modulate(bits, mod)  # unit-power points
    H = jnp.asarray(
        (rng.normal(size=(n_rx, n_tx, N)) + 1j * rng.normal(size=(n_rx, n_tx, N)))
        / np.sqrt(2),
        jnp.complex64,
    )
    y = jnp.einsum("rtn,tsn->rsn", H, x * jnp.float32(n_tx ** -0.5))
    s, eff = mo.mux_detect_sic(y, H, 1e-9, mod)
    np.testing.assert_allclose(np.asarray(s), np.asarray(x), rtol=2e-3, atol=2e-3)
    assert float(jnp.max(eff)) < 1e-6


def test_detector_ladder_mmse_sic_ml():
    """BER ordering at 2x2 QPSK 10 dB: ML < SIC < linear MMSE, with
    SIC a clear improvement over MMSE (ordering + cancellation)."""
    base = {**_BASE, "channel": ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0)}
    mk = lambda det: LinkConfig(
        **base, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector=det)
    )
    b_lin = _run_ber(mk("linear"), 1)
    b_sic = _run_ber(mk("sic"), 1)
    b_ml = _run_ber(mk("ml"), 1)
    assert b_ml < b_sic < b_lin, (b_ml, b_sic, b_lin)
    assert b_sic < 0.8 * b_lin


def test_sic_4x4_64qam_beyond_ml_budget():
    """4x4 64-QAM: the ML budget (64^4 candidates) is out of reach and
    the config layer rejects it; SIC runs and clearly beats linear."""
    base = dict(
        modulation=Modulation.QAM64,
        ofdm=OFDMConfig(n_fft=64, cp_len=16),
        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=22.0),
        equalizer=Equalizer.MMSE,
        n_symbols=8,
        n_channels=512,
    )
    with pytest.raises(ValueError):
        LinkConfig(
            **base,
            mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 4, 4, detector="ml"),
        )
    b_sic = _run_ber(
        LinkConfig(
            **base, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 4, 4, detector="sic")
        ),
        1,
    )
    b_lin = _run_ber(
        LinkConfig(**base, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 4, 4)), 1
    )
    assert b_sic < 0.8 * b_lin, (b_sic, b_lin)


# ---------------------------------------------------------------------------
# Preamble channel estimation (csi='preamble')
# ---------------------------------------------------------------------------


def test_preamble_estimator_exact_noiseless():
    """LS on a noiseless preamble returns the channel exactly; the
    DFT/CP-subspace projection is exact for any in-CP channel."""
    from sdr_tpu.ops.pilots import PILOT_VALUE, estimate_mimo_preamble

    rng = np.random.default_rng(11)
    n_rx, n_tx, N = 2, 2, 32
    # Frequency response of a 5-tap (in-CP) channel per pair.
    taps = (rng.normal(size=(n_rx, n_tx, 5)) + 1j * rng.normal(size=(n_rx, n_tx, 5)))
    H = np.fft.fft(taps, n=N, axis=-1)
    y_pre = jnp.asarray(H * PILOT_VALUE, jnp.complex64)
    h_ls = estimate_mimo_preamble(y_pre)
    np.testing.assert_allclose(np.asarray(h_ls), H, rtol=2e-4, atol=2e-4)
    h_dft = estimate_mimo_preamble(y_pre, n_taps=9)
    np.testing.assert_allclose(np.asarray(h_dft), H, rtol=2e-3, atol=2e-3)


def test_preamble_dft_denoises():
    """Under noise the CP-subspace projection cuts estimation MSE by
    ~n_taps/n_fft vs raw LS (here 9/64 → ~7x)."""
    from sdr_tpu.ops.pilots import PILOT_VALUE, estimate_mimo_preamble

    rng = np.random.default_rng(12)
    n_rx, n_tx, N = 2, 2, 64
    taps = (rng.normal(size=(n_rx, n_tx, 3)) + 1j * rng.normal(size=(n_rx, n_tx, 3))) / np.sqrt(6)
    H = np.fft.fft(taps, n=N, axis=-1)
    noise = (rng.normal(size=H.shape) + 1j * rng.normal(size=H.shape)) * 0.1
    y_pre = jnp.asarray(H * PILOT_VALUE + noise, jnp.complex64)
    mse_ls = float(np.mean(np.abs(np.asarray(estimate_mimo_preamble(y_pre)) - H) ** 2))
    mse_dft = float(
        np.mean(np.abs(np.asarray(estimate_mimo_preamble(y_pre, n_taps=9)) - H) ** 2)
    )
    assert mse_dft < 0.3 * mse_ls, (mse_dft, mse_ls)


@pytest.mark.parametrize(
    "mimo",
    [
        MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
        MIMOConfig(MIMOScheme.MRC, 1, 2, csi="preamble"),
        MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble", detector="ml"),
    ],
)
def test_preamble_ber_near_genie(mimo):
    """Estimated CSI costs a bounded penalty vs genie at 5 dB.

    Raw per-subcarrier LS sees estimation-error variance = nv (no
    averaging — a real but large penalty at 5 dB); the CP-subspace
    projection cuts it by n_taps/n_fft = 17/64 and must land close to
    genie. Neither can be materially BELOW genie."""
    import dataclasses

    from sdr_tpu.core.config import ChannelEstimator

    genie = _run_ber(
        LinkConfig(**_BASE, mimo=dataclasses.replace(mimo, csi="genie")), 1
    )
    est_ls = _run_ber(LinkConfig(**_BASE, mimo=mimo), 1)
    est_dft = _run_ber(
        LinkConfig(**{**_BASE, "estimator": ChannelEstimator.DFT}, mimo=mimo), 1
    )
    assert genie * 0.8 < est_dft < 3.0 * genie, (est_dft, genie)
    assert genie * 0.8 < est_ls < 12.0 * genie, (est_ls, genie)
    assert est_dft < est_ls, (est_dft, est_ls)


def test_preamble_dft_beats_ls_end_to_end():
    """Multipath Alamouti 2x2 with estimated CSI: the DFT-denoised
    estimator yields lower BER than raw per-subcarrier LS."""
    from sdr_tpu.core.config import ChannelEstimator

    base = dict(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(n_fft=64, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=9.0, pdp=(1.0, 0.6, 0.3)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=16,
        n_channels=1024,
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
    )
    b_ls = _run_ber(LinkConfig(**base), 1)
    b_dft = _run_ber(
        LinkConfig(**{**base, "estimator": ChannelEstimator.DFT}), 1
    )
    assert b_dft < b_ls, (b_dft, b_ls)


# ---------------------------------------------------------------------------
# Config surface
# ---------------------------------------------------------------------------


def test_mimo_config_validation():
    with pytest.raises(ValueError):
        MIMOConfig(MIMOScheme.ALAMOUTI, n_tx=3, n_rx=1)
    with pytest.raises(ValueError):
        MIMOConfig(MIMOScheme.MRC, n_tx=2, n_rx=2)
    with pytest.raises(ValueError):
        MIMOConfig(MIMOScheme.SPATIAL_MUX, n_tx=4, n_rx=2)
    with pytest.raises(ValueError):  # AWGN has no (n_rx, n_tx) matrix
        LinkConfig(**{**_BASE, "channel": ChannelConfig(model=ChannelModel.AWGN)},
                   mimo=MIMOConfig(MIMOScheme.MRC, 1, 2))
    with pytest.raises(ValueError):  # Alamouti needs even n_symbols
        LinkConfig(**{**_BASE, "n_symbols": 15},
                   mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 1))
    with pytest.raises(ValueError):  # mux needs a linear detector
        LinkConfig(**{**_BASE, "equalizer": Equalizer.NONE},
                   mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2))
    with pytest.raises(ValueError):  # comb pilots are SISO; use csi='preamble'
        LinkConfig(**{**_BASE, "pilot_spacing": 8},
                   mimo=MIMOConfig(MIMOScheme.MRC, 1, 2))
    with pytest.raises(ValueError):  # unknown csi mode
        MIMOConfig(MIMOScheme.MRC, 1, 2, csi="oracle")
    with pytest.raises(ValueError):  # ml is a spatial-mux detector
        MIMOConfig(MIMOScheme.ALAMOUTI, 2, 1, detector="ml")
    with pytest.raises(ValueError):  # ML candidate budget: 1024**2 > 4096
        LinkConfig(
            **{**_BASE, "modulation": Modulation.QAM1024},
            mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml"),
        )


def test_mimo_config_roundtrip():
    cfg = LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 4))
    assert link_config_from_dict(link_config_to_dict(cfg)) == cfg
    est = LinkConfig(
        **_BASE,
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble", detector="ml"),
    )
    assert link_config_from_dict(link_config_to_dict(est)) == est
    siso = LinkConfig(**_BASE)
    assert link_config_from_dict(link_config_to_dict(siso)) == siso
    assert siso.bits_per_ofdm_symbol * 2 == cfg.bits_per_ofdm_symbol


def test_mimo_gated_out_of_siso_engines():
    cfg = LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.MRC, 1, 2))
    from sdr_tpu.link.fast import fast_simulate
    from sdr_tpu.link.stream import stream_simulate
    from sdr_tpu.link.mc import supported

    with pytest.raises(NotImplementedError):
        fast_simulate(cfg, jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError):
        stream_simulate(cfg, jax.random.PRNGKey(0), n_blocks=2)
    assert not supported(cfg)


# ---------------------------------------------------------------------------
# Time-varying MIMO (Jakes per antenna pair, per-symbol detection)
# ---------------------------------------------------------------------------


def _jakes_cfg(doppler, mimo, ebno=5.0, n_channels=2048, **over):
    base = dict(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(n_fft=64, cp_len=16),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_TIME, ebno_db=ebno,
            doppler_norm=doppler,
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=16,
        n_channels=n_channels,
    )
    base.update(over)
    return LinkConfig(**base, mimo=mimo)


def test_jakes_mimo_slow_fading_matches_flat_theory():
    """doppler ~ 0: per-symbol Jakes is frame-constant Rayleigh, so the
    measured BER sits on the same exact diversity theory as the flat
    model (Alamouti 2x1 and MRC 1x2)."""
    th_a = ber_alamouti_exact(Modulation.QPSK, 5.0, 1)
    b_a = _run_ber(_jakes_cfg(1e-5, MIMOConfig(MIMOScheme.ALAMOUTI, 2, 1)))
    assert th_a * 0.85 < b_a < th_a * 1.15, (b_a, th_a)
    th_m = ber_mrc_exact(Modulation.QPSK, 5.0, 2)
    b_m = _run_ber(_jakes_cfg(1e-5, MIMOConfig(MIMOScheme.MRC, 1, 2)))
    assert th_m * 0.85 < b_m < th_m * 1.15, (b_m, th_m)


def test_jakes_mimo_mux_per_symbol_genie():
    """Spatial mux with per-symbol genie CSI: fast fading does not
    break detection — per-symbol BER statistics match the flat case
    (each symbol sees a fresh but perfectly-known H). ML and SIC run."""
    flat = LinkConfig(
        **{**_BASE, "n_channels": 1024},
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml"),
    )
    fast = _jakes_cfg(
        0.2,
        MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml"),
        n_channels=1024,
    )
    b_flat, b_fast = _run_ber(flat, 1), _run_ber(fast, 1)
    assert 0.6 < b_fast / b_flat < 1.4, (b_fast, b_flat)
    b_sic = _run_ber(
        _jakes_cfg(0.2, MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2,
                                   detector="sic"), n_channels=512), 1
    )
    assert 0 < b_sic < 0.5


def test_jakes_alamouti_doppler_floor():
    """The quasi-static pair assumption breaks as fD grows: Alamouti at
    doppler_norm 0.3 shows the classic error floor a slow channel
    doesn't have (20 dB, where the static curve is ~1e-5)."""
    slow = _run_ber(
        _jakes_cfg(1e-4, MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2), ebno=20.0), 1
    )
    fast = _run_ber(
        _jakes_cfg(0.3, MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2), ebno=20.0), 1
    )
    assert fast > 5 * max(slow, 1e-6), (fast, slow)


def test_jakes_mimo_head_preamble_rejected():
    """A single head preamble is stale under Doppler — the config
    demands a midamble schedule (or genie CSI)."""
    with pytest.raises(ValueError):
        _jakes_cfg(0.05, MIMOConfig(MIMOScheme.MRC, 1, 2, csi="preamble"))
    with pytest.raises(ValueError):  # midamble needs csi='preamble'
        MIMOConfig(MIMOScheme.MRC, 1, 2, midamble_period=8)
    with pytest.raises(ValueError):  # S must be a multiple of the period
        _jakes_cfg(
            0.05,
            MIMOConfig(MIMOScheme.MRC, 1, 2, csi="preamble", midamble_period=5),
        )


def test_jakes_mimo_midamble_tracks_channel():
    """Midamble-tracked CSI under Doppler: close to genie at a slow
    fade, and a tighter schedule beats a looser one once the channel
    moves within a block."""
    mk = lambda dop, period, **kw: _jakes_cfg(
        dop,
        MIMOConfig(MIMOScheme.MRC, 1, 2, csi="preamble",
                   midamble_period=period),
        **kw,
    )
    genie = _run_ber(_jakes_cfg(0.005, MIMOConfig(MIMOScheme.MRC, 1, 2)), 1)
    tracked = _run_ber(mk(0.005, 4), 1)
    assert tracked < 2.0 * genie, (tracked, genie)
    # At fast fading the 16-symbol schedule is stale mid-block.
    tight = _run_ber(mk(0.08, 2, ebno=15.0), 1)
    loose = _run_ber(mk(0.08, 16, ebno=15.0), 1)
    assert tight < 0.7 * loose, (tight, loose)


def test_midamble_config_roundtrip():
    import dataclasses

    cfg = _jakes_cfg(
        0.02,
        MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble",
                   detector="ml", midamble_period=8),
    )
    assert link_config_from_dict(link_config_to_dict(cfg)) == cfg
    # The mux detectors run off the tracked per-symbol estimates too.
    assert 0 <= _run_ber(dataclasses.replace(cfg, n_channels=256), 1) < 0.5
    with pytest.raises(ValueError):  # midamble is the TRACKING schedule
        LinkConfig(
            **_BASE,
            mimo=MIMOConfig(MIMOScheme.MRC, 1, 2, csi="preamble",
                            midamble_period=4),
        )


def test_mimo_acquisition_blind():
    """MIMO + unknown delay + CFO: the array-combined S&C front end
    (antenna-0 sync preamble, non-coherent metric combining) realigns
    every RX antenna; preamble CSI absorbs the residual timing phase.
    BER within a small factor of the genie-aligned preamble link."""
    import dataclasses

    from sdr_tpu.core.config import ChannelEstimator

    base = LinkConfig(
        **{
            **_BASE,
            "estimator": ChannelEstimator.DFT,
            "channel": ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0
            ),
            "n_channels": 1024,
        },
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
    )
    acq = dataclasses.replace(
        base,
        channel=dataclasses.replace(
            base.channel, cfo_subcarriers=1.3, timing_offset=37
        ),
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble",
                        midamble_period=4),
    )
    # Outage vs in-lock, separately (as in the SISO Jakes-acquisition
    # test): the sync preamble radiates from TX antenna 0 alone, so a
    # burst is lost when EVERY RX branch of that column fades at once —
    # ~p^n_rx, a physics floor, not an estimator defect.
    r_al = make_simulate_fn(base)(jax.random.PRNGKey(0))
    r_acq = make_simulate_fn(acq)(jax.random.PRNGKey(0))
    ba = np.asarray(r_al.bit_errors) / np.asarray(r_al.bits_counted)
    bq = np.asarray(r_acq.bit_errors) / np.asarray(r_acq.bits_counted)
    outage = float((bq > 0.25).mean())
    assert outage < 0.05, outage
    in_lock = bq[bq <= 0.25]
    assert in_lock.mean() < 3.0 * max(ba.mean(), 5e-4), (
        in_lock.mean(), ba.mean()
    )
    # Spatial mux + ML through the same blind front end.
    mux = dataclasses.replace(
        acq,
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble",
                        detector="ml", midamble_period=4),
        n_channels=256,
    )
    assert 0 < _run_ber(mux, 1) < 0.2
    with pytest.raises(ValueError):  # head preamble alone can't track
        dataclasses.replace(
            acq,
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
        )
    with pytest.raises(ValueError):  # genie CSI can't absorb timing phase
        LinkConfig(
            **{**_BASE, "channel": ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                cfo_subcarriers=1.0)},
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
        )
    # Jakes + acquisition composes since round 3 (gate removed) — see
    # test_mimo_acquisition_composes_with_jakes.


def test_mimo_acquisition_composes_with_mixer_impairments():
    """MIMO blind acquisition + LO phase noise + per-antenna I/Q
    imbalance in ONE link (round-3 gate removal): per-antenna blind
    properization runs on the raw unaligned stream (lag-sym_len
    moments, the SISO acquired convention), the midamble schedule
    tracks the walk afterwards — BER within a small factor of the
    clean-mixer acquired link."""
    import dataclasses

    def mk(pn=0.0, iqg=1.0, iqp=0.0):
        return LinkConfig(
            modulation=Modulation.QPSK,
            ofdm=OFDMConfig(64, 16),
            channel=ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                cfo_subcarriers=1.3, timing_offset=37,
                phase_noise_std=pn, iq_gain=iqg, iq_phase_rad=iqp,
            ),
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble",
                            midamble_period=4),
            equalizer=Equalizer.MMSE,
            n_symbols=32,
            n_channels=256,
        )

    def ber(cfg):
        r = make_simulate_fn(cfg)(jax.random.PRNGKey(1))
        return float(np.asarray(r.bit_errors).sum()) / float(
            np.asarray(r.bits_counted).sum()
        )

    b_clean = ber(mk())
    b_full = ber(mk(pn=2e-3, iqg=1.05, iqp=0.03))
    # Measured: the impairments are fully compensated (ratio ~1.0 —
    # the 1.5 bound leaves room for realization noise only).
    assert b_full < 1.5 * b_clean, (b_full, b_clean)


def test_mimo_acquisition_composes_with_jakes():
    """MIMO blind acquisition under Jakes fading (fD·T = 0.02): the
    array-combined S&C front end acquires through the time-varying
    channel and the midamble schedule tracks it afterwards.

    Acceptance (the round-2 verdict's #6 bar, with the SISO fading-
    acquisition outage treatment): in-lock channels within 2x of the
    GENIE-aligned Jakes link; outages (the genuinely-faded antenna-0
    preambles, a physics floor ~p^n_rx) bounded; and acquisition
    itself costs ~nothing over the aligned midamble-tracked link."""
    import dataclasses

    def cfg(csi, cfo=0.0, to=0, midamble=0):
        return _jakes_cfg(
            0.02,
            MIMOConfig(MIMOScheme.MRC, 1, 2, csi=csi,
                       midamble_period=midamble),
            n_channels=64,
            n_symbols=32,
            channel=ChannelConfig(
                model=ChannelModel.RAYLEIGH_TIME, ebno_db=5.0,
                doppler_norm=0.02, cfo_subcarriers=cfo,
                timing_offset=to,
            ),
        )

    key = jax.random.PRNGKey(3)
    r_g = make_simulate_fn(cfg("genie"))(key)
    r_m = make_simulate_fn(cfg("preamble", midamble=4))(key)
    r_a = make_simulate_fn(cfg("preamble", 1.7, 21, midamble=4))(key)
    t = float(np.asarray(r_g.bits_counted)[0])
    e_g = np.asarray(r_g.bit_errors)
    e_m = np.asarray(r_m.bit_errors)
    e_a = np.asarray(r_a.bit_errors)
    in_lock = e_a[e_a / t <= 0.25]
    outages = int((e_a / t > 0.25).sum())
    assert outages <= 3, outages  # array preamble diversity: ~1/64
    assert in_lock.mean() <= 2.0 * max(e_g.mean(), 1.0), (
        in_lock.mean(), e_g.mean()
    )
    # Acquisition adds little on top of midamble estimation itself.
    assert in_lock.sum() <= 1.5 * e_m.sum(), (in_lock.sum(), e_m.sum())


def test_mimo_phase_noise_midamble_tracked():
    """MIMO + shared-LO phase noise: the Wiener walk rides the
    midamble-interpolated composite estimates — BER within a small
    factor of the clean-LO midamble link; genie CSI and head-preamble
    configs are rejected."""
    import dataclasses

    from sdr_tpu.core.config import ChannelEstimator

    # The clean-LO baseline uses the single head preamble (a clean
    # frame-static link must not pay midamble overhead — the config
    # layer enforces that); the phase-noise link adds the midamble
    # schedule the walk requires.
    base = LinkConfig(
        **{
            **_BASE,
            "channel": ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0
            ),
            "n_channels": 1024,
        },
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
    )
    pn = dataclasses.replace(
        base,
        channel=dataclasses.replace(base.channel, phase_noise_std=2e-3),
        mimo=dataclasses.replace(base.mimo, midamble_period=4),
    )
    b_clean, b_pn = _run_ber(base, 1), _run_ber(pn, 1)
    assert b_pn < 1.8 * b_clean, (b_pn, b_clean)
    with pytest.raises(ValueError):  # genie CSI can't see the LO
        LinkConfig(
            **{**_BASE, "channel": ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                phase_noise_std=2e-3)},
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
        )
    with pytest.raises(ValueError):  # head preamble alone goes stale
        LinkConfig(
            **{**_BASE, "channel": ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                phase_noise_std=2e-3)},
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
        )
    # Frequency-selective composite: multipath + phase noise through
    # the DFT-denoised midamble estimates runs with sane BER.
    sel = LinkConfig(
        **{
            **_BASE,
            "channel": ChannelConfig(
                model=ChannelModel.MULTIPATH, ebno_db=14.0,
                pdp=(1.0, 0.5), phase_noise_std=2e-3,
            ),
            "estimator": ChannelEstimator.DFT,
            "n_channels": 256,
        },
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml",
                        csi="preamble", midamble_period=4),
    )
    assert 0 < _run_ber(sel, 1) < 0.1


def test_mimo_iq_imbalance_compensated():
    """MIMO + per-antenna RX I/Q imbalance: blind properization per
    antenna + preamble CSI lands within a small factor of the
    matched-mixer link; genie CSI is rejected (it can't absorb the
    compensator's residual direct gain)."""
    import dataclasses

    from sdr_tpu.core.config import ChannelEstimator

    base = LinkConfig(
        **{
            **_BASE,
            "estimator": ChannelEstimator.DFT,
            "channel": ChannelConfig(
                model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0
            ),
        },
        mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2, csi="preamble"),
    )
    imb = dataclasses.replace(
        base,
        channel=dataclasses.replace(
            base.channel, iq_gain=1.05, iq_phase_rad=0.03
        ),
    )
    b_clean, b_imb = _run_ber(base, 1), _run_ber(imb, 1)
    assert b_imb < 1.6 * b_clean, (b_imb, b_clean)
    with pytest.raises(ValueError):  # genie CSI can't absorb the mixer
        LinkConfig(
            **{
                **_BASE,
                "channel": ChannelConfig(
                    model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0,
                    iq_gain=1.05,
                ),
            },
            mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
        )


# ---------------------------------------------------------------------------
# Coded MIMO (FEC over the multi-antenna link)
# ---------------------------------------------------------------------------


def test_coded_mimo_frame_capacity():
    """MIMO frames carry n_streams x the coded bits: the mux payload
    roughly doubles the SISO/diversity payload for the same frame."""
    from sdr_tpu.link.coded import info_bits_per_channel

    div = info_bits_per_channel(
        LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2))
    )
    mux = info_bits_per_channel(
        LinkConfig(**_BASE, mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2))
    )
    siso = info_bits_per_channel(LinkConfig(**_BASE))
    assert div == siso
    assert mux > 1.9 * siso


@pytest.mark.parametrize(
    "mimo",
    [
        MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2),
        MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml"),
    ],
)
def test_coded_mimo_waterfall(mimo):
    """Conv-coded MIMO: diversity + coding is essentially error-free at
    an Eb/N0 where the uncoded link still errs at the percent level."""
    import dataclasses

    from sdr_tpu.link.coded import make_coded_fn

    cfg = LinkConfig(
        **{**_BASE, "channel": dataclasses.replace(_BASE["channel"], ebno_db=8.0),
           "n_channels": 64},
        mimo=mimo,
    )
    err, cnt = make_coded_fn(cfg)(jax.random.PRNGKey(0))
    coded_ber = float(jnp.sum(err)) / float(jnp.sum(cnt))
    uncoded_ber = _run_ber(cfg, 1)
    assert coded_ber < 0.1 * max(uncoded_ber, 1e-9), (coded_ber, uncoded_ber)


def test_ldpc_mimo_runs():
    """LDPC-coded spatial mux with preamble CSI: the full stack
    (estimation -> ML detection -> LLRs -> min-sum decode) composes."""
    import dataclasses

    from sdr_tpu.core.config import ChannelEstimator
    from sdr_tpu.link.coded import make_ldpc_fn

    cfg = LinkConfig(
        **{
            **_BASE,
            "channel": dataclasses.replace(_BASE["channel"], ebno_db=10.0),
            "n_channels": 16,
            "n_symbols": 48,  # >= one Z=128 codeword over 64sc QPSK x2
            "estimator": ChannelEstimator.DFT,
        },
        mimo=MIMOConfig(
            MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble", detector="ml"
        ),
    )
    err, cnt = make_ldpc_fn(cfg, rate="1/2", iters=20)(jax.random.PRNGKey(1))
    ber = float(jnp.sum(err)) / float(jnp.sum(cnt))
    assert ber < 5e-3, ber
