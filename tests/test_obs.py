"""Observability layer: roofline model, sweep accumulation math."""

import numpy as np
import pytest
import jax

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.obs.roofline import chip_peaks, demod_roofline

H100 = "NVIDIA H100 80GB HBM3"
from sdr_tpu.obs.sweep import ebno_sweep


def test_roofline_xla_traffic_at_256():
    """XLA composition at 256sc/CP64: the 8 B planar read per sample
    plus the stripped symbol and FFT output written and read back
    (4 x 256 x 8 B per 320-sample symbol); memory-bound on the H100."""
    r = demod_roofline(256, 64, Modulation.QAM16, chip_peaks(H100))
    assert abs(r.bytes_per_sample - (8.0 + 4 * 256 * 8 / 320)) < 1e-9
    assert r.bound == "memory"
    assert r.sol_samples_per_s > 1e9


def test_roofline_llr_write_pays_more_traffic():
    peaks = chip_peaks(H100)
    a = demod_roofline(256, 64, Modulation.QAM16, peaks)
    b = demod_roofline(256, 64, Modulation.QAM16, peaks, write_llrs=True)
    assert abs(b.bytes_per_sample - a.bytes_per_sample
               - 256 * 4 * 4 / 320) < 1e-9


def test_roofline_efficiency_fraction():
    r = demod_roofline(
        256, 64, Modulation.QAM16, chip_peaks(H100),
        measured_samples_per_s=5e9,
    )
    assert 0.0 < r.efficiency < 1.0


def test_roofline_peaks_table():
    """The H100 entry carries the data-sheet peaks and their source; a
    device_kind the table does not hold is an error, not a default."""
    p = chip_peaks(H100)
    assert p.hbm_bytes_per_s == 3.35e12 and p.power_limit_w == 700.0
    assert (p.bf16_flops, p.tf32_flops, p.f32_flops) == (989e12, 495e12,
                                                         67e12)
    assert "data sheet" in p.source
    with pytest.raises(KeyError, match="no published peaks"):
        chip_peaks("cpu")
    with pytest.raises(KeyError):
        chip_peaks("NVIDIA A100-SXM4-40GB")


def test_sweep_accumulates_until_target(tmp_path):
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=4.0),
        n_symbols=8,
        n_channels=4,
    )
    res = ebno_sweep(
        cfg, [4.0], jax.random.PRNGKey(0), target_errors=40, max_bits=10**6
    )
    pt = res.points[0]
    assert pt.bit_errors >= 40  # kept drawing batches until target met
    assert pt.bits_counted % cfg.bits_total == 0  # whole batches only
    th = res.theory(Modulation.QPSK)[0]
    assert 0.5 * th < pt.ber < 2.0 * th


def test_sweep_coded_families():
    """Coded sweeps (code=...) count decoded info bits: at a waterfall
    SNR each family's BER lands below uncoded theory, and the config
    summary distinguishes families (checkpoint separation)."""
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(128, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=5.0),
        n_symbols=16,
        n_channels=4,
    )
    summaries = set()
    for fam in ("conv", "polar"):
        res = ebno_sweep(
            cfg, [5.0], jax.random.PRNGKey(1),
            target_errors=1, max_bits=10_000, code=fam,
        )
        summaries.add(res.config_summary)
        th = res.theory(Modulation.QPSK)[0]
        assert res.points[0].ber < th  # coding gain at 5 dB
    assert len(summaries) == 2
    with pytest.raises(ValueError, match="pipeline"):
        ebno_sweep(cfg, [5.0], jax.random.PRNGKey(1), code="conv",
                   engine="fast")


def test_sweep_summary_keys_every_mimo_distinction():
    """Checkpoint matching is by config summary: SISO vs MIMO, antenna
    counts, CSI mode, detector, and pilot settings must all produce
    distinct keys or sweeps would silently reuse each other's points."""
    import dataclasses

    from sdr_tpu.core.config import ChannelEstimator, MIMOConfig, MIMOScheme
    from sdr_tpu.obs.sweep import _cfg_summary

    base = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=4.0),
        n_symbols=8,
        n_channels=4,
    )
    from sdr_tpu.core.config import Equalizer as _Eq

    variants = [
        base,
        dataclasses.replace(base, pilot_spacing=8, equalizer=_Eq.MMSE),
        dataclasses.replace(
            base, pilot_spacing=8, equalizer=_Eq.MMSE,
            estimator=ChannelEstimator.DFT,
        ),
        dataclasses.replace(
            base, equalizer=_Eq.MMSE,
            mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2),
        ),
        dataclasses.replace(
            base, equalizer=_Eq.MMSE,
            mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 4),
        ),
        dataclasses.replace(
            base, equalizer=_Eq.MMSE,
            mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, detector="ml"),
        ),
        dataclasses.replace(
            base, equalizer=_Eq.MMSE,
            mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble"),
        ),
        dataclasses.replace(base, mimo=MIMOConfig(MIMOScheme.ALAMOUTI, 2, 2)),
    ]
    keys = [_cfg_summary(c) for c in variants]
    assert len(set(keys)) == len(keys), keys


def test_sweep_checkpoint_tops_up_on_larger_target(tmp_path):
    """Rerunning with a larger target_errors must accumulate more bits
    onto the checkpointed point, not silently reuse the old one."""
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=4.0),
        n_symbols=8,
        n_channels=4,
    )
    ck = str(tmp_path / "sweep.json")
    r1 = ebno_sweep(
        cfg, [4.0], jax.random.PRNGKey(0), target_errors=20, max_bits=10**6,
        checkpoint_path=ck,
    )
    r2 = ebno_sweep(
        cfg, [4.0], jax.random.PRNGKey(0), target_errors=200, max_bits=10**6,
        checkpoint_path=ck,
    )
    assert r2.points[0].bit_errors >= 200
    assert r2.points[0].bits_counted > r1.points[0].bits_counted
    assert r2.points[0].batches > r1.points[0].batches
    # Same targets again → point is complete, untouched.
    r3 = ebno_sweep(
        cfg, [4.0], jax.random.PRNGKey(0), target_errors=200, max_bits=10**6,
        checkpoint_path=ck,
    )
    assert r3.points[0] == r2.points[0]


def test_weak_scaling_runs_on_virtual_mesh():
    """Weak scaling over the 8-device CPU mesh: functional smoke +
    monotone channel growth (efficiency numbers are meaningless on a
    shared-host CPU 'mesh')."""
    import dataclasses
    from sdr_tpu.obs.scaling import weak_scaling

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
        n_symbols=8,
        n_channels=2,
    )
    pts = weak_scaling(cfg, device_counts=[1, 2], reps=1)
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[0].n_channels == 2 and pts[1].n_channels == 4
    assert all(p.samples_per_s > 0 for p in pts)
    assert pts[0].efficiency == 1.0


def test_metrics_counters_and_jsonl(tmp_path):
    from sdr_tpu.obs.metrics import Metrics

    path = str(tmp_path / "m.jsonl")
    m = Metrics(path=path)
    m.count("frames")
    m.count("frames", 2)
    m.gauge("samples_per_s", 1.3e10)
    rec = m.emit("bench_done", case="qam16-256-llr")
    assert rec["counters"]["frames"] == 3
    assert rec["gauges"]["samples_per_s"] == 1.3e10
    import json as _json

    lines = [_json.loads(l) for l in open(path)]
    assert lines[-1]["event"] == "bench_done"
    assert lines[-1]["case"] == "qam16-256-llr"


def test_median_seconds_waits_for_results():
    """The timing helper runs the program once untimed, then returns
    the median of ``reps`` waited-for calls."""
    import jax.numpy as jnp

    from sdr_tpu.obs.autotune import median_seconds

    calls = []

    def fn(x):
        calls.append(1)
        return jnp.sum(x * x)

    sec = median_seconds(fn, (jnp.ones((64, 64)),), reps=3)
    assert sec > 0 and len(calls) == 4


def test_ber_plot_artifact(tmp_path):
    """The sweep → plot path produces a real image file."""
    from sdr_tpu.obs.plot import plot_sweep
    from sdr_tpu.obs.sweep import SweepPoint, SweepResult

    res = SweepResult(
        points=[
            SweepPoint(0.0, 5000, 100000),
            SweepPoint(4.0, 600, 100000),
            SweepPoint(8.0, 20, 500000),
            SweepPoint(12.0, 0, 500000),  # zero-BER point must not crash log axis
        ],
        config_summary="qpsk/64sc/cp16/awgn/eq=none",
    )
    out = str(tmp_path / "ber.png")
    assert plot_sweep(res, Modulation.QPSK, out) == out
    import os as _os

    assert _os.path.getsize(out) > 5000  # a real PNG, not an empty stub


def test_profiler_trace_captures_real_artifacts(tmp_path):
    """obs.trace must leave an actual Perfetto/XProf trace on disk, not
    just run the context manager."""
    import glob
    import jax.numpy as jnp
    import jax as _jax

    from sdr_tpu.obs.profile import trace
    from sdr_tpu.link.pipeline import make_simulate_fn

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
        n_symbols=4,
        n_channels=2,
    )
    fn = make_simulate_fn(cfg)
    fn(_jax.random.PRNGKey(0))  # compile outside the trace
    d = str(tmp_path / "trace")
    with trace(d, annotate="link-step"):
        r = fn(_jax.random.PRNGKey(1))
        _jax.block_until_ready(r.bit_errors)
    files = glob.glob(d + "/**/*.trace.json.gz", recursive=True) + glob.glob(
        d + "/**/*.xplane.pb", recursive=True
    )
    assert files, f"no trace artifacts under {d}"
    assert sum(__import__('os').path.getsize(f) for f in files) > 1000


def test_tune_demod_reports_backends():
    """tune_demod times the one demod chain at a shape: a positive rate
    in complex samples/s."""
    from sdr_tpu.obs.autotune import tune_demod

    rate = tune_demod(n_fft=1024, cp_len=256, batch=8, n_syms=8, reps=1)
    assert rate > 0


def test_sweep_fast_engine(tmp_path):
    """engine='fast' (the batched link) hits the same statistics and
    keeps its checkpoint namespace separate from the pipeline's."""
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=4.0),
        n_symbols=8,
        n_channels=4,
    )
    ck = str(tmp_path / "ck.json")
    res = ebno_sweep(
        cfg, [4.0], jax.random.PRNGKey(0), target_errors=40,
        max_bits=10**6, engine="fast", checkpoint_path=ck,
    )
    pt = res.points[0]
    th = res.theory(Modulation.QPSK)[0]
    assert 0.5 * th < pt.ber < 2.0 * th
    assert res.config_summary.endswith("/fast")
    # Pilot/impaired configs are rejected up front.
    import dataclasses
    import pytest as _pytest

    from sdr_tpu.core.config import Equalizer

    bad = dataclasses.replace(
        cfg, pilot_spacing=8, equalizer=Equalizer.MMSE
    )
    with _pytest.raises(ValueError, match="full-grid"):
        ebno_sweep(bad, [4.0], jax.random.PRNGKey(0), engine="fast")
