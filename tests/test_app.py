"""App layer: demo frame loop, CLI, baseline cases, sweep driver."""

import io
import json
import os

import numpy as np
import jax
import pytest

from sdr_tpu.app.baseline_configs import baseline_cases, get_case
from sdr_tpu.app.cli import main
from sdr_tpu.app.demo import DemoConfig, run_demo
from sdr_tpu.core.config import Modulation


def test_demo_identity_loopback_decodes_payload():
    """Identity channel (the reference's demo config) decodes exactly."""
    from sdr_tpu.app.demo import PAYLOAD

    out = io.StringIO()
    text = run_demo(
        DemoConfig(), frames=30, interval_ms=0, render=True, out=out
    )
    # 30 frames x 4 bytes = 120 decoded bytes; the 50-char ring holds the
    # most recent 50, which must be a contiguous slice of the payload.
    assert len(text) == 50
    doubled = (PAYLOAD + PAYLOAD).decode()
    assert text in doubled
    assert "constellation" in out.getvalue()


def test_demo_awgn_runs():
    text = run_demo(
        DemoConfig(ebno_db=20.0), frames=5, interval_ms=0, render=False
    )
    assert len(text) == 50


def test_baseline_cases_cover_the_five_configs():
    cases = baseline_cases()
    assert len(cases) == 5
    assert cases[0].cfg.modulation is Modulation.QPSK
    assert cases[0].cfg.ofdm.n_fft == 64
    assert cases[0].cfg.bits_total >= 1_000_000
    assert cases[1].cfg.ofdm.n_fft == 256 and cases[1].ebno_sweep_db
    assert cases[2].cfg.modulation is Modulation.QAM64
    assert cases[3].cfg.n_channels == 64 and cases[3].sharded
    assert cases[4].cfg.ofdm.n_fft == 4096 and cases[4].cfg.n_channels == 256
    assert get_case("qam64-1024") is not None
    assert get_case("2").name == "qam64-1024"
    with pytest.raises(KeyError):
        get_case("nope")


def test_cli_info(capsys):
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "16qam" in info["modulations"]


def test_cli_bench_list(capsys):
    assert main(["bench", "--list"]) == 0
    assert "qpsk64-awgn" in capsys.readouterr().out


def test_cli_autotune_demod(capsys):
    """autotune --demod times the one demod chain and prints its rate."""
    assert main(["autotune", "--demod", "--demod-nfft", "256",
                 "--demod-cp", "64", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["demod_samples_per_s"] > 0 and out["n_fft"] == 256


def test_cli_info_names_the_demod_route(capsys):
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "XLA" in info["demod"]
    assert "demod_backends" not in info


def test_cli_bench_runs_config0_small(capsys, monkeypatch):
    """Config 0 semantics via CLI (shrunk: the full 1e6-bit run is
    chip_smoke.py's entry-point phase)."""
    import sdr_tpu.app.baseline_configs as bc
    import dataclasses

    orig = bc.baseline_cases

    def small():
        cases = orig()
        c0 = cases[0]
        cases[0] = dataclasses.replace(
            c0, cfg=dataclasses.replace(c0.cfg, n_channels=4, n_symbols=16)
        )
        return cases

    monkeypatch.setattr(bc, "baseline_cases", small)
    assert main(["bench", "--config", "0"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["bits"] == 4 * 16 * 64 * 2
    # 10 dB QPSK: BER ~4e-6; a handful of errors at most in 8k bits.
    assert out["ber"] < 1e-2
    assert "ber_theory_awgn" in out


def test_cli_sweep_with_checkpoint_resume(tmp_path, capsys):
    ck = str(tmp_path / "sweep.json")
    args = [
        "sweep", "--config", "1", "--ebno-grid", "2,4",
        "--target-errors", "50", "--max-bits", "200000",
        "--checkpoint", ck,
    ]
    assert main(args) == 0
    first = json.loads(capsys.readouterr().out)
    assert os.path.exists(ck)
    saved = json.load(open(ck))
    assert len(saved["points"]) == 2

    # Resume: completed points load from the checkpoint (no recompute —
    # results must be identical).
    assert main(args) == 0
    second = json.loads(capsys.readouterr().out)
    assert second["ber"] == first["ber"]
    # Theory overlay is monotone decreasing and bracketed by sim.
    assert first["ber_theory_awgn"][0] > first["ber_theory_awgn"][1]


def test_cli_bench_acquisition_mode(capsys, monkeypatch):
    """bench --cfo/--timing-offset switches the case into blind
    acquisition and still decodes."""
    import sdr_tpu.app.baseline_configs as bc
    import dataclasses

    orig = bc.baseline_cases

    def small():
        cases = orig()
        c0 = cases[0]
        cases[0] = dataclasses.replace(
            c0, cfg=dataclasses.replace(c0.cfg, n_channels=4, n_symbols=16)
        )
        return cases

    monkeypatch.setattr(bc, "baseline_cases", small)
    assert main(["bench", "--config", "0", "--cfo", "1.7",
                 "--timing-offset", "23"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["case"].endswith("+acquire")
    # 10 dB QPSK with pilots after blind sync: still low-BER.
    assert out["ber"] < 2e-2


def test_cli_coded_rate(capsys, monkeypatch):
    import sdr_tpu.app.baseline_configs as bc
    import dataclasses

    orig = bc.baseline_cases

    def small():
        cases = orig()
        c0 = cases[0]
        cases[0] = dataclasses.replace(
            c0, cfg=dataclasses.replace(c0.cfg, n_channels=2, n_symbols=16)
        )
        return cases

    monkeypatch.setattr(bc, "baseline_cases", small)
    assert main(["bench", "--config", "0", "--coded", "--rate", "3/4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "3/4" in out["code"]
    assert out["ber"] < 1e-2  # 10 dB QPSK rate-3/4: clean


def test_cli_sweep_plot(tmp_path, capsys):
    png = str(tmp_path / "curve.png")
    assert main([
        "sweep", "--config", "1", "--ebno-grid", "4",
        "--target-errors", "20", "--max-bits", "100000", "--plot", png,
    ]) == 0
    capsys.readouterr()
    assert os.path.getsize(png) > 5000


def test_cli_packet(capsys):
    """packet sends bytes over an impaired channel blind; verdicts
    consistent and PER low at a comfortable SNR."""
    assert main([
        "packet", "--payload", "24", "--n", "8", "--ebno", "16",
        "--channel", "multipath",
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["crc_verdicts_consistent"]
    assert out["per"] <= 0.25


def test_cli_guards_unsupported_combos(tmp_path, capsys):
    """Forbidden flag combinations exit 2 with a message, not a raw
    traceback; missing replay files are reported, not crashed on."""
    assert main(["bench", "--config", "0", "--cfo", "1.0", "--mimo", "mux"]) == 2
    assert main(["bench", "--config", "0", "--mimo", "mux", "--fast"]) == 2
    assert main(["packet", "--pilots", "0", "--n", "1"]) == 2
    missing = str(tmp_path / "nope.sc16")
    assert main(["packet", "--n", "2", "--replay", missing]) == 2
    capsys.readouterr()


def test_cli_waveform(tmp_path, capsys):
    """waveform reports PAPR/EVM/PSD; EVM matches sqrt(nv) closely and
    the CCDF figure renders."""
    png = str(tmp_path / "ccdf.png")
    assert main([
        "waveform", "--config", "0", "--symbols", "512", "--plot", png,
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    assert 5.0 < out["papr_db"]["p99"] < 13.0
    aided = out["evm_rms_pct"]["data_aided"]
    assert abs(aided - out["evm_theory_pct"]) / out["evm_theory_pct"] < 0.05
    assert out["psd_inband_flatness_db"] < 2.0
    assert os.path.getsize(png) > 5000


def test_demo_snapshot_figure(tmp_path):
    """demo --snapshot renders the reference GUI's views to a figure."""
    from sdr_tpu.app.demo import DemoConfig, run_demo

    png = str(tmp_path / "snap.png")
    run_demo(
        DemoConfig(ebno_db=14.0), frames=5, interval_ms=0, render=False,
        snapshot=png,
    )
    assert os.path.getsize(png) > 10000


def test_cli_bench_fast_path(capsys, monkeypatch):
    import sdr_tpu.app.baseline_configs as bc
    import dataclasses

    orig = bc.baseline_cases

    def small():
        cases = orig()
        c0 = cases[0]
        cases[0] = dataclasses.replace(
            c0, cfg=dataclasses.replace(c0.cfg, n_channels=8, n_symbols=8)
        )
        return cases

    monkeypatch.setattr(bc, "baseline_cases", small)
    assert main(["bench", "--config", "0", "--fast"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["case"].endswith("+fast")
    assert out["ber"] < 1e-2


def test_cli_config_file_round_trip(tmp_path, capsys):
    """bench --config-file: JSON LinkConfig in, results out."""
    from sdr_tpu.core.config import (
        LinkConfig,
        Modulation,
        OFDMConfig,
        link_config_from_dict,
        link_config_to_dict,
    )

    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(128, 32),
        n_symbols=8,
        n_channels=4,
    )
    assert link_config_from_dict(link_config_to_dict(cfg)) == cfg
    from sdr_tpu.core.config import ChannelConfig, ChannelModel, Equalizer

    rician = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(128, 32),
        channel=ChannelConfig(
            model=ChannelModel.RICIAN, ebno_db=9.0, k_factor=7.5
        ),
        equalizer=Equalizer.MMSE,
    )
    assert link_config_from_dict(link_config_to_dict(rician)) == rician
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(link_config_to_dict(cfg)))
    assert main(["bench", "--config-file", str(p)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["bits"] == 4 * 8 * 128 * 4


def test_cli_bench_mc_rejects_unsupported_config(capsys):
    # Acquisition impairments need the pipeline's blind receiver — the
    # MC gate must reject them with a clear error, not crash.
    assert main(["bench", "--config", "0", "--mc", "2", "--cfo", "1.5"]) == 2
    assert "--mc needs" in capsys.readouterr().err


def test_demo_live_speed_control():
    """The reference slider's analog (QFDemoWindow.cpp:119-162): '+'
    and '-' retune the running frame interval within 1-200 ms and 'q'
    stops the loop — driven through the injected-key form."""
    import io

    from sdr_tpu.app.demo import DemoConfig, run_demo

    out = io.StringIO()
    # '-' twice then 'q' on frame 3: the loop must stop early (the
    # text ring stays mostly blank padding).
    text = run_demo(
        DemoConfig(), frames=50, interval_ms=0.0, render=True, out=out,
        keys=["-", "-", "q"],
    )
    assert "interval" in out.getvalue()
    assert len(text) == 50
    rendered = out.getvalue().count("[frame")
    assert rendered == 3  # stopped by 'q', not by the frame budget


def test_demo_interval_clamped():
    import io

    from sdr_tpu.app.demo import DemoConfig, run_demo

    out = io.StringIO()
    run_demo(
        DemoConfig(), frames=6, interval_ms=2.0, render=True, out=out,
        keys=["+", "+", "+", "+", "+"],
    )
    # last rendered interval is clamped at the reference slider's 1 ms
    assert "interval 1 ms" in out.getvalue()
