"""End-to-end link-simulation timer: the fast engine or the MC driver.

Times the full Monte-Carlo SIMULATION (bits → TX → channel → noise →
demod → count), not just the receive chain — the number that governs
how fast BER sweeps converge.

  SDR_BENCH_ENGINE=fast   link.fast, one pass per call
  SDR_BENCH_ENGINE=mc     link.mc, SDR_BENCH_PASSES passes per call

Rate: N-only complex samples/s (n_channels · n_symbols · n_fft per pass,
CP excluded). Sizes and link: SDR_BENCH_NFFT, SDR_BENCH_CP,
SDR_BENCH_CHANNELS, SDR_BENCH_SYMS, SDR_BENCH_EBNO, SDR_BENCH_MOD,
SDR_BENCH_CHANNEL_MODEL (awgn|rayleigh_flat|...), SDR_BENCH_DFT=1
(full-grid SC-FDMA).
"""

from __future__ import annotations

import os

from _timing import env_int, time_program


def main() -> None:
    import jax

    from sdr_tpu.core.config import (
        ChannelConfig,
        ChannelModel,
        Equalizer,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    n_fft = env_int("SDR_BENCH_NFFT", 256)
    model_name = os.environ.get("SDR_BENCH_CHANNEL_MODEL", "awgn")
    engine = os.environ.get("SDR_BENCH_ENGINE", "fast")
    passes = env_int("SDR_BENCH_PASSES", 8) if engine == "mc" else 1
    cfg = LinkConfig(
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=env_int("SDR_BENCH_CP", 64)),
        modulation=Modulation(os.environ.get("SDR_BENCH_MOD", "16qam")),
        channel=ChannelConfig(
            model=ChannelModel(model_name),
            ebno_db=float(os.environ.get("SDR_BENCH_EBNO", "12.0")),
            # Selective models get a 3-tap PDP; time-varying ones a
            # moderate Doppler (both ignored by the flat/AWGN models).
            pdp=(
                (1.0, 0.5, 0.25)
                if model_name in ("multipath", "multipath_time")
                else (1.0,)
            ),
            doppler_norm=0.02,
        ),
        equalizer=Equalizer.MMSE,
        n_channels=env_int("SDR_BENCH_CHANNELS", 512),
        n_symbols=env_int("SDR_BENCH_SYMS", 64),
        dft_spread=bool(env_int("SDR_BENCH_DFT", 0)),
    )
    if engine == "mc":
        from sdr_tpu.link.mc import make_mc_fn

        fn, args = make_mc_fn(cfg, iters=passes), (1,)
    elif engine == "fast":
        from sdr_tpu.link.fast import make_fast_fn

        fn, args = make_fast_fn(cfg), (jax.random.PRNGKey(1),)
    else:
        raise SystemExit(f"unknown SDR_BENCH_ENGINE {engine!r}")
    time_program(
        fn, args,
        {"engine": engine,
         "config": f"{cfg.modulation.value}/{n_fft}sc/"
                   f"cp{cfg.ofdm.cp_len}/{model_name}",
         "channels": cfg.n_channels, "n_syms": cfg.n_symbols,
         "passes": passes},
        cfg.n_channels * cfg.n_symbols * n_fft * passes,
        "samples_per_s_n_only",
    )


if __name__ == "__main__":
    main()
