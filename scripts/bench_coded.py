"""Coded-link timer: the batched LDPC fast engine, in information bits/s.

Measures end-to-end CODED Monte-Carlo simulation (info bits → encode →
interleave → TX → channel → demod → deinterleave → min-sum decode →
info-bit errors). Link and decoder: SDR_BENCH_CHANNELS, SDR_BENCH_SYMS,
SDR_BENCH_NFFT/CP/MOD/EBNO, SDR_BENCH_LDPC_ITERS,
SDR_BENCH_LDPC_SCHEDULE (flooding|layered).
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
    from sdr_tpu.link.coded import ldpc_code_for, ldpc_codewords_per_channel
    from sdr_tpu.link.fast_coded import make_ldpc_fast_fn

    cfg = LinkConfig(
        ofdm=OFDMConfig(n_fft=env_int("SDR_BENCH_NFFT", 256),
                        cp_len=env_int("SDR_BENCH_CP", 64)),
        modulation=Modulation(os.environ.get("SDR_BENCH_MOD", "16qam")),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_FLAT,
            ebno_db=float(os.environ.get("SDR_BENCH_EBNO", "6.0")),
        ),
        equalizer=Equalizer.MMSE,
        n_channels=env_int("SDR_BENCH_CHANNELS", 2048),
        n_symbols=env_int("SDR_BENCH_SYMS", 12),
    )
    schedule = os.environ.get("SDR_BENCH_LDPC_SCHEDULE", "flooding")
    ms_iters = env_int("SDR_BENCH_LDPC_ITERS", 25)
    code = ldpc_code_for("1/2")
    n_info = ldpc_codewords_per_channel(cfg, code) * code.k
    time_program(
        make_ldpc_fast_fn(cfg, iters=ms_iters, schedule=schedule),
        (jax.random.PRNGKey(1),),
        {"config": f"{cfg.modulation.value}/{cfg.ofdm.n_fft}sc/"
                   f"cp{cfg.ofdm.cp_len}/rayleigh ldpc-1/2",
         "channels": cfg.n_channels, "n_syms": cfg.n_symbols,
         "schedule": schedule, "minsum_iters": ms_iters},
        cfg.n_channels * n_info, "info_bits_per_s",
    )


if __name__ == "__main__":
    main()
