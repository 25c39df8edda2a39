"""Demod-chain timer at any numerology (the tuning companion of the
repo-root bench.py, which is pinned to the headline 16QAM/256sc shape).

  SDR_BENCH_NFFT=4096 SDR_BENCH_CP=512 SDR_BENCH_BATCH=4096 \
  SDR_BENCH_SYMS=32 SDR_BENCH_TERMINAL=count python scripts/bench_demod.py

Terminals: ``sum`` (LLR sum), ``count`` (per-channel error counts) and
``llr`` (the LLR plane, written out). Rate: complex samples/s entering
the chain (CP included).
"""

from __future__ import annotations

import os

from _timing import env_int, time_program


def main() -> None:
    import jax
    import jax.numpy as jnp

    from sdr_tpu.core.config import Modulation
    from sdr_tpu.ops.channel import ebno_db_to_noise_var
    from sdr_tpu.ops.demod import demod_chain, demod_count_chain

    n_fft = env_int("SDR_BENCH_NFFT", 4096)
    cp = env_int("SDR_BENCH_CP", 512)
    batch = env_int("SDR_BENCH_BATCH", 64)
    n_syms = env_int("SDR_BENCH_SYMS", 8)
    mod = Modulation(os.environ.get("SDR_BENCH_MOD", "16qam"))
    terminal = os.environ.get("SDR_BENCH_TERMINAL", "sum")
    nv = float(ebno_db_to_noise_var(12.0, mod.bits_per_symbol))
    sym_len = n_fft + cp

    @jax.jit
    def gen(key):
        kr, ki, kh, kx = jax.random.split(key, 4)
        scale = jnp.float32((2.0 * n_fft) ** -0.5)
        re = jax.random.normal(kr, (batch, n_syms, sym_len)) * scale
        im = jax.random.normal(ki, (batch, n_syms, sym_len)) * scale
        hr = jax.random.normal(kh, (batch, 1, n_fft)) * jnp.float32(0.5**0.5)
        hi = jax.random.normal(jax.random.fold_in(kh, 1), (batch, 1, n_fft))
        idx = jax.random.randint(
            kx, (batch, n_syms, n_fft), 0, 1 << mod.bits_per_symbol
        )
        return re, im, hr, hi * jnp.float32(0.5**0.5), idx

    if terminal == "count":
        fn = jax.jit(lambda re, im, hr, hi, idx: demod_count_chain(
            re, im, hr, hi, idx, cp, mod, nv))
    elif terminal == "llr":
        fn = jax.jit(lambda re, im, hr, hi, idx: demod_chain(
            re, im, hr, hi, cp, mod, nv))
    else:
        fn = jax.jit(lambda re, im, hr, hi, idx: demod_chain(
            re, im, hr, hi, cp, mod, nv, reduce_sum=True))
    time_program(
        fn, jax.block_until_ready(gen(jax.random.PRNGKey(0))),
        {"config": f"{mod.value}/{n_fft}sc/cp{cp}", "terminal": terminal,
         "batch": batch, "n_syms": n_syms},
        batch * n_syms * sym_len, "samples_per_s",
    )


if __name__ == "__main__":
    main()
