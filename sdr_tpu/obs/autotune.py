"""FFT backend autotuner — on-device A/B timing.

Measures the "xla" (jnp.fft) vs "matmul" (four-step matmul DFT)
backends across transform sizes and reports the per-size winner and
the crossover. Each timing is the median over ``reps`` calls of one
jitted transform, each ending in ``block_until_ready`` (compile and
warm-up excluded).

CLI: ``python -m sdr_tpu autotune``.
"""

from __future__ import annotations

import dataclasses
import statistics

import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass
class TunePoint:
    n: int
    xla_gelems: float
    matmul_gelems: float

    @property
    def winner(self) -> str:
        return "matmul" if self.matmul_gelems > self.xla_gelems else "xla"


def median_seconds(fn, args, reps: int) -> float:
    """Median wall time of ``fn(*args)`` over ``reps`` calls, each
    waited for with ``block_until_ready``; the first call (compile +
    warm-up) is not timed."""
    from sdr_tpu.obs.device import call_times

    return statistics.median(call_times(fn, args, reps)[2])


def _time_backend(backend: str, n: int, batch_elems: int, reps: int) -> float:
    """Returns Gelem/s for batched FFTs of size n."""
    from sdr_tpu.ops.fft import fft

    b = max(batch_elems // n, 8)
    key = jax.random.PRNGKey(0)
    xr = jax.random.normal(key, (b, n), jnp.float32)
    xi = jax.random.normal(jax.random.fold_in(key, 1), (b, n), jnp.float32)
    run = jax.jit(lambda xr, xi: fft(lax.complex(xr, xi), backend=backend))
    return b * n / median_seconds(run, (xr, xi), reps) / 1e9


def tune_fft(
    sizes=(128, 256, 512, 1024, 2048, 4096, 8192, 16384),
    batch_elems: int = 1 << 22,
    reps: int = 10,
) -> list:
    """A/B each size; returns [TunePoint...]."""
    out = []
    for n in sizes:
        out.append(
            TunePoint(
                n=n,
                xla_gelems=_time_backend("xla", n, batch_elems, reps),
                matmul_gelems=_time_backend("matmul", n, batch_elems, reps),
            )
        )
    return out


def recommend_crossover(points) -> int:
    """Smallest n from which matmul wins for all larger measured sizes
    (1 << 62 when it never does)."""
    cross = 1 << 62
    for p in sorted(points, key=lambda q: -q.n):
        if p.winner == "matmul":
            cross = p.n
        else:
            break
    return cross


def tune_demod(
    n_fft: int = 4096,
    cp_len: int = 512,
    batch: int = 256,
    n_syms: int = 8,
    reps: int = 10,
) -> float:
    """Median rate of the demod chain (``reduce_sum`` terminal) at one
    shape on THIS device, in complex samples/s (CP included)."""
    from sdr_tpu.core.config import Modulation
    from sdr_tpu.ops.channel import ebno_db_to_noise_var
    from sdr_tpu.ops.demod import demod_chain

    mod = Modulation.QAM16
    nv = float(ebno_db_to_noise_var(12.0, mod.bits_per_symbol))
    sym_len = n_fft + cp_len

    @jax.jit
    def gen(key):
        kr, ki, kh = jax.random.split(key, 3)
        scale = jnp.float32(1.0 / (2.0 * n_fft) ** 0.5)
        re = jax.random.normal(kr, (batch, n_syms, sym_len), jnp.float32) * scale
        im = jax.random.normal(ki, (batch, n_syms, sym_len), jnp.float32) * scale
        hr = jax.random.normal(kh, (batch, 1, n_fft), jnp.float32)
        hi = jax.random.normal(jax.random.fold_in(kh, 1), (batch, 1, n_fft), jnp.float32)
        return re, im, hr, hi

    run = jax.jit(
        lambda re, im, hr, hi: demod_chain(
            re, im, hr, hi, cp_len, mod, nv, reduce_sum=True
        )
    )
    sec = median_seconds(run, gen(jax.random.PRNGKey(0)), reps)
    return batch * n_syms * sym_len / sec
