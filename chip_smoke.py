#!/usr/bin/env python3
"""On-GPU smoke check: every engine, at campaign size, against the CPU.

    python chip_smoke.py               # one GPU, all single-card phases
    python chip_smoke.py --four        # the multi-GPU paths (4 cards) only
    python chip_smoke.py --trace DIR   # a traced window of the fast engine

Runs in ONE process. Phases (single card):

1. device       — JAX's platform must be "gpu"; prints versions, the card
                  and its power limit, and the compile cache directory.
2. entry points — ``sdr_tpu.app.cli.main`` in-process for the BASELINE
                  configs and the fast / coded / MC / acquisition modes.
                  Each AWGN case with >= 100 expected errors must land
                  within 3 sigma (binomial) of ``ber_awgn_exact``.
3. demod        — ``ops.demod`` count and reduce_sum terminals at
                  16QAM/256sc/CP64 x 32768 channels x 64 symbols and
                  16QAM/4096sc/CP512 x 4096 channels x 32 symbols.
4. fast engine  — ``link.fast.make_fast_fn`` at 16QAM/256sc/CP64 x 8192
                  channels x 64 symbols under awgn, rayleigh_flat,
                  multipath and multipath_time; SC-FDMA at 256sc and
                  4096sc; and 4096sc x 8192 x 64, a 2^31-sample grid.
5. coded        — ``link.fast_coded.ldpc_fast_simulate`` (n=3072 r=1/2,
                  flooding x25 and layered x13, 4096 channels x 64
                  symbols) and ``link.coded.make_polar_fn`` (CA-SCL-8
                  (256,128), 8192 codewords).
6. pipeline     — ``link.pipeline.make_simulate_fn`` on config 2's
                  numerology with 4x4 spatial-mux ML detection + preamble
                  CSI (QPSK: the ML candidate budget), and on config 0
                  with blind acquisition.

The reference for phases 3-6: every draw is keyed by fold_in(key, global
channel id), so the same function run on the host CPU over the first
``REF_CHANNELS`` channels recomputes exactly the channels the card
computed; it runs under ``jax.default_matmul_precision("highest")``.
Tolerances, and why:

- LLRs agree to ``LLR_TOL`` x max|LLR_ref|: float32 transforms and sums
  taken in another order (cuFFT vs the CPU FFT) move LLRs by a few ulp
  of their largest values. A control with the receiver's matrix
  products at TF32 must exceed this bound (4x4 MIMO case).
- The blind-acquisition receiver gets ``ACQ_LLR_TOL``. Its timing
  metric is a float32 prefix sum over the whole frame, and the CFO
  estimate taken from it rotates every later sample. The phase measures
  the witness on the CPU: the same receiver with that prefix sum taken
  in tree order instead of sequentially. It must lie above ``LLR_TOL``
  and under ``ACQ_LLR_TOL``, which is twice the witness measured on
  config 0 (2.56e-4 x max|LLR|). That receiver has no matrix product,
  so no TF32 control applies to it.
- Per channel, uncoded error counts may differ only by the number of
  bits whose reference |LLR| is under that same bound (a hard decision
  can only flip where the LLR is that close to zero); otherwise they are
  identical.
- Coded engines (LDPC, polar) run in the waterfall (``LDPC_EBNO``,
  ``POLAR_EBNO``), and the reference channels must hold at least
  ``MIN_CODED_ERRORS`` info-bit errors. Their decoder inputs get the
  checks above: the same payload bits, LLRs within ``LLR_TOL``,
  hard-decision error counts within the marginal decisions. Each
  decoder then decodes the CPU's LLRs on both sides. A decoder iterates
  on its LLRs, so a last-bit difference can change a codeword that is
  still undecided: for the decoder alone and for the whole link, at
  least ``CODED_AGREE`` of the reference channels must match exactly,
  and the totals within ``CODED_TOTAL_TOL``.
- Multi-card paths (``--four``) are expected bit-exact; where they are
  not, the counts must differ only on ``FOUR_DIFF_SHARE`` of channels.

Every line before the last starts with the card's ``name, power.limit``
as nvidia-smi reports it. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import statistics
import sys
import time
import traceback

import numpy as np

REF_CHANNELS = 128
# Campaign sizes: (n_fft, cp, channels, symbols).
DEMOD_SHAPES = ((256, 64, 32768, 64), (4096, 512, 4096, 32))
FAST_SHAPE = (256, 64, 8192, 64)
SCFDMA_WIDE_SHAPE = (4096, 512, 1024, 32)
# 2^31 subcarrier samples per transform batch: where XLA's own inverse
# FFT went wrong on the H100 (ops.fft.xla_ifft).
HUGE_SHAPE = (4096, 512, 8192, 64)
LDPC_SHAPE = (256, 64, 4096, 64)
POLAR_SHAPE = (256, 64, 256, 16)     # QPSK: 32 codewords per channel
# Eb/N0 per coded bit (the engines' convention), in the waterfall: on the
# CPU over the 128 reference channels, LDPC r=1/2 16QAM has 553
# (flooding x25) and 589 (layered x13) info-bit errors, polar CA-SCL-8
# QPSK 5999.
LDPC_EBNO = 2.0
POLAR_EBNO = -1.5
MIN_CODED_ERRORS = 100
PIPE_CHANNELS = 2 * REF_CHANNELS
FOUR_CHANNELS_PER_CARD = 8192
LLR_TOL = 1e-4
ACQ_LLR_TOL = 5e-4
CODED_AGREE = 0.97
CODED_TOTAL_TOL = 0.05
FOUR_DIFF_SHARE = 1e-3
# A stage whose least bytes would take longer at the HBM peak than its
# measured device time ran inside fusions charged to other stages.
ROOFLINE_SHARE_MAX = 1.05
REPS = 5

_CARD = ""


def log(msg: str) -> None:
    print(f"[{_CARD}] {msg}", flush=True)


class PhaseFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailure(what)


# ---------------------------------------------------------------------------
# Timing and memory
# ---------------------------------------------------------------------------


def peak_gb() -> float:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def timed(name: str, fn, args, reps: int | None = None):
    """Compile ``fn`` for ``args``, run it once, then ``reps`` times,
    each ending in block_until_ready; logs compile seconds, the median
    step time and the process's device-memory peak. Returns the output."""
    import jax

    from sdr_tpu.obs.device import call_times

    reps = REPS if reps is None else reps
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out, _, times = call_times(compiled, args, reps)
    log(
        f"  {name}: compile {compile_s:.2f} s, median step "
        f"{statistics.median(times) * 1e3:.3f} ms over {reps} reps, "
        f"peak_bytes_in_use {peak_gb():.2f} GB"
    )
    return out


@contextlib.contextmanager
def on_cpu():
    """Run the enclosed reference on the host CPU at full f32 precision.

    Its compiles are kept out of the persistent compile cache: a cached
    CPU executable is tuned to the host that built it, and the next run
    may land on a host with other CPU features."""
    import jax

    cpu = jax.devices("cpu")[0]
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            yield cpu
    finally:
        jax.config.update(key, prev)


def to_cpu(x):
    import jax

    return jax.device_put(np.asarray(x), jax.devices("cpu")[0])


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def llr_gap(name: str, llr_gpu, llr_ref) -> tuple[float, float]:
    """(max|LLR_gpu - LLR_ref|, max|LLR_ref|) of two finite LLR sets of
    one shape."""
    a = np.asarray(llr_gpu, np.float64)
    b = np.asarray(llr_ref, np.float64)
    check(a.shape == b.shape, f"{name}: LLR shapes {a.shape} vs {b.shape}")
    check(bool(np.all(np.isfinite(a))), f"{name}: non-finite LLRs")
    return float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))


def compare_llrs(name: str, llr_gpu, llr_ref, tol: float = LLR_TOL) -> float:
    """Assert |LLR_gpu - LLR_ref| <= tol * max|LLR_ref|; returns the
    bound."""
    err, scale = llr_gap(name, llr_gpu, llr_ref)
    bound = tol * scale
    log(f"  {name}: max|dLLR| {err:.3e} <= {bound:.3e}")
    check(err <= bound, f"{name}: LLRs differ by {err:.3e} > {bound:.3e}")
    return bound


def marginal_bits(llr_ref, axes, tol: float = LLR_TOL) -> np.ndarray:
    """Per-channel count of reference LLRs under the decision bound."""
    b = np.abs(np.asarray(llr_ref, np.float64))
    return np.sum(b < tol * b.max(), axis=axes)


def compare_counts(name: str, gpu, ref, marginal) -> None:
    """Per channel |gpu - ref| <= marginal decisions of the reference."""
    gpu = np.asarray(gpu, np.int64)
    ref = np.asarray(ref, np.int64)
    d = np.abs(gpu - ref)
    log(
        f"  {name}: errors gpu {int(gpu.sum())} / cpu {int(ref.sum())} "
        f"over {gpu.size} channels, {int((d > 0).sum())} differ "
        f"(allowed: <= marginal decisions, total {int(np.sum(marginal))})"
    )
    check(bool(np.all(d <= marginal)), f"{name}: counts differ beyond the "
          "marginal decisions")


def compare_coded(name: str, gpu, ref) -> None:
    gpu = np.asarray(gpu, np.int64)
    ref = np.asarray(ref, np.int64)
    agree = float(np.mean(gpu == ref))
    tg, tr = int(gpu.sum()), int(ref.sum())
    log(
        f"  {name}: info-bit errors gpu {tg} / cpu {tr}, channels "
        f"agreeing {agree:.3f} (need >= {CODED_AGREE})"
    )
    check(agree >= CODED_AGREE, f"{name}: only {agree:.3f} channels agree")
    check(abs(tg - tr) <= CODED_TOTAL_TOL * max(tr, 1) + 1,
          f"{name}: totals {tg} vs {tr}")


def check_awgn(name: str, errors: int, bits: int, mod, ebno_db: float):
    from sdr_tpu.link.ber import ber_awgn_exact

    p = ber_awgn_exact(mod, ebno_db)
    mean = bits * p
    if mean < 100:
        log(f"  {name}: {errors} errors, {mean:.1f} expected (< 100: no "
            "theory check)")
        return
    sigma = math.sqrt(bits * p * (1 - p))
    z = (errors - mean) / sigma
    log(f"  {name}: {errors} errors vs {mean:.1f} expected "
        f"(ber_awgn_exact), z = {z:+.2f}")
    check(abs(z) <= 3.0, f"{name}: BER off theory by {z:+.2f} sigma")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def _link_cfg(model: str, shape=None, ebno=12.0, mod="16qam",
              dft_spread=False):
    from sdr_tpu.core.config import (
        ChannelConfig,
        ChannelModel,
        Equalizer,
        LinkConfig,
        Modulation,
        OFDMConfig,
    )

    n_fft, cp, channels, symbols = shape or FAST_SHAPE
    return LinkConfig(
        modulation=Modulation(mod),
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
        channel=ChannelConfig(
            model=ChannelModel(model),
            ebno_db=ebno,
            pdp=(1.0, 0.5, 0.25, 0.125)
            if model in ("multipath", "multipath_time") else (1.0,),
            doppler_norm=0.02,
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=symbols,
        n_channels=channels,
        dft_spread=dft_spread,
    )


def phase_entry_points():
    """The CLI, in-process: one invocation each (compile included)."""
    from sdr_tpu.app.baseline_configs import get_case
    from sdr_tpu.app.cli import main as cli

    runs = [[ "bench", "--config", str(i)] for i in range(5)] + [
        ["bench", "--config", "3", "--fast"],
        ["bench", "--config", "1", "--coded", "--code", "ldpc"],
        ["bench", "--config", "1", "--coded", "--code", "polar",
         "--polar-list", "8"],
        ["bench", "--config", "1", "--mc", "4"],
        ["bench", "--config", "0", "--cfo", "2.3", "--timing-offset", "37"],
    ]
    for argv in runs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        wall = time.perf_counter() - t0
        name = " ".join(argv)
        check(rc == 0, f"{name}: exit {rc}")
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        bits = int(out.get("bits", out.get("info_bits", 0)))
        errors = int(out["bit_errors"])
        check(bits > 0 and 0 <= errors <= bits, f"{name}: counts {out}")
        log(f"  {name}: {errors}/{bits} errors, {wall:.2f} s for the one "
            f"call (compile included), peak_bytes_in_use {peak_gb():.2f} GB")
        case = get_case(argv[2])
        awgn = case.cfg.channel.model.value == "awgn"
        plain = len(argv) == 3 or "--mc" in argv
        if awgn and plain:
            check_awgn(name, errors, bits, case.cfg.modulation,
                       case.cfg.channel.ebno_db)


def _demod_inputs(n_fft, cp, batch, symbols, mod, nv):
    """A flat-Rayleigh 16QAM OFDM campaign: TX indices, faded + noisy
    planar samples and the per-link channel plane, all on the device."""
    import jax
    import jax.numpy as jnp

    from sdr_tpu.link.fast import _tx

    cfg = _link_cfg("awgn", (n_fft, cp, batch, symbols), mod=mod.value)

    @jax.jit
    def gen(key):
        ki, kh, kn = jax.random.split(key, 3)
        idx = jax.random.randint(
            ki, (batch, symbols, n_fft), 0, 1 << mod.bits_per_symbol
        )
        re, im = _tx(cfg, idx)
        h = jax.lax.complex(*jax.random.normal(kh, (2, batch, 1, 1))) * (
            jnp.float32(0.5**0.5)
        )
        nz = jax.random.normal(kn, (2,) + re.shape) * jnp.float32(
            (nv / n_fft / 2) ** 0.5
        )
        y = h * jax.lax.complex(re, im) + jax.lax.complex(nz[0], nz[1])
        hb = jnp.broadcast_to(h, (batch, 1, n_fft))
        return jnp.real(y), jnp.imag(y), jnp.real(hb), jnp.imag(hb), idx

    return gen(jax.random.PRNGKey(3))


def phase_demod():
    import jax

    from sdr_tpu.core.config import Modulation
    from sdr_tpu.ops.channel import ebno_db_to_noise_var
    from sdr_tpu.ops.demod import demod_chain, demod_count_chain

    mod = Modulation.QAM16
    nv = float(ebno_db_to_noise_var(12.0, mod.bits_per_symbol))
    for n_fft, cp, batch, symbols in DEMOD_SHAPES:
        tag = f"demod {n_fft}sc/cp{cp} {batch}x{symbols}"
        args = _demod_inputs(n_fft, cp, batch, symbols, mod, nv)
        count = jax.jit(lambda re, im, hr, hi, idx: demod_count_chain(
            re, im, hr, hi, idx, cp, mod, nv))
        total = jax.jit(lambda re, im, hr, hi: demod_chain(
            re, im, hr, hi, cp, mod, nv, reduce_sum=True))
        llr = jax.jit(lambda re, im, hr, hi: demod_chain(
            re, im, hr, hi, cp, mod, nv))
        counts = timed(f"{tag} count", count, args)
        s = timed(f"{tag} reduce_sum", total, args[:4])
        check(bool(np.isfinite(float(s))), f"{tag}: LLR sum {float(s)}")
        sl = tuple(a[:REF_CHANNELS] for a in args)
        llr_gpu = np.asarray(llr(*sl[:4]))
        sum_gpu = float(total(*sl[:4]))
        with on_cpu():
            ref = tuple(to_cpu(a) for a in sl)
            llr_ref = np.asarray(llr(*ref[:4]))
            count_ref = np.asarray(count(*ref))
        bound = compare_llrs(f"{tag} LLRs", llr_gpu, llr_ref)
        compare_counts(f"{tag} counts", np.asarray(counts)[:REF_CHANNELS],
                       count_ref, marginal_bits(llr_ref, (1, 2)))
        sum_ref = float(np.sum(llr_ref, dtype=np.float64))
        sum_bound = bound * llr_ref.size
        log(f"  {tag} LLR sum: gpu {sum_gpu:.6e} cpu {sum_ref:.6e}")
        check(abs(sum_gpu - sum_ref) <= sum_bound, f"{tag}: LLR sums")


def _fast_reference(cfg, key, ids):
    """CPU reference for the fast engine over channel ids: per-channel
    error counts, and the receiver's LLRs for the decision bound."""
    import jax.numpy as jnp

    from sdr_tpu.link.fast import (
        _fade_state, _role_keys, fast_core, tx_channel_core,
    )
    from sdr_tpu.ops.demod import demod_chain

    errs, _ = fast_core(cfg, key, ids)
    re, im = tx_channel_core(cfg, key, ids)
    h, _ = _fade_state(cfg, _role_keys(key, ids)[2])
    n = cfg.ofdm.n_fft
    hb = (jnp.ones((len(ids), 1, n), jnp.complex64) if h is None
          else jnp.broadcast_to(h, (len(ids), h.shape[1], n)))
    bps = cfg.modulation.bits_per_symbol
    nv = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * bps)
    llr = demod_chain(re, im, jnp.real(hb), jnp.imag(hb), cfg.ofdm.cp_len,
                      cfg.modulation, max(nv, 1e-12), despread=cfg.dft_spread)
    return errs, llr


def _check_fast(tag, cfg, errs_gpu, key_seed):
    import functools

    import jax
    import jax.numpy as jnp

    with on_cpu():
        ref_errs, llr = jax.jit(functools.partial(_fast_reference, cfg))(
            jax.random.PRNGKey(key_seed),
            jnp.arange(REF_CHANNELS, dtype=jnp.int32),
        )
        ref_errs, llr = np.asarray(ref_errs), np.asarray(llr)
    compare_counts(tag, np.asarray(errs_gpu)[:REF_CHANNELS], ref_errs,
                   marginal_bits(llr, (1, 2)))


def phase_fast():
    import jax

    from sdr_tpu.link.fast import make_fast_fn

    cases = [(m, _link_cfg(m)) for m in
             ("awgn", "rayleigh_flat", "multipath", "multipath_time")]
    cases += [
        ("scfdma 256sc awgn", _link_cfg("awgn", dft_spread=True)),
        ("scfdma 4096sc rayleigh_flat",
         _link_cfg("rayleigh_flat", SCFDMA_WIDE_SHAPE, dft_spread=True)),
        ("rayleigh_flat 2^31 grid", _link_cfg("rayleigh_flat", HUGE_SHAPE)),
    ]
    for name, cfg in cases:
        tag = (f"fast {name} {cfg.ofdm.n_fft}sc {cfg.n_channels}x"
               f"{cfg.n_symbols}")
        errs, counted = timed(tag, make_fast_fn(cfg),
                              (jax.random.PRNGKey(5),))
        # int64 on the host: a 2^31-sample grid overflows int32 sums.
        e = int(np.asarray(errs, np.int64).sum())
        b = int(np.asarray(counted, np.int64).sum())
        check(b == cfg.n_channels * cfg.n_symbols * cfg.ofdm.n_fft
              * cfg.modulation.bits_per_symbol, f"{tag}: bits {b}")
        if cfg.channel.model.value == "awgn":
            check_awgn(tag, e, b, cfg.modulation, cfg.channel.ebno_db)
        _check_fast(tag, cfg, errs, 5)


def _check_coded(tag, errs_gpu, front, encode, decode):
    """The coded checks over the first ``REF_CHANNELS`` channels.

    ``front(key, ch_ids)`` → (payload bits (B, n_cw, k), decoder input
    LLRs, B rows first); ``encode`` maps payload bits to codeword bits
    in LLR order; ``decode`` maps LLRs to decided payload bits (B, n_cw,
    k). ``errs_gpu``: the card's per-channel info-bit errors of the
    whole-size run.
    """
    import jax
    import jax.numpy as jnp

    def per_channel(x):
        return np.asarray(x).reshape(REF_CHANNELS, -1)

    ids = np.arange(REF_CHANNELS, dtype=np.int32)
    payload, llr = jax.jit(front)(ids)
    payload, llr = np.asarray(payload), np.asarray(llr)
    with on_cpu():
        payload_ref, llr_ref = jax.jit(front)(to_cpu(ids))
        cw_ref = np.asarray(jax.jit(encode)(payload_ref))
        dec_cpu = np.asarray(jax.jit(decode)(llr_ref))
        payload_ref, llr_ref = np.asarray(payload_ref), np.asarray(llr_ref)
    dec_gpu = np.asarray(jax.jit(decode)(jnp.asarray(llr_ref)))

    check(np.array_equal(payload, payload_ref), f"{tag}: payload bits differ")
    g, r, cw = per_channel(llr), per_channel(llr_ref), per_channel(cw_ref)
    compare_llrs(f"{tag} decoder-input LLRs", g, r)
    compare_counts(f"{tag} uncoded hard decisions",
                   np.sum((g < 0) != cw, axis=1), np.sum((r < 0) != cw, axis=1),
                   marginal_bits(r, (1,)))

    def info_errors(dec):
        return np.sum(per_channel(dec) != per_channel(payload_ref), axis=1)

    ref = info_errors(dec_cpu)
    compare_coded(f"{tag} decoder alone, on the CPU's LLRs",
                  info_errors(dec_gpu), ref)
    compare_coded(f"{tag} whole link", np.asarray(errs_gpu)[:REF_CHANNELS],
                  ref)
    check(int(ref.sum()) >= MIN_CODED_ERRORS,
          f"{tag}: {int(ref.sum())} reference info-bit errors, fewer than "
          f"{MIN_CODED_ERRORS}: not in the waterfall")


def phase_coded():
    import functools

    import jax

    from sdr_tpu.link.coded import (
        ldpc_code_for,
        make_polar_fn,
        polar_code_for,
        polar_codewords_per_channel,
        polar_decode,
        polar_llrs,
    )
    from sdr_tpu.link.fast_coded import ldpc_fast_llrs, make_ldpc_fast_fn
    from sdr_tpu.ops.ldpc import ldpc_decode, ldpc_encode
    from sdr_tpu.ops.polar import polar_encode_payload

    cfg = _link_cfg("awgn", LDPC_SHAPE, ebno=LDPC_EBNO)
    code = ldpc_code_for("1/2")
    for schedule, iters in (("flooding", 25), ("layered", 13)):
        tag = (f"ldpc n=3072 r=1/2 {schedule} x{iters} Eb/N0 {LDPC_EBNO} dB "
               f"{cfg.n_channels}x{cfg.n_symbols}")
        fn = make_ldpc_fast_fn(cfg, iters=iters, schedule=schedule)
        errs, counted = timed(tag, fn, (jax.random.PRNGKey(7),))
        check(int(np.asarray(counted, np.int64).sum()) > 0,
              f"{tag}: no info bits")

        def ldpc_dec(llr, iters=iters, schedule=schedule):
            dec = ldpc_decode(code, llr, iters=iters, schedule=schedule)
            return dec[:, : code.k].reshape(REF_CHANNELS, -1, code.k)

        _check_coded(
            tag, errs,
            lambda ids: ldpc_fast_llrs(cfg, jax.random.PRNGKey(7), "1/2",
                                       ids),
            functools.partial(ldpc_encode, code),
            ldpc_dec,
        )

    pcfg = _link_cfg("awgn", POLAR_SHAPE, ebno=POLAR_EBNO, mod="qpsk")
    pcode = polar_code_for("1/2", 256)
    per = polar_codewords_per_channel(pcfg, pcode.block_len)
    tag = (f"polar CA-SCL-8 (256,128) Eb/N0 {POLAR_EBNO} dB "
           f"{pcfg.n_channels * per} codewords")
    errs, counted = timed(tag, make_polar_fn(pcfg, list_size=8),
                          (jax.random.PRNGKey(9),))
    check(int(np.asarray(counted, np.int64).sum()) > 0,
          f"{tag}: no payload bits")

    def polar_front(ids):
        k = jax.random.PRNGKey(9)
        keys = jax.vmap(lambda c: jax.random.fold_in(k, c))(ids)
        return jax.vmap(lambda kc: polar_llrs(pcfg, kc, pcode, per))(keys)

    _check_coded(
        tag, errs, polar_front,
        lambda p: polar_encode_payload(p, pcode),
        lambda llr: polar_decode(llr, pcode, 8),
    )


@contextlib.contextmanager
def tree_order_prefix_sums():
    """Trace ``ops.sync`` with its prefix sums taken as a tree-order
    associative scan instead of a sequential cumsum: the same receiver,
    with its float32 sums in another order."""
    import types

    import jax
    import jax.numpy as jnp

    from sdr_tpu.ops import sync

    def tree_cumsum(x, axis=-1):
        return jax.lax.associative_scan(jnp.add, x, axis=axis)

    jax.clear_caches()
    sync.jnp = types.SimpleNamespace(**{**vars(jnp), "cumsum": tree_cumsum})
    try:
        yield
    finally:
        sync.jnp = jnp
        jax.clear_caches()


@contextlib.contextmanager
def tf32_matmuls():
    """Trace the receiver with its pinned f32 matrix products lifted to
    TF32: the precision regression the LLR bound must catch."""
    import jax

    from sdr_tpu.link import pipeline
    from sdr_tpu.ops import mimo, pilots

    mods = (pipeline, mimo, pilots)
    pinned = [m._HI for m in mods]
    jax.clear_caches()
    for m in mods:
        m._HI = None
    try:
        with jax.default_matmul_precision("tensorfloat32"):
            yield
    finally:
        for m, p in zip(mods, pinned):
            m._HI = p
        jax.clear_caches()


ACQ_TAG = "pipeline config 0 blind acquisition"


def phase_pipeline():
    import jax

    from sdr_tpu.app.baseline_configs import get_case
    from sdr_tpu.core.config import (
        ChannelModel, Equalizer, MIMOConfig, MIMOScheme, Modulation,
    )
    from sdr_tpu.link.pipeline import make_simulate_fn

    # As `bench --config 2 --mimo mux --ntx 4 --nrx 4 --csi preamble
    # --detector ml` and `bench --config 0 --cfo 2.3 --timing-offset 37`
    # build them, with PIPE_CHANNELS channels. Joint ML over 4 streams
    # enumerates M**4 candidates, and the detector's budget (4096)
    # admits QPSK only, so config 2's numerology carries QPSK here.
    c2 = get_case("2").cfg
    mimo = dataclasses.replace(
        c2, n_channels=PIPE_CHANNELS, modulation=Modulation.QPSK,
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 4, 4, csi="preamble",
                        detector="ml"),
        channel=dataclasses.replace(c2.channel,
                                    model=ChannelModel.RAYLEIGH_FLAT),
        equalizer=Equalizer.MMSE,
    )
    c0 = get_case("0").cfg
    acq = dataclasses.replace(
        c0, n_channels=PIPE_CHANNELS, pilot_spacing=8,
        equalizer=Equalizer.MMSE,
        channel=dataclasses.replace(c0.channel, cfo_subcarriers=2.3,
                                    timing_offset=37),
    )
    key = jax.random.PRNGKey(11)
    for tag, cfg, tol in (
        ("pipeline config 2 4x4 mux ML + preamble CSI", mimo, LLR_TOL),
        (ACQ_TAG, acq, ACQ_LLR_TOL),
    ):
        res = timed(tag, make_simulate_fn(cfg, want_llrs=True), (key,))
        ref_cfg = dataclasses.replace(cfg, n_channels=REF_CHANNELS)
        with on_cpu():
            ref = make_simulate_fn(ref_cfg, want_llrs=True)(to_cpu(key))
        llr_ref = np.asarray(ref.llrs)
        compare_llrs(f"{tag} LLRs", np.asarray(res.llrs)[:REF_CHANNELS],
                     llr_ref, tol)
        compare_counts(f"{tag} counts",
                       np.asarray(res.bit_errors)[:REF_CHANNELS],
                       np.asarray(ref.bit_errors),
                       marginal_bits(llr_ref, tuple(range(1, llr_ref.ndim)),
                                     tol))
        n_dots = str(jax.make_jaxpr(make_simulate_fn(ref_cfg))(key)).count(
            "dot_general")
        if n_dots:
            with tf32_matmuls():
                ctl = make_simulate_fn(ref_cfg, want_llrs=True)(key)
            err, scale = llr_gap(tag, ctl.llrs, llr_ref)
            log(f"  {tag} TF32 control ({n_dots} matrix products): "
                f"max|dLLR| {err:.3e} = {err / scale:.2e} x max, must "
                f"exceed {tol:.0e} x max")
            check(err > tol * scale, f"{tag}: the LLR bound does not see "
                  "TF32 matrix products")
        else:
            log(f"  {tag}: no matrix product, so no TF32 control")
        if tag == ACQ_TAG:  # the witness for ACQ_LLR_TOL
            with on_cpu(), tree_order_prefix_sums():
                wit = make_simulate_fn(ref_cfg, want_llrs=True)(to_cpu(key))
            err, scale = llr_gap(tag, wit.llrs, llr_ref)
            log(f"  {tag} witness, CPU with tree-order prefix sums vs "
                f"sequential: max|dLLR| {err:.3e} = {err / scale:.2e} x "
                f"max (bound {LLR_TOL:.0e} < witness <= {tol:.0e})")
            check(LLR_TOL * scale < err <= tol * scale,
                  f"{tag}: witness {err / scale:.2e} x max outside "
                  f"({LLR_TOL:.0e}, {tol:.0e}]")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def compare_four(name: str, sharded, single, cpu_cfg=None, seed=None):
    """Sharded vs one-card counts; on a mismatch, when the engine is the
    fast engine (``cpu_cfg``), say which side matches the CPU."""
    a = np.asarray(sharded, np.int64)
    b = np.asarray(single, np.int64)
    check(a.shape == b.shape, f"{name}: shapes {a.shape} vs {b.shape}")
    diff = int(np.sum(a != b))
    if diff == 0:
        log(f"  {name}: bit-exact over {a.size} channels "
            f"({int(a.sum())} errors)")
        return
    share = diff / a.size
    log(f"  {name}: NOT bit-exact, {diff}/{a.size} channels differ "
        f"(max |d| {int(np.max(np.abs(a - b)))}; allowed share "
        f"{FOUR_DIFF_SHARE})")
    if cpu_cfg is not None:
        import functools

        import jax
        import jax.numpy as jnp

        with on_cpu():
            ref, _ = jax.jit(functools.partial(_fast_reference, cpu_cfg))(
                jax.random.PRNGKey(seed),
                jnp.arange(REF_CHANNELS, dtype=jnp.int32),
            )
        ref = np.asarray(ref)
        log(f"    first {REF_CHANNELS} channels equal to the CPU: "
            f"sharded {int(np.sum(a[:REF_CHANNELS] == ref))}, one card "
            f"{int(np.sum(b[:REF_CHANNELS] == ref))}")
    check(share <= FOUR_DIFF_SHARE, f"{name}: {share:.2e} channels differ")


def phase_four():
    import jax
    import jax.numpy as jnp

    from sdr_tpu.app.baseline_configs import get_case
    from sdr_tpu.core.config import Modulation
    from sdr_tpu.link.fast import make_fast_fn
    from sdr_tpu.link.fast_coded import make_ldpc_fast_fn
    from sdr_tpu.link.stream import stream_simulate
    from sdr_tpu.ops.demod import demod_chain
    from sdr_tpu.parallel import (
        make_link_mesh,
        make_pipelined_fast_fn,
        make_sharded_coded_fast_fn,
        make_sharded_fast_fn,
        make_sharded_stream_fn,
        make_tp_demod_fn,
    )

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    seed = 13
    key = jax.random.PRNGKey(seed)

    n_fft, cp, _, symbols = FAST_SHAPE
    per = FOUR_CHANNELS_PER_CARD
    cfg = _link_cfg("multipath", (n_fft, cp, 4 * per, symbols))
    tag = f"sharded fast 4 x {per} channels"
    sharded = timed(tag, make_sharded_fast_fn(cfg, make_link_mesh(1, 4)),
                    (key,))[0]
    single = timed(f"{tag} (unsharded, one card)", make_fast_fn(cfg),
                   (key,))[0]
    compare_four(tag, sharded, single, cfg, seed)

    c5 = get_case("4").cfg
    tag = "sharded stream config 4 (4096sc/CP512) on 2x2"
    sharded = timed(tag, make_sharded_stream_fn(c5, make_link_mesh(2, 2),
                                                n_blocks=2), (key,))[0]
    single = timed(f"{tag} (stream_simulate, one card)",
                   jax.jit(lambda k: stream_simulate(c5, k, n_blocks=2)),
                   (key,))[0]
    compare_four(tag, sharded, single)

    tp_n, tp_cp, mod = 4096, 512, Modulation.QAM16
    kr, ki, kh1, kh2 = jax.random.split(key, 4)
    b, s = 256, 16
    scale = jnp.float32((2 * tp_n) ** -0.5)
    x = (jax.random.normal(kr, (b, s, tp_n + tp_cp)) * scale,
         jax.random.normal(ki, (b, s, tp_n + tp_cp)) * scale,
         jax.random.normal(kh1, (b, 1, tp_n)),
         jax.random.normal(kh2, (b, 1, tp_n)))
    tag = "TP demod 4-way at 4096sc"
    tp = make_tp_demod_fn(tp_n, tp_cp, mod, make_link_mesh(4, 1))
    llr_tp = timed(tag, lambda re, im, hr, hi: tp(re, im, hr, hi, 0.05), x)
    llr_1 = timed(f"{tag} (demod_chain, one card)",
                  lambda re, im, hr, hi: demod_chain(
                      re, im, hr, hi, tp_cp, mod, 0.05), x)
    compare_llrs(tag, llr_tp, llr_1)

    pcfg = _link_cfg("rayleigh_flat", (n_fft, cp, per, symbols))
    tag = "pipelined fast on 2x2"
    piped = timed(tag, make_pipelined_fast_fn(pcfg, make_link_mesh(2, 2)),
                  (key,))[0]
    single = timed(f"{tag} (fast_simulate, one card)", make_fast_fn(pcfg),
                   (key,))[0]
    compare_four(tag, piped, single, pcfg, seed)

    ccfg = _link_cfg("awgn", (n_fft, cp, per // 2, symbols), ebno=LDPC_EBNO)
    tag = (f"sharded coded fast 4 x {per // 8} channels, Eb/N0 "
           f"{LDPC_EBNO} dB")
    sharded = timed(tag, make_sharded_coded_fast_fn(
        ccfg, make_link_mesh(1, 4)), (key,))[0]
    single = timed(f"{tag} (ldpc_fast_simulate, one card)",
                   make_ldpc_fast_fn(ccfg), (key,))[0]
    compare_four(tag, sharded, single)
    per_card = np.asarray(single, np.int64).reshape(4, -1).sum(axis=1)
    log(f"  {tag}: info-bit errors per card's share {per_card.tolist()}")
    check(int(per_card.min()) >= MIN_CODED_ERRORS,
          f"{tag}: a card's share has fewer than {MIN_CODED_ERRORS} "
          "errors: not in the waterfall")


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------


def _stage_bytes(cfg, kind: str) -> dict:
    """The least bytes each stage must move: its inputs read once and
    its outputs written once (intermediates kept on chip)."""
    b, s = cfg.n_channels, cfg.n_symbols
    n, sym = cfg.ofdm.n_fft, cfg.ofdm.symbol_len
    grid, samples = b * s * n, b * s * sym
    if kind == "coded":
        bps = cfg.modulation.bits_per_symbol
        return {"decode": grid * bps * 4 + grid * bps}  # LLRs in, bits out
    if kind == "demod":
        return {
            "demod_fft": samples * 8 + grid * 8,
            "demod_tail": grid * 8 + b * n * 8,  # spectrum + channel in
            "count": grid * 4 + b * 4,
        }
    return {
        "payload": 2 * grid * 4,           # indices for TX and RX
        "tx": grid * 4 + samples * 8,      # indices in, planar waveform out
        "channel": 2 * samples * 8,        # waveform in, impaired out
        "demod_fft": samples * 8 + grid * 8,
        "demod_tail": grid * 8,            # spectrum in
        "count": grid * 4 + b * 4,         # indices in, counts out
    }


def roofline_share(nbytes: float, seconds: float,
                   hbm_bytes_per_s: float) -> float | None:
    """``nbytes`` over ``seconds`` as a share of the HBM peak; None when
    that share exceeds ``ROOFLINE_SHARE_MAX``: then the stage's bytes
    moved in kernels whose time the trace charged to other stages."""
    share = nbytes / hbm_bytes_per_s / seconds
    return share if share <= ROOFLINE_SHARE_MAX else None


def run_trace(trace_dir: str) -> None:
    """Trace 4 back-to-back calls of each job; log per-stage device time
    per call, its share of the HBM roofline and the device idle share."""
    import glob
    import os

    import jax

    from sdr_tpu.link.fast import make_fast_fn
    from sdr_tpu.link.fast_coded import make_ldpc_fast_fn
    from sdr_tpu.obs.profile import (
        device_events, event_stage, hlo_stages, stage_report,
    )
    from sdr_tpu.obs.roofline import chip_peaks
    from sdr_tpu.ops.demod import demod_count_chain

    peaks = chip_peaks(jax.devices()[0].device_kind)

    def keyed(fn):
        return fn, [(jax.random.PRNGKey(i),) for i in range(4)]

    def demod_count(cfg):
        n, cp, b, s = (cfg.ofdm.n_fft, cfg.ofdm.cp_len, cfg.n_channels,
                       cfg.n_symbols)
        nv = 1.0 / (10.0 ** (cfg.channel.ebno_db / 10.0) * 4)
        args = _demod_inputs(n, cp, b, s, cfg.modulation, nv)
        fn = jax.jit(lambda re, im, hr, hi, idx: demod_count_chain(
            re, im, hr, hi, idx, cp, cfg.modulation, nv))
        return fn, [args] * 4

    jobs = [
        ("fast", _link_cfg("multipath"),
         lambda c: keyed(make_fast_fn(c)), "fast"),
        ("ldpc", _link_cfg("awgn", LDPC_SHAPE, ebno=4.5),
         lambda c: keyed(make_ldpc_fast_fn(c, iters=13,
                                           schedule="layered")), "coded"),
        ("demod", _link_cfg("awgn", DEMOD_SHAPES[1]), demod_count, "demod"),
    ]
    summary = []
    for short, cfg, build, kind in jobs:
        name = {"fast": "fast multipath", "coded": "ldpc layered x13",
                "demod": "demod count"}[kind]
        name = (f"{name} {cfg.ofdm.n_fft}sc {cfg.n_channels}x"
                f"{cfg.n_symbols}")
        fn, calls = build(cfg)
        compiled = fn.lower(*calls[0]).compile()
        stages = hlo_stages(compiled.as_text())
        jax.block_until_ready(compiled(*calls[0]))
        d = os.path.join(trace_dir, short)
        jax.profiler.start_trace(d)
        outs = [compiled(*a) for a in calls]
        jax.block_until_ready(outs)
        jax.profiler.stop_trace()
        path = sorted(glob.glob(f"{d}/**/*.xplane.pb", recursive=True))[-1]
        events = device_events(path)
        rep = stage_report(events, stages)
        other = {}
        for _, dur, op, kname in events:
            if event_stage(op, kname, stages) == "other":
                other[kname[:80]] = other.get(kname[:80], 0.0) + dur
        check(rep["busy_ns"] > 0, f"{name}: no device events in the trace")
        nbytes = _stage_bytes(cfg, kind)
        log(f"  trace {name}: {len(calls)} calls, window "
            f"{rep['window_ns'] / 1e6:.3f} ms, device idle share "
            f"{rep['idle_share']:.4f}")
        rows = {}
        for st, ns in sorted(rep["stage_ns"].items(), key=lambda x: -x[1]):
            per_call = ns / len(calls)
            line = f"    {st:<11} {per_call / 1e6:9.3f} ms/call"
            row = {"ms_per_call": per_call / 1e6}
            if st in nbytes and per_call > 0:
                share = roofline_share(nbytes[st], per_call * 1e-9,
                                       peaks.hbm_bytes_per_s)
                line += f"  {nbytes[st] / 1e9:7.3f} GB min  "
                line += ("fused into other stages: no share" if share is None
                         else f"{share:6.3f} of the HBM roofline")
                row["bytes_roofline_share"] = share
            log(line)
            rows[st] = row
        # All byte-modelled stages together: bytes and time then come
        # from the same kernels, whatever the fusions.
        modelled_ns = sum(rep["stage_ns"].get(st, 0.0) for st in nbytes)
        total = None
        if modelled_ns > 0:
            total = (sum(nbytes.values()) / peaks.hbm_bytes_per_s
                     / (modelled_ns / len(calls) * 1e-9))
            log(f"    all modelled stages: {total:6.3f} of the HBM roofline")
        summary.append({
            "job": name, "idle_share": rep["idle_share"],
            "window_ms": rep["window_ns"] / 1e6, "stages": rows,
            "modelled_stages_roofline_share": total,
            "other_kernels_ms_per_call": {
                k: v / len(calls) / 1e6
                for k, v in sorted(other.items(), key=lambda x: -x[1])[:12]
            },
        })
    with open(os.path.join(trace_dir, "stages.json"), "w") as f:
        json.dump(summary, f, indent=1)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    global _CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-GPU paths (needs 4 GPUs)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="trace a short window of the fast engine "
                    "(multipath) and the coded engine into DIR")
    args = ap.parse_args(argv)

    import jax

    from sdr_tpu.obs.device import gpu_name_power, require_gpu
    from sdr_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cards = gpu_name_power()
    _CARD = cards[0] if len(set(cards)) == 1 else " | ".join(cards)
    log(f"device: jax {jax.__version__}, {len(devices)} x "
        f"{devices[0].device_kind}, cards {cards}, compile cache {cache}")

    if args.four:
        phases = [("four", phase_four)]
    elif args.trace:
        phases = [("trace", lambda: run_trace(args.trace))]
    else:
        phases = [
            ("entry points", phase_entry_points),
            ("demod", phase_demod),
            ("fast engine", phase_fast),
            ("coded", phase_coded),
            ("pipeline", phase_pipeline),
        ]
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase is reported, never swallowed
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED")
            continue
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"error: phases failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
