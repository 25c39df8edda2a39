"""Eb/N0 sweep driver with checkpoint/resume.

The reference has no benchmark, sweep, or persistence machinery at all
(SURVEY.md §5: no checkpointing, no metrics, no config system — its
only "observability" is the GUI, QFDemoWindow.cpp:226-265). This module
is the statistical engine the north star requires: BER curves over an
Eb/N0 grid, validated against exact AWGN theory (link.ber), with
error-count accumulation across batched link invocations and atomic
JSON checkpoints so a long sweep survives interruption — the
checkpoint/resume aux subsystem of SURVEY.md §5 done host-side (device
state is pure-functional; the counters ARE the whole state).

Termination per point follows standard Monte-Carlo practice: stop at
``target_errors`` bit errors (confidence ~1/sqrt(errors)) or at
``max_bits``, whichever first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

import jax

from sdr_tpu.core.config import LinkConfig
from sdr_tpu.link.ber import ber_awgn_exact
from sdr_tpu.link.pipeline import make_simulate_fn


@dataclasses.dataclass
class SweepPoint:
    ebno_db: float
    bit_errors: int
    bits_counted: int
    # Number of simulate invocations consumed (keys fold_in(point_key,
    # 0..batches)); persisted so a resumed top-up never replays a key.
    batches: int = 0

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.bits_counted, 1)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepResult:
    points: list  # list[SweepPoint], ascending ebno
    config_summary: str

    def bers(self) -> np.ndarray:
        return np.array([p.ber for p in self.points])

    def ebnos(self) -> np.ndarray:
        return np.array([p.ebno_db for p in self.points])

    def theory(
        self, mod, channel_model=None, k_factor: float = 4.0, mimo=None
    ) -> np.ndarray:
        """Exact reference curve: AWGN by default; flat Rayleigh when
        the sweep's channel model is RAYLEIGH_FLAT (or Jakes, whose
        per-symbol marginal is the same exponential fade); flat Rician
        (MGF integral) for RICIAN at the given K-factor; the exact
        diversity curves (ber_alamouti_exact / ber_mrc_exact) for
        Alamouti/MRC MIMO over flat Rayleigh (spatial mux has no simple
        closed form — it falls through to the channel-model curve)."""
        from sdr_tpu.core.config import ChannelModel, MIMOScheme
        from sdr_tpu.link.ber import (
            ber_alamouti_exact,
            ber_mrc_exact,
            ber_rayleigh_exact,
            ber_rician_exact,
        )

        if (
            mimo is not None
            and channel_model == ChannelModel.RAYLEIGH_FLAT
            and mimo.scheme in (MIMOScheme.ALAMOUTI, MIMOScheme.MRC)
        ):
            base = (
                ber_alamouti_exact
                if mimo.scheme == MIMOScheme.ALAMOUTI
                else ber_mrc_exact
            )
            fn = lambda m, e: base(m, e, mimo.n_rx)  # noqa: E731
        elif channel_model == ChannelModel.RICIAN:
            fn = lambda m, e: ber_rician_exact(m, e, k_factor)  # noqa: E731
        elif channel_model in (
            ChannelModel.RAYLEIGH_FLAT,
            ChannelModel.RAYLEIGH_TIME,
        ):
            fn = ber_rayleigh_exact
        else:
            fn = ber_awgn_exact
        return np.array([fn(mod, e) for e in self.ebnos()])


def _cfg_summary(cfg: LinkConfig) -> str:
    s = (
        f"{cfg.modulation.value}/{cfg.ofdm.n_fft}sc/cp{cfg.ofdm.cp_len}/"
        f"{cfg.channel.model.value}/eq={cfg.equalizer.value}"
    )
    if cfg.dft_spread:
        # The waveform keys the checkpoint match too: an SC-FDMA sweep
        # must never silently reuse an OFDM sweep's points.
        s += "/scfdma"
    if cfg.pilot_spacing:
        s += f"/pilots{cfg.pilot_spacing}:{cfg.estimator.value}"
    if cfg.mimo is not None:
        # Every MIMO distinction must key the checkpoint match, or a
        # SISO (or differently-configured MIMO) sweep's points would be
        # silently reused as this sweep's results.
        m = cfg.mimo
        s += f"/{m.scheme.value}{m.n_tx}x{m.n_rx}:{m.csi}:{m.detector}"
    return s


def _atomic_write(path: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def ebno_sweep(
    cfg: LinkConfig,
    ebno_grid_db: Sequence[float],
    key: jax.Array,
    target_errors: int = 500,
    max_bits: int = 20_000_000,
    checkpoint_path: Optional[str] = None,
    progress=None,
    engine: str = "pipeline",
    mc_iters: int = 16,
    code: Optional[str] = None,
    code_rate: str = "1/2",
) -> SweepResult:
    """BER over an Eb/N0 grid with stop-at-target-errors accumulation.

    One jitted simulate program per Eb/N0 point (ebno is static in the
    config); each invocation adds cfg.bits_total bits. If
    ``checkpoint_path`` exists and matches this sweep's config summary,
    completed points are loaded and the sweep resumes after them;
    every completed point rewrites the checkpoint atomically.

    ``engine="fast"`` drives link.fast (the batched throughput path —
    full-grid configs only, no pilots/impairments) with the same
    jax.random stream discipline as the pipeline oracle;
    ``engine="mc"`` drives link.mc (``mc_iters`` fast-engine passes
    per invocation, in one device loop). Same accumulation/
    termination/checkpoint logic either way. Checkpoints record the
    engine, so sweeps from different engines never share state (their
    random streams differ)."""
    if engine not in ("pipeline", "fast", "mc"):
        raise ValueError(f"unknown sweep engine {engine!r}")
    if engine == "fast" and (cfg.pilot_spacing or cfg.channel.impaired):
        raise ValueError(
            "engine='fast' needs a full-grid config (no pilots or "
            "timing/CFO impairments — use engine='pipeline')"
        )
    if code is not None and engine != "pipeline":
        raise ValueError(
            "coded sweeps run on the pipeline engine (the fast/mc "
            "engines count channel bits, not decoded info bits)"
        )
    summary = _cfg_summary(cfg) + {"pipeline": "", "fast": "/fast", "mc": "/mc"}[engine]
    if code is not None:
        summary += f"/{code}-{code_rate}"
    done: dict[float, SweepPoint] = {}
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            ck = json.load(f)
        if ck.get("config_summary") == summary:
            for p in ck.get("points", []):
                # Pre-'batches' checkpoints cannot be topped up safely
                # (the consumed key count is unknown — resuming from
                # batch 0 would replay the same draws and double-count
                # them); keep such points only if already complete.
                legacy = "batches" not in p
                pt = SweepPoint(**p)
                if legacy and pt.bit_errors < target_errors and pt.bits_counted < max_bits:
                    continue  # recompute from scratch
                done[float(pt.ebno_db)] = pt

    points: list[SweepPoint] = []
    for i, ebno in enumerate(ebno_grid_db):
        ebno = float(ebno)
        prev = done.get(ebno)
        if prev is not None and (
            prev.bit_errors >= target_errors or prev.bits_counted >= max_bits
        ):
            # Complete under the CURRENT targets; a rerun with larger
            # target_errors/max_bits tops the point up instead of
            # silently reusing a less-converged result.
            points.append(prev)
            continue
        pt_cfg = dataclasses.replace(
            cfg, channel=dataclasses.replace(cfg.channel, ebno_db=ebno)
        )
        if engine == "mc":
            from sdr_tpu.link.mc import make_mc_fn

            mc_fn = make_mc_fn(pt_cfg, iters=mc_iters)

            def invoke(batch, _i=i, _fn=mc_fn):
                # Deterministic, never-replayed seed per (point, batch).
                e, c = _fn(np.int32((_i * 1_000_003 + batch) & 0x7FFFFFFF))
                return int(np.asarray(e).sum()), int(np.asarray(c).sum())
        elif engine == "fast":
            from sdr_tpu.link.fast import make_fast_fn

            ffn = make_fast_fn(pt_cfg)
            pt_key = jax.random.fold_in(key, i)

            def invoke(batch, _fn=ffn, _k=pt_key):
                e, c = _fn(jax.random.fold_in(_k, batch))
                return int(np.asarray(e).sum()), int(np.asarray(c).sum())
        elif code is not None:
            from sdr_tpu.link.coded import make_family_fn

            cfn = make_family_fn(pt_cfg, code, rate=code_rate)
            pt_key = jax.random.fold_in(key, i)

            def invoke(batch, _fn=cfn, _k=pt_key):
                e, c = _fn(jax.random.fold_in(_k, batch))
                return int(np.asarray(e).sum()), int(np.asarray(c).sum())
        else:
            fn = make_simulate_fn(pt_cfg)
            pt_key = jax.random.fold_in(key, i)

            def invoke(batch, _fn=fn, _k=pt_key):
                res = _fn(jax.random.fold_in(_k, batch))
                return (
                    int(np.asarray(res.bit_errors).sum()),
                    int(np.asarray(res.bits_counted).sum()),
                )

        errors = prev.bit_errors if prev else 0
        bits = prev.bits_counted if prev else 0
        batch = prev.batches if prev else 0
        while errors < target_errors and bits < max_bits:
            e, c = invoke(batch)
            errors += e
            bits += c
            batch += 1
        pt = SweepPoint(
            ebno_db=ebno, bit_errors=errors, bits_counted=bits, batches=batch
        )
        points.append(pt)
        done[ebno] = pt
        if progress is not None:
            progress(pt)
        if checkpoint_path:
            _atomic_write(
                checkpoint_path,
                {
                    "config_summary": summary,
                    "points": [p.to_json() for p in sorted(done.values(), key=lambda q: q.ebno_db)],
                },
            )
    return SweepResult(points=points, config_summary=summary)
