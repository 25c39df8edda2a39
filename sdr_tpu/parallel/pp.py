"""Pipeline parallelism: the link chain staged across mesh devices.

The last unbuilt row of SURVEY.md §2's parallelism checklist. The RX
chain normally runs whole on each shard (the right single-device call
— docs/PARITY.md), but when TX and RX are *heterogeneous* work — e.g.
TX+channel simulation feeding a demod farm — staging them across
devices is real pipeline parallelism, and this module expresses it as
``shard_map`` over a 2-row stage axis, ``lax.scan`` over
microbatch ticks, one ``ppermute`` hop per tick (GPipe-style
fill/drain schedule).

Layout on the standard ("time", "channel") mesh:

- "time" axis (size 2) = PIPELINE STAGES: row 0 runs TX + channel,
  row 1 runs demod + error count. ``lax.cond`` on ``axis_index`` keeps
  the branches real control flow — each device compiles and executes
  only its stage's work per tick, which is what makes this PP and not
  redundantly-replicated SPMD.
- "channel" axis = data parallelism, as everywhere else.

Schedule: M microbatches (channel sub-batches) flow through the
2-stage pipe in M+1 ticks; the bubble fraction is 1/(M+1). The payload
crossing the stage boundary each tick is ONLY the impaired samples
(2·mb·S·sym_len f32): the RX stage recomputes the channel plane and
the transmitted bits from the channel-id PRNG keys (link.fast's keyed
discipline — both are pure functions of them), so no side-band data
travels with the samples.

Bit-exactness: stage 0 is link.fast.tx_channel_core and stage 1 is
link.fast.rx_count_core — the exact halves fast_simulate composes —
so the pipelined result equals the unsharded fast path for every
(mesh, n_micro) layout (tests/test_pp.py).

The reference is a single Qt event loop with zero IPC
(/root/reference/app/main.cpp:5-11); this supersedes it the way the
rest of parallel/ does — the chain itself becomes a distributed
program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sdr_tpu.core.config import LinkConfig
from sdr_tpu.link.fast import rx_count_core, tx_channel_core

N_STAGES = 2  # TX+channel | RX+count


def _vary(x, axes):
    """Mark constant zeros as varying over ``axes``, so both branches of
    a stage ``lax.cond`` (and the scan carry) have one sharding type."""
    return lax.pcast(x, axes, to="varying")


def make_pipelined_fast_fn(
    cfg: LinkConfig,
    mesh: Mesh,
    n_micro: int = 2,
):
    """Jitted 2-stage pipelined fast link over ``mesh``.

    Requires mesh "time" axis == 2 (the stage axis). Channels shard
    over "channel" and split into ``n_micro`` microbatches per shard.
    Returns (bit_errors, bits_counted), both (n_channels,) int32,
    equal to ``link.fast.fast_simulate(cfg, key)`` for any layout.
    """
    if mesh.shape["time"] != N_STAGES:
        raise ValueError(
            f'pipeline needs mesh "time" axis == {N_STAGES} (stages), '
            f"got {mesh.shape['time']}"
        )
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "the fast path simulates full-grid links (see link.fast)"
        )
    cdev = mesh.shape["channel"]
    if cfg.n_channels % (cdev * n_micro) != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"channel shards × microbatches = {cdev}×{n_micro}"
        )
    local = cfg.n_channels // cdev
    mb = local // n_micro
    S = cfg.n_symbols
    sym_len = cfg.ofdm.n_fft + cfg.ofdm.cp_len

    def local_fn(key):
        stage = lax.axis_index("time")
        csh = lax.axis_index("channel")

        def mb_ids(m):
            return csh * local + m * mb + jnp.arange(mb)

        def tick(carry, t):
            buf_re, buf_im = carry
            # Stage 0: produce microbatch t (garbage past the last tick;
            # never consumed — the drain tick only reads the buffer).
            def produce(_):
                m = jnp.clip(t, 0, n_micro - 1)
                return tx_channel_core(cfg, key, mb_ids(m))

            def idle(_):
                z = _vary(jnp.zeros((mb, S, sym_len), jnp.float32),
                          ("channel",))
                return z, z

            out_re, out_im = lax.cond(stage == 0, produce, idle, None)

            # Stage 1: consume the payload received at the END of the
            # previous tick = microbatch t-1 (invalid only at t=0).
            def consume(_):
                m = jnp.clip(t - 1, 0, n_micro - 1)
                errors, _ = rx_count_core(
                    cfg, key, mb_ids(m), buf_re, buf_im
                )
                return errors

            def skip(_):
                return _vary(jnp.zeros((mb,), jnp.int32), ("time", "channel"))

            e = lax.cond((stage == 1) & (t >= 1), consume, skip, None)

            # The pipeline hop: stage 0 → stage 1 (stage 1's outgoing
            # zeros fall off the end; stage 0 receives ppermute zeros).
            nxt_re = lax.ppermute(out_re, "time", [(0, 1)])
            nxt_im = lax.ppermute(out_im, "time", [(0, 1)])
            return (nxt_re, nxt_im), e

        z = _vary(jnp.zeros((mb, S, sym_len), jnp.float32),
                  ("time", "channel"))
        init = (z, z)
        _, es = lax.scan(tick, init, jnp.arange(n_micro + 1))
        # Ticks 1..M consumed microbatches 0..M-1 in order (stage-0
        # rows are all zeros); one row per stage leaves the mesh.
        return es[1:].reshape(1, local)

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=P("time", "channel"),
    )

    def run(key):
        errors = f(key)[N_STAGES - 1]  # the RX stage's counts
        counted = jnp.full(
            (cfg.n_channels,), S * cfg.bits_per_ofdm_symbol, jnp.int32
        )
        return errors, counted

    return jax.jit(run)
