"""Sharded link execution: channel-batch DP and time-block SP.

Everything here is ``shard_map`` over a ("time", "channel") mesh
(sdr_tpu.parallel.mesh). Bit-exactness vs the unsharded oracles is the
design invariant (the north star's seam requirement): both paths key
every random draw by GLOBAL channel/block index (sdr_tpu.core.prng),
so a device that owns channels [8..16) and block 3 draws exactly what
the single-device run draws for those coordinates.

Communication inventory (per invocation):
- halo: one ``ppermute`` shifting each time-block's last L-1 TX
  samples to its right neighbor (multipath seams only) — O(cp) bytes
  per boundary, the SDR analog of ring-attention's neighbor pass;
- reduction: one ``psum`` of per-channel error counts over "time".
XLA inserts nothing else: TX/RX are embarrassingly parallel per
(channel, block).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sdr_tpu.core.config import LinkConfig
from sdr_tpu.link import stream as _stream
from sdr_tpu.link.pipeline import _simulate_one


def make_sharded_simulate_fn(cfg: LinkConfig, mesh: Mesh):
    """Channel-batch data parallelism for link.pipeline.simulate.

    Channels are sharded over the "channel" mesh axis (replicated over
    "time"); returns (bit_errors, bits_counted), both (n_channels,),
    identical to the unsharded ``simulate`` for any mesh shape.
    """
    n_shards = mesh.shape["channel"]
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"channel-axis size {n_shards}"
        )
    local = cfg.n_channels // n_shards

    def local_fn(key):
        me = lax.axis_index("channel")
        ch_ids = me * local + jnp.arange(local)
        errors, counted, _ = jax.vmap(
            lambda c: _simulate_one(cfg, jax.random.fold_in(key, c), want_llrs=False)
        )(ch_ids)
        return errors, counted

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P("channel"), P("channel")),
    )
    return jax.jit(f)


def make_sharded_fast_fn(cfg: LinkConfig, mesh: Mesh):
    """Channel-batch data parallelism for the fast link.

    Each device runs link.fast.fast_core on its channel shard. Because
    fast_core keys every draw by global channel id, the result equals
    the unsharded ``fast_simulate`` bit-exactly for any channel-axis
    layout and any shard size (tests/test_parallel.py).
    """
    if cfg.pilot_spacing:
        raise NotImplementedError(
            "the fast path simulates full-grid links (see link.fast)"
        )
    if cfg.mimo is not None:
        raise NotImplementedError(
            "the fast path is SISO; sharded MIMO links run through "
            "make_sharded_simulate_fn (link.pipeline)"
        )
    from sdr_tpu.link.fast import fast_core

    # The fast link has no time-axis structure, so EVERY device is a
    # DP worker: channels shard over the flattened ("time", "channel")
    # axes rather than replicating the chain across "time" rows.
    n_shards = mesh.shape["time"] * mesh.shape["channel"]
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"device count {n_shards}"
        )
    local = cfg.n_channels // n_shards
    cdev = mesh.shape["channel"]

    def local_fn(key):
        me = lax.axis_index("time") * cdev + lax.axis_index("channel")
        ch_ids = me * local + jnp.arange(local)
        return fast_core(cfg, key, ch_ids)

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P(("time", "channel")), P(("time", "channel"))),
    )
    return jax.jit(f)


def make_sharded_stream_fn(
    cfg: LinkConfig, mesh: Mesh, n_blocks: int | None = None
):
    """Time-block sequence parallelism (+ channel DP) for the stream link.

    ``n_blocks`` time blocks (default: one per time-axis device) are
    distributed contiguously: device t owns global blocks
    [t·bpd, (t+1)·bpd). The multipath FIR's seam history is the only
    cross-block coupling; because the TX stream of every block is
    derived purely from its (channel, block) key, each device computes
    its LAST block's tail locally and ONE rightward ``ppermute``
    delivers every device-boundary halo — intra-device seams thread
    sequentially. Device 0 receives zeros (ppermute semantics),
    matching the unsharded stream's cold start.

    Returns (bit_errors, bits_counted) per channel; must equal
    ``link.stream.stream_simulate(cfg, key, n_blocks=n_blocks)``
    bit-exactly (tests/test_parallel.py).
    """
    tdev = mesh.shape["time"]
    cdev = mesh.shape["channel"]
    if n_blocks is None:
        n_blocks = tdev
    if n_blocks % tdev != 0:
        raise ValueError(f"n_blocks={n_blocks} not divisible by time axis {tdev}")
    _stream._check_blocking(cfg, n_blocks)  # divisibility + pilot gate
    if cfg.n_channels % cdev != 0:
        raise ValueError(f"n_channels % channel axis != 0")
    local_ch = cfg.n_channels // cdev
    bpd = n_blocks // tdev  # blocks per device
    spb = cfg.n_symbols // n_blocks
    L_halo = _stream._halo_len(cfg)

    def local_fn(key):
        t = lax.axis_index("time")
        csh = lax.axis_index("channel")
        ch_ids = csh * local_ch + jnp.arange(local_ch)
        blocks = t * bpd + jnp.arange(bpd)  # this device's global blocks

        # TX all local blocks (independent given their keys).
        bits, streams = jax.vmap(
            lambda c: jax.vmap(
                lambda b: _stream._block_tx(cfg, key, c, b, spb)
            )(blocks)
        )(ch_ids)  # bits: (local_ch, bpd, spb, bits/sym); streams: (local_ch, bpd, n)

        if L_halo:
            tails = streams[:, -1, -L_halo:]  # last local block's tail
            perm = [(i, i + 1) for i in range(tdev - 1)]  # rightward, no wrap
            boundary_halo = lax.ppermute(tails, "time", perm)  # (local_ch, L)
        else:
            boundary_halo = None

        def rx_channel(c, streams_c, halo0_c):
            taps, h_freq, jakes = _stream._channel_taps(cfg, key, c)

            def rx_block(halo, idx):
                b, stream = idx
                hard = _stream._block_rx(
                    cfg, key, c, b, stream, taps, h_freq, jakes, spb,
                    halo if L_halo else None,
                )
                next_halo = stream[-L_halo:] if L_halo else halo
                return next_halo, hard

            init = halo0_c if L_halo else jnp.zeros((0,), jnp.complex64)
            _, hard = lax.scan(rx_block, init, (blocks, streams_c))
            return hard  # (bpd, spb, bits/sym)

        if boundary_halo is None:
            zero = jnp.zeros((local_ch, 0), jnp.complex64)
            hard = jax.vmap(rx_channel)(ch_ids, streams, zero)
        else:
            hard = jax.vmap(rx_channel)(ch_ids, streams, boundary_halo)

        errors = jnp.sum((hard != bits).astype(jnp.int32), axis=(1, 2, 3))
        errors = lax.psum(errors, "time")  # total over all blocks
        counted = jnp.full(
            (local_ch,), cfg.n_symbols * cfg.bits_per_ofdm_symbol, jnp.int32
        )
        return errors, counted

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P("channel"), P("channel")),
    )
    return jax.jit(f)


def make_sharded_mc_fn(cfg: LinkConfig, mesh: Mesh, iters: int = 1):
    """Channel-batch data parallelism for the Monte-Carlo driver.

    Each device runs link.mc.mc_simulate over its slice of GLOBAL
    channel ids; every pass keys its draws by (pass key, role, channel
    id), so the result equals the unsharded ``mc_simulate`` bit-exactly
    for any channel-axis layout. The only communication is the
    concatenated per-channel count output. Returns fn(seed).
    """
    from sdr_tpu.link.mc import mc_simulate

    n_shards = mesh.shape["channel"]
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"channel-axis size {n_shards}"
        )
    local = cfg.n_channels // n_shards

    def local_fn(seed):
        ch_ids = lax.axis_index("channel") * local + jnp.arange(local)
        return mc_simulate(cfg, seed, iters=iters, ch_ids=ch_ids)

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P("channel"), P("channel")),
    )
    return jax.jit(f)


def make_sharded_coded_fn(
    cfg: LinkConfig,
    mesh: Mesh,
    code: str = "conv",
    rate: str = "1/2",
    ldpc_iters: int = 25,
    polar_n: int = 256,
    polar_list: int = 8,
):
    """Channel-batch data parallelism for the CODED links
    (conv/LDPC/polar).

    Each device runs the per-channel coded chain (link.coded) on its
    channel shard. All coded paths key every draw by the GLOBAL
    channel index (fold_in(key, c)), so each device reconstructing its
    own global ids makes the result bit-exact vs the unsharded
    ``simulate_coded`` / ``simulate_ldpc`` / ``simulate_polar`` for
    any channel layout — the same invariant as the uncoded DP paths.
    Decoding (Viterbi / min-sum / CA-SCL) runs entirely device-local:
    the only communication is the sharded count output.
    """
    import functools

    from sdr_tpu.link import coded as _coded

    if code == "conv":
        n_info = _coded.info_bits_per_channel(cfg, rate=rate)
        one = functools.partial(
            _coded._coded_one, cfg, n_info=n_info,
            polys=_coded.DEFAULT_POLYS, K=_coded.DEFAULT_K, rate=rate,
        )
    elif code == "ldpc":
        ldpc = _coded.ldpc_code_for(rate)
        n_cw = _coded.ldpc_codewords_per_channel(cfg, ldpc)
        one = functools.partial(
            _coded._ldpc_one, cfg, code=ldpc, n_cw=n_cw, iters=ldpc_iters
        )
    elif code == "polar":
        pc = _coded.polar_code_for(rate, polar_n)
        n_cw = _coded.polar_codewords_per_channel(cfg, pc.block_len)
        one = functools.partial(
            _coded._polar_one, cfg, code=pc, n_cw=n_cw,
            list_size=polar_list,
        )
    else:
        raise ValueError(
            f"code must be 'conv', 'ldpc' or 'polar', got {code!r}"
        )

    # Like the fast path, the coded chain has no time-axis structure:
    # every device is a DP worker over the flattened mesh.
    n_shards = mesh.shape["time"] * mesh.shape["channel"]
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"device count {n_shards}"
        )
    local = cfg.n_channels // n_shards
    cdev = mesh.shape["channel"]

    def local_fn(key):
        me = lax.axis_index("time") * cdev + lax.axis_index("channel")
        ch_ids = me * local + jnp.arange(local)
        ch_keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(ch_ids)
        return jax.vmap(one)(ch_keys)

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P(("time", "channel")), P(("time", "channel"))),
        check_vma=False,
    )
    return jax.jit(f)


def make_sharded_coded_fast_fn(
    cfg: LinkConfig,
    mesh: Mesh,
    rate: str = "1/2",
    ldpc_iters: int = 25,
    schedule: str = "flooding",
):
    """Channel-batch DP for the CODED FAST engine (link.fast_coded —
    the batched LDPC chain).

    Every draw in the engine is keyed by global channel id (payload,
    fading and noise), so each device running its own consecutive id
    slice is bit-exact vs the unsharded ``ldpc_fast_simulate`` — the
    coded analog of ``make_sharded_fast_fn``.
    """
    from sdr_tpu.link.fast_coded import ldpc_fast_simulate

    n_shards = mesh.shape["time"] * mesh.shape["channel"]
    if cfg.n_channels % n_shards != 0:
        raise ValueError(
            f"n_channels={cfg.n_channels} not divisible by "
            f"device count {n_shards}"
        )
    local = cfg.n_channels // n_shards
    cdev = mesh.shape["channel"]

    def local_fn(key):
        me = lax.axis_index("time") * cdev + lax.axis_index("channel")
        ch_ids = me * local + jnp.arange(local)
        return ldpc_fast_simulate(
            cfg, key, rate=rate, iters=ldpc_iters, schedule=schedule,
            ch_ids=ch_ids,
        )

    f = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(),
        out_specs=(P(("time", "channel")), P(("time", "channel"))),
    )
    return jax.jit(f)
