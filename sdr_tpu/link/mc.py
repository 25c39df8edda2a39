"""Monte-Carlo link driver: many fast-engine passes in one program.

``mc_simulate`` runs ``iters`` passes of link.fast.fast_core inside one
jitted ``lax.fori_loop``, with one key per pass (fold_in of the seed's
key and the pass index), and accumulates per-channel error counts on
the device. Per pass every draw — payload, fading, noise — is keyed by
(pass key, role, global channel id), so a channel-sharded run over the
same channel ids is bit-exact vs the unsharded one
(parallel.shard.make_sharded_mc_fn). Use it for BER curves and Eb/N0
sweeps at bit counts one fast-engine call cannot hold.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from sdr_tpu.core.config import ChannelModel, LinkConfig

_SUPPORTED_MODELS = (
    ChannelModel.IDENTITY,
    ChannelModel.AWGN,
    ChannelModel.RAYLEIGH_FLAT,
    ChannelModel.MULTIPATH,
    ChannelModel.RAYLEIGH_TIME,
    ChannelModel.RICIAN,
    ChannelModel.MULTIPATH_TIME,
)


def supported(cfg: LinkConfig) -> bool:
    """A full-grid SISO link the fast engine runs: supported channel
    model, genie CSI, no acquisition impairments, no PA."""
    return (
        cfg.channel.model in _SUPPORTED_MODELS
        and cfg.pilot_spacing == 0
        and cfg.mimo is None
        and not cfg.channel.impaired
        and not cfg.channel.has_pa
    )


def _check_counter(cfg: LinkConfig, iters: int) -> int:
    """Bits counted per channel per pass; raises if ``iters`` passes
    overflow the int32 per-channel counters."""
    bits_per_pass = (
        cfg.n_symbols * cfg.ofdm.n_fft * cfg.modulation.bits_per_symbol
    )
    if bits_per_pass * iters >= 2**31:
        raise ValueError(
            f"iters={iters} overflows the int32 per-channel bit counter "
            f"({bits_per_pass} bits/pass); accumulate across mc_simulate "
            "calls at the caller instead"
        )
    return bits_per_pass


def mc_simulate(
    cfg: LinkConfig,
    seed: int | jax.Array = 0,
    iters: int = 1,
    ch_ids: jnp.ndarray | None = None,
):
    """Run ``iters`` Monte-Carlo passes; returns per-channel
    (bit_errors, bits_counted), both int32 over ``ch_ids`` (default:
    every channel of ``cfg``).

    Bits counted per channel per pass is the static
    n_symbols·n_fft·bits_per_symbol (CP carries no payload)."""
    from sdr_tpu.link.fast import fast_core

    if not supported(cfg):
        raise ValueError(f"mc_simulate does not support this config: {cfg}")
    bits_per_pass = _check_counter(cfg, iters)
    if ch_ids is None:
        ch_ids = jnp.arange(cfg.n_channels, dtype=jnp.int32)
    base = jax.random.fold_in(
        jax.random.PRNGKey(0), jnp.asarray(seed, jnp.int32)
    )

    def body(i, acc):
        errs, _ = fast_core(cfg, jax.random.fold_in(base, i), ch_ids)
        return acc + errs

    # zeros_like keeps the carry's sharding type equal to the body's
    # output when ch_ids varies over a shard_map axis.
    errs = lax.fori_loop(0, iters, body, jnp.zeros_like(ch_ids, jnp.int32))
    counted = jnp.full(ch_ids.shape, bits_per_pass * iters, jnp.int32)
    return errs, counted


def make_mc_fn(cfg: LinkConfig, iters: int = 1):
    """Jitted MC driver with cfg closed over (seed stays a traced arg)."""
    return jax.jit(functools.partial(mc_simulate, cfg, iters=iters))
