"""Monte-Carlo driver (link.mc): ``iters`` fast-engine passes in one
``lax.fori_loop``, one key per pass.

BER against exact theory for every channel model it runs, the int32
counter guard, the pass accumulation, and sharded == unsharded on the
8-device CPU mesh (every draw is keyed by global channel id).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.ber import (
    ber_awgn_exact,
    ber_rayleigh_exact,
    ber_rician_exact,
)
from sdr_tpu.link.fast import fast_core
from sdr_tpu.link.mc import make_mc_fn, mc_simulate, supported


def _cfg(model=ChannelModel.AWGN, ebno=6.0, n_fft=64, cp=16, **kw):
    kw.setdefault("n_symbols", 4)
    kw.setdefault("n_channels", 256)
    return LinkConfig(
        modulation=kw.pop("mod", Modulation.QPSK),
        ofdm=OFDMConfig(n_fft=n_fft, cp_len=cp),
        channel=ChannelConfig(
            model=model,
            ebno_db=ebno,
            pdp=(1.0, 0.5, 0.25)
            if model in (ChannelModel.MULTIPATH, ChannelModel.MULTIPATH_TIME)
            else (1.0,),
            doppler_norm=0.05,
            k_factor=4.0,
        ),
        equalizer=Equalizer.MMSE,
        **kw,
    )


def _ber(cfg, iters=4, seed=1):
    e, c = make_mc_fn(cfg, iters=iters)(seed)
    return float(np.sum(e)) / float(np.sum(c))


@pytest.mark.parametrize(
    "model,ebno,tol",
    [
        (ChannelModel.AWGN, 6.0, 0.1),
        (ChannelModel.RAYLEIGH_FLAT, 10.0, 0.25),
        (ChannelModel.RICIAN, 10.0, 0.25),
        (ChannelModel.RAYLEIGH_TIME, 10.0, 0.25),
        (ChannelModel.MULTIPATH, 10.0, 0.25),
        (ChannelModel.MULTIPATH_TIME, 10.0, 0.25),
    ],
)
def test_mc_ber_matches_theory(model, ebno, tol):
    """Each pass draws fresh channels, so 4 passes x 256 links average
    the fading; every selective model is Rayleigh per subcarrier."""
    cfg = _cfg(model, ebno)
    mod = cfg.modulation
    if model == ChannelModel.AWGN:
        th = ber_awgn_exact(mod, ebno)
    elif model == ChannelModel.RICIAN:
        th = ber_rician_exact(mod, ebno, 4.0)
    else:
        th = ber_rayleigh_exact(mod, ebno)
    ber = _ber(cfg)
    assert abs(ber / th - 1.0) < tol, (ber, th)


@pytest.mark.parametrize("n_fft,cp", [(64, 16), (1024, 128)])
def test_mc_scfdma_ber_matches_theory(n_fft, cp):
    """Full-grid SC-FDMA over AWGN: SC-FDE receive sits on theory."""
    cfg = _cfg(ChannelModel.AWGN, 6.0, n_fft, cp, dft_spread=True,
               n_channels=64 if n_fft == 64 else 8)
    th = ber_awgn_exact(cfg.modulation, 6.0)
    assert abs(_ber(cfg) / th - 1.0) < 0.1


def test_mc_identity_zero_errors():
    e, c = mc_simulate(_cfg(ChannelModel.IDENTITY, n_channels=4), 0,
                       iters=2)
    assert int(np.sum(e)) == 0 and int(np.sum(c)) == 4 * 2 * 4 * 64 * 2


def test_mc_counter_guard():
    """iters that would overflow the int32 per-channel counter raise."""
    cfg = _cfg(n_fft=4096, cp=512, n_symbols=64, n_channels=2,
               mod=Modulation.QAM1024)
    per_pass = 64 * 4096 * 10
    with pytest.raises(ValueError, match="overflows"):
        mc_simulate(cfg, 0, iters=2**31 // per_pass + 1)


def test_mc_supported_gate():
    from sdr_tpu.core.config import MIMOConfig, MIMOScheme

    assert supported(_cfg())
    assert supported(_cfg(ChannelModel.MULTIPATH_TIME))
    piloted = dataclasses.replace(_cfg(), pilot_spacing=8)
    assert not supported(piloted)
    assert not supported(dataclasses.replace(
        _cfg(ChannelModel.RAYLEIGH_FLAT),
        mimo=MIMOConfig(MIMOScheme.MRC, 1, 2),
    ))
    with pytest.raises(ValueError, match="does not support"):
        mc_simulate(piloted, 0)


def test_mc_passes_accumulate():
    """iters passes == the sum of fast_core over the per-pass keys."""
    cfg = _cfg(ChannelModel.RAYLEIGH_FLAT, n_channels=6)
    e, c = mc_simulate(cfg, 7, iters=3)
    base = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    ids = jnp.arange(6, dtype=jnp.int32)
    want = sum(
        np.asarray(fast_core(cfg, jax.random.fold_in(base, i), ids)[0])
        for i in range(3)
    )
    np.testing.assert_array_equal(np.asarray(e), want)
    assert int(c[0]) == 3 * 4 * 64 * 2


def test_mc_seed_changes_draws():
    cfg = _cfg(ChannelModel.AWGN, 2.0, n_channels=8)
    a, _ = mc_simulate(cfg, 1)
    b, _ = mc_simulate(cfg, 2)
    assert not np.array_equal(np.asarray(a), np.asarray(b))


def test_mc_seed_is_traced():
    """make_mc_fn compiles once: the seed is a runtime argument."""
    fn = make_mc_fn(_cfg(n_channels=4), iters=2)
    a = fn(jnp.int32(3))
    b = fn(jnp.int32(3))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert fn._cache_size() == 1


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mc_sharded_bit_exact(n_shards):
    from sdr_tpu.parallel import make_link_mesh
    from sdr_tpu.parallel.shard import make_sharded_mc_fn

    cfg = _cfg(ChannelModel.MULTIPATH, 8.0, n_channels=24)
    mesh = make_link_mesh(1, n_shards, devices=jax.devices()[:n_shards])
    got, cnt = make_sharded_mc_fn(cfg, mesh, iters=2)(5)
    want, _ = make_mc_fn(cfg, iters=2)(5)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(cnt).shape == (24,)
