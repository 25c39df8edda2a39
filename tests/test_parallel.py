"""Sharding tests on the virtual 8-device CPU mesh.

The north-star invariant: sharded execution is BIT-exact vs the
unsharded oracle for every mesh layout — including the multipath halo
seams exchanged over ppermute.
"""

import numpy as np
import pytest
import jax

from sdr_tpu.core.config import (
    ChannelConfig,
    ChannelModel,
    Equalizer,
    LinkConfig,
    Modulation,
    OFDMConfig,
)
from sdr_tpu.link.pipeline import make_simulate_fn
from sdr_tpu.link.stream import stream_simulate
from sdr_tpu.parallel import (
    make_link_mesh,
    make_sharded_simulate_fn,
    make_sharded_stream_fn,
)


def _awgn_cfg(n_channels=16, n_symbols=8):
    return LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=8.0),
        n_symbols=n_symbols,
        n_channels=n_channels,
    )


def _multipath_cfg(n_channels=8, n_symbols=8):
    return LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=12.0, pdp=(1.0, 0.6, 0.3, 0.1)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=n_symbols,
        n_channels=n_channels,
    )


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"


@pytest.mark.parametrize("tshape", [(1, 8), (2, 4), (1, 4)])
def test_sharded_simulate_bit_exact(tshape):
    nt, nc = tshape
    devices = jax.devices()[: nt * nc]
    mesh = make_link_mesh(nt, nc, devices=devices)
    cfg = _awgn_cfg(n_channels=16)
    key = jax.random.PRNGKey(42)
    ref = make_simulate_fn(cfg)(key)
    got_err, got_cnt = make_sharded_simulate_fn(cfg, mesh)(key)
    np.testing.assert_array_equal(np.asarray(got_err), np.asarray(ref.bit_errors))
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(ref.bits_counted))


def test_sharded_fast_rejects_mimo():
    """The sharded fast path is SISO like its unsharded twin — a MIMO
    config must raise, never silently simulate SISO."""
    from sdr_tpu.core.config import MIMOConfig, MIMOScheme
    from sdr_tpu.parallel import make_sharded_fast_fn

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0),
        equalizer=Equalizer.MMSE,
        n_symbols=8,
        n_channels=16,
        mimo=MIMOConfig(MIMOScheme.SPATIAL_MUX, 2, 2),
    )
    with pytest.raises(NotImplementedError):
        make_sharded_fast_fn(cfg, make_link_mesh(1, 8))


def test_sharded_simulate_mimo_bit_exact():
    """MIMO links compose with channel DP unchanged: antenna axes are
    per-channel batch axes inside _simulate_one, so the sharded result
    is bit-exact vs the unsharded pipeline (ML detector + preamble CSI
    — the most involved MIMO path)."""
    from sdr_tpu.core.config import ChannelEstimator, MIMOConfig, MIMOScheme

    mesh = make_link_mesh(1, 8)
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=8.0),
        equalizer=Equalizer.MMSE,
        estimator=ChannelEstimator.DFT,
        n_symbols=8,
        n_channels=16,
        mimo=MIMOConfig(
            MIMOScheme.SPATIAL_MUX, 2, 2, csi="preamble", detector="ml"
        ),
    )
    key = jax.random.PRNGKey(5)
    ref = make_simulate_fn(cfg)(key)
    got_err, got_cnt = make_sharded_simulate_fn(cfg, mesh)(key)
    np.testing.assert_array_equal(np.asarray(got_err), np.asarray(ref.bit_errors))
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(ref.bits_counted))


@pytest.mark.parametrize("tshape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_stream_bit_exact_multipath(tshape):
    """The flagship seam test: time-sharded multipath stream with
    ppermute halos equals the sequential blocked oracle exactly."""
    nt, nc = tshape
    mesh = make_link_mesh(nt, nc)
    cfg = _multipath_cfg(n_channels=8, n_symbols=8)
    key = jax.random.PRNGKey(7)
    ref_err, ref_cnt = jax.jit(
        lambda k: stream_simulate(cfg, k, n_blocks=nt), static_argnums=()
    )(key)
    got_err, got_cnt = make_sharded_stream_fn(cfg, mesh)(key)
    np.testing.assert_array_equal(np.asarray(got_err), np.asarray(ref_err))
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(ref_cnt))


def test_sharded_stream_scfdma_bit_exact():
    """SC-FDMA on the SP path (round 3): the spread/despread are
    per-symbol, so the multipath halo seams carry over unchanged —
    time-sharded SC-FDMA equals the sequential blocked oracle
    bit-for-bit."""
    import dataclasses

    mesh = make_link_mesh(4, 2)
    cfg = dataclasses.replace(
        _multipath_cfg(n_channels=8, n_symbols=8), dft_spread=True
    )
    key = jax.random.PRNGKey(7)
    ref_err, ref_cnt = jax.jit(
        lambda k: stream_simulate(cfg, k, n_blocks=4)
    )(key)
    got_err, got_cnt = make_sharded_stream_fn(cfg, mesh)(key)
    np.testing.assert_array_equal(np.asarray(got_err), np.asarray(ref_err))
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(ref_cnt))


@pytest.mark.parametrize(
    "model",
    [ChannelModel.AWGN, ChannelModel.RAYLEIGH_FLAT, ChannelModel.RICIAN],
)
def test_sharded_stream_bit_exact_other_channels(model):
    mesh = make_link_mesh(4, 2)
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=model, ebno_db=6.0),
        equalizer=Equalizer.NONE if model == ChannelModel.AWGN else Equalizer.ZF,
        n_symbols=8,
        n_channels=8,
    )
    key = jax.random.PRNGKey(3)
    ref_err, _ = jax.jit(lambda k: stream_simulate(cfg, k, n_blocks=4))(key)
    got_err, _ = make_sharded_stream_fn(cfg, mesh)(key)
    np.testing.assert_array_equal(np.asarray(got_err), np.asarray(ref_err))


def test_stream_identity_loopback_zero_errors():
    mesh = make_link_mesh(2, 4)
    cfg = LinkConfig(
        modulation=Modulation.QAM64,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.IDENTITY),
        n_symbols=4,
        n_channels=8,
    )
    err, cnt = make_sharded_stream_fn(cfg, mesh)(jax.random.PRNGKey(0))
    assert int(np.sum(np.asarray(err))) == 0
    assert int(np.sum(np.asarray(cnt))) == cfg.bits_total


def test_multipath_blocking_invariance_noiseless():
    """Noiseless multipath: any blocking gives identical demod output
    (the halo fully reconstructs the convolution at every seam)."""
    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=300.0, pdp=(1.0, 0.5, 0.25)
        ),
        equalizer=Equalizer.ZF,
        n_symbols=8,
        n_channels=4,
    )
    key = jax.random.PRNGKey(1)
    errs = []
    for nb in (1, 2, 4, 8):
        e, _ = jax.jit(lambda k, nb=nb: stream_simulate(cfg, k, n_blocks=nb))(key)
        errs.append(np.asarray(e))
    for e in errs[1:]:
        np.testing.assert_array_equal(e, errs[0])
    assert int(np.sum(errs[0])) == 0  # 300 dB SNR ⇒ error-free


def test_mesh_validation():
    with pytest.raises(ValueError, match="mesh"):
        make_link_mesh(3, 3)
    cfg = _awgn_cfg(n_channels=3)
    with pytest.raises(ValueError, match="divisible"):
        make_sharded_simulate_fn(cfg, make_link_mesh(1, 8))


def test_init_multihost_single_process_noop():
    """Single-process call is a safe no-op returning the topology."""
    from sdr_tpu.parallel import init_multihost

    info = init_multihost()
    assert info["process_count"] == 1
    assert info["global_devices"] == 8  # the virtual CPU mesh


def test_sharded_stream_multiple_blocks_per_device():
    """n_blocks > time-axis: intra-device seams thread via lax.scan,
    device boundaries via one ppermute — still bit-exact vs the oracle."""
    import dataclasses
    from sdr_tpu.core.config import (
        ChannelConfig, ChannelModel, Equalizer, LinkConfig, Modulation, OFDMConfig,
    )
    from sdr_tpu.link.stream import stream_simulate
    from sdr_tpu.parallel import make_link_mesh, make_sharded_stream_fn

    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=12.0, pdp=(1.0, 0.5, 0.25)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=16,
        n_channels=4,
    )
    mesh = make_link_mesh(4, 2)
    key = jax.random.PRNGKey(5)
    n_blocks = 8  # 2 blocks per time device
    errors, counted = make_sharded_stream_fn(cfg, mesh, n_blocks=n_blocks)(key)
    ref_err, ref_cnt = jax.jit(
        lambda k: stream_simulate(cfg, k, n_blocks=n_blocks)
    )(key)
    np.testing.assert_array_equal(np.asarray(errors), np.asarray(ref_err))
    np.testing.assert_array_equal(np.asarray(counted), np.asarray(ref_cnt))


def _rayleigh_time_cfg(n_channels=8, n_symbols=16):
    return LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_TIME, ebno_db=12.0, doppler_norm=0.03
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=n_symbols,
        n_channels=n_channels,
    )


@pytest.mark.parametrize("tshape", [(4, 2), (2, 4), (8, 1)])
def test_sharded_stream_rayleigh_time_bit_exact(tshape):
    """Time-varying fading under time sharding: each block evaluates the
    Jakes state at ABSOLUTE symbol indices, so the sharded stream must
    equal the unsharded oracle bit-exactly (regression for the silent
    AWGN fall-through in the stream path)."""
    nt, nc = tshape
    mesh = make_link_mesh(nt, nc, devices=jax.devices()[: nt * nc])
    cfg = _rayleigh_time_cfg()
    key = jax.random.PRNGKey(11)
    n_blocks = 2 * nt  # exercise intra-device seams too
    e_sh, c_sh = make_sharded_stream_fn(cfg, mesh, n_blocks=n_blocks)(key)
    e_ref, c_ref = stream_simulate(cfg, key, n_blocks=n_blocks)
    np.testing.assert_array_equal(np.asarray(e_sh), np.asarray(e_ref))
    np.testing.assert_array_equal(np.asarray(c_sh), np.asarray(c_ref))


@pytest.mark.parametrize("tshape", [(1, 8), (2, 2)])
def test_sharded_fast_fused_kernels_bit_exact(tshape):
    """The fast engine under shard_map must match unsharded
    fast_simulate bit-exactly — the throughput path composed with the
    mesh program."""
    from sdr_tpu.link.fast import fast_simulate
    from sdr_tpu.parallel import make_sharded_fast_fn

    nt, nc = tshape
    mesh = make_link_mesh(nt, nc, devices=jax.devices()[: nt * nc])
    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(128, 32),
        channel=ChannelConfig(
            model=ChannelModel.MULTIPATH, ebno_db=12.0, pdp=(1.0, 0.5, 0.25)
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=4,
        n_channels=2 * nt * nc,  # every device is a DP worker
    )
    key = jax.random.PRNGKey(17)
    e_sh, c_sh = make_sharded_fast_fn(cfg, mesh)(key)
    e_ref, c_ref = jax.jit(lambda k: fast_simulate(cfg, k))(key)
    np.testing.assert_array_equal(np.asarray(e_sh), np.asarray(e_ref))
    np.testing.assert_array_equal(np.asarray(c_sh), np.asarray(c_ref))


@pytest.mark.parametrize("n_shards", [3, 5])
def test_sharded_fast_odd_shards_bit_exact(n_shards):
    """Shard sizes that are no multiple of 128 (or of anything): the
    single RNG stream keeps sharded == unsharded bit-exact."""
    from sdr_tpu.link.fast import fast_simulate
    from sdr_tpu.parallel import make_sharded_fast_fn

    mesh = make_link_mesh(1, n_shards, devices=jax.devices()[:n_shards])
    cfg = LinkConfig(
        modulation=Modulation.QAM16,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(model=ChannelModel.RAYLEIGH_FLAT, ebno_db=10.0),
        equalizer=Equalizer.MMSE,
        n_symbols=2,
        n_channels=n_shards * 43,
    )
    key = jax.random.PRNGKey(23)
    e_sh, _ = make_sharded_fast_fn(cfg, mesh)(key)
    e_ref, _ = jax.jit(lambda k: fast_simulate(cfg, k))(key)
    np.testing.assert_array_equal(np.asarray(e_sh), np.asarray(e_ref))


def test_sharded_fast_jnp_backend_bit_exact():
    """Same invariant under per-symbol (Jakes) fading."""
    from sdr_tpu.link.fast import fast_simulate
    from sdr_tpu.parallel import make_sharded_fast_fn

    mesh = make_link_mesh(1, 4, devices=jax.devices()[:4])
    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(64, 16),
        channel=ChannelConfig(
            model=ChannelModel.RAYLEIGH_TIME, ebno_db=10.0, doppler_norm=0.02
        ),
        equalizer=Equalizer.MMSE,
        n_symbols=8,
        n_channels=8,
    )
    key = jax.random.PRNGKey(19)
    e_sh, _ = make_sharded_fast_fn(cfg, mesh)(key)
    e_ref, _ = jax.jit(lambda k: fast_simulate(cfg, k))(key)
    np.testing.assert_array_equal(np.asarray(e_sh), np.asarray(e_ref))


@pytest.mark.parametrize("code", ["conv", "ldpc", "polar"])
def test_sharded_coded_bit_exact(code):
    """Coded-link channel DP (conv/Viterbi, LDPC/min-sum and
    polar/CA-SCL decode entirely device-local): bit-exact vs the
    unsharded coded link."""
    from sdr_tpu.link.coded import make_coded_fn, make_ldpc_fn, make_polar_fn
    from sdr_tpu.parallel import make_sharded_coded_fn

    cfg = LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(128, 16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=3.0),
        equalizer=Equalizer.NONE,
        n_symbols=16,
        n_channels=8,
    )
    key = jax.random.PRNGKey(9)
    mesh = make_link_mesh(2, 2, devices=jax.devices()[:4])
    if code == "conv":
        ref_err, ref_cnt = make_coded_fn(cfg)(key)
        got_err, got_cnt = make_sharded_coded_fn(cfg, mesh, code="conv")(key)
    elif code == "ldpc":
        ref_err, ref_cnt = make_ldpc_fn(cfg, iters=10)(key)
        got_err, got_cnt = make_sharded_coded_fn(
            cfg, mesh, code="ldpc", ldpc_iters=10
        )(key)
    else:
        ref_err, ref_cnt = make_polar_fn(cfg, list_size=4)(key)
        got_err, got_cnt = make_sharded_coded_fn(
            cfg, mesh, code="polar", polar_list=4
        )(key)
    np.testing.assert_array_equal(np.asarray(got_err), np.asarray(ref_err))
    np.testing.assert_array_equal(np.asarray(got_cnt), np.asarray(ref_cnt))
