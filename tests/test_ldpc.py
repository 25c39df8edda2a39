"""QC-LDPC construction, encode/decode, and the coded-link path."""

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
from sdr_tpu.ops.ldpc import (
    _has_4cycle,
    ldpc_decode,
    ldpc_encode,
    ldpc_syndrome,
    make_qc_ldpc,
)


@pytest.mark.parametrize("mb,rate", [(12, 0.5), (8, 2 / 3), (6, 0.75)])
def test_construction(mb, rate):
    code = make_qc_ldpc(nb=24, mb=mb, z=128)
    assert code.n == 24 * 128 and abs(code.rate - rate) < 1e-9
    base = np.array(code.base)
    assert not _has_4cycle(base, code.z)
    # Information columns have weight 3; bidiagonal parity part.
    kb = code.kb
    assert ((base[:, :kb] >= 0).sum(axis=0) == 3).all()
    for c in range(mb):
        assert base[c, kb + c] == 0
        if c + 1 < mb:
            assert base[c + 1, kb + c] == 0


def test_encode_valid_and_systematic(rng):
    code = make_qc_ldpc()
    info = jnp.asarray(rng.integers(0, 2, (4, code.k)), jnp.int8)
    cw = ldpc_encode(code, info)
    assert cw.shape == (4, code.n)
    np.testing.assert_array_equal(np.asarray(cw)[:, : code.k], np.asarray(info))
    assert int(np.asarray(ldpc_syndrome(code, cw)).max()) == 0


def test_decode_clean_is_exact(rng):
    code = make_qc_ldpc()
    info = jnp.asarray(rng.integers(0, 2, (2, code.k)), jnp.int8)
    cw = ldpc_encode(code, info)
    llr = jnp.asarray(10.0 * (1.0 - 2.0 * np.asarray(cw, np.float32)))
    dec = ldpc_decode(code, llr, iters=5)
    np.testing.assert_array_equal(np.asarray(dec), np.asarray(cw))


def test_decode_corrects_bpsk_awgn(rng):
    """Waterfall sanity: raw BER ~9% at 3 dB decodes to zero errors
    (measured margin: zero from 2.5 dB up on 49k-bit batches)."""
    code = make_qc_ldpc()
    info = jnp.asarray(rng.integers(0, 2, (16, code.k)), jnp.int8)
    cw = ldpc_encode(code, info)
    esno = 10 ** (3.0 / 10.0) * code.rate
    sigma = np.sqrt(1.0 / (2.0 * esno))
    x = 1.0 - 2.0 * np.asarray(cw, np.float32)
    y = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
    llr = jnp.asarray(2.0 * y / sigma**2)
    raw = float(((np.asarray(llr) < 0) != np.asarray(cw)).mean())
    assert raw > 0.05  # the channel really is noisy
    dec = np.asarray(jax.jit(lambda l: ldpc_decode(code, l, iters=30))(llr))
    assert (dec[:, : code.k] == np.asarray(info)).all()


def _link_cfg(ebno=4.0):
    return LinkConfig(
        modulation=Modulation.QPSK,
        ofdm=OFDMConfig(n_fft=128, cp_len=16),
        channel=ChannelConfig(model=ChannelModel.AWGN, ebno_db=ebno),
        equalizer=Equalizer.NONE,
        n_symbols=16,
        n_channels=8,
    )


def test_ldpc_link_beats_uncoded():
    from sdr_tpu.link.coded import make_ldpc_fn
    from sdr_tpu.link.pipeline import make_simulate_fn

    cfg = _link_cfg(4.0)
    err, cnt = make_ldpc_fn(cfg)(jax.random.PRNGKey(0))
    assert int(np.asarray(err).sum()) == 0  # 408 uncoded errors here
    assert int(np.asarray(cnt).sum()) == 8 * 1536
    res = make_simulate_fn(cfg)(jax.random.PRNGKey(0))
    assert int(np.asarray(res.bit_errors).sum()) > 100


@pytest.mark.parametrize("rate", ["2/3", "3/4"])
def test_ldpc_link_higher_rates(rate):
    from sdr_tpu.link.coded import make_ldpc_fn

    err, cnt = make_ldpc_fn(_link_cfg(5.0), rate=rate)(jax.random.PRNGKey(1))
    assert int(np.asarray(err).sum()) == 0
    assert int(np.asarray(cnt).sum()) > 0


def test_cli_bench_ldpc(capsys):
    import json

    from sdr_tpu.app.cli import main

    rc = main([
        "bench", "--config", "0", "--coded", "--code", "ldpc",
        "--ldpc-iters", "15",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert "QC-LDPC" in out["code"]
    assert out["ber"] < 1e-3


def _np_minsum(code, llr, iters, offset=0.5, layered=False):
    """Float64 offset min-sum on the lifted parity-check matrix, one
    check at a time: H[i·Z + r, j·Z + (r + s) mod Z] = 1 for each base
    entry s at (i, j). Layered processes the Z checks of base row i as
    one layer (they share no variable), updating the posteriors before
    the next layer; flooding updates every check from the previous
    iteration's messages."""
    z = code.z
    checks = [
        [j * z + (r + s) % z for j, s in code.row_edges(i)]
        for i in range(code.mb) for r in range(z)
    ]
    ch = np.asarray(llr, np.float64)
    c2v = [np.zeros((ch.shape[0], len(v))) for v in checks]
    tot = ch.copy()

    def update(m):
        sign = np.prod(np.where(m < 0, -1.0, 1.0), axis=1, keepdims=True)
        a = np.abs(m)
        order = np.sort(a, axis=1)
        excl = np.where(a == order[:, :1], order[:, 1:2], order[:, :1])
        return sign * np.where(m < 0, -1.0, 1.0) * np.maximum(
            excl - offset, 0.0)

    for _ in range(iters):
        if layered:
            for i in range(code.mb):
                for c in range(i * z, (i + 1) * z):
                    v = checks[c]
                    new = update(tot[:, v] - c2v[c])
                    tot[:, v] += new - c2v[c]
                    c2v[c] = new
        else:
            new = [update(tot[:, v] - c2v[c]) for c, v in enumerate(checks)]
            c2v = new
            tot = ch.copy()
            for c, v in enumerate(checks):
                np.add.at(tot, (slice(None), v), c2v[c])
    return (tot < 0).astype(np.int8)


def _noisy_llrs(rng, code, n_cw, sigma):
    info = jnp.asarray(rng.integers(0, 2, (n_cw, code.k)), jnp.int8)
    cw = ldpc_encode(code, info)
    x = 1.0 - 2.0 * np.asarray(cw, np.float32)
    y = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
    return info, cw, jnp.asarray(2.0 * y / sigma**2)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("nb,mb", [(8, 4), (12, 6)])
def test_decoder_matches_numpy_minsum(rng, schedule, nb, mb):
    """Both schedules against a float64 min-sum on the lifted H, at a
    waterfall point where many codewords are still being corrected:
    decisions agree except on the rare bit a float32 tie moves."""
    code = make_qc_ldpc(nb, mb, 16)
    _, _, llr = _noisy_llrs(rng, code, 32, 0.85)
    iters = 8 if schedule == "flooding" else 4
    got = np.asarray(ldpc_decode(code, llr, iters=iters, schedule=schedule))
    want = _np_minsum(code, llr, iters, layered=schedule == "layered")
    assert (got != want).mean() < 1e-3
    assert (want != (np.asarray(llr) < 0)).sum() > 0  # it corrected bits


def test_layered_schedule_waterfall(rng):
    """Layered at ~half the iterations matches the flooding waterfall:
    info-bit error counts within 30% relative at an operating point,
    and clean codewords decode exactly."""
    code = make_qc_ldpc(8, 4, 128)
    esno = 10 ** (2.0 / 10.0) * code.rate
    sigma = float(np.sqrt(1.0 / (2.0 * esno)))
    info, cw, llr = _noisy_llrs(rng, code, 256, sigma)
    flood = np.asarray(ldpc_decode(code, llr, iters=24))
    lay = np.asarray(ldpc_decode(code, llr, iters=12, schedule="layered"))
    info_np = np.asarray(info)
    be_f = (flood[:, : code.k] != info_np).sum()
    be_l = (lay[:, : code.k] != info_np).sum()
    assert be_f > 0  # operating point produces errors to compare
    assert abs(be_l - be_f) <= max(0.3 * be_f, 20)

    x = 1.0 - 2.0 * np.asarray(cw, np.float32)
    out = np.asarray(ldpc_decode(code, jnp.asarray(100.0 * x), iters=4,
                                 schedule="layered"))
    np.testing.assert_array_equal(out, np.asarray(cw))


def test_decode_schedule_dispatch(rng):
    """An unknown schedule is an explicit error, not a silent flooding
    decode; both schedules take any batch shape."""
    code = make_qc_ldpc(8, 4, 128)
    llr = jnp.asarray(rng.standard_normal((3, 2, code.n)).astype(np.float32))
    with pytest.raises(ValueError, match="schedule"):
        ldpc_decode(code, llr, schedule="zigzag")
    for schedule in ("flooding", "layered"):
        out = ldpc_decode(code, llr, iters=2, schedule=schedule)
        assert out.shape == (3, 2, code.n) and out.dtype == jnp.int8
