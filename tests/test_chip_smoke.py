"""The on-GPU check's helpers, on the CPU: the no-GPU refusal, the
compile-cache location, the comparisons and tolerances chip_smoke.py
applies, and the trace reduction (obs.profile) it reports from."""

import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke as cs
from sdr_tpu.obs import profile
from sdr_tpu.obs.device import require_gpu
from sdr_tpu.utils import cache

REPO = Path(__file__).resolve().parents[1]


# --- refusing to measure without a GPU -------------------------------------


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


def test_chip_smoke_four_exits_nonzero_without_gpu(capsys):
    assert cs.main(["--four"]) != 0
    assert capsys.readouterr().out == ""


def test_bench_exits_nonzero_without_gpu(capsys):
    import bench

    assert bench.main() != 0
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


# --- compile cache ----------------------------------------------------------


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is set.
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed_in_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compile_cache_dir() == str(REPO / ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# --- comparisons ------------------------------------------------------------


@pytest.mark.parametrize("err,ok", [(0.5e-4, True), (2e-4, False)])
def test_compare_llrs_bound(err, ok):
    ref = np.linspace(-10.0, 10.0, 101)
    got = ref + err * 10.0
    if ok:
        assert cs.compare_llrs("t", got, ref) == pytest.approx(1e-3)
    else:
        with pytest.raises(cs.PhaseFailure):
            cs.compare_llrs("t", got, ref)


def test_compare_llrs_rejects_non_finite():
    ref = np.ones(4)
    with pytest.raises(cs.PhaseFailure, match="non-finite"):
        cs.compare_llrs("t", np.array([1.0, np.nan, 1.0, 1.0]), ref)


def test_marginal_bits_per_channel():
    llr = np.array([[[5.0, 1e-5, -3.0]], [[2e-3, -1e-6, 9.0]]])
    np.testing.assert_array_equal(cs.marginal_bits(llr, (1, 2)), [1, 1])
    np.testing.assert_array_equal(
        cs.marginal_bits(llr, (1, 2), tol=1e-3), [1, 2])


@pytest.mark.parametrize("gpu,ok", [([10, 3], True), ([11, 3], True),
                                    ([12, 3], False), ([10, 4], False)])
def test_compare_counts_allows_marginal_flips(gpu, ok):
    ref, marginal = np.array([10, 3]), np.array([1, 0])
    if ok:
        cs.compare_counts("t", gpu, ref, marginal)
    else:
        with pytest.raises(cs.PhaseFailure):
            cs.compare_counts("t", gpu, ref, marginal)


@pytest.mark.parametrize("shift,ok", [(0.0, True), (2.5, True), (4.0, False)])
def test_check_awgn_three_sigma(shift, ok):
    from sdr_tpu.core.config import Modulation
    from sdr_tpu.link.ber import ber_awgn_exact

    bits = 10**6
    p = ber_awgn_exact(Modulation.QPSK, 4.0)
    errors = int(round(bits * p + shift * np.sqrt(bits * p * (1 - p))))
    if ok:
        cs.check_awgn("t", errors, bits, Modulation.QPSK, 4.0)
    else:
        with pytest.raises(cs.PhaseFailure, match="sigma"):
            cs.check_awgn("t", errors, bits, Modulation.QPSK, 4.0)


def test_check_awgn_skips_small_counts():
    from sdr_tpu.core.config import Modulation

    cs.check_awgn("t", 0, 1000, Modulation.QPSK, 10.0)  # no theory check


@pytest.mark.parametrize("n_diff,ok", [(0, True), (1, True), (3, False)])
def test_compare_four(n_diff, ok):
    single = np.arange(2000)
    sharded = single.copy()
    sharded[:n_diff] += 1
    if ok:
        cs.compare_four("t", sharded, single)
    else:
        with pytest.raises(cs.PhaseFailure):
            cs.compare_four("t", sharded, single)


@pytest.mark.parametrize("n_diff,ok", [(0, True), (3, True), (4, False)])
def test_compare_coded_agreement(n_diff, ok):
    ref = np.full(100, 10)
    gpu = ref.copy()
    gpu[:n_diff] += 1
    if ok:
        cs.compare_coded("t", gpu, ref)
    else:
        with pytest.raises(cs.PhaseFailure):
            cs.compare_coded("t", gpu, ref)


def test_llr_gap():
    err, scale = cs.llr_gap("t", np.array([1.0, -2.5]), np.array([1.5, -2.0]))
    assert (err, scale) == (0.5, 2.0)


@pytest.mark.parametrize("seconds,share", [(1.0, 0.5), (0.5, 1.0),
                                           (0.1, None)])
def test_roofline_share_refuses_impossible_shares(seconds, share):
    # 0.5 GB at 1 GB/s: a share above ROOFLINE_SHARE_MAX means the
    # stage's bytes moved in kernels charged to other stages.
    assert cs.roofline_share(0.5e9, seconds, 1e9) == share


def test_tf32_control_lifts_and_restores_the_pins():
    from sdr_tpu.link import pipeline
    from sdr_tpu.ops import mimo, pilots

    mods = (pipeline, mimo, pilots)
    with cs.tf32_matmuls():
        assert all(m._HI is None for m in mods)
        assert jax.config.jax_default_matmul_precision == "tensorfloat32"
    assert all(m._HI == jax.lax.Precision.HIGHEST for m in mods)


def test_tree_order_prefix_sums_are_a_cumsum():
    from sdr_tpu.ops import sync

    x = jnp.arange(1.0, 9.0).reshape(2, 4)
    with cs.tree_order_prefix_sums():
        got = sync.jnp.cumsum(x, axis=-1)
    assert sync.jnp is jnp
    np.testing.assert_allclose(got, jnp.cumsum(x, axis=-1))


def test_acquisition_tolerance_witness():
    """ACQ_LLR_TOL's reason, on the CPU: the blind-acquisition receiver
    with its prefix sums in tree order moves the LLRs by more than
    LLR_TOL and by no more than ACQ_LLR_TOL (x max|LLR|)."""
    import dataclasses

    from sdr_tpu.app.baseline_configs import get_case
    from sdr_tpu.core.config import Equalizer
    from sdr_tpu.link.pipeline import make_simulate_fn

    c0 = get_case("0").cfg
    cfg = dataclasses.replace(
        c0, n_channels=cs.REF_CHANNELS, pilot_spacing=8,
        equalizer=Equalizer.MMSE,
        channel=dataclasses.replace(c0.channel, cfo_subcarriers=2.3,
                                    timing_offset=37),
    )
    key = jax.random.PRNGKey(11)
    ref = make_simulate_fn(cfg, want_llrs=True)(key).llrs
    with cs.tree_order_prefix_sums():
        wit = make_simulate_fn(cfg, want_llrs=True)(key).llrs
    err, scale = cs.llr_gap("t", wit, ref)
    assert cs.LLR_TOL * scale < err <= cs.ACQ_LLR_TOL * scale


def test_check_coded_on_the_cpu(monkeypatch):
    """The coded checks run end to end (both sides on the CPU here), and
    refuse a comparison with too few errors to be in the waterfall."""
    import functools

    from sdr_tpu.link.coded import ldpc_code_for
    from sdr_tpu.link.fast_coded import ldpc_fast_llrs, ldpc_fast_simulate
    from sdr_tpu.ops.ldpc import ldpc_decode, ldpc_encode

    monkeypatch.setattr(cs, "REF_CHANNELS", 2)
    cfg = cs._link_cfg("awgn", (256, 64, 2, 24), ebno=cs.LDPC_EBNO)
    code = ldpc_code_for("1/2")
    key = jax.random.PRNGKey(7)
    errs, _ = ldpc_fast_simulate(cfg, key, iters=3)

    def decode(llr):
        dec = ldpc_decode(code, llr, iters=3)
        return dec[:, : code.k].reshape(2, -1, code.k)

    args = (lambda ids: ldpc_fast_llrs(cfg, key, "1/2", ids),
            functools.partial(ldpc_encode, code), decode)
    monkeypatch.setattr(cs, "MIN_CODED_ERRORS", 1)
    cs._check_coded("t", errs, *args)
    monkeypatch.setattr(cs, "MIN_CODED_ERRORS", int(np.sum(errs)) + 1)
    with pytest.raises(cs.PhaseFailure, match="waterfall"):
        cs._check_coded("t", errs, *args)


def test_stage_bytes_model():
    cfg = cs._link_cfg("awgn", (256, 64, 2, 3))
    b = cs._stage_bytes(cfg, "fast")
    grid, samples = 2 * 3 * 256, 2 * 3 * 320
    assert b["channel"] == 2 * samples * 8
    assert b["demod_fft"] == samples * 8 + grid * 8
    assert set(cs._stage_bytes(cfg, "coded")) == {"decode"}


# --- trace reduction ---------------------------------------------------------


@pytest.mark.parametrize(
    "intervals,busy",
    [([(0, 10), (20, 5)], 15), ([(0, 10), (5, 10)], 15),
     ([(0, 30), (5, 10), (40, 1)], 31)],
)
def test_busy_union(intervals, busy):
    assert profile.busy_ns(intervals) == busy


def test_stage_of_and_hlo_stages():
    @jax.jit
    def f(x):
        with jax.named_scope("tx"):
            y = jnp.fft.fft(x)
        with jax.named_scope("count"):
            return jnp.sum(jnp.abs(y))

    x = jnp.ones((4, 64), jnp.complex64)
    stages = profile.hlo_stages(f.lower(x).compile().as_text())
    assert "tx" in stages.values() and "count" in stages.values()
    assert profile.stage_of("jit(f)/jit(main)/demod_tail/mul") == "demod_tail"
    assert profile.stage_of("jit(f)/mul") == "other"


def test_event_stage_reads_command_buffer_kernels():
    stages = {"loop_add_fusion_6": "channel", "fft_0": "demod_fft"}
    assert profile.event_stage("command_buffer", "loop_add_fusion_6",
                               stages) == "channel"
    assert profile.event_stage("fft.0.0", "void vector_fft<256>",
                               stages) == "demod_fft"
    assert profile.event_stage(None, "memcpy", stages) == "other"


def test_stage_report_idle_share():
    events = [(0.0, 10.0, "command_buffer", "a_1"),
              (30.0, 10.0, "command_buffer", "b"),
              (35.0, 5.0, None, "memcpy")]
    rep = profile.stage_report(events, {"a_1": "tx", "b": "count"})
    assert rep["stage_ns"] == {"tx": 10.0, "count": 10.0, "other": 5.0}
    assert rep["window_ns"] == 40.0 and rep["busy_ns"] == 20.0
    assert rep["idle_share"] == pytest.approx(0.5)


def test_trace_on_cpu_records_events(tmp_path):
    """A real trace file parses, and the GPU-plane filter yields nothing
    on a CPU run (so run_trace's "no device events" check fires)."""
    @jax.jit
    def f(x):
        return jnp.sum(x * 2.0)

    x = jnp.ones((128,))
    f(x).block_until_ready()
    with profile.trace(str(tmp_path)):
        f(x).block_until_ready()
    path = next(Path(tmp_path).rglob("*.xplane.pb"))
    assert profile.device_events(str(path)) == []
    assert json.dumps(profile.stage_report([], {}))
