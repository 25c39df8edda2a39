"""Tensor parallelism: subcarrier-split demod on the virtual CPU mesh.

Invariants:
- sharded == unsharded SAME-decomposition oracle (the all_to_all only
  moves data; bit-exactness is checked empirically and pinned);
- sharded ≈ the plain-FFT jnp chain (f32 re-association tolerance);
- hard decisions identical to the jnp chain (LLR signs robust).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax

from sdr_tpu.core.config import Modulation
from sdr_tpu.ops.demod import demod_chain
from sdr_tpu.ops.equalize import equalize_mmse
from sdr_tpu.ops.llr import llr_maxlog
from sdr_tpu.parallel import make_link_mesh
from sdr_tpu.parallel.tp import (
    _twiddle_np,
    digit_permute_h,
    digit_restore_llrs,
    make_tp_demod_fn,
    tp_split,
)


def _tp_oracle(re, im, hr, hi, cp_len, mod, noise_var, n_dev):
    """The same four-step decomposition, computed on one device."""
    b, s, sym_len = re.shape
    n_fft = sym_len - cp_len
    n1, n2 = tp_split(n_fft, n_dev)
    twr, twi = _twiddle_np(n1, n2)
    x = lax.complex(re[..., cp_len:], im[..., cp_len:]).reshape(b, s, n1, n2)
    g = jnp.fft.fft(x, axis=2)
    t = g * lax.complex(jnp.asarray(twr), jnp.asarray(twi))
    y = jnp.fft.fft(t, axis=3)
    h4 = lax.complex(
        digit_permute_h(hr, n1, n2), digit_permute_h(hi, n1, n2)
    )
    sx, eff = equalize_mmse(y, h4, noise_var)
    return digit_restore_llrs(llr_maxlog(sx, mod, eff), mod)


def _inputs(key, b, s, n_fft, cp_len, h_syms):
    kr, ki, kh1, kh2 = jax.random.split(key, 4)
    re = jax.random.normal(kr, (b, s, n_fft + cp_len), jnp.float32)
    im = jax.random.normal(ki, (b, s, n_fft + cp_len), jnp.float32)
    hr = jax.random.normal(kh1, (b, h_syms, n_fft), jnp.float32)
    hi = jax.random.normal(kh2, (b, h_syms, n_fft), jnp.float32)
    return re, im, hr, hi


@pytest.mark.parametrize("tshape,h_syms", [((8, 1), 1), ((4, 2), 1), ((2, 4), 4)])
def test_tp_matches_unsharded_oracle(tshape, h_syms):
    nt, nc = tshape
    mesh = make_link_mesh(nt, nc, devices=jax.devices()[: nt * nc])
    n_fft, cp_len = 1024, 128
    mod = Modulation.QAM16
    nv = 0.05
    re, im, hr, hi = _inputs(jax.random.PRNGKey(0), 4, 4, n_fft, cp_len, h_syms)
    fn = make_tp_demod_fn(n_fft, cp_len, mod, mesh, axis="time")
    got = np.asarray(fn(re, im, hr, hi, nv))
    want = np.asarray(_tp_oracle(re, im, hr, hi, cp_len, mod, nv, nt))
    # Not bit-exact: the pocketfft batch kernels pick different SIMD
    # paths for (n2/D)-lane vs n2-lane batches, so stage-1 results
    # differ at f32 rounding level (~1e-6 relative). Pin a tight bound
    # and exact hard-decision agreement instead.
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    assert np.array_equal(got < 0, want < 0)


@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM64])
def test_tp_matches_jnp_chain(mod):
    mesh = make_link_mesh(8, 1, devices=jax.devices())
    n_fft, cp_len = 1024, 128
    nv = 0.05
    re, im, hr, hi = _inputs(jax.random.PRNGKey(1), 2, 4, n_fft, cp_len, 1)
    fn = make_tp_demod_fn(n_fft, cp_len, mod, mesh, axis="time")
    got = np.asarray(fn(re, im, hr, hi, nv))
    want = np.asarray(
        demod_chain(re, im, hr, hi, cp_len, mod, nv)
    )
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-4 * scale)
    # Hard decisions must agree everywhere (sign-robust LLRs).
    assert np.array_equal(got < 0, want < 0)


def test_tp_split_validation():
    with pytest.raises(ValueError):
        tp_split(32, 8)  # 8² = 64 does not divide 32
    assert tp_split(1024, 8) == (8, 128)
    assert tp_split(4096, 8) == (8, 512)


def test_tp_rejects_bad_shapes():
    mesh = make_link_mesh(8, 1, devices=jax.devices())
    fn = make_tp_demod_fn(1024, 128, Modulation.QPSK, mesh, axis="time")
    re, im, hr, hi = _inputs(jax.random.PRNGKey(2), 2, 4, 1024, 64, 1)
    with pytest.raises(ValueError):
        fn(re, im, hr, hi, 0.1)  # wrong sym_len for cp mismatch


def test_tp_runtime_nv():
    """noise_var is a runtime argument: one compiled fn serves two
    Eb/N0 points, each matching the unsharded chain with identical
    hard decisions."""
    mesh = make_link_mesh(8, 1, devices=jax.devices())
    n_fft, cp_len = 1024, 128
    mod = Modulation.QAM16
    re, im, hr, hi = _inputs(jax.random.PRNGKey(3), 4, 4, n_fft, cp_len, 1)
    fn = make_tp_demod_fn(n_fft, cp_len, mod, mesh)
    for nv in (0.05, 0.2):
        got = np.asarray(fn(re, im, hr, hi, nv))
        want = np.asarray(demod_chain(re, im, hr, hi, cp_len, mod, nv))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-4 * scale)
        assert np.array_equal(got < 0, want < 0)
    assert fn._cache_size() == 1


@pytest.mark.parametrize("n_dev", [2, 4])
def test_tp_fewer_devices_matches_unsharded(n_dev):
    """The 4-way split the four-GPU check runs, and 2-way, at 4096sc."""
    mesh = make_link_mesh(n_dev, 1, devices=jax.devices()[:n_dev])
    n_fft, cp_len, mod = 4096, 512, Modulation.QAM16
    re, im, hr, hi = _inputs(jax.random.PRNGKey(5), 2, 2, n_fft, cp_len, 1)
    got = np.asarray(make_tp_demod_fn(n_fft, cp_len, mod, mesh)(
        re, im, hr, hi, 0.05))
    want = np.asarray(demod_chain(re, im, hr, hi, cp_len, mod, 0.05))
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_tp_legacy_baked_noise_var():
    mesh = make_link_mesh(8, 1, devices=jax.devices())
    re, im, hr, hi = _inputs(jax.random.PRNGKey(4), 2, 4, 1024, 128, 1)
    fn = make_tp_demod_fn(1024, 128, Modulation.QPSK, mesh,
                          noise_var=0.1)
    fn2 = make_tp_demod_fn(1024, 128, Modulation.QPSK, mesh)
    np.testing.assert_allclose(
        np.asarray(fn(re, im, hr, hi)),
        np.asarray(fn2(re, im, hr, hi, 0.1)),
        rtol=1e-6, atol=1e-6,
    )
