"""Polar codes: construction, butterfly encoder, SC and CA-SCL decoders.

The third FEC family (next to the convolutional code + Viterbi in
ops.fec and the QC-LDPC + min-sum in ops.ldpc — together the classic /
5G-data / 5G-control roster). The reference has no channel coding at
all (its loopback decodes exactly, QFDemoWindow.cpp:201-224); this is
north-star capability. As soft-decision FEC it replaces the
reference's hard-decision nearest-point scan
(/root/reference/lib/inc/modulation.hpp:50-67).

Shape discipline:
- the ENCODER is the n-stage butterfly x = u·F^{⊗n} (F = [[1,0],[1,1]],
  natural bit order) — log2(N) vectorized XOR stages, batched over
  codewords; no bit-reversal anywhere (both ends use the same natural-
  order transform, so the permutation cancels by construction).
- the SC DECODER is one ``lax.scan`` over the N leaf bits carrying
  static-shape LLR/partial-sum planes of (n+1, N). The depth pattern
  per bit (how far to climb with a ``g`` update, how many ``f``
  descents follow, how many partial-sum merges close) depends only on
  the bit INDEX — so it is precomputed as static tables and dispatched
  with ``lax.switch`` over n+1 fixed-shape branches. All segment
  widths are static Python ints (N/2^d at depth d).
- the SCL DECODER treats the LIST as one more leading batch axis on
  the same planes ((L, n+1, N)); forking is a concatenation of the
  stay/flip path metrics and one ``lax.top_k`` per bit, survivor
  states gathered by parent index. Inactive list slots are modelled as
  paths with a huge metric — no dynamic list growth, static shapes
  throughout. CRC-aided selection is a GF(2) syndrome matmul over the
  final list (the CRC is linear, so validity is ``info @ M == 0`` for
  a precomputed matrix M).
- min-sum (max-log) f/g updates in float32, the same approximation
  family as the max-log LLR demapper and the min-sum LDPC decoder;
  path-metric penalties use the standard |LLR|-on-disagreement
  approximation.

SC/SCL are inherently bit-serial (the decision for bit i feeds the
partial sums bit i+1 needs) — the scan IS the algorithm, not a
compromise; the codeword and list axes provide the data parallelism
(vmap/batch), which is where the device's parallelism goes. This decoder is the
capability/BER-parity path, not a throughput kernel.

Constructions:
- Bhattacharyya-parameter recursion (Arikan's BEC heuristic):
  z -> {2z - z², z²} (``polar_construct``), kept for the SC oracle
  tests;
- Gaussian approximation for BPSK-AWGN density evolution
  (``polar_construct_ga``): track the mean LLR m, worse child
  phi_inv(1 - (1 - phi(m))²), better child 2m, with Chung's phi
  approximation — the production default (``make_polar_code``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _require_pow2(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"polar block length must be a power of 2, got {n}")
    return int(n).bit_length() - 1


@functools.lru_cache(maxsize=None)
def polar_construct(block_len: int, k: int, design_z: float = 0.5):
    """Info-bit positions for a (block_len, k) polar code.

    Bhattacharyya recursion from z = design_z: at each polarization
    level the parameter splits into the worse channel 2z − z² and the
    better channel z². The k positions with the SMALLEST final z carry
    information; the rest are frozen to 0. Returns (info_idx, frozen
    mask) as numpy (static tables).
    """
    n = _require_pow2(block_len)
    if not 1 <= k <= block_len:
        raise ValueError(f"k must be in [1, {block_len}], got {k}")
    z = np.array([design_z], dtype=np.float64)
    for _ in range(n):
        nz = np.empty(2 * z.size, np.float64)
        # Standard recursion W_{2N}^{(2j)} = worse(W_N^{(j)}),
        # W_{2N}^{(2j+1)} = better(W_N^{(j)}) — INTERLEAVED, not
        # concatenated: worse/better do not commute, and genie-aided
        # per-position error measurements on this encoder match the
        # interleaved order (concat permutes reliabilities and costs
        # several dB at N >= 512).
        nz[0::2] = 2.0 * z - z * z
        nz[1::2] = z * z
        z = nz
    # z[i] is the Bhattacharyya parameter of synthetic channel i in
    # natural (encoder-input) order. Stable argsort keeps ties
    # deterministic.
    order = np.argsort(z, kind="stable")
    info_idx = np.sort(order[:k]).astype(np.int32)
    frozen = np.ones(block_len, dtype=bool)
    frozen[info_idx] = False
    return info_idx, frozen


def polar_encode(u: jnp.ndarray) -> jnp.ndarray:
    """x = u · F^{⊗n} over GF(2), natural order. u: int8 (..., N)."""
    N = u.shape[-1]
    n = _require_pow2(N)
    x = u
    for s in range(n):
        step = 1 << s
        shp = x.shape[:-1] + (N // (2 * step), 2, step)
        xb = x.reshape(shp)
        top = jnp.bitwise_xor(xb[..., 0, :], xb[..., 1, :])
        x = jnp.stack([top, xb[..., 1, :]], axis=-2).reshape(u.shape)
    return x


def polar_encode_info(info: jnp.ndarray, block_len: int) -> jnp.ndarray:
    """Info bits (..., k) → codeword (..., block_len) with frozen 0s."""
    k = info.shape[-1]
    info_idx, _ = polar_construct(block_len, k)
    u = jnp.zeros(info.shape[:-1] + (block_len,), jnp.int8)
    u = u.at[..., jnp.asarray(info_idx)].set(info.astype(jnp.int8))
    return polar_encode(u)


def _f_minsum(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Check-node (left-child) update: sgn(a)sgn(b)·min(|a|,|b|)."""
    return jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))


def _g(a: jnp.ndarray, b: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Variable-node (right-child) update: b + (1−2s)·a, s the left-
    subtree partial sum."""
    return b + (1.0 - 2.0 * s.astype(jnp.float32)) * a


@functools.lru_cache(maxsize=None)
def _sc_tables(block_len: int):
    """Static per-bit dispatch tables: trailing zeros (g-depth) and
    trailing ones (partial-sum merge count) of each leaf index."""
    idx = np.arange(block_len)
    tz = np.zeros(block_len, np.int32)
    to = np.zeros(block_len, np.int32)
    for i in range(1, block_len):
        v = i
        while v % 2 == 0:
            tz[i] += 1
            v //= 2
        v = i
        while v % 2 == 1:
            to[i] += 1
            v //= 2
    return idx, tz, to


def polar_decode_sc(
    llr: jnp.ndarray, block_len: int, k: int
) -> jnp.ndarray:
    """Successive-cancellation decode. llr: float32 (..., block_len)
    channel LLRs (positive ⇒ bit 0, the framework's demapper
    convention). Returns the decoded INFO bits int8 (..., k)."""
    if llr.shape[-1] != block_len:
        raise ValueError(
            f"llr last axis {llr.shape[-1]} != block_len {block_len}"
        )
    n = _require_pow2(block_len)
    info_idx, frozen = polar_construct(block_len, k)
    frozen_j = jnp.asarray(frozen)

    batch = llr.shape[:-1]
    flat = llr.reshape((-1, block_len)).astype(jnp.float32)

    N = block_len
    _, tz_tab, to_tab = _sc_tables(N)
    tz_tab = jnp.asarray(np.minimum(tz_tab, n))
    to_tab = jnp.asarray(to_tab)

    def f_descend(L, d_from):
        """f-updates from depth d_from..n (static unroll)."""
        for d in range(d_from, n + 1):
            w = N >> d
            seg = L[d - 1, : 2 * w]
            L = L.at[d, :w].set(_f_minsum(seg[:w], seg[w : 2 * w]))
        return L

    def decode_one(ch_llr):
        # L[d, :N>>d] — the CURRENT path's LLRs at depth d (each depth
        # is revisited strictly left-to-right, so one segment per depth
        # suffices). B[d] — partial sums (each node's ENCODED bits) at
        # their NATURAL positions: node j at depth d owns
        # B[d, j·w:(j+1)·w], w = N>>d — left siblings leave the current
        # path, so they need a home addressed by node index.
        L = jnp.zeros((n + 1, N), jnp.float32).at[0].set(ch_llr)
        B = jnp.zeros((n + 1, N), jnp.int8)
        u = jnp.zeros((N,), jnp.int8)

        # Bit 0: full left descent.
        L = f_descend(L, 1)

        def make_g_branch(t):
            # t = trailing zeros of i: the path from bit i-1 to bit i
            # turns right at depth a = n - t (one g update against the
            # left sibling's stored sums), then f-descends to the leaf.
            a = n - t

            def branch(i, L, B):
                w = N >> a
                j = lax.shift_right_logical(i, n - a)  # odd node index
                left = lax.dynamic_slice(B[a], ((j - 1) * w,), (w,))
                seg = L[a - 1, : 2 * w]
                L = L.at[a, :w].set(_g(seg[:w], seg[w : 2 * w], left))
                return f_descend(L, a + 1)

            return branch

        # t = n only occurs at i = 0 (handled before the scan); a no-op
        # stand-in keeps every lax.switch branch traceable.
        g_branches = [make_g_branch(t) for t in range(n)] + [
            lambda i, L, B: L
        ]

        def make_merge_branch(t):
            # t = trailing ones of i: bit i closes t right children;
            # merge each with its stored left sibling into the parent's
            # slot: parent = [left ⊕ right, right] (the node's own
            # encoded bits, per x = (p ⊕ q, q)).
            def branch(i, B):
                for d in range(n, n - t, -1):
                    w = N >> d
                    j = lax.shift_right_logical(i, n - d)  # odd
                    start = (j - 1) * w
                    pair = lax.dynamic_slice(B[d], (start,), (2 * w,))
                    merged = jnp.concatenate(
                        [jnp.bitwise_xor(pair[:w], pair[w:]), pair[w:]]
                    )
                    B = B.at[d - 1].set(
                        lax.dynamic_update_slice(B[d - 1], merged, (start,))
                    )
                return B

            return branch

        merge_branches = [make_merge_branch(t) for t in range(n + 1)]

        def leaf(i, L, B, u):
            dec = jnp.where(
                frozen_j[i], jnp.int8(0), (L[n, 0] < 0).astype(jnp.int8)
            )
            u = u.at[i].set(dec)
            B = B.at[n, i].set(dec)
            B = lax.switch(to_tab[i], merge_branches, i, B)
            return B, u

        B, u = leaf(jnp.int32(0), L, B, u)

        def step(carry, i):
            L, B, u = carry
            L = lax.switch(tz_tab[i], g_branches, i, L, B)
            B, u = leaf(i, L, B, u)
            return (L, B, u), ()

        (L, B, u), _ = lax.scan(
            step, (L, B, u), jnp.arange(1, N, dtype=jnp.int32)
        )
        return u

    u_all = jax.vmap(decode_one)(flat)
    info = u_all[:, jnp.asarray(info_idx)]
    return info.reshape(batch + (k,))


# ---------------------------------------------------------------------------
# Gaussian-approximation construction (BPSK-AWGN density evolution).

# phi() underflows to exactly 0.0 past ~3000 (exp(-m/4) leaves float64
# range); clamping keeps phi_inv's bracket well-conditioned. Channels
# at the clamp are "perfect" — their relative order no longer matters.
_GA_M_MAX = 2800.0


def _ga_phi(m: float) -> float:
    """Chung et al.'s approximation of E[tanh(L/2)]-style phi(m):
    decreasing, phi(0)=1, phi(inf)=0."""
    if m <= 1e-12:
        return 1.0
    if m < 10.0:
        return math.exp(-0.4527 * m**0.86 + 0.0218)
    return math.sqrt(math.pi / m) * math.exp(-m / 4.0) * (1.0 - 10.0 / (7.0 * m))


def _ga_phi_inv(y: float) -> float:
    """Inverse of _ga_phi on [0, _GA_M_MAX] by bisection (phi is
    strictly decreasing)."""
    if y >= 1.0:
        return 0.0
    lo, hi = 0.0, _GA_M_MAX
    if _ga_phi(hi) >= y:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _ga_phi(mid) > y:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


@functools.lru_cache(maxsize=None)
def polar_construct_ga(block_len: int, k: int, design_snr_db: float = 2.0):
    """Info-bit positions via the Gaussian approximation.

    Models each synthetic channel's LLR as N(m, 2m) and density-evolves
    the mean: worse (f) child m' = phi_inv(1 - (1 - phi(m))²), better
    (g) child m' = 2m, from the channel mean m0 = 4·Es/N0 (BPSK, Es=1,
    sigma² = N0/2 per dim → E[2y/sigma²] = 4·Es/N0). The k positions
    with the LARGEST final mean carry information. design_snr_db is
    Es/N0 per coded bit in dB.
    """
    n = _require_pow2(block_len)
    if not 1 <= k <= block_len:
        raise ValueError(f"k must be in [1, {block_len}], got {k}")
    m0 = 4.0 * 10.0 ** (design_snr_db / 10.0)
    m = np.array([min(m0, _GA_M_MAX)], dtype=np.float64)
    for _ in range(n):
        nm = np.empty(2 * m.size, np.float64)
        # Interleaved recursion (see polar_construct): index parity,
        # not half, selects worse/better — validated against
        # genie-aided per-position error rates on this encoder.
        nm[0::2] = [_ga_phi_inv(1.0 - (1.0 - _ga_phi(x)) ** 2) for x in m]
        nm[1::2] = np.minimum(2.0 * m, _GA_M_MAX)
        m = nm
    # Largest mean = most reliable; stable sort keeps ties (clamped
    # channels) deterministic.
    order = np.argsort(-m, kind="stable")
    info_idx = np.sort(order[:k]).astype(np.int32)
    frozen = np.ones(block_len, dtype=bool)
    frozen[info_idx] = False
    return info_idx, frozen


# ---------------------------------------------------------------------------
# CRC as GF(2) linear algebra (the CRC of a zero-initialized LFSR is
# linear in the message, so both generation and syndrome checking are
# precomputed matrices — one int matmul per codeword on device).

#: CRC polynomials by name: (degree, coefficient bits below the top
#: term, MSB first). crc11 is 5G NR's g(x)=x^11+x^10+x^9+x^5+1.
_CRC_POLYS = {
    "crc8": (8, 0x9B),   # x^8+x^4+x^3+x+1 (ITU I.432.1 without the +1 form)
    "crc11": (11, 0x621),
    "crc16": (16, 0x1021),  # CCITT x^16+x^12+x^5+1
}


def _crc_lfsr_matrix(msg_len: int, crc_name: str) -> np.ndarray:
    """(msg_len, c) GF(2) matrix M with CRC(msg) = msg @ M (mod 2):
    column j of row i is the j-th CRC bit of the i-th unit message.
    Computed by running the MSB-first LFSR over each basis vector."""
    c, low = _CRC_POLYS[crc_name]
    taps = np.array([(low >> (c - 1 - j)) & 1 for j in range(c)], np.int8)
    M = np.zeros((msg_len, c), np.int8)
    for i in range(msg_len):
        reg = np.zeros(c, np.int8)
        for pos in range(msg_len):
            b = 1 if pos == i else 0
            fb = reg[0] ^ b
            reg = np.concatenate([reg[1:], np.zeros(1, np.int8)])
            if fb:
                reg ^= taps
        M[i] = reg
    return M


@functools.lru_cache(maxsize=None)
def crc_matrices(payload_len: int, crc_name: str):
    """(gen, chk): gen (payload_len, c) with crc = payload @ gen; chk
    (payload_len + c, c) with syndrome = (payload‖crc) @ chk == 0 iff
    the CRC is consistent (appending the remainder zeroes the LFSR)."""
    c, _ = _CRC_POLYS[crc_name]
    gen = _crc_lfsr_matrix(payload_len, crc_name)
    chk = _crc_lfsr_matrix(payload_len + c, crc_name)
    return gen, chk


# ---------------------------------------------------------------------------
# PolarCode: the static descriptor the encoder/decoder pair shares.


@dataclasses.dataclass(frozen=True)
class PolarCode:
    """Static (trace-time) polar code descriptor.

    block_len = N, k = info POSITIONS (payload + CRC bits), crc: name
    from _CRC_POLYS or None. payload_len = k - crc_len is what users
    send/count. Arrays are numpy (static tables baked into the jitted
    program).
    """

    block_len: int
    k: int
    crc: str | None
    info_idx: np.ndarray = dataclasses.field(compare=False)
    frozen: np.ndarray = dataclasses.field(compare=False)

    @property
    def crc_len(self) -> int:
        return _CRC_POLYS[self.crc][0] if self.crc else 0

    @property
    def payload_len(self) -> int:
        return self.k - self.crc_len

    @property
    def rate(self) -> float:
        return self.payload_len / self.block_len


@functools.lru_cache(maxsize=None)
def make_polar_code(
    block_len: int,
    k: int,
    crc: str | None = "crc11",
    design_snr_db: float = 2.0,
    construction: str = "ga",
) -> PolarCode:
    """Build the production code: GA construction by default, CRC-11
    inside the k info positions (payload = k - 11 bits)."""
    if crc is not None and crc not in _CRC_POLYS:
        raise ValueError(f"crc must be one of {sorted(_CRC_POLYS)} or None")
    c = _CRC_POLYS[crc][0] if crc else 0
    if k - c < 1:
        raise ValueError(
            f"k={k} leaves no payload after a {c}-bit CRC"
        )
    if construction == "ga":
        info_idx, frozen = polar_construct_ga(block_len, k, design_snr_db)
    elif construction == "bhattacharyya":
        info_idx, frozen = polar_construct(block_len, k)
    else:
        raise ValueError("construction must be 'ga' or 'bhattacharyya'")
    return PolarCode(block_len, k, crc, info_idx, frozen)


def polar_encode_payload(payload: jnp.ndarray, code: PolarCode) -> jnp.ndarray:
    """Payload bits (..., payload_len) → codeword (..., N): append the
    CRC (GF(2) matmul), scatter into the info positions, butterfly."""
    if payload.shape[-1] != code.payload_len:
        raise ValueError(
            f"payload last axis {payload.shape[-1]} != {code.payload_len}"
        )
    info = payload.astype(jnp.int8)
    if code.crc_len:
        gen, _ = crc_matrices(code.payload_len, code.crc)
        crc = jnp.mod(
            payload.astype(jnp.int32) @ jnp.asarray(gen, jnp.int32), 2
        ).astype(jnp.int8)
        info = jnp.concatenate([info, crc], axis=-1)
    u = jnp.zeros(payload.shape[:-1] + (code.block_len,), jnp.int8)
    u = u.at[..., jnp.asarray(code.info_idx)].set(info)
    return polar_encode(u)


def _rate0_penalty(alpha: jnp.ndarray) -> jnp.ndarray:
    """EXACT bitwise-equivalent path-metric increment of an all-frozen
    subtree, computed in log2(W) parallel steps.

    With every decision 0 the partial sums are all 0, so the subtree's
    leaf LLRs are a deterministic f/g cascade of the node LLRs —
    computable depth-parallel: each level maps every segment (a‖b) to
    the pair (minsum(a,b), a+b). The penalty Σ_leaf max(−λ_leaf, 0) is
    order-invariant, so segment ordering never matters. alpha:
    (Lw, W) → (Lw,) float32 increment, identical to what the bit-serial
    decoder accumulates over the subtree's W frozen leaves.
    """
    Lw = alpha.shape[0]
    x = alpha[:, None, :]  # (Lw, segments, seg_width)
    while x.shape[-1] > 1:
        w = x.shape[-1] // 2
        a = x[..., :w]
        b = x[..., w:]
        x = jnp.concatenate([_f_minsum(a, b), a + b], axis=1)
    return jnp.sum(jnp.maximum(-x.reshape(Lw, -1), 0.0), axis=-1)


# Survivor selection is represented as a ONE-HOT matrix S (Lw, Lw)
# f32 — new_path l = old_path argmax(S[l]) — applied as small dense
# products instead of per-path index gathers, so every selection is a
# batched elementwise/reduce over (Lw, Lw, W) with no data-dependent
# addressing.


def _selmm(S, arr, exact: bool = True):
    """arr' = S @ arr (S one-hot). ``exact`` payloads carry f32 VALUES
    (path metrics, LLR planes, position tables > 256), which a reduced-
    precision matmul (TF32 or bf16, an accelerator's default for f32
    operands) would truncate — they are selected by an explicit
    broadcast-multiply-reduce instead, f32-exact on any backend. 0/1
    payloads (decisions, flips, selection composition) are exact in
    TF32 and bf16 and ride the default matmul precision."""
    if exact:
        return jnp.sum(S[:, :, None] * arr[None, :, :], axis=1)
    return jnp.matmul(S, arr)


def _sel_f(arr, S):
    return arr if S is None else _selmm(S, arr)


def _sel_i8(arr, S):
    if S is None:
        return arr
    # 0/1 payload: bf16-exact, default-precision pass.
    return _selmm(S, arr.astype(jnp.float32), exact=False).astype(jnp.int8)


def _compose(S1, S2):
    """Composition of selections applied first-S1-then-S2."""
    if S1 is None:
        return S2
    if S2 is None:
        return S1
    return _selmm(S2, S1, exact=False)  # 0/1 payload


def _rate1_node(alpha, pm, Lw: int, BIG):
    """Exact SCL handling of an all-information node (fast-SSCL,
    Hashemi et al.): hard-decide every bit, then fork sequentially on
    the τ = min(L−1, W) LEAST-RELIABLE positions (each path sorts its
    own |λ|) — provably yields the same L survivors and metrics as
    forking bit-by-bit through the subtree under the min-sum/LLR path
    metric. Returns (beta (Lw, W) int8 node codeword, pm, S) with S
    the one-hot survivor selection (or None).
    """
    W = alpha.shape[-1]
    absl = jnp.abs(alpha)
    dec0 = (alpha < 0.0).astype(jnp.float32)
    tau = min(Lw - 1, W)
    if tau == 0:
        return dec0.astype(jnp.int8), pm, None
    # Only the τ least-reliable positions can fork: top_k of −|λ|
    # instead of a full W-wide sort (W can be 256; τ = L−1).
    neg_pen, order = lax.top_k(-absl, tau)  # (Lw, τ) each
    pen = -neg_pen
    order_f = order.astype(jnp.float32)
    lanes = jnp.arange(Lw)
    S = None
    flips = jnp.zeros((Lw, tau), jnp.float32)
    # Per-fork state stays τ-wide: the W-wide decision plane is
    # reconstructed ONCE at node end from (S, order, flips).
    for t in range(tau):
        cat = jnp.concatenate([pm, pm + pen[:, t]])
        neg_top, idx = lax.top_k(-cat, Lw)
        parent = jnp.mod(idx, Lw)
        flip = (idx >= Lw).astype(jnp.float32)
        pm = -neg_top
        P = (parent[:, None] == lanes[None, :]).astype(jnp.float32)
        # order values < W: bf16-exact up to 256.
        order_f = _selmm(P, order_f, exact=W > 256)
        pen = _selmm(P, pen)  # f32 metric values: exact pass
        flips = _selmm(P, flips, exact=False)  # 0/1
        col = jnp.asarray(
            (np.arange(tau) == t).astype(np.float32)
        )
        flips = flips * (1.0 - col) + flip[:, None] * col
        S = _compose(S, P)
    dec = _selmm(S, dec0, exact=False) if S is not None else dec0  # 0/1
    # Flip positions are distinct per path (order rows are distinct
    # indices), so the XOR of 0/1 one-hots is |dec − Σ one-hots|.
    cols = jnp.arange(W, dtype=jnp.float32)
    oh = (order_f[:, :, None] == cols[None, None, :]).astype(
        jnp.float32
    ) * flips[:, :, None]
    dec = jnp.abs(dec - jnp.sum(oh, axis=1))
    return dec.astype(jnp.int8), pm, S


def polar_decode_scl_fast(
    llr: jnp.ndarray, code: PolarCode, list_size: int = 8
) -> jnp.ndarray:
    """Fast-SSCL CRC-aided list decode — the THROUGHPUT polar decoder.

    Same contract as ``polar_decode_scl`` (decision-parity tested), but
    the bit-serial scan is replaced by a trace-time recursion over the
    code tree pruned at special nodes:

    - **rate-0** (all frozen): no fork; the EXACT bitwise metric in
      log2(W) parallel steps (``_rate0_penalty``).
    - **rate-1** (all info): τ = min(L−1, W) sorted forks
      (``_rate1_node``), exact per the fast-SSCL theorem; the node's
      u-bits are one W-wide butterfly of its codeword (F^{⊗} is an
      involution).
    - anything mixed recurses (REP/SPC therefore collapse into a
      log-factor chain of rate-0/rate-1 nodes + one leaf).

    Everything is STATIC: no lax.scan, no lax.switch, no dynamic
    slices — the tree is known at trace time, so XLA sees a straight
    dataflow of small static-shape ops whose live state is a few
    (L, W) planes per recursion level, instead of the scan decoder's
    (L, n+1, N)-plane carry crossing device memory once per bit. Survivor reordering composes a permutation up the
    recursion; each level gathers only its own pending arrays.
    """
    N, k = code.block_len, code.k
    if llr.shape[-1] != N:
        raise ValueError(f"llr last axis {llr.shape[-1]} != block_len {N}")
    if list_size < 1:
        raise ValueError(f"list_size must be >= 1, got {list_size}")
    _require_pow2(N)
    Lw = int(list_size)
    BIG = jnp.float32(1e30)
    CRC_PENALTY = jnp.float32(1e15)
    frozen = np.asarray(code.frozen, bool)
    info_idx_j = jnp.asarray(code.info_idx)

    batch = llr.shape[:-1]
    flat = llr.reshape((-1, N)).astype(jnp.float32)

    def node(fz: np.ndarray, alpha, pm):
        """→ (beta, u, pm, perm); beta/u (Lw, W) int8."""
        W = alpha.shape[-1]
        if not fz.any():  # rate-1
            beta, pm, perm = _rate1_node(alpha, pm, Lw, BIG)
            u = beta if W == 1 else polar_encode(beta)  # F^{⊗} involution
            return beta, u, pm, perm
        if fz.all():  # rate-0
            pm = pm + _rate0_penalty(alpha)
            z = jnp.zeros((Lw, W), jnp.int8)
            return z, z, pm, None
        if W == 1:  # mixed never reaches W=1, but keep the leaf exact
            raise AssertionError("unreachable: width-1 node is pure")
        w2 = W // 2
        al = _f_minsum(alpha[:, :w2], alpha[:, w2:])
        bl, ul, pm, S1 = node(fz[:w2], al, pm)
        a_in = _sel_f(alpha, S1)
        ar = _g(a_in[:, :w2], a_in[:, w2:], bl)
        br, ur, pm, S2 = node(fz[w2:], ar, pm)
        bl = _sel_i8(bl, S2)
        ul = _sel_i8(ul, S2)
        beta = jnp.concatenate([jnp.bitwise_xor(bl, br), br], axis=-1)
        u = jnp.concatenate([ul, ur], axis=-1)
        return beta, u, pm, _compose(S1, S2)

    def decode_one(ch_llr):
        alpha = jnp.broadcast_to(ch_llr, (Lw, N))
        # Only path 0 is live initially; the first fork grows the list.
        pm = jnp.full((Lw,), BIG, jnp.float32).at[0].set(0.0)
        _, u, pm, _ = node(frozen, alpha, pm)
        info = u[:, info_idx_j]  # (Lw, k)
        if code.crc_len:
            _, chk = crc_matrices(code.payload_len, code.crc)
            # f32 matmul of 0/1 operands with f32 accumulation: exact
            # at the default precision (0/1 is exact in TF32 and bf16,
            # counts ≤ k < 2^24).
            syn = jnp.mod(
                jnp.matmul(
                    info.astype(jnp.float32), jnp.asarray(chk, jnp.float32)
                ),
                2.0,
            )
            ok = jnp.all(syn == 0.0, axis=-1)
            sel = pm + jnp.where(ok, jnp.float32(0.0), CRC_PENALTY)
        else:
            sel = pm
        best = jnp.argmin(sel)
        return info[best, : code.payload_len]

    payload = jax.vmap(decode_one)(flat)
    return payload.reshape(batch + (code.payload_len,))


def polar_decode_scl(
    llr: jnp.ndarray, code: PolarCode, list_size: int = 8
) -> jnp.ndarray:
    """CRC-aided successive-cancellation LIST decode.

    llr: float32 (..., N) channel LLRs (positive ⇒ bit 0). Returns the
    decoded PAYLOAD bits int8 (..., payload_len): the lowest-metric
    path whose CRC checks, falling back to the lowest-metric path if
    none does (plain SCL when code.crc is None; plain SC at
    list_size=1).

    The list is a leading axis of the same (n+1, N) LLR/partial-sum
    planes the SC decoder scans; each bit forks every path into
    stay/flip with path-metric penalty |leaf LLR| on the decision that
    disagrees with the LLR sign, and one lax.top_k keeps the best
    list_size of the 2·list_size candidates (frozen bits force the
    flip candidates out with a huge penalty — the scan body stays
    uniform, no per-bit cond). Inactive slots start at metric BIG so
    the list "grows" implicitly while shapes stay static.
    """
    N, k = code.block_len, code.k
    if llr.shape[-1] != N:
        raise ValueError(f"llr last axis {llr.shape[-1]} != block_len {N}")
    if list_size < 1:
        raise ValueError(f"list_size must be >= 1, got {list_size}")
    n = _require_pow2(N)
    Lw = int(list_size)
    BIG = jnp.float32(1e30)
    CRC_PENALTY = jnp.float32(1e15)

    frozen_j = jnp.asarray(code.frozen)
    info_idx_j = jnp.asarray(code.info_idx)

    _, tz_tab, to_tab = _sc_tables(N)
    tz_tab = np.minimum(tz_tab, n)
    tz_tab[0] = n  # bit 0 takes the full-descent branch (see below)
    tz_tab = jnp.asarray(tz_tab)
    to_tab = jnp.asarray(to_tab)

    batch = llr.shape[:-1]
    flat = llr.reshape((-1, N)).astype(jnp.float32)

    # Carry layout: PER-DEPTH arrays, not one (n+1, N) plane. Every
    # depth the algorithm touches is REPLACED WHOLE (the f/g update at
    # depth d consumes exactly the two halves of depth d-1's full
    # array), so no in-scan slice-update of a large buffer exists —
    # the monolithic-plane version spent ~100x the arithmetic cost
    # copying the whole (Lw, n+1, N) plane for every `.at[d, :w].set`
    # inside every unrolled branch. Ls[d]: (Lw, N >> d) float32;
    # Bs[d]: (Lw, N) int8 (node j of depth d owns [j·w, (j+1)·w)).

    def f_descend(Ls, d_from):
        Ls = list(Ls)
        for d in range(d_from, n + 1):
            w = N >> d
            prev = Ls[d - 1]  # (Lw, 2w) — full array, static halves
            Ls[d] = _f_minsum(prev[:, :w], prev[:, w:])
        return tuple(Ls)

    def make_g_branch(t):
        a = n - t

        def branch(i, Ls, Bs):
            w = N >> a
            j = lax.shift_right_logical(i, n - a)
            # Left sibling's partial sums live at node j-1 of depth a.
            left = jax.vmap(
                lambda b: lax.dynamic_slice(b, ((j - 1) * w,), (w,))
            )(Bs[a])
            prev = Ls[a - 1]
            Ls = list(Ls)
            Ls[a] = _g(prev[:, :w], prev[:, w:], left)
            return f_descend(tuple(Ls), a + 1)

        return branch

    def make_merge_branch(t):
        def branch(i, Bs):
            Bs = list(Bs)
            for d in range(n, n - t, -1):
                w = N >> d
                j = lax.shift_right_logical(i, n - d)
                start = (j - 1) * w

                def one(bd, bprev):
                    pair = lax.dynamic_slice(bd, (start,), (2 * w,))
                    merged = jnp.concatenate(
                        [jnp.bitwise_xor(pair[:w], pair[w:]), pair[w:]]
                    )
                    return lax.dynamic_update_slice(bprev, merged, (start,))

                Bs[d - 1] = jax.vmap(one)(Bs[d], Bs[d - 1])
            return tuple(Bs)

        return branch

    # Branch roster: the t = n slot (only bit 0) is the initial full
    # descent, so ONE uniform scan covers i = 0..N-1. The list axis is
    # already the leading axis of every per-depth array — no vmap
    # needed on the L side.
    g_branches = [make_g_branch(t) for t in range(n)] + [
        lambda i, Ls, Bs: f_descend(Ls, 1)
    ]
    merge_branches = [make_merge_branch(t) for t in range(n + 1)]

    def decode_one(ch_llr):
        Ls = tuple(
            jnp.broadcast_to(ch_llr, (Lw, N))
            if d == 0
            else jnp.zeros((Lw, N >> d), jnp.float32)
            for d in range(n + 1)
        )
        Bs = tuple(jnp.zeros((Lw, N), jnp.int8) for _ in range(n + 1))
        u = jnp.zeros((Lw, N), jnp.int8)
        pm = jnp.full((Lw,), BIG, jnp.float32).at[0].set(0.0)

        def step(carry, i):
            Ls, Bs, u, pm = carry
            Ls = lax.switch(tz_tab[i], g_branches, i, Ls, Bs)
            leaf = Ls[n][:, 0]
            # Penalty |LLR| for deciding against the LLR's sign.
            c0 = pm + jnp.maximum(-leaf, 0.0)
            c1 = (
                pm
                + jnp.maximum(leaf, 0.0)
                + jnp.where(frozen_j[i], BIG, jnp.float32(0.0))
            )
            neg_top, idx = lax.top_k(-jnp.concatenate([c0, c1]), Lw)
            parent = jnp.mod(idx, Lw)
            dec = (idx >= Lw).astype(jnp.int8)
            # Survivor gather: depth 0 of Ls is list-invariant (the
            # channel LLRs) and the deeper arrays are tiny (N >> d).
            Ls = tuple(Ls[0:1]) + tuple(a[parent] for a in Ls[1:])
            Bs = tuple(b[parent] for b in Bs)
            u = u[parent].at[:, i].set(dec)
            Bs = Bs[:n] + (
                Bs[n].at[:, i].set(dec),
            )
            Bs = lax.switch(to_tab[i], merge_branches, i, Bs)
            return (Ls, Bs, u, -neg_top), ()

        (Ls, Bs, u, pm), _ = lax.scan(
            step, (Ls, Bs, u, pm), jnp.arange(N, dtype=jnp.int32)
        )

        info = u[:, info_idx_j]  # (Lw, k)
        if code.crc_len:
            _, chk = crc_matrices(code.payload_len, code.crc)
            syn = jnp.mod(
                info.astype(jnp.int32) @ jnp.asarray(chk, jnp.int32), 2
            )
            ok = jnp.all(syn == 0, axis=-1)
            sel = pm + jnp.where(ok, jnp.float32(0.0), CRC_PENALTY)
        else:
            sel = pm
        best = jnp.argmin(sel)
        return info[best, : code.payload_len]

    payload = jax.vmap(decode_one)(flat)
    return payload.reshape(batch + (code.payload_len,))
