"""Quasi-cyclic LDPC codes: construction, encode, min-sum decode.

The modern-FEC counterpart of ops/fec.py's convolutional/Viterbi stack
(the reference library has no FEC at all — its 16-QAM Gray comment
merely gestures at coded systems, modulation.hpp:25-27). Everything is
designed around the quasi-cyclic structure:

- **Code**: H is an (mb × nb) base matrix of Z×Z blocks, each either
  zero or a cyclic shift of I. The lifting size Z defaults to 128, so
  every per-block message is a (batch, Z) plane and a cyclic shift is
  two slices + a concat along the Z axis.
- **Construction** (`make_qc_ldpc`): information part with fixed column
  weight 3 and seeded random shifts, retried until the lifted graph has
  no 4-cycles (girth ≥ 6: for every pair of rows sharing two columns,
  the shift differences must differ mod Z); parity part is the IEEE-
  style block lower-bidiagonal T (T[c][c] = T[c+1][c] = I), so H is
  full-rank by construction and encoding is forward substitution.
- **Encode** (`ldpc_encode`): r = A·s over GF(2) (trace-unrolled block
  rotates + XOR on int8 lanes), then p_i = p_{i-1} ⊕ r_i down the
  bidiagonal — O(edges) lane ops, no generator matrix materialized.
- **Decode** (`ldpc_decode`): offset min-sum, flooding or layered
  schedule. The base matrix is static, so the per-row edge loops unroll
  at trace time; messages are per-edge (…, Z) float32 arrays. Two
  passes per row (min1/min2/sign-product, then per-edge exclusion) —
  the standard dataflow, every op elementwise over (batch, Z). A fixed
  iteration count keeps the loop jit-static.

LLR convention matches the demapper (ops/llr.py): positive = bit 0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class QcLdpcCode:
    """A lifted QC-LDPC code. ``base`` holds -1 for zero blocks, else
    the cyclic shift; shape (mb, nb) with the LAST mb columns the
    bidiagonal parity part. Hashable (arrays as tuples) so it can ride
    jit static args."""

    base: Tuple[Tuple[int, ...], ...]
    z: int

    @property
    def mb(self) -> int:
        return len(self.base)

    @property
    def nb(self) -> int:
        return len(self.base[0])

    @property
    def kb(self) -> int:
        return self.nb - self.mb

    @property
    def n(self) -> int:
        return self.nb * self.z

    @property
    def k(self) -> int:
        return self.kb * self.z

    @property
    def rate(self) -> float:
        return self.k / self.n

    def row_edges(self, i: int):
        """[(col, shift), ...] for base row i (static, trace-unrolled)."""
        return [(j, s) for j, s in enumerate(self.base[i]) if s >= 0]


def _has_4cycle(base: np.ndarray, z: int) -> bool:
    """4-cycle in the lifted graph: rows i1 ≠ i2 sharing columns
    j1 ≠ j2 with s(i1,j1)−s(i2,j1) ≡ s(i1,j2)−s(i2,j2) (mod Z)."""
    mb, nb = base.shape
    for i1 in range(mb):
        for i2 in range(i1 + 1, mb):
            both = np.flatnonzero((base[i1] >= 0) & (base[i2] >= 0))
            if len(both) < 2:
                continue
            d = (base[i1, both] - base[i2, both]) % z
            if len(np.unique(d)) < len(d):
                return True
    return False


@functools.lru_cache(maxsize=None)
def make_qc_ldpc(
    nb: int = 24, mb: int = 12, z: int = 128, seed: int = 0x1D9C
) -> QcLdpcCode:
    """Construct a girth-≥6 QC-LDPC code (rate (nb−mb)/nb).

    Information columns get weight 3 (rows drawn without replacement,
    shifts uniform in [0, Z)); the parity part is block
    lower-bidiagonal with shift-0 identities. Shifts are redrawn until
    the lifted graph is 4-cycle-free — at Z = 128 a handful of tries
    suffices (collision probability per cycle ~1/Z).
    """
    if mb < 2 or nb <= mb:
        raise ValueError(f"need nb > mb >= 2, got nb={nb} mb={mb}")
    kb = nb - mb
    rng = np.random.default_rng(seed)
    for _attempt in range(200):
        base = np.full((mb, nb), -1, np.int64)
        for j in range(kb):  # information columns, weight 3
            rows = rng.choice(mb, size=min(3, mb), replace=False)
            base[rows, j] = rng.integers(0, z, size=len(rows))
        for c in range(mb):  # bidiagonal parity part
            base[c, kb + c] = 0
            if c + 1 < mb:
                base[c + 1, kb + c] = 0
        if not _has_4cycle(base, z):
            return QcLdpcCode(tuple(tuple(int(x) for x in r) for r in base), z)
    raise RuntimeError(
        f"no 4-cycle-free lifting found for nb={nb} mb={mb} z={z}"
    )


def _rot(v: jnp.ndarray, s: int, z: int) -> jnp.ndarray:
    """Check-aligned view of a variable block: out[r] = v[(r+s) mod Z]."""
    s = s % z
    if s == 0:
        return v
    return jnp.concatenate([v[..., s:], v[..., :s]], axis=-1)


def ldpc_encode(code: QcLdpcCode, info: jnp.ndarray) -> jnp.ndarray:
    """Systematic encode: (..., k) int8 bits → (..., n) codeword.

    r_i = ⊕_j rot(s_j, shift(i,j)) over the information part, then the
    bidiagonal forward substitution p_i = p_{i-1} ⊕ r_i. All XOR on
    int8 lanes; the block loops unroll at trace time.
    """
    z, kb, mb = code.z, code.kb, code.mb
    if info.shape[-1] != code.k:
        raise ValueError(f"info length {info.shape[-1]} != k={code.k}")
    s = info.reshape(info.shape[:-1] + (kb, z)).astype(jnp.int8)
    r = []
    for i in range(mb):
        acc = None
        for j, sh in code.row_edges(i):
            if j >= kb:
                continue
            t = _rot(s[..., j, :], sh, z)
            acc = t if acc is None else acc ^ t
        r.append(acc if acc is not None else jnp.zeros(s.shape[:-2] + (z,), jnp.int8))
    p = []
    for i in range(mb):
        p.append(r[i] if i == 0 else p[i - 1] ^ r[i])
    blocks = [s[..., j, :] for j in range(kb)] + p
    return jnp.concatenate(blocks, axis=-1)


def ldpc_syndrome(code: QcLdpcCode, cw: jnp.ndarray) -> jnp.ndarray:
    """H·c over GF(2): (..., n) → (..., mb·Z); all-zero iff valid."""
    z = code.z
    c = cw.reshape(cw.shape[:-1] + (code.nb, z)).astype(jnp.int8)
    rows = []
    for i in range(code.mb):
        acc = None
        for j, sh in code.row_edges(i):
            t = _rot(c[..., j, :], sh, z)
            acc = t if acc is None else acc ^ t
        rows.append(acc)
    return jnp.concatenate(rows, axis=-1)


def _row_update(ms, beta):
    """Offset min-sum check update for one base row: check-aligned
    variable-to-check planes in, check-to-variable planes out (sign
    product times the self-excluded minimum magnitude less the offset)."""
    sign = None
    min1 = min2 = None
    for m in ms:
        a = jnp.abs(m)
        sg = jnp.where(m < 0, jnp.float32(-1.0), jnp.float32(1.0))
        sign = sg if sign is None else sign * sg
        if min1 is None:
            min1, min2 = a, jnp.full_like(a, 3.4e38)
        else:
            min2 = jnp.minimum(min2, jnp.maximum(min1, a))
            min1 = jnp.minimum(min1, a)
    out = []
    for m in ms:
        a = jnp.abs(m)
        sg = jnp.where(m < 0, jnp.float32(-1.0), jnp.float32(1.0))
        excl = jnp.where(a == min1, min2, min1)
        out.append(sign * sg * jnp.maximum(excl - beta, 0.0))
    return out


def ldpc_decode(
    code: QcLdpcCode,
    llr: jnp.ndarray,
    iters: int = 25,
    offset: float = 0.5,
    schedule: str = "flooding",
) -> jnp.ndarray:
    """Offset min-sum over (..., n) channel LLRs → (..., n) hard bits
    (int8). Positive LLR = bit 0 (demapper convention).

    ``schedule="flooding"``: every check row updates from the previous
    iteration's messages. Messages are per-edge (…, Z) float32 planes
    in VARIABLE alignment; the row update rotates them into check
    alignment, computes the sign product and the two smallest
    magnitudes in one unrolled pass, then emits each edge's
    self-excluded min with the offset applied.

    ``schedule="layered"``: the base rows update in order within an
    iteration, each from the posteriors the rows before it already
    refreshed, so the same waterfall takes about half the iterations
    (use iters ≈ half the flooding count). Messages are held in CHECK
    alignment and only the per-variable totals rotate. Statistically
    matched to flooding, not decision-identical.

    Either way the iteration loop is a ``lax.fori_loop`` (fixed trip
    count, jit-static structure) whose body unrolls the static base
    matrix at trace time.
    """
    z, nb, mb = code.z, code.nb, code.mb
    if llr.shape[-1] != code.n:
        raise ValueError(f"llr length {llr.shape[-1]} != n={code.n}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    ch = llr.reshape(llr.shape[:-1] + (nb, z)).astype(jnp.float32)
    edges = [(i, j, s) for i in range(mb) for j, s in code.row_edges(i)]
    e_by_row = [
        [e for e, (i, _, _) in enumerate(edges) if i == r] for r in range(mb)
    ]
    e_by_col = [
        [e for e, (_, j, _) in enumerate(edges) if j == c] for c in range(nb)
    ]
    beta = jnp.float32(offset)
    # Built from ch so the carry has ch's sharding type under shard_map.
    c2v0 = jnp.stack([jnp.zeros_like(ch[..., 0, :])] * len(edges))

    def totals(c2v):
        """Per-variable-block posterior: channel + all incoming c2v."""
        out = []
        for j in range(nb):
            t = ch[..., j, :]
            for e in e_by_col[j]:
                t = t + c2v[e]
            out.append(t)
        return out

    if schedule == "layered":
        def body(_, carry):
            c2v, tot = carry
            c2v = list(c2v)
            tot = [tot[..., j, :] for j in range(nb)]
            for r in range(mb):
                ms = [
                    _rot(tot[edges[e][1]], edges[e][2], z) - c2v[e]
                    for e in e_by_row[r]
                ]
                for v, e in zip(_row_update(ms, beta), e_by_row[r]):
                    _, j, s = edges[e]
                    tot[j] = tot[j] + _rot(v - c2v[e], -s, z)
                    c2v[e] = v
            return jnp.stack(c2v), jnp.stack(tot, axis=-2)

        _, tot = jax.lax.fori_loop(0, iters, body, (c2v0, ch))
        tot = [tot[..., j, :] for j in range(nb)]
    else:
        def body(_, c2v):
            tot = totals(c2v)
            new = [None] * len(edges)
            for r in range(mb):
                # Check alignment: v2c for each edge of the row.
                ms = [
                    _rot(tot[edges[e][1]] - c2v[e], edges[e][2], z)
                    for e in e_by_row[r]
                ]
                for v, e in zip(_row_update(ms, beta), e_by_row[r]):
                    new[e] = _rot(v, -edges[e][2], z)  # back to var align
            return jnp.stack(new)

        tot = totals(jax.lax.fori_loop(0, iters, body, c2v0))
    hard = [(tot[j] < 0).astype(jnp.int8) for j in range(nb)]
    return jnp.concatenate(hard, axis=-1)
