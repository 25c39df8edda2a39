"""Sliding (circular) buffers — host-side and jit-functional.

The reference's ``utils::sliding_buffer<T>``
(/root/reference/lib/inc/sliding_buffer.hpp:14-104) is a fixed-capacity
ring used by its demo GUI for plot history: logical index ``pos`` maps
to ``data_[(cur_ + pos) % size]`` (sliding_buffer.hpp:73-76), range
``push_back`` splits the copy at the physical end and wraps
(sliding_buffer.hpp:78-88), checked ``at()`` reports
"pos=N exceeds size=M" (sliding_buffer.hpp:59-65).

Two device-side counterparts live here:

- ``SlidingBuffer`` — a host-side Python ring with the reference's
  exact indexing/push/saturation semantics (validated against the nine
  reference tests, sliding_buffer_test.cpp:11-154). Used by the CLI
  demo for plot/text history, like the reference GUI uses its
  (QFDemoWindow.cpp:20-21).
- ``RingState`` + ``ring_*`` — a pure-functional fixed-shape ring for
  use INSIDE jitted programs (streaming state such as FIR halo history
  or live metric windows). State in, state out; static shapes; safe
  under jit/vmap/scan.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp


class SlidingBuffer:
    """Host-side fixed-capacity ring with reference-exact semantics."""

    def __init__(self, size: int):
        if size <= 0:
            raise ValueError(f"size must be positive, got {size}")
        self._data = [0] * size
        self._cur = 0

    def __len__(self) -> int:
        return len(self._data)

    def size(self) -> int:
        return len(self._data)

    def __getitem__(self, pos: int):
        # Logical index relative to the head (sliding_buffer.hpp:73-76).
        return self._data[(self._cur + pos) % len(self._data)]

    def __setitem__(self, pos: int, val) -> None:
        self._data[(self._cur + pos) % len(self._data)] = val

    def at(self, pos: int):
        """Checked access; raises IndexError with the reference's message."""
        if pos >= len(self._data) or pos < 0:
            raise IndexError(f"pos={pos} exceeds size={len(self._data)}")
        return self[pos]

    def push_back(self, values) -> None:
        """Append a scalar or an iterable, wrapping at the physical end.

        Mirrors sliding_buffer.hpp:78-94: copy up to the physical end
        from the cursor, wrap the remainder to the front, leave the
        cursor one past the last written element.
        """
        if not isinstance(values, (list, tuple)) and not hasattr(values, "__iter__"):
            values = [values]
        vals = list(values)
        size = len(self._data)
        free = size - self._cur
        if len(vals) - free > size:
            # The reference's behavior here is an untested overflow
            # (SURVEY.md component #11); reject instead of corrupting.
            raise ValueError(
                f"push of {len(vals)} overflows capacity {size} (cur={self._cur})"
            )
        head = vals[: min(free, len(vals))]
        self._data[self._cur : self._cur + len(head)] = head
        if len(head) == free and len(vals) > len(head):
            rest = vals[len(head) :]
            self._data[: len(rest)] = rest
            self._cur = len(rest)
        else:
            self._cur = self._cur + len(head)
            if self._cur == size:
                self._cur = 0

    def __iter__(self):
        for i in range(len(self._data)):
            yield self[i]

    def tolist(self) -> list:
        return list(iter(self))


# ---------------------------------------------------------------------------
# Functional (jit-safe) ring.
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RingState:
    """Functional ring state: fixed-shape data + cursor (both arrays)."""

    data: jnp.ndarray  # (capacity, ...) — slot 0 is physical, not logical
    cur: jnp.ndarray  # int32 scalar: next write position == logical head


def ring_new(capacity: int, dtype=jnp.float32, item_shape: Sequence[int] = ()) -> RingState:
    """Zero-initialized ring (the reference zero-fills too, hpp:53)."""
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    return RingState(
        data=jnp.zeros((capacity, *item_shape), dtype),
        cur=jnp.int32(0),
    )


def ring_push(state: RingState, values: jnp.ndarray) -> RingState:
    """Push ``values`` (leading axis = count) with wrap-around.

    Count must be a static shape <= capacity (the reference's behavior
    beyond that is an untested overflow, SURVEY.md component #11 —
    rejected here at trace time).
    """
    n = values.shape[0]
    cap = state.data.shape[0]
    if n > cap:
        raise ValueError(f"push of {n} exceeds capacity {cap}")
    idx = (state.cur + jnp.arange(n, dtype=jnp.int32)) % cap
    data = state.data.at[idx].set(values.astype(state.data.dtype))
    return RingState(data=data, cur=((state.cur + n) % cap).astype(jnp.int32))


def ring_read(state: RingState, pos) -> jnp.ndarray:
    """Logical read relative to the head: data[(cur + pos) % capacity]."""
    cap = state.data.shape[0]
    return state.data[(state.cur + jnp.asarray(pos, jnp.int32)) % cap]


def ring_window(state: RingState) -> jnp.ndarray:
    """The full buffer in logical order (oldest-at-head), shape-stable.

    Equivalent to iterating the reference buffer begin()..end().
    """
    cap = state.data.shape[0]
    return jnp.roll(state.data, -state.cur, axis=0)
