"""Profiler hooks (jax.profiler) — the tracing subsystem.

The reference has no tracing/profiling anywhere (SURVEY.md §5). Here
profiling is a context manager around any framework call; traces are
Perfetto/XProf-compatible and viewable with `xprof` or
ui.perfetto.dev.

The reduction from a device trace to per-stage device time lives here
too, so every measurement computes it the same way. The link engines
name their stages with ``jax.named_scope`` (``STAGES``); XLA carries
the scope into each HLO instruction's ``op_name`` metadata, and each
device event in the trace names its instruction — in its ``hlo_op``
stat, or, for kernels XLA launches inside a command buffer (a CUDA
graph, ``hlo_op == "command_buffer"``), in the kernel name, which is
the fusion's name with "." written as "_" — so an event's stage is
read from the compiled program's HLO text.
"""

from __future__ import annotations

import contextlib
import re

import jax

#: The named scopes the engines put around their stages.
STAGES = (
    "payload", "encode", "tx", "channel",
    "demod_fft", "demod_tail", "count", "decode",
)


@contextlib.contextmanager
def trace(log_dir: str, annotate: str | None = None):
    """Capture a device trace of the enclosed block into ``log_dir``.

    Usage:
        with obs.trace("/tmp/sdr_trace"):
            fn(key)  # any jitted framework call
    """
    jax.profiler.start_trace(log_dir)
    try:
        if annotate:
            with jax.profiler.TraceAnnotation(annotate):
                yield
        else:
            yield
    finally:
        jax.profiler.stop_trace()


_INSTR = re.compile(r"%([\w.\-]+) = .*?op_name=\"([^\"]*)\"")


def stage_of(op_name: str) -> str:
    """The first ``STAGES`` scope on an op_name path, else "other"."""
    for part in op_name.split("/"):
        if part in STAGES:
            return part
    return "other"


def _norm(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def hlo_stages(hlo_text: str) -> dict[str, str]:
    """Instruction name (with "." and "-" written as "_") → stage, from
    a compiled program's HLO text (``compiled.as_text()``)."""
    return {
        _norm(m.group(1)): stage_of(m.group(2))
        for m in _INSTR.finditer(hlo_text)
    }


def event_stage(hlo_op: str | None, name: str, stages: dict) -> str:
    """The stage of one device event: its ``hlo_op`` (a thunk may add a
    ".N" suffix), else its kernel name; "other" when neither names an
    instruction of the program."""
    cands = []
    if hlo_op and hlo_op != "command_buffer":
        cands += [hlo_op, hlo_op.rsplit(".", 1)[0]]
    cands.append(name)
    for c in cands:
        st = stages.get(_norm(c))
        if st is not None:
            return st
    return "other"


def busy_ns(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total = 0.0
    end = None
    for start, dur in sorted(intervals):
        stop = start + dur
        if end is None or start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def device_events(xplane_path: str):
    """Kernel and copy events of the GPU planes of a trace file:
    [(start_ns, duration_ns, hlo_op or None, name)], taken from the
    planes' stream lines (the derived per-op/per-module lines would
    count the same time twice)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                stats = dict(ev.stats)
                out.append(
                    (float(ev.start_ns), float(ev.duration_ns),
                     stats.get("hlo_op"), ev.name)
                )
    return out


def stage_report(events, stages: dict[str, str]) -> dict:
    """Per-stage device time and the device's idle share.

    ``events``: [(start_ns, duration_ns, hlo_op, name)]; ``stages``:
    the ``hlo_stages`` map of the traced program. The window runs from
    the first event's start to the last event's end; idle share is 1
    minus the union of event intervals over the window.
    """
    per = {}
    for _, dur, op, name in events:
        st = event_stage(op, name, stages)
        per[st] = per.get(st, 0.0) + dur
    if not events:
        return {"stage_ns": per, "window_ns": 0.0, "busy_ns": 0.0,
                "idle_share": None}
    t0 = min(e[0] for e in events)
    t1 = max(e[0] + e[1] for e in events)
    busy = busy_ns([(e[0], e[1]) for e in events])
    window = t1 - t0
    return {
        "stage_ns": per,
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window > 0 else None,
    }
