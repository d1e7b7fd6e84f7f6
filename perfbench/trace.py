"""Reading the profiler's trace of the traced batches.

A ``--trace 1`` run serves its first batches under ``torch.profiler``
inside one host range, ``perfbench.traced``; that range is the traced
window.  Every batch ends in a host sync, so each device operation that
starts inside it ran inside it.  From the trace this module takes the
seconds in which some operation ran on the device (the union of their
intervals), the device time by kernel name, and the longest idle gaps,
each named by the innermost host event that spans its middle.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

__all__ = ["Event", "TraceSummary", "summarize", "kineto_events", "TRACED_RANGE"]

TRACED_RANGE = "perfbench.traced"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start_ns: int
    dur_ns: int
    on_device: bool


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    by_name: dict  # device seconds by operation name
    gaps: list  # [[host event, seconds], ...], longest first

    def device_s(self, needle: str) -> float:
        """Device seconds of the operations whose name holds ``needle``."""
        return sum(s for n, s in self.by_name.items() if needle in n)

    def top_ops(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]]


def kineto_events(prof) -> list[Event]:
    """The profiler's events as :class:`Event` s.  The host ranges the
    profiler mirrors onto the device's timeline (``serve.prefill`` and the
    like) are host events: no operation ran in them."""
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events if "CUDA" not in str(e.device_type())}
    out = []
    for e in events:
        on_device = "CUDA" in str(e.device_type()) and e.name() not in ranges
        if on_device or "CUDA" not in str(e.device_type()):
            out.append(Event(e.name(), int(e.start_ns()), int(e.duration_ns()), on_device))
    return out


def _short(name: str) -> str:
    """A kernel's name without its parameter list: ``void
    (anonymous namespace)::k<1, 2>(float*, int)`` -> ``void (anonymous
    namespace)::k<1, 2>``."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() if i > 0 else name
    return name


def summarize(events: list[Event], n_gaps: int = 10) -> TraceSummary:
    """Busy seconds, device seconds by name and the longest idle gaps
    inside the traced range."""
    rng = [e for e in events if not e.on_device and e.name == TRACED_RANGE]
    if len(rng) != 1:
        raise ValueError(f"expected one {TRACED_RANGE!r} range in the trace, found {len(rng)}")
    w0, w1 = rng[0].start_ns, rng[0].start_ns + rng[0].dur_ns
    dev = [e for e in events if e.on_device and w0 <= e.start_ns < w1]
    by_name: dict = collections.defaultdict(float)
    for e in dev:
        by_name[_short(e.name)] += e.dur_ns / 1e9
    if not dev:
        return TraceSummary((w1 - w0) / 1e9, 0.0, {}, [])
    starts = np.array([e.start_ns for e in dev], np.int64)
    ends = np.minimum(starts + np.array([e.dur_ns for e in dev], np.int64), w1)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    reach = np.maximum.accumulate(ends)
    # a new busy interval starts where an operation starts after all before it ended
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(starts) - 1)
    iv_start, iv_end = starts[first], reach[last]
    busy = int((iv_end - iv_start).sum())
    # idle gaps: before the first interval, between intervals, after the last
    g_start = np.concatenate([[w0], iv_end])
    g_end = np.concatenate([iv_start, [w1]])
    g_len = g_end - g_start
    host = [e for e in events if not e.on_device and e.name != TRACED_RANGE]
    gaps = []
    for i in np.argsort(-g_len, kind="stable")[:n_gaps]:
        if g_len[i] <= 0:
            break
        mid = (g_start[i] + g_end[i]) // 2
        spans = [e for e in host if e.start_ns <= mid < e.start_ns + e.dur_ns]
        label = min(spans, key=lambda e: e.dur_ns).name if spans else "no host event"
        gaps.append([label, float(g_len[i]) / 1e9])
    return TraceSummary((w1 - w0) / 1e9, busy / 1e9, dict(by_name), gaps)
