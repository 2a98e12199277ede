"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
steps or calls after the window, reduced in memory (nothing is written to
disk) to the device's operations, the host's operations, and the traced
window's bounds, all on the profiler's clock in seconds.

Two passes. The first records the device's activity alone: recording
every host operation costs the host about as much time as a training
step's enqueue, and the device would wait for it, so the busy share, the
time by kernel and the rooflines come from this pass. The second records
the host's operations as well, over fewer steps or calls, and only names
what the host was doing in the device's idle gaps."""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time

WINDOW_MARK = "bench.window"
# The prefix of the benchmark's own host spans.
MARKS = "bench."


@dataclasses.dataclass
class Trace:
    """Device operations and host operations as (name, start s, duration s),
    and the traced window [lo, hi] on the same clock."""

    device: list
    host: list
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def clipped(self) -> list:
        """Device operations cut to the window."""
        out = []
        for name, s, d in self.device:
            a, b = max(s, self.lo), min(s + d, self.hi)
            if b > a:
                out.append((name, a, b - a))
        return out


def device_trace(prof, window_s: float) -> Trace:
    """A device-only profile's operations, over a window of ``window_s``
    measured on the host's clock from a sync before the first traced
    operation to one after the last: the window starts at the first
    operation (the window's idle time sits at its end)."""
    from torch.autograd import DeviceType

    device = [(e.name(), e.start_ns() / 1e9, e.duration_ns() / 1e9)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() != DeviceType.CPU and e.duration_ns() > 0
              and not e.is_user_annotation() and not e.name().startswith(MARKS)]
    lo = min((s for _, s, _ in device), default=0.0)
    return Trace(device=device, host=[], lo=lo, hi=lo + window_s)


def from_profile(prof) -> Trace:
    """A finished profile's events, summed straight from its Kineto events
    (``key_averages()`` builds a Python object per event)."""
    from torch.autograd import DeviceType

    device, host, lo, hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e9, e.duration_ns() / 1e9)
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW_MARK:
                lo, hi = rec[1], rec[1] + rec[2]
            else:
                host.append(rec)
        elif e.duration_ns() > 0 and not e.is_user_annotation() and not e.name().startswith(MARKS):
            # A host span's copy on the device's timeline is no operation.
            device.append(rec)
    if lo is None:
        raise RuntimeError("the profile holds no window mark")
    return Trace(device=device, host=host, lo=lo, hi=hi)


class Tracer:
    """``with tracer.window():`` around the traced steps, then ``with
    tracer.host_window():`` around a few more; afterwards ``tracer.trace``
    holds the first pass (the device alone) and ``tracer.host_trace`` the
    second (host and device), each None where it was not traced."""

    def __init__(self, sync):
        self.sync = sync
        self.trace: Trace | None = None
        self.host_trace: Trace | None = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self.sync()
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            a = time.perf_counter()
            yield
            self.sync()
            b = time.perf_counter()
        self.trace = device_trace(prof, b - a)

    @contextlib.contextmanager
    def host_window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts) as prof:
            with record_function(WINDOW_MARK):
                yield
                self.sync()
        self.host_trace = from_profile(prof)


def union(intervals: list) -> list:
    """Merged [start, end] of (name, start, duration) records."""
    spans = sorted((s, s + d) for _, s, d in intervals)
    out: list = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in union(trace.clipped()))


def top_ops(trace: Trace, n: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    sums: dict = {}
    for name, _, d in trace.clipped():
        sums[name] = sums.get(name, 0.0) + d
    return [[k[:120], v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """[what the host was doing, seconds] of the device's idle time in the
    window, summed by the host operation open at each gap's middle that
    started last (the innermost, for operations nested on one thread), the
    largest first."""
    spans = union(trace.clipped())
    edges = [trace.lo] + [x for a, b in spans for x in (a, b)] + [trace.hi]
    gaps = sorted(((a + b) / 2, b - a) for a, b in zip(edges[::2], edges[1::2]) if b > a)
    host = sorted(trace.host, key=lambda r: r[1])
    sums: dict = {}
    active: list = []  # max-heap on start: (-start, end, name)
    i = 0
    for mid, length in gaps:
        while i < len(host) and host[i][1] <= mid:
            name, s, d = host[i]
            heapq.heappush(active, (-s, s + d, name))
            i += 1
        while active and active[0][1] < mid:  # ended: covers no later middle
            heapq.heappop(active)
        label = active[0][2] if active else "python (no operation open)"
        sums[label] = sums.get(label, 0.0) + length
    return [[k[:120], v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]
