"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the window, read back as device operations on the profiler's clock.

Kineto stamps host and device events on one clock, nanoseconds since the
epoch, which ``time.time_ns()`` reads too: the host stamps the harness takes
around the engine's calls line up with the device operations.
"""
from __future__ import annotations

import time
from collections import Counter, defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# runtime calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")() * 1000)


class Profiler:
    """``start``/``stop`` around a stretch of a run; ``warm`` once in set-up
    (the profiler's first start is slow).  ``cpu`` adds host activity, which
    ties kernels to the host ranges that launched them.  ``stop`` may keep a
    shorter stretch ``(h0, h1)`` of what was recorded: the serving driver
    records from before the engine's threads start until they have ended, so
    that no start or stop runs beside them (a stop beside the engine's lanes
    hung a traced run on an H100), and keeps the window's middle."""

    def __init__(self, cpu: bool = False):
        self.acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
        self._prof = None
        self.h0 = self.h1 = 0

    def warm(self) -> None:
        with profile(activities=self.acts):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        self._prof = profile(activities=self.acts)
        self._prof.start()
        self.h0 = time.time_ns()

    def stop(self, h0: "int | None" = None, h1: "int | None" = None) -> "Trace":
        torch.cuda.synchronize()
        self.h1 = time.time_ns()
        self._prof.stop()
        trace = Trace(self._prof.profiler.kineto_results.events(), h0 or self.h0, h1 or self.h1)
        self._prof = None
        return trace


class Trace:
    """Device operations (kernels, copies, fills) clipped to the traced
    window ``[h0, h1]``, host ranges and the launches' correlation ids."""

    def __init__(self, events, h0: int, h1: int):
        self.h0, self.h1 = h0, h1
        self.ops = []       # (name, start, end, stream, correlation)
        self.ranges = []    # host ranges of record_function: (name, start, end)
        self.launch_at = {}  # correlation id -> host start of the launch call
        for e in events:
            user = getattr(e, "is_user_annotation", lambda: False)()
            if e.device_type() == DeviceType.CUDA:
                if user:
                    continue
                s, t = _ns(e, "start"), _ns(e, "end")
                if t < h0 or s > h1:
                    continue
                self.ops.append((e.name(), s, t, int(e.device_resource_id()),
                                 int(e.correlation_id())))
            elif e.device_type() == DeviceType.CPU:
                if e.name() in LAUNCH_CALLS:
                    self.launch_at[int(e.correlation_id())] = _ns(e, "start")
                elif user or e.name().startswith(("train.", "serve.")):
                    self.ranges.append((e.name(), _ns(e, "start"), _ns(e, "end")))
        self.ops.sort(key=lambda o: o[1])

    @property
    def window_s(self) -> float:
        return (self.h1 - self.h0) / 1e9

    def clipped(self, ops=None):
        for name, s, e, stream, corr in (self.ops if ops is None else ops):
            s, e = max(s, self.h0), min(e, self.h1)
            if e > s:
                yield name, s, e, stream, corr

    def busy_intervals(self, ops=None) -> "list[tuple[int, int]]":
        """The union of the operations' intervals inside the window."""
        out: "list[list[int]]" = []
        for _, s, e, _, _ in sorted(self.clipped(ops), key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self, ops=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(ops)) / 1e9

    def kernels(self, needle: str):
        """Device operations whose name contains ``needle``."""
        return [o for o in self.ops if needle in o[0]]

    def seconds(self, ops) -> float:
        return sum(e - s for _, s, e, _, _ in self.clipped(ops)) / 1e9

    def launched_in(self, range_name: str):
        """Device operations launched from inside host ranges named
        ``range_name`` (by the launch call's correlation id)."""
        spans = [(s, e) for n, s, e in self.ranges if n == range_name]
        out = []
        for op in self.ops:
            t = self.launch_at.get(op[4])
            if t is not None and any(s <= t <= e for s, e in spans):
                out.append(op)
        return out, len(spans)

    def top_ops(self, n: int = 10) -> "list[list]":
        by = Counter()
        for name, s, e, _, _ in self.clipped():
            by[name[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, host_spans, n: int = 10) -> "list[list]":
        """Idle device time inside the window, summed by what the host was
        doing then: ``host_spans`` is a list of (label, start_ns, end_ns);
        a gap goes to the label that overlaps it most ("host.other" where
        none does)."""
        busy = self.busy_intervals()
        gaps, t = [], self.h0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.h1 > t:
            gaps.append((t, self.h1))
        spans = sorted(host_spans, key=lambda x: x[1])
        by = defaultdict(float)
        j = 0
        for gs, ge in gaps:
            while j < len(spans) and spans[j][2] < gs:
                j += 1
            best, label = 0, "host.other"
            k = j
            while k < len(spans) and spans[k][1] <= ge:
                ov = min(ge, spans[k][2]) - max(gs, spans[k][1])
                if ov > best:
                    best, label = ov, spans[k][0]
                k += 1
            by[label] += (ge - gs) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def attribute(ops, stamps):
    """Each operation with the host record it belongs to: the latest of
    ``stamps`` (sorted (time_ns, record)) at or before the operation's
    start; operations before the first stamp are dropped."""
    out, j = [], -1
    for op in sorted(ops, key=lambda o: o[1]):
        while j + 1 < len(stamps) and stamps[j + 1][0] <= op[1]:
            j += 1
        if j >= 0:
            out.append((op, stamps[j][1]))
    return out
