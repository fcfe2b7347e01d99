"""A bounded torch.profiler window reduced in memory to what the readers
need: the device's busy time as the union of its kernel and copy
intervals (several streams overlap, so per-kernel sums would overcount),
time by kernel name, and the idle gaps labelled by what the host was
doing. No trace file is written."""

from __future__ import annotations

import collections
import re
import time
from typing import List, Optional, Tuple

import torch

# idle gaps shorter than this are launch latency between back-to-back
# kernels: summed under one label rather than looked up one by one
SHORT_GAP_NS = 20_000

# the kernel torch.cuda._sleep launches: Profiler.mark()'s marker
MARKER = "spin_kernel"


class TraceSummary:
    def __init__(self, window_s: float, device: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]]):
        self.window_s = window_s
        self.kernels = device          # (name, start ns, end ns)
        spans = sorted((s, e) for _, s, e in device)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        self._merged = merged
        self._host = sorted(host, key=lambda h: h[1])

    def time_of(self, pattern: str) -> Tuple[int, float]:
        """(count, seconds) of the device events whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.kernels if rx.search(n)]
        return len(hits), sum(hits) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by = collections.Counter()
        for n, s, e in self.kernels:
            by[n[:120]] += (e - s) / 1e9
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time between device intervals, summed by the host op that
        was running at each gap's middle (the innermost one, any thread;
        the benchmark's own "bench." spans win)."""
        import bisect

        by = collections.Counter()
        starts = [h[1] for h in self._host]
        for (s0, e0), (s1, _) in zip(self._merged, self._merged[1:]):
            if s1 - e0 < SHORT_GAP_NS:
                by["gaps under 20 us"] += (s1 - e0) / 1e9
                continue
            mid = (e0 + s1) // 2
            i = bisect.bisect_right(starts, mid)
            label, best = "host: none", None
            for name, hs, he in self._host[max(0, i - 400):i][::-1]:
                if he < mid:
                    continue
                if name.startswith("bench."):
                    label = name
                    break
                if best is None:
                    best = name
            if label == "host: none" and best is not None:
                label = best
            by[label[:120]] += (s1 - e0) / 1e9
        return [[n, t] for n, t in by.most_common(top)]


class Profiler:
    """start() / stop() around a bounded part of a window. host=False
    records the device's activity alone: recording every host op costs the
    host tens of microseconds an op, which a host-bound program pays in
    device idle time, so the busy and idle shares come from a device-only
    span and the host's ops are recorded over a separate short span that
    labels the idle gaps.

    mark() ends the span where the caller holds the program still, with
    the device synchronized; stop() can then follow after the program has
    been let go, and summary() reads the events once the window is over,
    so neither the profiler's exit nor the walk over its events holds the
    program up."""

    def __init__(self, host: bool = True):
        self._host = host
        self._prof = None
        self._t0 = 0.0
        self._window: Optional[float] = None
        self._mark_ns: Optional[int] = None
        self._summary: Optional[TraceSummary] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self._host else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        elif not acts:
            acts = [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def mark(self) -> None:
        """End the span now. The device is idle (the caller synchronized),
        and a marker kernel divides the span's device events from those of
        the work launched after it, before stop(); without one in the
        trace, the events' own clock (Unix time) divides them."""
        self._window = time.perf_counter() - self._t0
        self._mark_ns = time.time_ns()
        if torch.cuda.is_available():
            torch.cuda._sleep(1000)

    def stop(self) -> None:
        """Stop recording (the span ends here unless mark() ended it)."""
        if self._window is None:
            self._window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def summary(self) -> TraceSummary:
        """The span's events, reduced (read once, after the window)."""
        if self._summary is not None:
            return self._summary
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns()
            item = (e.name(), s, s + e.duration_ns())
            (dev if e.device_type() == cuda else host).append(item)
        if self._mark_ns is not None:
            cut = min([s for n, s, _ in dev if MARKER in n],
                      default=self._mark_ns)
            dev = [d for d in dev if d[1] < cut]
        self._prof = None
        self._summary = TraceSummary(self._window, dev, host)
        return self._summary
