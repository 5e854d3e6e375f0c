"""Device time from a ``torch.profiler`` trace: the events it holds in
memory, or a Chrome trace.

The union of device intervals is a frozen copy of
``rustqip_tpu_torch.utils.observe.trace_summary``'s arithmetic; the window
is the benchmark's own: from the first timed job's start to the last one's
end, read from the jobs' annotations (``JOB_SPAN``) in the same trace, so
host set-up before the window never counts as idle. Imports nothing of the
port.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Chrome-trace categories of host work that can name an idle gap.
HOST_CATEGORIES = ("user_annotation", "cpu_op", "python_function", "cuda_runtime",
                   "cuda_driver")
#: The annotation the harness puts around each timed job.
JOB_SPAN = "portbench.job"

Interval = Tuple[float, float]


#: An event: (name, category, start s, end s).
Event = Tuple[str, str, float, float]


def chrome_source(trace: dict) -> Callable[[], Iterator[Event]]:
    """The complete ("X") events of a Chrome trace, as a source."""
    def events():
        for e in trace.get("traceEvents", []):
            if e.get("ph") == "X" and "dur" in e and "ts" in e:
                t0 = float(e["ts"]) * 1e-6
                yield str(e.get("name", "")), str(e.get("cat", "")), t0, \
                    t0 + float(e["dur"]) * 1e-6
    return events


def profiler_source(prof) -> Callable[[], Iterator[Event]]:
    """The events a finished ``torch.profiler.profile`` holds in memory
    (no trace file: a QFT-32 job alone makes some 60,000)."""
    evs = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in evs), default=0)
    category = _category if evs and not hasattr(evs[0], "activity_type") else \
        (lambda e: e.activity_type())

    def events():
        for e in evs:
            t0 = (e.start_ns() - base) * 1e-9
            yield e.name(), category(e), t0, t0 + e.duration_ns() * 1e-9
    return events


def _category(e) -> str:
    """The Chrome category of an event, where the profiler does not name
    it: by device and name."""
    if str(e.device_type()).endswith("CPU"):
        return "user_annotation" if e.is_user_annotation() else "cpu_op"
    if e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")


def union_s(intervals: Sequence[Interval]) -> float:
    """Seconds covered by the union of ``intervals``."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def clip(iv: Interval, window: Interval) -> Optional[Interval]:
    a, b = max(iv[0], window[0]), min(iv[1], window[1])
    return (a, b) if b > a else None


@dataclass
class TraceView:
    """The device's work inside the window of the timed jobs."""

    window: Interval
    #: (name, start s, end s) of each device operation, clipped to the window.
    device: List[Tuple[str, float, float]]
    #: (name, start s, end s) of each host event inside the window.
    host: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.device])

    def seconds_where(self, keep) -> Optional[float]:
        """Summed seconds of the device operations whose name ``keep``
        accepts; None when there is none."""
        picked = [b - a for name, a, b in self.device if keep(name)]
        return sum(picked) if picked else None

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            out[name] += b - a
        return dict(out)

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the device inside the window, each gap named by
        the shortest host event that covers its midpoint (what the host
        was doing), summed by that name."""
        gaps = _gaps([(a, b) for _, a, b in self.device], self.window)
        # sweep the gaps' midpoints in order; a heap holds the host events
        # begun so far, shortest first, and drops those that ended
        host = sorted(self.host, key=lambda h: h[1])
        out: Dict[str, float] = defaultdict(float)
        heap: list = []
        i = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                name, ha, hb = host[i]
                heapq.heappush(heap, (hb - ha, hb, name))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            out[heap[0][2] if heap else "host"] += b - a
        return dict(out)


def _gaps(spans: Sequence[Interval], window: Interval) -> List[Interval]:
    gaps, end = [], window[0]
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if window[1] > end:
        gaps.append((end, window[1]))
    return gaps


def view(source: Callable[[], Iterable[Event]]) -> Optional[TraceView]:
    """The TraceView of the timed jobs in ``source()`` (read twice), or
    None when it holds no job annotation. Of the host events it keeps
    those that cover the midpoint of an idle gap of the device."""
    jobs, device = [], []
    for name, cat, a, b in source():
        if cat == "user_annotation" and name == JOB_SPAN:
            jobs.append((a, b))
        elif cat in DEVICE_CATEGORIES:
            device.append((name, a, b))
    if not jobs:
        return None
    window = (min(a for a, _ in jobs), max(b for _, b in jobs))
    device = [(name, *iv) for name, a, b in device if (iv := clip((a, b), window))]
    mids = [0.5 * (a + b) for a, b in _gaps([(a, b) for _, a, b in device], window)]
    host = []
    for name, cat, a, b in source():
        if cat in HOST_CATEGORIES and name != JOB_SPAN:
            i = bisect.bisect_left(mids, a)
            if i < len(mids) and mids[i] <= b:
                host.append((name, a, b))
    return TraceView(window, device, host)


def top(d: Dict[str, float], k: int = 10, width: int = 160) -> List[list]:
    """The ``k`` largest entries of ``d`` as [name, seconds], names cut to
    ``width`` characters."""
    return [[name[:width], s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
