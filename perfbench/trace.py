"""Reading a profiled interval: device busy time, kernel times by name, the
idle gaps and what the host was doing in them.

Only `torch.profiler`'s in-memory events are read; nothing is written.
Times are in seconds, on the profiler's clock.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

NAME_CHARS = 120  # kept of a kernel or host-op name in the breakdown


@dataclass
class TraceSummary:
    window_s: float                 # first event's start to last event's end
    busy_s: float                   # union of the device's operations
    units: int                      # whole units of work profiled
    host_s: float                   # host clock around the profiled units
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # name: (s, launches)
    launches: int = 0               # device operations (kernels, copies, sets)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)  # program counters' deltas

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds `pattern`."""
        s, n = 0.0, 0
        for name, (t, k) in self.kernels.items():
            if pattern in name:
                s, n = s + t, n + k
        return s, n

    def top_ops(self, k: int = 10) -> List[List]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return [[name[:NAME_CHARS], t] for name, (t, _) in ops]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def profile_units(run_unit, units: int, counters) -> TraceSummary:
    """Profile `units` calls of run_unit() (each ends synchronised) and read
    the events. `counters()` returns the program's counters; their change
    over the profiled units is kept beside the trace's own counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            run_unit()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    after = counters()
    dev, cpu = [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((a, b, e.name))
        else:
            cpu.append((a, b, e.name))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        kernels[name][0] += b - a
        kernels[name][1] += 1
    busy = _union([(a, b) for a, b, _ in dev])
    ends = [x for a, b, _ in dev + cpu for x in (a, b)] or [0.0]
    lo, hi = min(ends), max(ends)
    return TraceSummary(
        window_s=hi - lo, busy_s=sum(b - a for a, b in busy), units=units, host_s=host_s,
        kernels={k: (v[0], int(v[1])) for k, v in kernels.items()}, launches=len(dev),
        idle_gaps=_gaps_by_host_op([(lo, lo)] + busy + [(hi, hi)], cpu),
        counters={k: after[k] - before[k] for k in after})


def _gaps_by_host_op(busy, cpu, k: int = 10) -> List[Tuple[str, float]]:
    """Idle time between device operations, summed by the innermost host
    operation that was running at the middle of each gap ('python' where
    none was)."""
    cpu = sorted(cpu)
    starts = [a for a, _, _ in cpu]
    by_name: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (end + nxt)
        i = bisect.bisect_right(starts, mid)
        name = "python"
        for a, b, n in reversed(cpu[max(0, i - 64):i]):  # the latest start covering mid
            if b >= mid:
                name = n
                break
        by_name[name[:NAME_CHARS]] += nxt - end
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
