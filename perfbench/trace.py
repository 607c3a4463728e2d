"""Reading a ``torch.profiler`` trace: device intervals, kernels by name,
the program's ``genvc.*`` spans, and idle gaps by what the host was doing.

The union-of-intervals busy time and the per-name sums follow the port's
``profile_streaming.analyse``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

CUDA = torch.autograd.DeviceType.CUDA


def busy_us(intervals) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


class Trace:
    """One traced region. Times are in microseconds on the profiler's clock,
    except ``wall_s`` (the host's clock around the region)."""

    def __init__(self, prof, wall_s: float):
        self.wall_s = wall_s
        self._prof = prof

    def __getattr__(self, name):
        # the events are read on first use, so a serving loop is not held
        # up by the reading inside its window
        if name in ("kernels", "spans", "device_spans", "launches") and "_prof" in self.__dict__:
            self._load(self.__dict__.pop("_prof"))
            return getattr(self, name)
        raise AttributeError(name)

    def _load(self, prof):
        self.kernels: list[tuple[str, float, float]] = []
        self.spans: list[tuple[str, float, float]] = []
        self.device_spans: list[tuple[str, float, float]] = []
        self.launches = 0
        for ev in prof.events():
            tr = ev.time_range
            if ev.device_type == CUDA:
                if ev.name.startswith("genvc."):
                    self.device_spans.append((ev.name, tr.start, tr.end))
                else:
                    self.kernels.append((ev.name, tr.start, tr.end))
            elif ev.name.startswith("genvc."):
                self.spans.append((ev.name, tr.start, tr.end))
            elif "LaunchKernel" in ev.name:
                self.launches += 1
        self.kernels.sort(key=lambda k: k[1])
        self.spans.sort(key=lambda s: s[1])

    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.kernels]) / 1e6

    def count(self, *parts: str) -> int:
        return sum(1 for n, _, _ in self.kernels if any(p in n for p in parts))

    def device_s(self, *parts: str) -> float:
        return sum(e - s for n, s, e in self.kernels if any(p in n for p in parts)) / 1e6

    def device_s_within(self, name: str) -> float:
        """Device time of the kernels that start inside the device-side
        ranges of the ``name`` annotation."""
        ranges = sorted((s, e) for n, s, e in self.device_spans if n == name)
        starts = [s for s, _ in ranges]
        total = 0.0
        for _, s, e in self.kernels:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= ranges[i][1]:
                total += e - s
        return total / 1e6

    def span_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e6

    def span_ends(self, name: str) -> list[float]:
        return sorted(e for n, _, e in self.spans if n == name)

    def whole(self) -> bool:
        """Every kernel launch the host made has its device record."""
        return bool(self.kernels) and len(self.kernels) >= self.launches

    def top_ops(self, n: int = 10) -> list:
        by = collections.defaultdict(float)
        for name, s, e in self.kernels:
            by[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Device idle time between kernels, summed by the innermost
        ``genvc.*`` span that holds the gap's middle on the host."""
        merged = []
        for _, s, e in self.kernels:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [s for _, s, _ in self.spans]
        by = collections.defaultdict(float)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = (e0 + s1) / 2
            name = "outside genvc spans"
            i = bisect.bisect_right(starts, mid)
            best = None
            for name_j, sj, ej in self.spans[max(0, i - 64): i]:
                if sj <= mid <= ej and (best is None or sj >= best[1]):
                    best = (name_j, sj)
            if best is not None:
                name = best[0]
            by[name] += (s1 - e0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def traced(out: list):
    """Profile the block between two device synchronisations; append a
    :class:`Trace` to ``out``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(Trace(prof, wall))
