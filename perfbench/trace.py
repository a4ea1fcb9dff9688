"""The traced segment: ``torch.profiler`` over a run of the cell's own
loop, reduced to what the per-layer readers and the breakdown need.

Only the profiler's device events (kernels, copies, fills) count as
device work: a host op's device time repeats that of the kernels it
launched.  Busy time is the union of the device events' intervals; the
idle gaps are the stretches between them, each named by the innermost
host op that was running at its middle (the harness's own ranges,
``bench.step`` and ``bench.to_host``, included).
"""
from __future__ import annotations

import collections
import re
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Segment:
    window_s: float
    busy_s: float
    items: int                                # answers finished in it
    launches: dict                            # the program's LAUNCHES
    kernel_s: dict                            # device seconds by name
    gaps: list = field(default_factory=list)  # [(label, seconds), ...]
    device_events: int = 0                    # kernels, copies, fills

    def device_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(t for name, t in self.kernel_s.items() if rx.search(name))

    def device_ops(self, k: int = 10) -> list:
        return [[name, t] for name, t in sorted(
            self.kernel_s.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        return [[name, t] for name, t in self.gaps[:k]]


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA and \
        not e.is_user_annotation()


def record(step, seconds: float, launches) -> Segment:
    """Run ``step()`` (one answer, brought to the host) under the profiler
    until ``seconds`` have passed; ``launches`` is the program's launch
    counter, cleared at the start."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    items = 0
    with profile(activities=activities) as prof:
        launches.clear()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            step()
            items += 1
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
        counts = dict(launches)
    return reduce(list(_events(prof)), window, items, counts)


def reduce(events, window: float, items: int, launches: dict) -> Segment:
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in events if _is_device(e)]
    kernel_s = collections.Counter()
    for s, e, name in dev:
        kernel_s[name] += (e - s) / 1e9
    spans = sorted((s, e) for s, e, _ in dev)
    busy, gaps, end = 0, [], None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return Segment(window, busy / 1e9, items, launches, dict(kernel_s),
                   _name_gaps(events, gaps), len(dev))


def _name_gaps(events, gaps, depth: int = 64) -> list:
    """Total seconds of the idle gaps by what the host was doing at each
    gap's middle: the latest-started host op that spans it (of the
    ``depth`` that started last before it), else "host between ops";
    largest first."""
    import numpy as np

    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events
                  if e.device_type() == torch.autograd.DeviceType.CPU)
    if not gaps:
        return []
    start = np.array([h[0] for h in host] or [0], dtype=np.int64)
    end = np.array([h[1] for h in host] or [0], dtype=np.int64)
    s = np.array([g[0] for g in gaps], dtype=np.int64)
    e = np.array([g[1] for g in gaps], dtype=np.int64)
    mid = (s + e) // 2
    last = np.searchsorted(start, mid, side="right") - 1       # (G,)
    cand = last[:, None] - np.arange(depth)[None, :]            # (G, depth)
    ok = (cand >= 0) & (end[np.clip(cand, 0, None)] >= mid[:, None])
    first = np.where(ok.any(axis=1), ok.argmax(axis=1), -1)
    by_name = collections.Counter()
    for g, k in enumerate(first.tolist()):
        name = host[cand[g, k]][2] if k >= 0 and host else \
            "host between ops"
        by_name[name] += (e[g] - s[g]) / 1e9
    return sorted(by_name.items(), key=lambda kv: -kv[1])
