"""What the profiler saw on the card during a traced window.

``DeviceTrace.read(prof)`` takes the events of a finished
``torch.profiler.profile`` with CPU and CUDA activities: every operation
on the device (kernels, copies, sets) with its interval, and the host's
operations, to name what the host was doing while the device idled.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# the profiler's own host events: never what the program was doing
PROFILER_EVENTS = frozenset({"Activity Buffer Request"})


@dataclass
class DeviceTrace:
    # (start_ns, end_ns, name) of each device operation, by start
    device_ops: list = field(default_factory=list)
    # (start_ns, end_ns, name) of each host operation, by start
    host_ops: list = field(default_factory=list)

    @classmethod
    def read(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType

        out = cls()
        for e in prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type() == DeviceType.CUDA:
                out.device_ops.append(rec)
            elif e.device_type() == DeviceType.CPU:
                out.host_ops.append(rec)
        out.device_ops.sort()
        out.host_ops.sort()
        return out

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, as merged
        (start_ns, end_ns) pairs."""
        merged = []
        for s, e, _ in self.device_ops:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def seconds_by_kernel(self) -> dict:
        out = {}
        for s, e, name in self.device_ops:
            out[name] = out.get(name, 0.0) + (e - s) * 1e-9
        return out

    def seconds_of(self, patterns) -> float:
        """Device seconds of the operations whose name any regex of
        ``patterns`` finds."""
        rx = [re.compile(p) for p in patterns]
        return sum(t for name, t in self.seconds_by_kernel().items()
                   if any(r.search(name) for r in rx))

    def top_ops(self, n: int = 10) -> list:
        ops = sorted(self.seconds_by_kernel().items(), key=lambda kv: -kv[1])
        return [[name, t] for name, t in ops[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device operations, each named by
        the innermost host operation of the program running at its middle
        (or, where none runs, the last one that ended before it)."""
        busy = self.busy_intervals()
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                        busy[i + 1][0]) for i in range(len(busy) - 1)),
                      reverse=True)[:n]
        out = []
        for length, g0, g1 in gaps:
            mid = (g0 + g1) // 2
            inner, before = None, None
            for s, e, name in self.host_ops:
                if s > mid:
                    break
                if name in PROFILER_EVENTS:
                    continue
                if e >= mid:
                    inner = name  # the latest start that covers mid
                elif e <= g0:
                    before = name
            label = inner if inner is not None else \
                f"after {before}" if before is not None else "host"
            out.append([label, length * 1e-9])
        return out
