"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
over the measured window, read into the device's operations (kernels,
copies, sets) as (name, start, end) and the host's operations beside
them.

From it: the busy time (the union of the device's operations), the
operations that took most time, and the longest idle gaps by what the
host was doing then (the innermost host operation or span open at the
gap's middle).
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class Trace:
    device_ops: list[tuple[str, float, float]]  # (name, start_s, end_s), sorted by start
    host_ops: list[tuple[str, float, float]]  # (name, start_s, end_s)
    window_s: float

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.device_ops:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def time_of(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        a match of ``pattern`` (a regular expression)."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.device_ops if rx.search(n)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for n, s, e in self.device_ops:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n[:200], t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10, min_gap_s: float = 20e-6) -> list[list]:
        """The idle time between device operations, summed by the host
        operation open at each gap's middle; the ``k`` largest."""
        starts = sorted(self.host_ops, key=lambda t: t[1])
        tot: dict[str, float] = {}
        i, active, end = 0, [], None
        for _, s, e in self.device_ops:
            if end is not None and s - end >= min_gap_s:
                mid = 0.5 * (s + end)  # the gaps' middles rise: a host op ended before one is done with
                while i < len(starts) and starts[i][1] <= mid:
                    active.append(starts[i])
                    i += 1
                active = [a for a in active if a[2] >= mid]
                label = max(active, key=lambda a: a[1])[0] if active else "host: no operation"
                tot[label] = tot.get(label, 0.0) + (s - end)
            end = e if end is None else max(end, e)
        return [[n[:200], t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


class Profiler:
    """``torch.profiler`` over CPU and CUDA from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._t = None
        self.window_s = None  # set by stop()

    @property
    def active(self) -> bool:
        return self._t is not None and self.window_s is None

    def start(self) -> None:
        import time

        self._prof.__enter__()
        self._t = time.perf_counter()

    def stop(self) -> float:
        """Stop tracing; returns the traced window's length in seconds."""
        import time

        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t
        self._prof.__exit__(None, None, None)
        return self.window_s

    def trace(self) -> Trace:
        from torch.autograd import DeviceType

        dev, host = [], []
        for ev in self._prof.events():
            tr = ev.time_range
            row = (ev.name, tr.start * 1e-6, tr.end * 1e-6)
            if ev.device_type == DeviceType.CUDA:
                dev.append(row)
            elif ev.device_type == DeviceType.CPU:
                host.append(row)
        dev.sort(key=lambda t: t[1])
        return Trace(dev, host, self.window_s)
