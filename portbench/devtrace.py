"""The device trace of a run's window, and the arithmetic the per-layer
metrics read it with.

With ``--trace 1`` the window runs under ``torch.profiler`` (CPU and CUDA
activities). Its chrome trace is read back once the window has closed: every
device operation (kernels, copies, sets) and every CUDA runtime or driver call
that launched one, moved onto the host's monotonic clock. The clocks are tied
by a ``record_function`` mark the main thread stamps at the window's start and
end with ``time.monotonic()``.

The arithmetic is a copy of ``scripts/torch_cycle_trace.py``'s
``device_intervals`` and ``union_us``, on seconds.
"""

from __future__ import annotations

import json
import os
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
CLOCK_MARK = "portbench.clock"


def union_s(intervals) -> float:
    """Length of the union of ``(start, end, ...)`` intervals."""
    total, end = 0.0, float("-inf")
    for start, stop, *_ in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def clip(intervals, t0: float, t1: float) -> list:
    """``intervals`` cut to ``[t0, t1]``; those outside are dropped."""
    return [(max(a, t0), min(b, t1), *rest) for a, b, *rest in intervals if b > t0 and a < t1]


class DeviceTrace:
    """The device's work in a window: ``ops`` as ``(start, end, name,
    correlation)`` and ``launches`` as ``{correlation: (thread id, time)}``,
    both in host monotonic seconds; ``window`` the traced ``(start, end)``."""

    def __init__(self, ops, launches, window):
        self.ops = ops
        self.launches = launches
        self.window = window

    @classmethod
    def from_chrome(cls, trace: dict, marks) -> "DeviceTrace":
        events = trace.get("traceEvents", [])
        stamps = sorted(float(e["ts"]) for e in events if e.get("name") == CLOCK_MARK and e.get("ph") == "X")
        if len(stamps) != len(marks):
            raise RuntimeError(f"the trace holds {len(stamps)} clock marks, the run stamped {len(marks)}")
        offset_us = sum(ts - 1e6 * host for ts, host in zip(stamps, marks)) / len(marks)

        def host(ts) -> float:
            return (float(ts) - offset_us) / 1e6

        ops, launches = [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATEGORIES:
                start = host(e["ts"])
                ops.append((start, start + float(e.get("dur", 0.0)) / 1e6, e.get("name", "?"), corr))
            elif cat in LAUNCH_CATEGORIES and corr is not None:
                launches[corr] = (e.get("tid"), host(e["ts"]))
        return cls(ops, launches, (marks[0], marks[-1]))

    def busy_s(self, t0: float = None, t1: float = None) -> float:
        """Seconds in ``[t0, t1]`` (default: the window) with device work."""
        w0, w1 = self.window
        return union_s(clip(self.ops, w0 if t0 is None else t0, w1 if t1 is None else t1))

    def ops_of(self, rng, by_thread: bool = True) -> list:
        """The device operations launched inside ``rng`` (a ``spans.Range``):
        those whose runtime call lies in its interval, on its thread when
        ``by_thread``. Where the trace carries no launch of an operation, it
        counts when it starts inside the interval."""
        out = []
        for op in self.ops:
            launch = self.launches.get(op[3])
            if launch is None:
                if rng.t0 <= op[0] <= rng.t1:
                    out.append(op)
            elif rng.t0 <= launch[1] <= rng.t1 and (not by_thread or str(launch[0]) == str(rng.tid)):
                out.append(op)
        return out

    def by_thread(self, ranges) -> bool:
        """Whether the launches' thread ids are those ``ranges`` carry (the
        profiler's ids are the native ones): else ops are matched by time."""
        tids = {str(t) for t, _ in self.launches.values()}
        return any(str(r.tid) in tids for r in ranges)

    def device_s(self, ranges) -> float:
        """Device seconds of the operations launched inside ``ranges``."""
        thread = self.by_thread(ranges)
        return sum(union_s(self.ops_of(r, thread)) for r in ranges)

    def top_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the device operations that took most
        time in the window, by name."""
        w0, w1 = self.window
        totals = {}
        for start, end, name, _ in clip(self.ops, w0, w1):
            totals[name[:80]] = totals.get(name[:80], 0.0) + (end - start)
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, ranges, n: int = 10) -> list:
        """``[[what the host was doing, seconds], ...]``: the longest gaps in
        the window with no device work, each named by the innermost range
        open at its middle (``host`` where none was)."""
        w0, w1 = self.window
        gaps, end = [], w0
        for start, stop, *_ in sorted(clip(self.ops, w0, w1)):
            if start > end:
                gaps.append((end, start))
            end = max(end, stop)
        if w1 > end:
            gaps.append((end, w1))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [r for r in ranges if r.t0 <= mid <= r.t1]
            name = min(inside, key=lambda r: r.t1 - r.t0).name if inside else "host"
            out.append([f"{name} at +{a - w0:.3f} s", b - a])
        return out


def warm_profiler(run) -> None:
    """Start and stop the profiler once in set-up: its first start in a
    process sets CUPTI up, which took seconds on the chip and would otherwise
    fall into the window."""
    import torch

    t0 = time.monotonic()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        torch.ones(1, device=run.device).sum().item()
    run.say("profiler warm-up", {"seconds": time.monotonic() - t0})


class Profiled:
    """``with Profiled(enabled, path):`` runs its body under ``torch.profiler``
    when enabled; ``trace`` is the :class:`DeviceTrace` afterwards (None when
    not enabled). The chrome trace is written to ``path``, read and removed."""

    def __init__(self, enabled: bool, path: str):
        self.enabled, self.path = enabled, path
        self.marks, self.trace, self._prof = [], None, None

    def mark(self) -> float:
        from torch.profiler import record_function

        with record_function(CLOCK_MARK):
            t = time.monotonic()
        self.marks.append(t)
        return t

    def __enter__(self) -> "Profiled":
        if self.enabled:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            t0 = time.monotonic()
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self.mark()
            self.start_s = self.marks[0] - t0
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        self.mark()
        self._prof.__exit__(None, None, None)
        if exc[0] is not None:
            return
        self._prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as fh:
                self.trace = DeviceTrace.from_chrome(json.load(fh), self.marks)
        finally:
            os.unlink(self.path)
