"""Spans and counters inside the probe cycle, and the watcher's own.

A span is ``(name, parent, start, end, thread)``: ``start`` and ``end`` are
``time.monotonic()`` seconds, the clock of the trace plane's ``(stage, start,
end)`` triples; ``parent`` is the innermost span open on the same thread when
it opened; ``thread`` is the thread's native id, the one ``torch.profiler``
events carry. A :func:`cycle` opened with no cycle open on its thread starts a
:class:`Cycle`: every span the thread opens until the cycle closes belongs to
it. Spans opened outside any cycle (a probe run on its own) keep the parent
chain and are then dropped.

Completed cycles go into one ring of ``RING_CYCLES`` for the process
(:func:`cycles_between`).

The watcher's threads open spans outside any cycle: :func:`watch_span`
(``watch.batch``, one ingest batch through the pipeline to the egress lanes;
``notify.post``, one egress POST). Such a span, and every span its thread
opens inside it, goes into a ring of ``WATCH_RING`` spans of its own when it
closes (:func:`watch_between`); opened inside a cycle, it is the cycle's.
:func:`take` counts the events the watch streams delivered (``watch_events``:
each one parsed, and each one the prefilter dropped unparsed); the count
reached is stamped at each outermost watcher span's end, so a window reads
the events taken between two stamps.

A span costs two ``monotonic()`` calls and an append. While
``torch.profiler`` records, each span also opens a ``RecordFunction`` range
of its name (what ``record_function`` opens) inside its stamps, so a
profiler trace shows the stages around the kernels they launched, at one
offset from the spans' clock; with the profiler off no range is opened.

Each cycle's counters: ``syncs`` (its ``probe.sync`` spans: the blocking
readbacks outside the timed launches, which read back through the bare
fence), ``collectives`` (the rank's collective calls and batched
point-to-point exchanges; none in a group of one rank), ``graph_captures``,
``queued_launches`` (the HBM stages' timed launches submitted while the
stage's launch before them was still queued or running: 8 a cycle on the
card, none on the CPU), ``device_allocs`` (the change in the CUDA caching
allocator's ``num_device_alloc`` across the cycle; CUDA only) and ``gc_ms``:
the interpreter's collections during the cycle, on every thread (a
collection on another thread holds the probe thread through the interpreter
lock), timed by a ``gc.callbacks`` hook that is installed only while a cycle
is open, so the rest of the process pays nothing between cycles.
"""

from __future__ import annotations

import collections
import functools
import gc
import threading
import time
from typing import Dict, List, Optional

import torch

RING_CYCLES = 1024  # > 8 h at production's 30 s cadence
WATCH_RING = 1 << 16  # watcher spans: minutes of batches and POSTs at a busy ingest
CYCLE = "probe.cycle"
SYNC = "probe.sync"

_profiler_enabled = torch._C._autograd._profiler_enabled
# a RecordFunction range, as ``record_function`` opens, at a tenth of its cost
# (0.8 µs against 8 µs on a CPU)
_Range = torch._C._profiler._RecordFunctionFast


class Span:
    __slots__ = ("name", "parent", "start", "end", "thread")

    def __init__(self, name: str, parent: Optional["Span"], start: float, thread: int):
        self.name = name
        self.parent = parent
        self.start = start
        self.end: Optional[float] = None
        self.thread = thread

    @property
    def ms(self) -> float:
        return 1e3 * (self.end - self.start)

    def __repr__(self) -> str:
        parent = self.parent.name if self.parent is not None else None
        return f"Span({self.name!r}, parent={parent!r}, {self.start:.6f}-{self.end}, thread={self.thread})"


def union_s(spans) -> float:
    """Seconds covered by the union of ``spans``' intervals."""
    total, end = 0.0, float("-inf")
    for s in sorted(spans, key=lambda s: s.start):
        if s.start > end:
            total += s.end - s.start
            end = s.end
        elif s.end > end:
            total += s.end - end
            end = s.end
    return total


class Cycle:
    """One cycle: its ``probe.cycle`` span, every span of it (the cycle's own
    last), and its counters."""

    __slots__ = ("span", "spans", "counters", "_gc0", "_device", "_allocs0")

    def __init__(self, span: Span):
        self.span = span
        self.spans: List[Span] = []
        self.counters: Dict[str, object] = {"graph_captures": 0, "collectives": 0, "queued_launches": 0}

    @property
    def start(self) -> float:
        return self.span.start

    @property
    def end(self) -> float:
        return self.span.end

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self) -> List[Span]:
        """The stages: spans opened directly under the cycle's."""
        return [s for s in self.spans if s.parent is self.span]

    def self_ms(self) -> float:
        """The cycle's length less the part its child spans cover."""
        return self.span.ms - 1e3 * union_s(self.children())

    def stages_ms(self) -> Dict[str, float]:
        """Each child span's ms by its name less ``probe.``, and ``self``."""
        out: Dict[str, float] = {}
        for s in self.children():
            key = s.name.removeprefix("probe.")
            out[key] = out.get(key, 0.0) + s.ms
        out["self"] = self.self_ms()
        return out

    def gc_ms(self) -> float:
        return self.counters["gc_ms"]


def _device_allocs(device) -> Optional[int]:
    """The caching allocator's ``num_device_alloc`` on a CUDA ``device``;
    None elsewhere. Before CUDA's first use in the process (a first cycle)
    torch has no statistics, and nothing has been allocated."""
    if device is None or torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_initialized():
        return 0
    return torch.cuda.memory_stats_as_nested_dict(device)["num_device_alloc"]


class _Thread(threading.local):
    def __init__(self):
        self.stack: List[Span] = []
        self.kept = 0  # watcher spans open on this thread outside a cycle
        self.cycle: Optional[Cycle] = None  # open on this thread
        self.last: Optional[Cycle] = None  # the last one closed on this thread
        self.tid = threading.get_native_id()


class _Scope:
    """``with recorder.span(name):`` — see :meth:`SpanRecorder.span`."""

    __slots__ = ("rec", "name", "device", "span", "range", "keep")

    def __init__(self, rec: "SpanRecorder", name: str, device=None, keep: bool = False):
        self.rec, self.name, self.device, self.keep = rec, name, device, keep
        self.span = self.range = None

    def __enter__(self) -> Span:
        st = self.rec._local
        span = self.span = Span(self.name, st.stack[-1] if st.stack else None, time.monotonic(), st.tid)
        if _profiler_enabled():
            self.range = _Range(self.name)
            self.range.__enter__()
        st.stack.append(span)
        if self.name == CYCLE and st.cycle is None:
            self.rec._open_cycle(st, span, self.device)
        elif self.keep:
            # from here on ``keep`` says whether this span counts in the thread's open watcher spans
            self.keep = st.cycle is None
            st.kept += self.keep
        return span

    def __exit__(self, *exc) -> None:
        span = self.span
        if self.range is not None:
            self.range.__exit__(None, None, None)
        span.end = time.monotonic()
        st = self.rec._local
        st.stack.pop()
        cycle = st.cycle
        if cycle is not None:
            cycle.spans.append(span)
            if cycle.span is span:
                self.rec._close_cycle(st, cycle)
        elif st.kept:
            self.rec._keep(span, outermost=self.keep and st.kept == 1)
            st.kept -= self.keep


class SpanRecorder:
    """The spans of the cycles of a process, and its ring of completed ones."""

    def __init__(self, capacity: int = RING_CYCLES, watch_capacity: int = WATCH_RING):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = _Thread()
        self._cycles_open = 0  # on every thread; the GC hook is in while above 0
        self._gc_ms = 0.0
        self._gc_t0: Optional[float] = None
        self._watch: collections.deque = collections.deque(maxlen=watch_capacity)
        self._stamps: collections.deque = collections.deque(maxlen=watch_capacity)  # (end, events taken)
        self._taken = 0
        self._taken_lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def span(self, name: str) -> _Scope:
        """``with recorder.span(name):`` times its body as a span ``name``."""
        return _Scope(self, name)

    def sync(self) -> _Scope:
        """A blocking readback of device data (``probe.sync``)."""
        return _Scope(self, SYNC)

    def cycle(self, device=None) -> _Scope:
        """The ``probe.cycle`` span; ``device`` is the one whose allocator is
        counted."""
        return _Scope(self, CYCLE, device)

    def watch_span(self, name: str) -> _Scope:
        """``with recorder.watch_span(name):`` a span of the watcher's, kept
        in the watcher ring when no cycle is open on its thread."""
        return _Scope(self, name, keep=True)

    def traced(self, name: str, keep: bool = False):
        """A decorator: every call of the function is a span ``name`` (a
        watcher span with ``keep``)."""

        def wrap(fn):
            @functools.wraps(fn)
            def spanned(*args, **kwargs):
                with _Scope(self, name, keep=keep):
                    return fn(*args, **kwargs)

            return spanned

        return wrap

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` of the cycle open on this thread."""
        cycle = self._local.cycle
        if cycle is not None:
            cycle.counters[name] = cycle.counters.get(name, 0) + n

    def cycles_between(self, t0: float, t1: float) -> List[Cycle]:
        """The completed cycles lying wholly in ``[t0, t1]`` (monotonic), oldest first."""
        with self._lock:
            cycles = list(self._ring)
        return [c for c in cycles if t0 <= c.start and c.end <= t1]

    def take(self, n: int = 1) -> None:
        """Count ``n`` events taken off the watch streams."""
        with self._taken_lock:
            self._taken += n

    def taken(self) -> int:
        """The events taken off the watch streams so far in the process."""
        return self._taken

    def watch_between(self, t0: float, t1: float):
        """``(spans, events)``: the watcher spans lying wholly in ``[t0, t1]``
        (monotonic), oldest first, and the events taken between the last
        stamps at or before ``t0`` and ``t1``."""
        with self._lock:
            kept, stamps = list(self._watch), list(self._stamps)

        def at(t: float) -> int:
            return max((n for end, n in stamps if end <= t), default=0)

        return [s for s in kept if t0 <= s.start and s.end <= t1], at(t1) - at(t0)

    def last(self) -> Optional[Cycle]:
        """The last cycle completed on this thread."""
        return self._local.last

    def _open_cycle(self, st: _Thread, span: Span, device) -> None:
        cycle = Cycle(span)
        with self._lock:
            self._cycles_open += 1
            if self._cycles_open == 1:
                gc.callbacks.append(self._on_gc)
            cycle._gc0 = self._gc_ms
        cycle._device = device
        cycle._allocs0 = _device_allocs(device)
        st.cycle = cycle

    def _close_cycle(self, st: _Thread, cycle: Cycle) -> None:
        st.cycle, st.last = None, cycle
        c = cycle.counters
        c["syncs"] = sum(1 for s in cycle.spans if s.name == SYNC)
        if cycle._allocs0 is not None:
            c["device_allocs"] = _device_allocs(cycle._device) - cycle._allocs0
        cycle._device = None
        with self._lock:
            c["gc_ms"] = self._gc_ms - cycle._gc0
            self._cycles_open -= 1
            if self._cycles_open == 0:
                gc.callbacks.remove(self._on_gc)
                self._gc_t0 = None  # a collection in flight is no longer timed
            self._ring.append(cycle)

    def _keep(self, span: Span, outermost: bool) -> None:
        with self._lock:
            self._watch.append(span)
            if outermost:
                self._stamps.append((span.end, self._taken))

    def _on_gc(self, phase: str, info: dict) -> None:
        # takes no lock: a collection can start inside any allocation,
        # including one made while this recorder's lock is held; one
        # collection runs at a time in a process
        now = time.monotonic()
        if phase == "start":
            self._gc_t0 = now
        elif self._gc_t0 is not None:
            self._gc_ms += 1e3 * (now - self._gc_t0)
            self._gc_t0 = None


RECORDER = SpanRecorder()

span = RECORDER.span
sync = RECORDER.sync
cycle = RECORDER.cycle
traced = RECORDER.traced
count = RECORDER.count
cycles_between = RECORDER.cycles_between
watch_span = RECORDER.watch_span
take = RECORDER.take
watch_between = RECORDER.watch_between
