"""Ranges around the port's stage entries, taken from the benchmark's side.

:meth:`Spans.wrap` replaces a function or method of the port, for the run's
process only, by one that times the call on the host's monotonic clock,
wraps it in a ``torch.profiler.record_function`` range of the same name and
keeps a :class:`Range`. A hook (:meth:`Spans.hook`) runs beside a call and
may note the work it did (``Range.work``) on the innermost open range of its
thread. :meth:`Spans.replace` puts another function in a port's place (the
controls). :meth:`Spans.restore` puts every original back.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class Range:
    name: str
    tid: int  # the thread's native id, as the profiler's runtime events carry it
    t0: float
    t1: float = 0.0
    work: dict = dataclasses.field(default_factory=dict)


class Spans:
    def __init__(self):
        self.ranges = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._patched = []
        self.listeners = []  # called with each closed Range, on its thread

    def _open(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def wrap(self, owner, attr: str, name: str, after: Optional[Callable] = None) -> None:
        """Time every call of ``owner.attr`` as a range ``name``; ``after(range,
        args, kwargs, result)`` notes its work."""
        from torch.profiler import record_function

        original = getattr(owner, attr)
        spans = self

        def ranged(*args, **kwargs):
            rng = Range(name, threading.get_native_id(), time.monotonic())
            stack = spans._open()
            stack.append(rng)
            try:
                with record_function(name):
                    result = original(*args, **kwargs)
            finally:
                stack.pop()
                rng.t1 = time.monotonic()
            if after is not None:
                after(rng, args, kwargs, result)
            with spans._lock:
                spans.ranges.append(rng)
            for listener in spans.listeners:
                listener(rng)
            return result

        self._patched.append((owner, attr, original))
        setattr(owner, attr, ranged)

    def hook(self, owner, attr: str, after: Callable) -> None:
        """Call ``after(innermost open range or None, args, kwargs, result)``
        after every call of ``owner.attr``."""
        original = getattr(owner, attr)
        spans = self

        def hooked(*args, **kwargs):
            result = original(*args, **kwargs)
            stack = spans._open()
            after(stack[-1] if stack else None, args, kwargs, result)
            return result

        self._patched.append((owner, attr, original))
        setattr(owner, attr, hooked)

    def replace(self, owner, attr: str, substitute: Callable) -> None:
        """Put ``substitute`` in the place of ``owner.attr`` (the controls)."""
        self._patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, substitute)

    def restore(self) -> None:
        for owner, attr, original in reversed(self._patched):
            setattr(owner, attr, original)
        self._patched.clear()

    def named(self, name: str, t0: float, t1: float) -> list:
        """The ranges ``name`` that lie wholly in ``[t0, t1]``."""
        with self._lock:
            return [r for r in self.ranges if r.name == name and t0 <= r.t0 and r.t1 <= t1]
