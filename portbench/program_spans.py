"""The program's own spans and counters, for the per-layer readers.

The port keeps every completed probe cycle, with its spans and counters, in a
ring of its process (``k8s_watcher_tpu_torch/probe/spans.py``), on the host's
monotonic clock, the clock the run's ``window`` and the device trace use. A
reader takes the cycles that lie wholly in the window. A program that keeps
no such ring gives no cycles, and every reader then returns None.
"""

from __future__ import annotations

SETUP = ".setup"


def cycles(obs: dict) -> list:
    """The program's ``probe.cycle``s inside ``obs["window"]``, oldest first."""
    window = obs.get("window")
    if window is None:
        return []
    try:
        from k8s_watcher_tpu_torch.probe.spans import cycles_between
    except ImportError:
        return []
    return cycles_between(*window)


def per_cycle(obs: dict, value):
    """The mean of ``value(cycle)`` over the window's cycles; None where there
    are none, or where any cycle gives None."""
    values = [value(c) for c in cycles(obs)]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def outermost_setups(cycle) -> list:
    """The cycle's ``probe.<stage>.setup`` spans that lie in no other such span."""
    out = []
    for s in cycle.spans:
        if not (s.name.startswith("probe.") and s.name.endswith(SETUP)):
            continue
        parent = s.parent
        while parent is not None and not parent.name.endswith(SETUP):
            parent = parent.parent
        if parent is None:
            out.append(s)
    return out
