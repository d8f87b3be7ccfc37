"""The watcher's own spans and its ``watch_events`` counter, for the
per-layer readers of the watcher cell.

The port keeps the spans its watcher threads open outside a probe cycle
(``watch.batch``, ``notify.post``) in a ring of their own, and stamps the
count of events taken off its watch streams at each batch's end
(``k8s_watcher_tpu_torch/probe/spans.py:watch_between``), on the host's
monotonic clock, the run's ``window``'s. A program without that ring gives
nothing, and every reader then returns None.
"""

from __future__ import annotations


def kept(obs: dict):
    """``(spans, events)`` of the window: the watcher spans lying wholly in
    it and the events taken between its two ends; None without the ring."""
    window = obs.get("window")
    if window is None:
        return None
    try:
        from k8s_watcher_tpu_torch.probe.spans import watch_between
    except ImportError:
        return None
    return watch_between(*window)


def mean_ms(obs: dict, name: str):
    """The mean ms of the window's spans ``name``; None where there are none."""
    found = kept(obs)
    spans = [s for s in found[0] if s.name == name] if found else []
    return sum(s.ms for s in spans) / len(spans) if spans else None
