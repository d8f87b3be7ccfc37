"""The arithmetic the per-layer readers (``metrics/<name>.py``) share.

Each reader gets the run's observation: ``device_trace`` (a
``devtrace.DeviceTrace``, None without ``--trace 1``), ``spans`` (the
``spans.Spans`` of the port's stage entries), ``window`` (the measured
``(start, end)``, host monotonic). A reader returns None when it finds
nothing to read.
"""

from __future__ import annotations


def ranges_in_window(obs: dict, name: str) -> list:
    spans, window = obs.get("spans"), obs.get("window")
    if spans is None or window is None:
        return []
    return spans.named(name, *window)


def roofline_pct(obs: dict, stage: str, work: str, peak: float):
    """The stage's counted work over the peak rate, as a share of the device
    time of the operations it launched in the window."""
    trace = obs.get("device_trace")
    ranges = [r for r in ranges_in_window(obs, stage) if r.work.get(work)]
    if trace is None or not ranges:
        return None
    device_s = trace.device_s(ranges)
    if device_s <= 0:
        return None
    return 100.0 * sum(r.work[work] for r in ranges) / peak / device_s


def idle_pct(obs: dict):
    """The share of the traced window in which no operation ran on the device."""
    trace = obs.get("device_trace")
    if trace is None:
        return None
    w0, w1 = trace.window
    return 100.0 * (1.0 - trace.busy_s() / (w1 - w0))
