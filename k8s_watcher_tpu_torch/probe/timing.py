"""Probe timing discipline, as in the JAX package's ``probe/timing.py``.

Each timed call chains its real work inside one launch (inner iterations,
multi-pass kernels), is fenced by reading one element back to the host, and
has the separately measured median cost of that fence subtracted. PyTorch
launches are asynchronous, so ``.item()`` of one element is the completion
fence here as the host readback is in the reference; on a local card the
fence costs microseconds and the subtraction is small, but the readings mean
what they mean in the reference.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch


def fetch_scalar(out) -> float:
    """Read one element of ``out`` (a tensor, or a tuple/list whose first
    item is one) back to the host: the completion fence."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return float(out.reshape(-1)[0].item())


def fence_baseline_ms(device: Optional[torch.device] = None, samples: int = 3) -> float:
    """Median cost of the completion fence itself (readback of a tiny tensor)."""
    tiny = torch.zeros((2,), dtype=torch.float32, device=device)
    fetch_scalar(tiny)  # warm the path
    costs = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fetch_scalar(tiny)
        costs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(costs)


class TimedStats(tuple):
    """(min, mean, max) seconds, plus ``median`` (the robust headline: the
    min estimator over-subtracts the median fence from the luckiest sample)
    and ``unreliable`` (device time buried in fence noise)."""

    median: float
    unreliable: bool

    def __new__(cls, tmin: float, tmean: float, tmax: float, unreliable: bool, median: float):
        obj = super().__new__(cls, (tmin, tmean, tmax))
        obj.unreliable = unreliable
        obj.median = median
        return obj


def timed_fenced(fn, x, iters: int, baseline_ms: float = 0.0) -> TimedStats:
    """(min, mean, max) SECONDS over ``iters`` fenced calls of ``fn(x)``,
    each with the fence baseline subtracted (clamped at ~0). ``unreliable``
    is set when the best sample's device share is under a quarter of the
    baseline."""
    times = []
    raw_min = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fetch_scalar(fn(x))
        raw = time.perf_counter() - t0
        raw_min = min(raw_min, raw)
        times.append(max(raw - baseline_ms / 1e3, 1e-9))
    unreliable = baseline_ms > 0 and (raw_min - baseline_ms / 1e3) < 0.25 * baseline_ms / 1e3
    return TimedStats(
        min(times), sum(times) / len(times), max(times), unreliable, statistics.median(times)
    )
