"""Probe timing discipline, as in the JAX package's ``probe/timing.py``.

Each timed call chains its real work inside one launch (inner iterations,
multi-pass kernels) and is fenced by reading one element back to the host
(``.item()`` of one element: PyTorch launches are asynchronous).

:func:`timed_fenced` spans launch and fence with the host clock and
subtracts the separately measured median cost of the fence, as the reference
does. The readings the trend tracker holds (GEMM TFLOP/s, HBM GB/s) are the
device's own on a CUDA device instead. In the watcher the probe shares its
Python process with the ingest threads, and every release of the interpreter
lock (each PyTorch call, each fence) can cost the probe thread a wait of a
switch interval (5 ms) or more before it runs again: a sub-millisecond GEMM
chain timed on the host clock read tens of times slower than it ran, and
tripped a trend alert. So the GEMM chain is captured into a CUDA graph and
launched by one C call that records CUDA events around it
(:func:`graph_times_ms`), as the HBM kernels time themselves
(``kernels/hbm.py``).

The graph is captured once per key (device, size, inner iterations) and
replayed in every later cycle (``probe/ici.py:GemmGraphs``). A capture each
cycle cost the cycle more than its own time: ``torch.cuda.graph`` synchronizes
the device and empties the caching allocator on entry, so every cycle handed
the HBM stages' cached buffers back to the driver and allocated them again.
"""

from __future__ import annotations

import ctypes
import statistics
import time
from typing import Optional

import torch

from k8s_watcher_tpu_torch.probe import spans


def read_scalar(out) -> float:
    """Read one element of ``out`` (a tensor, or a tuple/list whose first
    item is one) back to the host: the completion fence, bare, as the timed
    launches and the fence baseline's samples take it."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return float(out.reshape(-1)[0].item())


def fetch_scalar(out) -> float:
    """:func:`read_scalar` as a ``probe.sync`` span: a fence outside the
    timed launches."""
    with spans.sync():
        return read_scalar(out)


def fence_baseline_ms(device: Optional[torch.device] = None, samples: int = 3) -> float:
    """Median cost of the completion fence itself (readback of a tiny tensor),
    sampled through the same bare :func:`read_scalar` the timed launches
    end in."""
    tiny = torch.zeros((2,), dtype=torch.float32, device=device)
    fetch_scalar(tiny)  # warm the path
    costs = []
    for _ in range(samples):
        t0 = time.perf_counter()
        read_scalar(tiny)
        costs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(costs)


def capture_graph(fn, device: torch.device):
    """``fn()`` captured into a CUDA graph: ``(graph, output)``, to be kept and
    replayed: each call synchronizes the device and empties the caching
    allocator (``torch.cuda.graph``'s entry). One run on a side stream
    first, as capture requires (the GEMM library makes its handles and
    workspace outside the capture). The capture is thread-local:
    other threads of the process (the watcher's analytics requests) keep
    allocating, copying and synchronizing their own streams meanwhile, which
    a global capture forbids and which would invalidate it."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        spans.count("graph_captures")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
    return graph, out


def graph_times_ms(graph, device: torch.device, iters: int) -> list:
    """Device ms of ``iters`` launches of ``graph``, each launched and timed
    by one C call (``k8w_time_graph``), so no host delay falls inside."""
    from k8s_watcher_tpu_torch.kernels import build

    lib = build.load()
    exec_handle = graph.raw_cuda_graph_exec()
    stream = torch.cuda.current_stream(device).cuda_stream
    times = []
    with torch.cuda.device(device):
        for _ in range(iters):
            ms = ctypes.c_float()
            build.check(lib, lib.k8w_time_graph(exec_handle, stream, ctypes.byref(ms)), "graph")
            times.append(ms.value)
    return times


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

    @classmethod
    def of(cls, times: list, unreliable: bool = False) -> "TimedStats":
        return cls(min(times), sum(times) / len(times), max(times), unreliable, statistics.median(times))


def timed_fenced(fn, x, iters: int, baseline_ms: float = 0.0) -> TimedStats:
    """(min, mean, max) SECONDS over ``iters`` fenced calls of ``fn(x)``,
    each with the fence baseline subtracted (clamped at ~0). ``unreliable``
    is set when the best sample's device share is under a quarter of the
    baseline."""
    times = []
    raw_min = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        read_scalar(fn(x))
        raw = time.perf_counter() - t0
        raw_min = min(raw_min, raw)
        times.append(max(raw - baseline_ms / 1e3, 1e-9))
    unreliable = baseline_ms > 0 and (raw_min - baseline_ms / 1e3) < 0.25 * baseline_ms / 1e3
    return TimedStats.of(times, unreliable)
