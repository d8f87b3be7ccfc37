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

The collectives of a group of several ranks on CUDA are timed on the device
too, as CUDA graphs kept across cycles (:class:`CollectiveGraphs`). Timed on
the host, a round of the latency chain on four H100s of one node read
0.12-0.57 ms where NVLink takes microseconds: each call's reading is the
slowest rank's submission of it, and its host's stalls, so a quiet node's
readings drifted past the trend tracker's factors in about half its cycles.
Submitted call by call, even when timed on the device, the cycle's ~250
collective calls a rank took 50-140 ms of host time, which rose and fell with
the host's speed from run to run. A kept graph holds a timed call's whole
chain (a latency chain's rounds, a link's exchanges); :func:`collective_times_ms`
launches it behind the gate after a barrier graph (one tiny collective over
the same members), so the window starts once every member has arrived and
times the call as the fabric runs it, for one C call of host work. A group
of one rank measures no fabric and keeps the host's clock (its readings fold
into no trend).
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import statistics
import threading
import time
from typing import Callable, Dict, Optional

import torch

from k8s_watcher_tpu_torch.probe import spans

logger = logging.getLogger(__name__)


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
            build.check(lib, lib.k8w_time_graph(exec_handle, None, stream, ctypes.byref(ms)), "graph")
            times.append(ms.value)
    return times


def times_on_device(device: torch.device, n_ranks: int) -> bool:
    """Whether the collectives of a group of ``n_ranks`` on ``device`` are
    timed on the device, as kept CUDA graphs (:class:`CollectiveGraphs`),
    rather than fenced on the host: a group of several CUDA ranks."""
    return device.type == "cuda" and n_ranks > 1


def collective_times_ms(graph, out: torch.Tensor, barrier, iters: int, device: torch.device) -> list:
    """``[(ms, value), ...]`` of ``iters`` launches of a collective's
    ``graph``, each timed by one C call (``k8w_time_graph``) behind the gate
    after one launch of the ``barrier`` graph, then fenced by reading the
    first element of ``out`` (the graph's output) back: ``value``. The window
    holds neither the host's submission nor the wait for the other members'
    arrival."""
    from k8s_watcher_tpu_torch.kernels import build

    lib = build.load()
    exec_handle, before = graph.raw_cuda_graph_exec(), barrier.raw_cuda_graph_exec()
    stream = torch.cuda.current_stream(device).cuda_stream
    samples = []
    with torch.cuda.device(device):
        for _ in range(iters):
            ms = ctypes.c_float()
            build.check(lib, lib.k8w_time_graph(exec_handle, before, stream, ctypes.byref(ms)), "collective graph")
            samples.append((ms.value, read_scalar(out)))
    return samples


@dataclasses.dataclass
class KeptCollective:
    """One timed call of a collective as a CUDA graph, with the barrier
    graph launched ahead of each timed launch; ``x`` is the input the graph
    reads, ``out`` what it writes."""

    x: torch.Tensor
    graph: object
    out: torch.Tensor
    barrier: object

    def replay(self) -> torch.Tensor:
        """One untimed launch; ``out``."""
        self.graph.replay()
        return self.out

    def times_ms(self, iters: int) -> list:
        """:func:`collective_times_ms` of ``iters`` launches."""
        return collective_times_ms(self.graph, self.out, self.barrier, iters, self.x.device)


class CollectiveGraphs:
    """The process's collective graphs, kept from one cycle to the next.

    A stage's timed call is the same every cycle (its members, sizes and
    input), so it is captured once, in the first cycle of its key, and
    replayed after; later cycles make no call into ``torch.distributed``
    for it. Every member captures the same keys in the same order: a capture
    runs the call once first (``capture_graph``), which connects its peers.
    The members then agree that each has captured, so none replays a graph
    that a peer lacks. Graphs hold the default group's communicators: a new
    default group drops them all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._world = None
        self._kept: Dict[tuple, KeptCollective] = {}

    def get(self, key: tuple, fn, x: torch.Tensor, barrier: Callable[[], None],
            agree: Callable[[bool], bool]) -> KeptCollective:
        """The kept call ``fn(x)`` for ``key``, captured where none is (with
        ``barrier()`` as its barrier graph, then ``agree(captured)`` over
        its members); a kept one reads ``x`` copied into its input."""
        import torch.distributed as dist

        with self._lock:
            if self._world is not dist.group.WORLD:
                self._world, self._kept = dist.group.WORLD, {}
            kept = self._kept.get(key)
        if kept is not None:
            kept.x.copy_(x)
            return kept
        kept = None
        try:
            graph, out = capture_graph(lambda: fn(x), x.device)
            barrier_graph, _ = capture_graph(barrier, x.device)
            kept = KeptCollective(x, graph, out, barrier_graph)
        except Exception as exc:  # noqa: BLE001 — agreed on below: every member raises alike
            logger.warning("Capturing the collective %s failed: %s", key, exc)
        if not agree(kept is not None):
            raise RuntimeError(f"the collective {key} is not captured on every member")
        with self._lock:
            self._kept[key] = kept
        return kept

    def drop(self) -> None:
        """Let go of every kept graph: before the default group is destroyed,
        so no graph outlives the communicators it launches on."""
        with self._lock:
            self._world, self._kept = None, {}


COLLECTIVE_GRAPHS = CollectiveGraphs()


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
