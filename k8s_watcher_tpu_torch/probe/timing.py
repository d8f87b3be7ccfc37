"""Probe timing discipline, as in the JAX package's ``probe/timing.py``.

Each timed call chains its real work inside one launch (inner iterations,
multi-pass kernels) and is fenced by reading one element back to the host
(``.item()`` of one element: PyTorch launches are asynchronous).

Where a launch is timed is decided by its device alone
(:func:`timed_on_device`). On the CPU, :func:`timed_fenced` spans launch and
fence with the host clock and subtracts the separately measured median cost
of the fence, as the reference does; the CPU tests hold the port to the JAX
package through these host-fenced twins. On a CUDA device every reading is
the device's own, at any rank count. There the probe shares its Python
process with the watcher's ingest threads, and every release of the
interpreter lock (each PyTorch call, each fence) can cost the probe thread a
switch interval (5 ms) or more before it runs again: a sub-millisecond GEMM
chain timed on the host clock read tens of times slower than it ran and
tripped a trend alert, and a round of the latency chain on four H100s read
0.12-0.57 ms where NVLink takes microseconds (each reading was the slowest
rank's submission of the call). So each timed call is a CUDA graph, launched
by one C call that records CUDA events around it (``k8w_time_graph``), as
the HBM kernels time themselves (``kernels/hbm.py``): the GEMM chain through
:func:`graph_times_ms`; a collective (a latency chain's rounds, the payload
all-reduce, a link's exchanges) through :func:`collective_times_ms`, behind
the gate after a barrier graph (one tiny collective over the same members),
so the window starts once every member has arrived.

The graphs live in one store for the process (:data:`GRAPHS`), captured in
the first cycle of their key and replayed in every later one. A capture each
cycle cost the cycle more than its own time: ``torch.cuda.graph``
synchronizes the device and empties the caching allocator on entry, which
freed the HBM stages' cached buffers every cycle, to be allocated again.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import logging
import statistics
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

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
    allocator (``torch.cuda.graph``'s entry). One run first, as capture
    requires (the GEMM library makes its handles and workspace outside the
    capture), on the device's side stream (:meth:`GraphStore.side_stream`):
    the library keeps a workspace for every stream it runs on. The capture
    is thread-local: other threads of the process (the watcher's analytics
    requests) keep allocating, copying and synchronizing their own streams
    meanwhile, which a global capture forbids and which would invalidate it."""
    side = GRAPHS.side_stream(device)
    with torch.cuda.device(device):
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


def timed_on_device(device: torch.device) -> bool:
    """Whether the probe's launches on ``device`` are timed on the device, as
    kept CUDA graphs and self-timed kernels, rather than fenced on the host:
    on CUDA, at any rank count."""
    return device.type == "cuda"


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


@dataclasses.dataclass(eq=False)
class KeptCall:
    """A timed call kept as a CUDA graph: the tensors it reads (``inputs``,
    refreshed in place every cycle), its ``graph`` and the ``out`` it
    writes, and a collective's ``barrier`` graph, launched ahead of each
    timed launch. Empty (``graph`` None) until captured."""

    inputs: tuple = ()
    graph: object = None
    out: Optional[torch.Tensor] = None
    barrier: object = None
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    def capture(self, fn, device: torch.device, barrier: Optional[Callable[[], None]] = None) -> None:
        """Capture ``fn``, and ``barrier`` as the barrier graph."""
        self.graph, self.out = capture_graph(fn, device)
        if barrier is not None:
            self.barrier, _ = capture_graph(barrier, device)

    def empty(self) -> None:
        """Let go of the graphs: the next holder captures anew."""
        self.inputs, self.graph, self.out, self.barrier = (), None, None, None


class GraphStore:
    """The process's kept CUDA graphs, one per key, from one cycle to the next.

    A stage's timed call is the same every cycle (its device, sizes and, for
    a collective, members), so it is captured in the first cycle of its key
    and replayed after. Every member of a collective captures the same keys
    in the same order (a capture runs the call once first, which connects
    its peers), and the members then agree that each has captured, so none
    replays a graph that a peer lacks. Collective graphs hold the default
    group's communicators: a new default group drops them all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._world = None
        self._kept: Dict[tuple, KeptCall] = {}
        self._streams: Dict[int, torch.cuda.Stream] = {}

    @contextlib.contextmanager
    def hold(self, key: tuple, world=None) -> Iterator[KeptCall]:
        """What is kept for ``key`` (empty where nothing is), for this caller
        alone until the block ends: no two threads capture or replay one key
        at once. ``world``: a collective's default group. A block that raises
        empties a graph no peer shares; a collective's stays, as its
        members keep theirs."""
        with self._lock:
            if world is not None and world is not self._world:
                self._world = world
                self._kept = {k: v for k, v in self._kept.items() if v.barrier is None}
            kept = self._kept.setdefault(key, KeptCall())
        with kept.lock:
            try:
                yield kept
            except BaseException:
                if world is None:
                    kept.empty()
                raise

    def drop(self) -> None:
        """Let go of every kept graph: before the default group is destroyed,
        so no graph outlives the communicators it launches on."""
        with self._lock:
            self._world, self._kept = None, {}

    def side_stream(self, device: torch.device) -> torch.cuda.Stream:
        """The stream every capture on ``device`` runs its first run on."""
        with self._lock:
            if device.index not in self._streams:
                self._streams[device.index] = torch.cuda.Stream(device)
            return self._streams[device.index]


GRAPHS = GraphStore()


def kept_collective_ms(key: tuple, fn, x: torch.Tensor, barrier: Callable[[], None],
                       agree: Callable[[bool], bool], iters: int, stage: str,
                       timed: Optional[str] = None) -> Tuple[float, float, list]:
    """The collective call ``fn(x)`` as the process's kept graph for ``key``
    on ``x``'s device, warmed and timed: ``(warm, warm_s, samples)``.

    The first cycle of a key captures the call (``barrier()`` as its barrier
    graph) and its members then ``agree(captured)``: a capture that failed
    on any member is kept by none, and raises. Later cycles copy ``x`` into
    the kept input. One untimed launch, fenced, reads ``warm`` (the first
    element of the output), ``warm_s`` after the call began; then ``iters``
    launches are timed by :func:`collective_times_ms`: ``samples``. The
    capture and the warm launch are a ``<stage>.setup`` span, the timed
    launches a ``<stage>.timed`` span, holding the span ``timed`` where
    given."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    with GRAPHS.hold((x.device.index,) + key, dist.group.WORLD) as kept:
        with spans.span(f"{stage}.setup"):
            if kept.graph is None:
                try:
                    kept.capture(lambda: fn(x), x.device, barrier)
                    kept.inputs = (x,)
                except Exception as exc:  # noqa: BLE001 — agreed on below: every member raises alike
                    logger.warning("Capturing the collective %s failed: %s", key, exc)
                    kept.empty()
                if not agree(kept.graph is not None):
                    kept.empty()
                    raise RuntimeError(f"the collective {key} is not captured on every member")
            else:
                kept.inputs[0].copy_(x)
            kept.graph.replay()
            warm = fetch_scalar(kept.out)
            warm_s = time.perf_counter() - t0
        with spans.span(f"{stage}.timed"), spans.span(timed) if timed else contextlib.nullcontext():
            samples = collective_times_ms(kept.graph, kept.out, kept.barrier, iters, x.device)
    return warm, warm_s, samples


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
