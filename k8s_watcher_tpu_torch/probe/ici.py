"""Timed collective + GEMM probes (the JAX package's ``probe/ici.py``).

Measurement discipline (see probe/timing.py): the first call is the warmup,
each timed call chains ``inner_iters`` dependent operations, and each is
fenced by a one-element readback with the median fence cost subtracted. The
minimum is reported as the RTT (least-noise estimate), beside mean, max and
the median headline. A group of several ranks on CUDA keeps each timed call
of the chain and of the bandwidth all-reduce as a CUDA graph and times it on
the device instead, behind a gate after a barrier
(``probe/timing.py:CollectiveGraphs``).

On Hopper the collectives are NCCL's and the GEMM is cuBLAS's through
``torch.matmul``, as the JAX package left both to XLA rather than Pallas.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from k8s_watcher_tpu_torch.parallel.collectives import (
    allreduce_bus_bandwidth_gbps,
    bandwidth_probe_input,
    make_allreduce_bandwidth_probe,
    all_agree,
    make_barrier,
    make_psum_probe,
    psum_probe_input,
)
from k8s_watcher_tpu_torch.parallel.mesh import Mesh, host_chip_mesh
from k8s_watcher_tpu_torch.probe import spans
from k8s_watcher_tpu_torch.probe.device import device_id, resolve_device
from k8s_watcher_tpu_torch.probe.timing import (
    TimedStats,
    capture_graph,
    fence_baseline_ms,
    fetch_scalar,
    COLLECTIVE_GRAPHS,
    KeptCollective,
    graph_times_ms,
    timed_fenced,
    times_on_device,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class IciProbeResult:
    ok: bool
    n_devices: int
    n_hosts: int
    psum_rtt_ms: float  # min over iters (best case)
    psum_rtt_mean_ms: float
    psum_rtt_max_ms: float
    psum_rtt_median_ms: float  # robust headline (see probe/timing.py)
    psum_correct: bool
    bandwidth_gbps: float  # min-time-based (best case)
    bandwidth_gbps_median: float
    payload_bytes: int
    compile_ms: float
    error: Optional[str] = None
    # True when the fence-noise floor makes rtt/bandwidth untrustworthy
    timing_unreliable: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _kept(key: tuple, fn, x, mesh: Mesh) -> KeptCollective:
    """``fn(x)`` as this rank's kept graph for ``key``, its barrier one
    all-reduce over the mesh's group."""
    return COLLECTIVE_GRAPHS.get((device_id(mesh.device),) + key, fn, x, make_barrier(mesh.group, mesh.device),
                                 lambda ok: all_agree(ok, mesh.device, mesh.group))


def _device_timed(kept: KeptCollective, iters: int) -> TimedStats:
    """Seconds of ``iters`` launches of a kept graph, timed on the device."""
    return TimedStats.of([ms / 1e3 for ms, _ in kept.times_ms(iters)])


@spans.traced("probe.ici")
def run_ici_probe(
    mesh: Optional[Mesh] = None,
    *,
    payload_bytes: int = 4 * 1024 * 1024,
    iters: int = 10,
    inner_iters: int = 10,
    fault=None,  # faults.ici.IciFaultSpec — chaos testing only
    device=None,
) -> IciProbeResult:
    """Latency (chained tiny all-reduces) + bandwidth (one large all-reduce).

    Bandwidth stays 0.0 in a group of one rank: there is no link to measure.
    Its timed launches are a ``probe.ici.bandwidth`` span inside
    ``probe.ici.timed``."""
    try:
        with spans.span("probe.ici.setup"):
            if mesh is None:
                mesh = host_chip_mesh(resolve_device(device))
            n = mesh.size
            n_hosts = mesh.ranks.shape[0]

            t0 = time.perf_counter()
            psum = make_psum_probe(mesh, inner_iters, fault)
            x = psum_probe_input(mesh)
            graphed = times_on_device(mesh.device, n)
            if graphed:
                chain = _kept(("psum", inner_iters, fault), psum, x, mesh)
                result = chain.replay()
            else:
                result = psum(x)
            fetch_scalar(result)  # warmup (fenced)
            compile_ms = 1e3 * (time.perf_counter() - t0)

            expected = (n + 1) / 2.0  # fixed point of chained all_reduce(x)/n
            with spans.sync():
                psum_correct = bool(np.allclose(result.cpu().numpy()[0], expected))

            # a graph is timed on the device: no fence to subtract
            baseline_ms = 0.0 if graphed else fence_baseline_ms(mesh.device)
        with spans.span("probe.ici.timed"):
            rtt_stats = _device_timed(chain, iters) if graphed else timed_fenced(psum, x, iters, baseline_ms)
        rtt_min, rtt_mean, rtt_max = (t / inner_iters for t in rtt_stats)
        unreliable = rtt_stats.unreliable

        bw_gbps = 0.0
        bw_gbps_median = 0.0
        if payload_bytes > 0 and n > 1:
            with spans.span("probe.ici.setup"):
                bw_fn = make_allreduce_bandwidth_probe(mesh, payload_bytes, fault)
                payload = bandwidth_probe_input(mesh, payload_bytes)
                if graphed:
                    bandwidth = _kept(("bandwidth", payload_bytes, fault), bw_fn, payload, mesh)
                    fetch_scalar(bandwidth.replay())  # warmup
                else:
                    fetch_scalar(bw_fn(payload))  # warmup
            bw_iters = max(3, iters // 3)
            with spans.span("probe.ici.timed"), spans.span("probe.ici.bandwidth"):
                if graphed:
                    bw_stats = _device_timed(bandwidth, bw_iters)
                else:
                    bw_stats = timed_fenced(bw_fn, payload, bw_iters, baseline_ms)
            bw_gbps = allreduce_bus_bandwidth_gbps(payload_bytes, n, bw_stats[0])
            bw_gbps_median = allreduce_bus_bandwidth_gbps(payload_bytes, n, bw_stats.median)
            unreliable = unreliable or bw_stats.unreliable

        return IciProbeResult(
            ok=psum_correct,
            n_devices=n,
            n_hosts=n_hosts,
            psum_rtt_ms=1e3 * rtt_min,
            psum_rtt_mean_ms=1e3 * rtt_mean,
            psum_rtt_max_ms=1e3 * rtt_max,
            psum_rtt_median_ms=1e3 * rtt_stats.median / inner_iters,
            psum_correct=psum_correct,
            bandwidth_gbps=bw_gbps,
            bandwidth_gbps_median=bw_gbps_median,
            payload_bytes=payload_bytes,
            compile_ms=compile_ms,
            timing_unreliable=unreliable,
        )
    except Exception as exc:  # noqa: BLE001 — a failed probe is an unhealthy reading
        logger.error("ICI probe failed: %s", exc)
        return IciProbeResult(
            ok=False, n_devices=0, n_hosts=0,
            psum_rtt_ms=-1.0, psum_rtt_mean_ms=-1.0, psum_rtt_max_ms=-1.0,
            psum_rtt_median_ms=-1.0,
            psum_correct=False, bandwidth_gbps=0.0, bandwidth_gbps_median=0.0,
            payload_bytes=payload_bytes,
            compile_ms=0.0, error=str(exc),
        )


def mxu_chain(a: torch.Tensor, b: torch.Tensor, inner_iters: int, inv_scale: float) -> torch.Tensor:
    """``inner_iters`` dependent bf16 GEMMs ``carry @ b``, each rescaled by the
    constant ``inv_scale`` and rounded back to bf16.

    The GEMM accumulates in fp32 and rounds its product to bf16 once; the
    rescale then runs in fp32. Where ``inv_scale`` is a power of two (sizes
    that are powers of four, as the defaults are), that is the JAX chain's
    rounding exactly: scaling by a power of two commutes with rounding."""
    carry = a
    for _ in range(inner_iters):
        carry = (torch.matmul(carry, b).float() * inv_scale).to(torch.bfloat16)
    return carry


def mxu_operands(size: int, device, out=None) -> tuple:
    """The chain's operands ``(a, b)``: unit normals from a ``torch.Generator``
    seeded 0, rounded to bf16. Drawn into the two tensors of ``out`` where
    given, so a kept graph reads the same inputs as a fresh draw."""
    gen = torch.Generator(device=device).manual_seed(0)
    if out is None:
        return tuple(torch.randn((size, size), generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    for t in out:
        t.copy_(torch.randn(t.shape, generator=gen, device=device))
    return out


class KeptGraph:
    """The GEMM chain's operands, and the CUDA graph that reads them with its
    output, for one key ``(device index, size, inner_iters)``."""

    __slots__ = ("key", "operands", "graph", "out")

    def __init__(self, key: tuple):
        self.key = key
        self.operands: Optional[tuple] = None
        self.graph = None
        self.out: Optional[torch.Tensor] = None

    def draw(self, size: int, device) -> tuple:
        """The operands, drawn anew into the kept tensors: a flipped bit in
        one does not outlast the cycle."""
        self.operands = mxu_operands(size, device, out=self.operands)
        return self.operands

    def capture(self, fn, device) -> tuple:
        """``(graph, output)`` of ``fn``, captured where none is kept."""
        if self.graph is None:
            with spans.span("probe.mxu.capture"):
                self.graph, self.out = capture_graph(fn, device)
        return self.graph, self.out


class GemmGraphs:
    """The GEMM chain's CUDA graph, kept from one cycle to the next.

    Every cycle of a process runs the same chain, on the same device and
    operands, so its graph is captured once and replayed after. Capturing
    anew each cycle cost more than the capture: ``torch.cuda.graph``
    synchronizes and empties the caching allocator on entry, which handed
    the HBM stages' cached buffers back to the driver every cycle, to be
    allocated again. One key is kept at a time; another key, or a stage that
    raised inside :meth:`hold`, drops what was kept."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kept: Optional[KeptGraph] = None

    @contextlib.contextmanager
    def hold(self, key: tuple) -> Iterator[KeptGraph]:
        """What is kept for ``key`` (new and empty where it was not), for
        this caller alone until the block ends: no two threads replay or
        capture one graph at once."""
        with self._lock:
            if self._kept is None or self._kept.key != key:
                self._kept = KeptGraph(key)
            try:
                yield self._kept
            except BaseException:
                self._kept = None
                raise


GRAPHS = GemmGraphs()  # the process's: each rank probes one device with one key


@spans.traced("probe.mxu")
def run_mxu_probe(
    size: int = 4096,
    *,
    iters: int = 5,
    inner_iters: int = 8,
    device=None,
) -> Dict[str, Any]:
    """Chained bf16 GEMMs on one device: tensor-core throughput + numeric sanity.

    TFLOP/s = 2·size³·inner_iters / t. A health signal, not a benchmark.
    Operands come from a ``torch.Generator`` seeded 0 (entries unit-normal,
    so each product scales RMS by ~sqrt(size), undone by the rescale).

    On a CUDA device the chain is timed as a CUDA graph (see
    probe/timing.py), captured in the first cycle of a key and replayed in
    every later one (:class:`GemmGraphs`). Each cycle redraws the operands
    into the kept tensors and runs the chain eagerly once, fenced and checked,
    before the graph's timed launches; a graph whose output is not finite is
    dropped and captured again next cycle."""
    try:
        with contextlib.ExitStack() as held:
            with spans.span("probe.mxu.setup"):
                device = resolve_device(device)
                on_card = device.type == "cuda"
                inv_scale = 1.0 / (size**0.5)
                if on_card:
                    kept = held.enter_context(GRAPHS.hold((device_id(device), size, inner_iters)))
                    a, b = kept.draw(size, device)
                else:
                    a, b = mxu_operands(size, device)

                def step(ab):
                    return mxu_chain(ab[0], ab[1], inner_iters, inv_scale)

                out = step((a, b))
                fetch_scalar(out)  # warmup (fenced)
                with spans.sync():
                    finite = bool(torch.isfinite(out.float()).all())
                if on_card:
                    # one graph launch per timed run: see probe/timing.py
                    graph, graph_out = kept.capture(lambda: step((a, b)), device)
                else:
                    baseline_ms = fence_baseline_ms(device)
            with spans.span("probe.mxu.timed"):
                if on_card:
                    stats = TimedStats.of([ms / 1e3 for ms in graph_times_ms(graph, device, iters)])
                else:
                    stats = timed_fenced(step, (a, b), iters, baseline_ms)
            if on_card:
                with spans.sync():
                    finite = finite and bool(torch.isfinite(graph_out.float()).all())
                if not finite:
                    kept.graph = kept.out = None
        tmin = stats[0]
        flops = 2.0 * size**3 * inner_iters
        return {
            "ok": finite,
            "size": size,
            "inner_iters": inner_iters,
            "device_id": device_id(device),
            "time_ms": 1e3 * tmin,
            "tflops": flops / tmin / 1e12,
            # median-based reading: the min estimator biases TFLOP/s high
            "time_median_ms": 1e3 * stats.median,
            "tflops_median": flops / stats.median / 1e12,
            "finite": finite,
            "timing_unreliable": stats.unreliable,
        }
    except Exception as exc:  # noqa: BLE001 — a failed probe is an unhealthy reading
        logger.error("MXU probe failed: %s", exc)
        return {"ok": False, "size": size, "error": str(exc)}
