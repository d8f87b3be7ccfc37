#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of the probe plane on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one H100, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch
built for CUDA. Imports nothing of JAX or of ``k8s_watcher_tpu``.

Phases, each fatal on failure (exit code 1, no result line):

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels of ``k8s_watcher_tpu_torch/csrc`` with ``nvcc``,
   printing ``-Xptxas -v`` (registers, spills);
3. each kernel against its plain PyTorch version on the card at the
   production size (256 MiB buffers);
4. the main path: one ``ProbeAgent.run_once()`` on CUDA with the
   ``production`` environment's probe settings as they are (the per-link
   walk on: no link on one card), which must be healthy, must have launched
   every kernel, and must read no rate above the card's published peak;
5. one cycle with the multislice probe on (one slice: no pairs);
6. the loop: ``ProbeAgent.start()`` at a 1 s interval for 5 cycles, then
   ``stop()``; every cycle healthy, one heartbeat per cycle, every kernel
   launched in every cycle; the first and the median steady-state cycle's
   ``duration_ms`` are printed;
7. each kernel against its plain version again at phase 16a's shapes (the
   soak's 128 MiB buffers and its passes), then each kernel's time beside
   its bound, its plain version's and one PyTorch library call's, at the
   main path's shapes and at the soak's; and the sweeps' rates at equal
   bytes a call over buffers of 32 MiB to 1 GiB (``size sweep:``), to show
   whether the soak's buffer is read or written from the 50 MB L2;
8. the deployment loop: ``probe_agent.run_loop`` with the ``production``
   settings (notifier, status server, dry-run remediation), pointed at a
   receiver and a stub apiserver that the script serves on 127.0.0.1, for
   at least 5 cycles at a 1 s interval; every cycle healthy with every
   kernel launched, one POSTed probe payload per cycle, the status routes
   answering, no node patched, and the stop within 10 s;
9. the watcher: ``python -m k8s_watcher_tpu_torch production``'s
   ``WatcherApp`` with every plane as shipped (leader election, the node
   watch, serving, analytics, history, health and SLO; GPU backend, node
   selector and accelerator label on the GPU operator's node labels, 1 s
   probe interval) against a seeded cluster of
   2,048 GPU nodes and 50,000 pods that the script serves on 127.0.0.1
   (paged LIST, then 60,000 watch events, with node churn at a third and at
   two thirds: 16 JobSet nodes NotReady and back, one deleted); the Lease is
   created before the first pod LIST, renewed, released by the stop and taken
   again by the restart; the node payloads equal their plain fold and every
   slice transition the node churn causes is POSTed; what it POSTs must equal a plain
   fold of the same events under the ``production`` rules, the churn must
   drain without loss, at least 3 in-process probe cycles must run healthy
   with every kernel launched, the status routes must answer, the stop must
   take under 10 s and leave a checkpoint of the last resourceVersion and
   every live pod, and a second app started from that checkpoint must POST a
   DELETED for each pod deleted while it was down. Beside it: 64 ``?watch=1``
   streams read by a child process fold to ``GET /serve/fleet`` (one of them
   cut and resumed mid-churn), the snapshot equals a plain fold of the
   events, every ``/serve/analytics`` body (a summary every 0.5 s, a
   32-scenario what-if) equals the plain reference and the numpy backend,
   and the probe readings taken while analytics requests ran stay within
   20% of phase 4's. The history WAL: a ``?at=`` read at a mid-churn rv
   equals the view's journal folded to that rv, and after the restart the
   view is restored from the WAL and a resume token minted before the stop
   reads deltas (no re-snapshot) that fold to the WAL's state. The health
   plane: every probe cycle's report reaches the detector and the card's
   node stays healthy; synthetic degraded link reports for one cluster node
   confirm it, a TPU_HEALTH escalation reaches the receiver, and no node is
   PATCHed (dry-run actuator). The SLO engine: ``/debug/slo`` lists every
   objective with both burn windows, and local-propagation-p99's sample count
   equals ``/metrics``' ``watch_to_local_view_seconds`` count. ``--seed N``
   picks another cluster (default 0);
10. analytics at fleet scale: a ``FleetView`` of 16,384 JobSets of 8 GPU
   workers (131,072 pods over 3 clusters and 16,384 nodes), where
   ``summary()`` and a 32-scenario ``evaluate()`` on the card, on the numpy
   backend and through the plain reference must agree; with their times, the
   segment sums' CUDA-event time and the share of the host-to-device copies;
11. ``staging`` as shipped on the same seeded cluster: two shard streams in
   two spawned reader processes on the native prefilter (``fastscan.cpp``,
   built with ``g++``), one reader SIGKILLed mid-churn and respawned from its
   shard checkpoints, what is POSTed equal to the plain fold under the
   staging rules (at-least-once: the last payload per pod and slice), the
   node watch, ``/debug/processes``, 3 healthy probe cycles with every kernel
   launched, a stop under 10 s that leaves no reader process; it prints the
   LIST and churn times, the frames per second and the prefiltered share;
12. the federator: three upstream serving planes of the port on 127.0.0.1
   (a ``FleetView`` with a history WAL behind a bearer token each) holding
   phase 10's fleet, 16,384 JobSets of 8 GPU workers (131,072 pods over
   16,384 nodes), split over ``us-east``, ``us-west`` and ``eu-west``, with a
   seeded churn of workers lost and replaced on all three at once; the
   federator is ``production``'s ``WatcherApp`` with federation on over the
   three, trace joining and the health plane's freshness source on, every
   other plane as shipped, beside its own cluster of 128 nodes and 1,000
   pods. In process: merged equals the union of the upstream snapshots once
   materialized and at the end; a port ``ResumeLoop`` and 16 watch streams in
   a child process fold the global view with no gap or duplicate; one
   upstream is stopped mid-churn (WAL drained): ``/healthz`` reports
   ``federation.healthy`` false within ``stale_after_seconds`` plus 5 s with
   liveness 200, the health plane's freshness source sees its watermark age
   grow and the others keep flowing; restarted on its port and directory it
   is resumed with the held token (no resync) and ``/healthz`` recovers;
   analytics over the merged view on the card equal the numpy backend and
   the plain reference (a summary, a 32-scenario what-if draining one
   upstream); a sampled pod's ``/debug/trace?uid=`` answers the joined
   journey and ``/debug/trace/diagnosis`` names a slowest stage per upstream.
   Then again with ``federation.processes: 2``: each merge worker owns an
   upstream, one is SIGKILLed mid-churn and respawns, merged equals the
   union at the end, ``/debug/processes`` lists both and the stop leaves
   none. Both runs: 3 healthy probe cycles with every kernel launched, a
   stop under 10 s; it prints the time to materialize, the upstream delta to
   global view latency, the merged deltas per second, the resyncs, the
   analytics times beside phase 10's and the respawn time;
13. the relay: ``production``'s ``WatcherApp`` with ``relay.enabled`` (serve
   only) in front of one phase-12 upstream: 64 watch streams on the relay
   fold to the root's ``/serve/fleet``, the relay encodes no frame while the
   root does, resume tokens cross the tier both ways, ``/debug/relay``
   reports depth 1, a restart with ``backfill`` resumes a pre-stop token
   with deltas, and the probe runs healthy beside it;
14. the probe plane as deployed on GPU nodes: (a) the graft entry
   (``k8s_watcher_tpu_torch/graft.py``): ``entry()`` on the card, its f32
   product and its checksum against the CPU's f32 product of the same bf16
   inputs (within 1e-4 x max|out| and 1e-5 x sum|out|), NaN for an ``inf``
   input, the CUDA kernels the step launched and its median time over 20
   calls; (b) the container command of ``deploy/gpu-probe-daemonset.yaml``
   (``torchrun --standalone --nproc-per-node=gpu -m
   k8s_watcher_tpu_torch.probe_agent production``) run as a subprocess with
   ``--once``: ``production`` as shipped at full width (4 MiB all-reduce,
   1024^2 GEMM chain, 256 MiB HBM buffers, 128 passes), exit 0 with a healthy
   payload, HBM read and write from the card with integrity ok, and each CUDA
   kernel launched in the child (its counts through
   ``K8S_WATCHER_TPU_LAUNCH_COUNTS``); its wall time; (c)
   ``dryrun_multichip(128)``, the JAX package's 128-device dryrun shape on
   128 gloo ranks in CPU processes on the card's host (the 256-edge link
   walk, 6 slice pairs): its wall time and peak host memory;
15. the remediation loop: (a) ``python -m
   k8s_watcher_tpu_torch.chaos_remediate --cpu-ranks 8`` as a child on the
   card's host (an injected slow rank localized, confirmed, quarantined and
   released over the port's mock apiserver, then a slow slice decided in dry
   run), which must exit 0 with every stage passing; (b) on the card: the
   port's ``MockApiServer`` holding phase 9's 2,048 GPU nodes (GPU operator
   labels), ``production``'s ``tpu.remediation`` with ``dry_run`` false and
   cooldown 0 (both printed), and ``ProbeRemediationPolicy`` fed reports
   whose ``hbm_write`` is ``run_hbm_write_probe`` at 256 MiB with one element
   of block 137 changed: ``bad_blocks`` must name exactly that block at byte
   offset ``137 << 19`` (the plain block sums agree), ``fill`` and
   ``blocksums`` must be launched, no PATCH before ``confirm_cycles``, then
   the probe's node cordoned with production's taint and exactly one
   TPU_REMEDIATION with an action whose evidence is the HBM finding;
   ``python -m k8s_watcher_tpu_torch.remediate_ctl production status`` from
   a config directory pointed at the mock lists exactly that node, ``release
   NODE --no-dry-run`` restores it, and a clean cycle acts on nothing. It
   prints each cycle's ms, the write GB/s, the confirming cycle to PATCH ms
   and each CLI call's wall time;
16. the tooling on the card: (a) ``python -m k8s_watcher_tpu_torch.probe_soak
   --minutes 1 --interval 3`` as a subprocess at the soak's settings (4096 x
   128 bf16 GEMM chain as a CUDA graph, 128 MiB HBM buffers, 256 passes):
   exit 0, at least 10 cycles, every one healthy, no trend alert, no band's
   max above the card's peak x 1.05, and each kernel launched in every cycle
   (counts through ``K8S_WATCHER_TPU_LAUNCH_COUNTS``); it prints the bands,
   the GEMM's device time per call, the peak device memory and the median
   cycle; (b) within phase 9, on its WAL before its directory goes: ``python
   -m k8s_watcher_tpu_torch.history_replay --verify --analytics --scenarios``
   (drain the local cluster, cordon 16 nodes) on the card and with
   ``--device cpu``: deterministic, the cross-check ok, the two reports
   equal; the replay and analytics seconds; (c) ``python -m
   k8s_watcher_tpu_torch.acceptance_drill --cpu-ranks 8 --seconds 30`` on the
   card's host CPUs: exit 0 with every gate (1k+ events/min, preemption and
   reschedule, 90% of tracers, p50 under 1 s, no overflow, the corrupt slice
   localized and decided in dry run, no node written);
17. the JAX package's tooling, as the port's twins, each a subprocess on the
   card and the card's host: ``check_connection`` and ``check_mock`` against
   the port's mock apiserver on a free port (exit 0); the eleven smoke drills
   (``python -m k8s_watcher_tpu_torch.<name>_smoke``: serve, history,
   analytics, columnar at 50,000 pods, health, obs, trace, ingest,
   federation, fan-in, relay), one after another, their apps' analytics on the
   card: each must exit 0 with ``ok: true`` and its artifact's ``checks``
   exactly the names the twin declares, every one true; then
   ``integration_tier --backend auto`` (the mock when the host has no kind or
   kube-apiserver): ``ok``. It prints one line per twin with its wall seconds
   and its checks, the analytics' kernel and request times of the analytics
   and columnar drills, and the columnar drill's memory and body size.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import http.client
import json
import os
import random
import select
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# phase 9's seeded cluster and its plain fold, shared with the benchmark's
# watcher cell (the port's tests read facts_of and UNWATCHED_NAMESPACE here)
from portbench.reference.watcher import facts_of, fold_production  # noqa: F401
from portbench.traffic.apiserver import LEASE_PATH, PodsAndLeases
from portbench.traffic.cluster import (  # noqa: F401
    GPU_KEY,
    GPU_PRESENT_LABEL,
    GPU_PRODUCT,
    GPU_PRODUCT_LABEL,
    UNWATCHED_NAMESPACE,
    WATCHED_NAMESPACES,
    GpuCluster,
)

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: HBM3 rate, bf16 tensor-core and f32 rates
HBM_BYTES_PER_S = 3.35e12
BF16_TFLOPS = 989.0
F32_FLOPS_PER_S = 67e12
# a reading above peak by more than this means work was dropped
PEAK_SLACK = 1.05
MIB = 1 << 20
LOOP_CYCLES = 5
SOURCE = "k8s_watcher_tpu_torch/csrc/hbm.cu"
NODE_NAME = "chip-smoke-node"
API_KEY = "chip-smoke-key"
STOP_LIMIT_S = 10.0


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, warm: int = 2, n: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``n`` warm back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


class _Recorder(BaseHTTPRequestHandler):
    """Phase 8's local servers: the cluster API receiver (POSTs) and the stub
    apiserver (``/version``, the node list, one node); every request is
    recorded as ``(method, path, Authorization, body)``."""

    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    requests: list = []

    def log_message(self, *a):
        pass

    def _answer(self, status: int, body=None) -> None:
        data = json.dumps(body).encode() if body is not None else b""
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _record(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
        self.requests.append((self.command, self.path, self.headers.get("Authorization"),
                              json.loads(body) if body else None))

    def do_POST(self):  # noqa: N802
        self._record()
        self._answer(200)

    def do_GET(self):  # noqa: N802
        self._record()
        node = {"metadata": {"name": NODE_NAME, "resourceVersion": "1"}, "spec": {}}
        path = self.path.split("?")[0]
        if path == "/version":
            self._answer(200, {"major": "1", "minor": "31"})
        elif path == "/api/v1/nodes":
            self._answer(200, {"kind": "NodeList", "metadata": {"resourceVersion": "1"}, "items": [node]})
        elif path == f"/api/v1/nodes/{NODE_NAME}":
            self._answer(200, node)
        else:
            self._answer(404, {"kind": "Status", "code": 404})

    def do_PATCH(self):  # noqa: N802
        self._record()
        self._answer(200, {"metadata": {"name": NODE_NAME}, "spec": {}})


def serve(name: str) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer(("127.0.0.1", 0), type(name, (_Recorder,), {"requests": []}))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.1}, daemon=True).start()
    return server


def http_get(port: int, path: str, token: str = None):
    """(status, body) of one GET to 127.0.0.1:port, JSON decoded where it is JSON."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path, headers={"Authorization": f"Bearer {token}"} if token else {})
        response = conn.getresponse()
        body = response.read()
        if response.getheader("Content-Type", "").startswith("application/json"):
            body = json.loads(body)
        return response.status, body
    finally:
        conn.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bound(bytes_moved: float, f32_ops: float):
    """(least ms, what bounds it) from bytes over HBM rate and ops over peak."""
    by_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    by_ops = 1e3 * f32_ops / F32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def compare_kernels(torch, K, dev, buf: int, repeats: int) -> dict:
    """Each kernel against its plain version on the same inputs on the card,
    at ``buf`` bytes and ``repeats`` passes: read_sweep exactly equal (random
    integers, small enough that the largest total, and so every partial sum,
    stays within 2**24 and is exact in f32), fill bitwise, blocksums within
    rel 1e-5 and naming the same planted bad blocks. Fails on any mismatch;
    returns the max abs errors by kernel."""
    shape = f"{buf // MIB} MiB x {repeats} passes"
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = buf // K.BYTES_PER_BLOCK * K.BLOCK_ROWS
    high = min(4, 2 ** 24 // (rows * repeats) + 1)
    x = torch.randint(0, high, (rows, K.WIDTH), generator=gen, device=dev).to(torch.float32)
    got, want = K.read_sweep(x, repeats), K.read_sweep_plain(x, repeats)
    read_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        fail(f"read_sweep differs from read_sweep_plain at {shape} (max abs err {read_err})")
    del x
    num_blocks = buf // K.WRITE_BYTES_PER_BLOCK
    seed3 = torch.full((1, 1), 3.0, device=dev)
    got, want = K.fill(seed3, num_blocks, repeats), K.fill_plain(seed3, num_blocks, repeats)
    fill_err = (got - want).abs().max().item()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"fill is not bitwise equal to fill_plain at {shape} (max abs err {fill_err})")
    y = K.fill_plain(torch.zeros((1, 1), device=dev), num_blocks, 1)
    corrupted = [5, num_blocks // 2 + 7, num_blocks - 1]
    y.view(num_blocks, -1)[corrupted, 17] += 1e6
    got, want = K.blocksums(y), K.blocksums_plain(y)
    torch.cuda.synchronize()
    sums_err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        fail(f"blocksums differs from blocksums_plain beyond rel 1e-5 at {shape} (max abs err {sums_err})")
    expected = torch.arange(1, num_blocks + 1, device=dev, dtype=torch.float64) * K.WRITE_BLOCK_ELEMS

    def bad(sums):
        return torch.nonzero((sums.double().view(-1) - expected).abs() > 1e-5 * expected).view(-1).tolist()

    if bad(got) != corrupted or bad(want) != corrupted:
        fail(f"bad blocks at {shape}: kernel {bad(got)}, plain {bad(want)}, corrupted {corrupted}")
    return {"read_sweep": read_err, "fill": fill_err, "blocksums": sums_err}


def size_sweep(torch, K, dev, total: int, sizes_mib, rounds: int = 5) -> dict:
    """The sweeps' rates at equal bytes moved (``total`` a call) over several
    buffer sizes, the sizes interleaved in each of ``rounds`` rounds (CUDA-event
    mean of 3 warm calls a reading). A buffer served partly from the 50 MB L2
    reads or writes faster than the larger ones beyond their spread."""
    bufs = {}
    for mib in sizes_mib:
        buf = mib * MIB
        x = torch.ones((buf // K.BYTES_PER_BLOCK * K.BLOCK_ROWS, K.WIDTH), dtype=torch.float32, device=dev)
        bufs[mib] = (x, buf // K.WRITE_BYTES_PER_BLOCK, total // buf)
    seed3 = torch.full((1, 1), 3.0, device=dev)
    gbps = {mib: {"read_sweep": [], "fill": []} for mib in sizes_mib}
    for _ in range(rounds):
        for mib, (x, num_blocks, repeats) in bufs.items():
            for kname, fn in (("read_sweep", lambda: K.read_sweep(x, repeats)),
                              ("fill", lambda: K.fill(seed3, num_blocks, repeats))):
                gbps[mib][kname].append(total / cuda_ms(torch, fn, warm=1, n=3) / 1e6)
    del bufs
    rows = [{"mib": mib, "repeats": total // (mib * MIB),
             **{k: {"median": statistics.median(v), "min": min(v), "max": max(v)} for k, v in kinds.items()}}
            for mib, kinds in gbps.items()]
    return {"total_bytes": total, "rounds": rounds, "rows": rows}


def kernel_timings(torch, K, dev, buf: int, repeats: int) -> list:
    """Each kernel's time at ``buf`` bytes and ``repeats`` passes beside its
    bound, its plain version's and one PyTorch library call's (CUDA-event
    means over warm calls: 5 kernel, 3 plain and library calls for the
    sweeps; 50 and 25 for the block sums)."""
    rows = buf // K.BYTES_PER_BLOCK * K.BLOCK_ROWS
    num_blocks = buf // K.WRITE_BYTES_PER_BLOCK
    seed3 = torch.full((1, 1), 3.0, device=dev)
    x = torch.ones((rows, K.WIDTH), dtype=torch.float32, device=dev)
    y = K.fill_plain(torch.zeros((1, 1), device=dev), num_blocks, 1)

    def library_read():
        for _ in range(repeats):
            x.sum(0, keepdim=True)

    column = torch.arange(1, num_blocks + 1, dtype=torch.float32, device=dev)[:, None] + 3.0
    out = torch.empty((num_blocks, K.WRITE_BLOCK_ELEMS), dtype=torch.float32, device=dev)

    def library_fill():
        for _ in range(repeats):
            out.copy_(column.expand(num_blocks, K.WRITE_BLOCK_ELEMS))

    specs = [
        ("read_sweep", "k8s_watcher_tpu/probe/hbm.py:74 (_reduce_kernel; pallas_call :95)",
         lambda: K.read_sweep(x, repeats), lambda: K.read_sweep_plain(x, repeats), library_read,
         bound(buf * repeats + 4 * K.WIDTH, buf // 4 * repeats), 5),
        ("fill", "k8s_watcher_tpu/probe/hbm.py:107 (_fill_kernel; pallas_call :135)",
         lambda: K.fill(seed3, num_blocks, repeats), lambda: K.fill_plain(seed3, num_blocks, repeats),
         library_fill, bound(buf * repeats + 4, buf // 4 * repeats), 5),
        ("blocksums", "k8s_watcher_tpu/probe/hbm.py:117 (_blocksum_kernel; pallas_call :145)",
         lambda: K.blocksums(y), lambda: K.blocksums_plain(y),
         lambda: y.view(num_blocks, -1).sum(1), bound(buf + 4 * num_blocks, buf // 4), 50),
    ]
    out_rows = []
    for kname, replaces, kernel_fn, plain_fn, library_fn, (bound_ms, bound_by), n in specs:
        out_rows.append({
            "name": kname, "replaces": replaces, "ms": cuda_ms(torch, kernel_fn, n=n),
            "plain_ms": cuda_ms(torch, plain_fn, n=max(3, n // 2)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(torch, library_fn, n=max(3, n // 2)),
        })
    return out_rows


# -- phase 9: the watcher on a seeded GPU cluster --------------------------------

STATUS_TOKEN = "chip-smoke-status-token"
CHURN_DRAIN_LIMIT_S = 120.0
WATCHER_PROBE_CYCLES = 3
LIST_PAGE = 500
SUBSCRIBERS = 64
ANALYTICS_EVERY_S = 0.5
SCENARIOS = 32
# a probe reading taken while an analytics request ran may differ from the
# quiet card's (phase 4) by at most this share
READING_TOLERANCE = 0.20


def fold_node_payloads(node_steps, environment: str) -> dict:
    """The plain reference of the node plane's payloads over ``node_steps``
    (all nodes listed Ready first): a GPU node's Ready change is a
    ``NODE_CONDITION_CHANGE``, its deletion a ``NODE_DELETED``; each payload as
    the watcher POSTs it, without its ``event_timestamp``. Returns ``{node:
    [payload, ...]}``."""
    out = {}
    for rv, (_, kind, name, ready) in enumerate(node_steps, start=2):
        node = GpuCluster.node(name, bool(ready) if kind != "DELETED" else True, rv)
        out.setdefault(name, []).append({
            "event_type": "NODE_DELETED" if kind == "DELETED" else "NODE_CONDITION_CHANGE",
            "environment": environment, "node": name, "ready": bool(ready),
            "tpu": {"chips": 8, "accelerator": GPU_PRODUCT, "topology": None},
            "conditions": [{k: c.get(k) for k in ("type", "status", "reason", "message")}
                           for c in node["status"]["conditions"]],
            "unschedulable": False,
        })
    return out


def fold_view(steps, namespaces=WATCHED_NAMESPACES):
    """The plain reference of the serving plane's pod objects over ``steps``
    in watch order: every event past the namespace and GPU resource filters
    (whatever the critical gate says) upserts the pod's compact object, a
    DELETED drops it. Returns ``{uid: object}``."""
    pods = {}
    for kind, spec, phase, ready, restarts, rv in steps:
        if (namespaces and spec.namespace not in namespaces) or not spec.gpus:
            continue
        if kind == "DELETED":
            pods.pop(spec.uid, None)
        else:
            pods[spec.uid] = {"kind": "pod", "key": spec.uid, "name": spec.name, "namespace": spec.namespace,
                              "phase": phase, "ready": ready, "node": spec.spec["nodeName"],
                              "pod_resource_version": str(rv)}
    return pods


def model_digest(model: dict) -> str:
    """The digest of a ``{(kind, key): object}`` fold, the same in the
    subscriber child."""
    return hashlib.sha256(json.dumps(sorted([k[0], k[1], o] for k, o in model.items()), sort_keys=True)
                          .encode()).hexdigest()


# The subscriber child: one snapshot, then ``n`` ?watch=1 streams from its rv,
# read with one selector and folded each into its own model, gaps and
# duplicates counted. Commands on stdin: "cut" closes stream 0 and resumes it
# with its token; "finish R" records each stream's (rv, digest) once its token
# reaches R, prints the result and exits. An optional fourth argument
# "msgpack" reads the streams as msgpack frames with freshness stamps.
SUBSCRIBER_CHILD = r"""
import hashlib, http.client, json, os, selectors, socket, sys, time

port, token, n = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
if len(sys.argv) > 4 and sys.argv[4] == "msgpack":
    import msgpack
    decode, accept, query = (lambda b: msgpack.unpackb(b, raw=False)), "Accept: application/x-msgpack\r\n", "&fresh=1"
else:
    decode, accept, query = json.loads, "", ""


def digest(model):
    return hashlib.sha256(json.dumps(sorted([k[0], k[1], o] for k, o in model.items()), sort_keys=True)
                          .encode()).hexdigest()


conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
conn.request("GET", "/serve/fleet", headers={"Authorization": "Bearer " + token})
snap = json.loads(conn.getresponse().read())
conn.close()
view = snap["view"]
sel = selectors.DefaultSelector()


class Stream:
    def __init__(self, rv, model):
        self.rv, self.model = rv, model
        self.frames = self.deltas = self.gaps = self.dups = self.compacted = self.gone = 0
        self.gone_frame = None
        self.sanction_to = -1
        self.at = None
        self.connect()

    def connect(self):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.sendall(("GET /serve/fleet?watch=1&rv=%d&view=%s&timeout=300%s HTTP/1.1\r\nHost: smoke\r\n"
                           "Authorization: Bearer %s\r\n%s\r\n" % (self.rv, view, query, token, accept)).encode())
        self.sock.setblocking(False)
        self.buf, self.status, self.first_sync, self.open = b"", None, None, True
        sel.register(self.sock, selectors.EVENT_READ, self)

    def close(self):
        if self.open:
            sel.unregister(self.sock)
            self.sock.close()
            self.open = False

    def feed(self, data):
        self.buf += data
        if self.status is None:
            head, sep, rest = self.buf.partition(b"\r\n\r\n")
            if not sep:
                return
            self.status, self.buf = int(head.split(b" ", 2)[1]), rest
        # walk the chunks by offset and cut the buffer once: slicing it per
        # frame costs the whole backlog for every frame of a large read
        buf, pos = self.buf, 0
        while self.status == 200:
            end = buf.find(b"\r\n", pos)
            if end < 0:
                break
            size = int(buf[pos:end], 16)
            if size == 0 or len(buf) < end + 2 + size + 2:
                break
            self.frame(decode(buf[end + 2:end + 2 + size]))
            pos = end + 2 + size + 2
        self.buf = buf[pos:]

    def frame(self, f):
        self.frames += 1
        kind = f["type"]
        if kind == "SYNC":
            if self.first_sync is None:
                self.first_sync = f["rv"]
            self.gaps += f["rv"] != self.rv
        elif kind == "COMPACTED":
            self.compacted += 1
            self.sanction_to = f["to_rv"]
        elif kind == "GONE":
            self.gone += 1
            self.gone_frame = f
        else:
            rv = f["rv"]
            if rv <= self.rv:
                self.dups += 1
                return
            self.gaps += rv != self.rv + 1 and rv > self.sanction_to
            if kind == "DELETE":
                self.model.pop((f["kind"], f["key"]), None)
            else:
                self.model[(f["kind"], f["key"])] = f["object"]
            self.rv = rv
            self.deltas += 1


base = {(o["kind"], o["key"]): o for o in snap["objects"]}
streams = [Stream(snap["rv"], dict(base)) for _ in range(n)]
print(json.dumps({"ready": True, "rv": snap["rv"], "view": view}), flush=True)
sel.register(0, selectors.EVENT_READ, None)
target, deadline, resumed, pending = None, None, None, b""
while True:
    for key, _ in sel.select(0.2):
        if key.data is None:
            data = os.read(0, 4096)
            if not data:
                sys.exit(1)
            pending += data
            while b"\n" in pending:
                cmd, pending = pending.split(b"\n", 1)
                words = cmd.decode().split()
                if words[0] == "cut":
                    s0 = streams[0]
                    s0.close()
                    resumed = {"from_rv": s0.rv, "deltas_before": s0.deltas}
                    s0.connect()
                elif words[0] == "finish":
                    target, deadline = int(words[1]), time.monotonic() + 60
            continue
        stream = key.data
        try:
            data = stream.sock.recv(1 << 20)
        except BlockingIOError:
            continue
        except OSError:
            data = b""
        if data:
            stream.feed(data)
        else:
            stream.close()
    if target is None:
        continue
    for n, stream in enumerate(streams):
        if stream.at is None and stream.rv >= target:
            # a fold equal to an earlier stream's at the same rv shares its digest
            same = next((s for s in streams[:n] if s.at is not None and s.at[0] == stream.rv
                         and s.model == stream.model), None)
            stream.at = same.at if same is not None else (stream.rv, digest(stream.model))
    if all(s.at is not None for s in streams) or time.monotonic() > deadline:
        break
if resumed is not None:
    s0 = streams[0]
    resumed.update(status=s0.status, first_sync=s0.first_sync, deltas_after=s0.deltas - resumed["deltas_before"])
print(json.dumps({"resumed": resumed, "streams": [
    {"at": s.at, "status": s.status, "open": s.open, "frames": s.frames, "deltas": s.deltas, "gaps": s.gaps,
     "dups": s.dups, "compacted": s.compacted, "gone": s.gone, "gone_frame": s.gone_frame}
    for s in streams]}), flush=True)
"""


class Subscribers:
    """Watch streams (phase 9, 12 and 13), read in a child process so
    that they do not share the watcher's interpreter."""

    def __init__(self, port: int, token: str, n: int, wire: str = "json"):
        self.proc = subprocess.Popen([sys.executable, "-c", SUBSCRIBER_CHILD, str(port), token, str(n), wire],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.ready = self._line(60)

    def _line(self, timeout_s: float) -> dict:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.close()
            fail(f"the subscriber child gave no answer within {timeout_s} s (exit {self.proc.poll()})")
        return json.loads(line)

    def send(self, command: str) -> None:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def finish(self, rv: int) -> dict:
        self.send(f"finish {rv}")
        result = self._line(90)
        self.close()
        return result

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


class AnalyticsPoller(threading.Thread):
    """One ``GET /serve/analytics`` summary every ``ANALYTICS_EVERY_S``;
    each call is kept as ``(start, end, status, body)``."""

    def __init__(self, port: int, token: str):
        super().__init__(name="analytics-poller", daemon=True)
        self.port, self.token = port, token
        self.calls = []
        self.halt = threading.Event()

    def run(self) -> None:
        while not self.halt.is_set():
            t0 = time.monotonic()
            try:
                status, body = http_get(self.port, "/serve/analytics", self.token)
            except OSError as exc:  # a failed request is a finding, checked later
                status, body = None, repr(exc)
            self.calls.append((t0, time.monotonic(), status, body))
            self.halt.wait(max(0.0, ANALYTICS_EVERY_S - (time.monotonic() - t0)))


def states_at(deltas, rvs, base: dict = None) -> dict:
    """``{rv: {(kind, key): object}}``: the view's state at each wanted rv,
    folded once from ``base`` (the state before the first delta; default
    empty, for a journal that starts at rv 1)."""
    wanted, out, state, i = sorted(set(rvs)), {}, dict(base or {}), 0
    for d in deltas:
        while i < len(wanted) and wanted[i] < d.rv:
            out[wanted[i]] = dict(state)
            i += 1
        if d.object is None:
            state.pop((d.kind, d.key), None)
        else:
            state[(d.kind, d.key)] = d.object
    for rv in wanted[i:]:
        out[rv] = dict(state)
    return out


def tables_of(state: dict) -> dict:
    tables = {}
    for (kind, _key), obj in state.items():
        tables.setdefault(kind, []).append(obj)
    return tables


def numpy_plane(objects, config):
    """An analytics plane on the numpy backend over a fresh view of
    ``objects`` (``(kind, key) -> object``)."""
    from k8s_watcher_tpu_torch.analytics import AnalyticsPlane
    from k8s_watcher_tpu_torch.serve import FleetView

    view = FleetView(compact_horizon=1 << 20)
    view.apply_batch([(kind, key, obj) for (kind, key), obj in objects.items()])
    return AnalyticsPlane(dataclasses.replace(config, backend="numpy"), view)


def comparable(body: dict) -> dict:
    """A response body without the fields that name the run (rv, backend),
    as JSON would carry it."""
    return json.loads(json.dumps({k: v for k, v in body.items() if k not in ("rv", "backend")}))


def draw_scenarios(rng, nodes, n: int = SCENARIOS, drain: str = "") -> list:
    """baseline, a drain of the cluster ``drain`` (default: the local one),
    and ``n - 2`` cordons of 1-16 of ``nodes`` drawn with ``rng``."""
    out = [{"kind": "baseline"}, {"kind": "drain_cluster", "cluster": drain}]
    for _ in range(n - len(out)):
        out.append({"kind": "cordon_nodes", "nodes": rng.sample(nodes, rng.randint(1, 16))})
    return out


def analytics_timings(torch, view, raw, config, dev, *, reference_calls: int = 5) -> dict:
    """``summary()`` and a ``raw``-scenario ``evaluate()`` over ``view`` on the
    card, on the numpy backend and through the plain reference: all three
    must agree. Returns each one's median ms over warm calls, the CUDA-event
    ms of the host-to-device copies and of the segment sums alone, and the
    copies' share of a request."""
    import numpy as np

    from k8s_watcher_tpu_torch.analytics import (
        AnalyticsPlane,
        Scenario,
        build_masks,
        parse_scenarios,
        python_reference_verdicts,
    )

    card = AnalyticsPlane(dataclasses.replace(config, backend="auto"), view, device=dev)
    plain = AnalyticsPlane(dataclasses.replace(config, backend="numpy"), view)
    rv, tables = view.snapshot_tables()
    scenarios = parse_scenarios(raw, max_scenarios=config.max_scenarios)

    def median_ms(fn, calls=5, warm=True):
        if warm:
            fn()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), out

    out = {}
    for shape, on_card, on_host, reference in (
            ("summary", card.summary, plain.summary,
             lambda: python_reference_verdicts(tables, [Scenario("baseline")])),
            ("evaluate", lambda: card.evaluate(raw), lambda: plain.evaluate(raw),
             lambda: python_reference_verdicts(tables, scenarios))):
        card_ms, card_body = median_ms(on_card)
        numpy_ms, numpy_body = median_ms(on_host)
        ref_ms, ref_body = median_ms(reference, reference_calls, warm=False)  # plain Python: nothing to warm
        if card_body["rv"] != rv or card_body["backend"] != "torch" or not card_body["crosscheck"]["ok"]:
            fail(f"analytics {shape} on the card: rv {card_body['rv']} (view {rv}), {card_body['backend']}, "
                 f"{card_body['crosscheck']}")
        if comparable(card_body) != comparable(numpy_body):
            fail(f"analytics {shape}: the card and the numpy backend disagree")
        got = card_body["fleet"] if shape == "summary" else {k: card_body[k] for k in ("baseline", "scenarios")}
        want = ref_body["baseline"] if shape == "summary" else ref_body
        if json.loads(json.dumps(got)) != json.loads(json.dumps(want)):
            fail(f"analytics {shape}: the card and the plain reference disagree")
        out[shape] = {"card_ms": card_ms, "numpy_ms": numpy_ms, "reference_ms": ref_ms,
                      "reference_calls": reference_calls}
    # the what-if's copies and segment sums alone, on the backend's stream
    _, cols = view.fleet_columns()
    b, n = card.backend, cols.n_slices
    masks = build_masks(cols, scenarios).astype(np.int32)
    copies, sums = [], []
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with b.launch():
            marks[0].record(b.stream)
            m, ws = b.asarray(masks), b.segment_ids(cols.w_slice, n)
            wu, wc = b.asarray(cols.w_up), b.asarray(cols.w_chips)
            marks[1].record(b.stream)
            up_after = m * wu.unsqueeze(0)
            up_chips = up_after * wc.unsqueeze(0)
            marks[2].record(b.stream)
            b.segment_sum(up_after, ws, n)
            b.segment_sum(up_chips, ws, n)
            marks[3].record(b.stream)
        b.stream.synchronize()
        copies.append(marks[0].elapsed_time(marks[1]))
        sums.append(marks[2].elapsed_time(marks[3]))
    out["whatif_device"] = {
        "scenarios": len(scenarios), "workers": int(cols.n_workers), "slices": int(n),
        "h2d_bytes": int(masks.nbytes + 8 * cols.n_workers + 4 * 2 * cols.n_workers),
        "h2d_ms": statistics.median(copies[1:]), "segment_sums_ms": statistics.median(sums[1:]),
        "h2d_share_of_evaluate": statistics.median(copies[1:]) / out["evaluate"]["card_ms"],
    }
    return out


class ClusterStub(PodsAndLeases):
    """The apiserver side of phases 9 and 11.

    - ``GET /version``.
    - Pods: the LIST in ``limit`` pages with ``continue`` tokens (each list a
      snapshot of the objects at its first page), and the WATCH. Every watch
      from the LIST's resourceVersion or later gets the churn after its rv as
      fast as the stub can write it (a stock apiserver ignores the shard
      selector, so each shard stream gets all of it), then a BOOKMARK a
      second. The objects a LIST returns follow the furthest watch. The churn
      stops at each position of ``pauses`` until its event is set. A watch
      below ``gone_below`` gets 410 Gone (history compacted).
    - Nodes: the LIST (paged, ``labelSelector`` terms ``key`` and
      ``key=value``) and the WATCH, which carries the node events the script
      hands to ``emit_nodes``.
    - Leases (``coordination.k8s.io/v1``): GET, POST (409 when it exists) and
      PUT (409 when ``metadata.resourceVersion`` is stale); every write is
      logged with its time (the LIST and the Leases: ``PodsAndLeases``).
    - Node PATCHes are counted and answered 404."""

    def __init__(self, cluster: GpuCluster, pauses=()):
        import zlib

        self.cluster = cluster
        self.lock = threading.Lock()
        self.objects = {spec.uid: spec.encode(rv, phase, ready, restarts)
                        for _, spec, phase, ready, restarts, rv in cluster.initial}
        self.pod_bytes = sum(len(b) for b in self.objects.values())
        self.churn = [(kind, spec.uid, spec.encode(rv, phase, ready, restarts))
                      for kind, spec, phase, ready, restarts, rv in cluster.churn]
        # (carries the GPU key, crc32 of the uid): what a shard stream's
        # foreign GPU frames are
        self.churn_keys = [(bool(spec.gpus), zlib.crc32(spec.uid.encode())) for _, spec, *_ in cluster.churn]
        self.published = 0  # churn[:published] is folded into objects
        self.rv = cluster.list_rv
        self.gone_below = 0
        self.pauses = {position: threading.Event() for position in pauses}
        self.paused_at = None
        self.paused_s = 0.0  # the churn's time standing at its pauses
        self.snapshots = {}
        self.list_pages = 0
        self.pod_lists = 0
        self.first_pod_list_t = None
        self.churn_t0 = self.churn_t1 = None
        self.churn_done = threading.Event()
        self.closing = threading.Event()
        self.patches = []  # node PATCHes: the dry-run actuator must send none
        self.watches = []  # (resourceVersion, shard selector) of each pod watch
        self.foreign_written = {}  # shard selector -> other shards' GPU frames written to it
        self.frames_written = 0  # churn frames written, over every pod watch
        self.nodes = {name: GpuCluster.node(name, True, 1) for name in cluster.node_names()}
        self.node_rv = 1
        self.node_events = []  # (rv, frame bytes)
        self.node_cond = threading.Condition()
        self.leases = {}
        self.lease_rv = 0
        self.lease_log = []  # (monotonic time, method, spec)

    # -- pods ----------------------------------------------------------------

    def release(self, position: int) -> None:
        self.pauses[position].set()

    def watch(self, handler, params: dict) -> None:
        rv = int(params.get("resourceVersion") or 0)
        list_rv = self.cluster.list_rv
        if rv < max(self.gone_below, list_rv):
            handler.answer(410, {"kind": "Status", "code": 410, "message": "too old resource version"})
            return
        shard = params.get("shard")
        index, shards = (int(x) for x in shard.split("/")) if shard else (0, 1)
        with self.lock:
            self.watches.append((rv, shard))
            if rv == list_rv and self.churn_t0 is None:
                self.churn_t0 = time.monotonic()
        out, write = self._chunked(handler)
        deadline = time.monotonic() + int(params.get("timeoutSeconds") or 300)
        position = min(rv - list_rv, len(self.churn))
        stops = sorted(p for p in self.pauses if p >= position) + [len(self.churn)]
        try:
            while position < len(self.churn):
                end = min(position + 256, stops[0])
                if end == position:  # a pause: wait for the script's node events
                    t0 = time.monotonic()
                    self.paused_at = position
                    self.pauses[stops.pop(0)].wait(180)
                    self.paused_at = None
                    self.paused_s += time.monotonic() - t0
                    continue
                block = self.churn[position:end]
                write(b"".join(b'{"type":"%s","object":%s}\n' % (kind.encode(), body) for kind, _, body in block))
                foreign = sum(1 for gpu, crc in self.churn_keys[position:end] if gpu and crc % shards != index) \
                    if shard else 0
                with self.lock:
                    self.frames_written += len(block)
                    if shard:
                        self.foreign_written[shard] = self.foreign_written.get(shard, 0) + foreign
                    if end > self.published:
                        for kind, uid, body in self.churn[self.published:end]:
                            if kind == "DELETED":
                                self.objects.pop(uid, None)
                            else:
                                self.objects[uid] = body
                        self.published = end
                        self.rv = list_rv + end
                        if end == len(self.churn):
                            self.churn_t1 = time.monotonic()
                            self.churn_done.set()
                position = end
            while not self.closing.wait(1.0) and time.monotonic() < deadline:
                write(b'{"type":"BOOKMARK","object":{"kind":"Pod","metadata":{"resourceVersion":"%d"}}}\n' % self.rv)
            out.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the watcher closed the stream (stop, reconnect or a killed reader)

    def delete_while_down(self, uids) -> None:
        """Delete pods with no watch to see it, and compact the history past
        them: a watch resuming from before gets 410 Gone."""
        with self.lock:
            for uid in uids:
                self.objects.pop(uid, None)
            self.rv += len(uids)
            self.gone_below = self.rv

    # -- nodes ---------------------------------------------------------------

    @staticmethod
    def _selected(node: dict, selector: str) -> bool:
        labels = node["metadata"]["labels"]
        for term in filter(None, (t.strip() for t in selector.split(","))):
            key, eq, value = term.partition("=")
            if key not in labels or (eq and labels[key] != value):
                return False
        return True

    def node_page(self, params: dict) -> bytes:
        selector = params.get("labelSelector") or ""
        with self.node_cond:
            items = [n for _, n in sorted(self.nodes.items()) if self._selected(n, selector)]
            rv = self.node_rv
        offset = int(params.get("continue") or 0)
        limit = int(params.get("limit") or 0) or len(items)
        body = {"kind": "NodeList", "apiVersion": "v1", "metadata": {"resourceVersion": str(rv)},
                "items": items[offset:offset + limit]}
        if offset + limit < len(items):
            body["metadata"]["continue"] = str(offset + limit)
        return json.dumps(body).encode()

    def emit_nodes(self, steps) -> int:
        """Apply node steps ``(type, name, ready)``; returns the last node rv."""
        with self.node_cond:
            for kind, name, ready in steps:
                self.node_rv += 1
                if kind == "DELETED":
                    node = self.nodes.pop(name)
                else:
                    node = self.nodes[name] = GpuCluster.node(name, ready, self.node_rv)
                frame = json.dumps({"type": kind, "object": node}).encode() + b"\n"
                self.node_events.append((self.node_rv, frame))
            self.node_cond.notify_all()
            return self.node_rv

    def node_watch(self, handler, params: dict) -> None:
        rv = int(params.get("resourceVersion") or 0)
        selector = params.get("labelSelector") or ""
        out, write = self._chunked(handler)
        deadline = time.monotonic() + int(params.get("timeoutSeconds") or 300)
        try:
            while not self.closing.is_set() and time.monotonic() < deadline:
                with self.node_cond:
                    if not any(r > rv for r, _ in self.node_events):
                        self.node_cond.wait(1.0)
                    fresh = [(r, f) for r, f in self.node_events if r > rv]
                    latest = self.node_rv
                if fresh:
                    frames = [f for _, f in fresh if self._selected(json.loads(f)["object"], selector)]
                    if frames:
                        write(b"".join(frames))
                    rv = fresh[-1][0]
                else:
                    write(b'{"type":"BOOKMARK","object":{"kind":"Node","metadata":{"resourceVersion":"%d"}}}\n'
                          % latest)
            out.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass


class _StubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    stub: ClusterStub = None

    def log_message(self, *a):
        pass

    def answer(self, status: int, body) -> None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        path, _, query = self.path.partition("?")
        params = dict(urllib.parse.parse_qsl(query))
        if path == "/version":
            self.answer(200, {"major": "1", "minor": "31", "gitVersion": "v1.31.0"})
        elif path == "/api/v1/nodes" and params.get("watch") == "true":
            self.stub.node_watch(self, params)
        elif path == "/api/v1/nodes":
            self.answer(200, self.stub.node_page(params))
        elif path == "/api/v1/pods" and params.get("watch") == "true":
            self.stub.watch(self, params)
        elif path == "/api/v1/pods":
            self.answer(200, self.stub.page(params))
        elif path.startswith(LEASE_PATH):
            self.answer(*self.stub.lease("GET", path, None))
        else:
            self.answer(404, {"kind": "Status", "code": 404})

    def _lease_write(self, method: str) -> None:
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0) or 0)) or b"{}")
        path = self.path.partition("?")[0]
        if path.startswith(LEASE_PATH):
            self.answer(*self.stub.lease(method, path, body))
        else:
            self.answer(404, {"kind": "Status", "code": 404})

    def do_POST(self):  # noqa: N802
        self._lease_write("POST")

    def do_PUT(self):  # noqa: N802
        self._lease_write("PUT")

    def do_PATCH(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
        with self.stub.lock:
            self.stub.patches.append(self.path)
        self.answer(404, {"kind": "Status", "code": 404})


class _ReceiverHandler(BaseHTTPRequestHandler):
    """The cluster API: every payload, per item or batched, is recorded as
    ``(monotonic time, payload)``."""

    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0) or 0)))
        now = time.monotonic()
        server = self.server
        if self.path.endswith("/update_batch"):
            updates = body["updates"]
            with server.lock:
                server.payloads.extend((now, p) for p in updates)
                server.batch_posts += 1
            data = json.dumps({"results": [True] * len(updates)}).encode()
        else:
            with server.lock:
                server.payloads.append((now, body))
                server.item_posts += 1
            data = b""
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        self.send_response(200 if self.path == "/health" else 404)
        self.send_header("Content-Length", "0")
        self.end_headers()


class _QuietServer(ThreadingHTTPServer):
    """A client dropping its connection (the watcher's stop shuts its watch
    socket down) ends the conversation; it is no server error."""

    def handle_error(self, request, client_address):
        if not isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError, TimeoutError)):
            super().handle_error(request, client_address)


def serve_handler(handler: type, **attrs) -> ThreadingHTTPServer:
    server = _QuietServer(("127.0.0.1", 0), handler)
    server.daemon_threads = True
    for key, value in attrs.items():
        setattr(server, key, value)
    threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.1}, daemon=True).start()
    return server


class GcPauses:
    """The interpreter's cyclic collections while it is open, as ``(end,
    seconds)`` on the monotonic clock: every thread, the probe's included,
    stands still while one runs."""

    def __init__(self):
        self.pauses = []
        self._start = None
        gc.callbacks.append(self._hook)

    def _hook(self, phase: str, info: dict) -> None:
        now = time.monotonic()
        if phase == "start":
            self._start = now
        elif self._start is not None:
            self.pauses.append((now, now - self._start))
            self._start = None

    def between(self, t0: float, t1: float) -> dict:
        inside = [s for end, s in self.pauses if t0 <= end < t1]
        return {"collections": len(inside), "seconds": sum(inside), "longest_s": max(inside, default=0.0)}

    def close(self) -> None:
        gc.callbacks.remove(self._hook)


def watcher_config(config_dir: str, receiver_url: str, apiserver_url: str, workdir: str, *, probe_interval: float,
                   environment: str = "production", overlay: dict = None):
    """``environment`` as the port's ``load_app_config`` loads it (with
    ``overlay`` merged over the files before the schema reads them), every
    plane as shipped, with these overrides: the serving plane and the status routes
    on free ports, the GPU backend and resource key, the node plane's
    accelerator label and node selector pointed at the GPU operator's node
    labels (``nvidia.com/gpu.product``, ``nvidia.com/gpu.present``; both
    shipped selectors name GKE TPU labels), the probe interval, and the
    watcher pointed at local servers, a temporary checkpoint and a temporary
    history WAL."""
    from k8s_watcher_tpu_torch.config import AppConfig, deep_merge, load_raw_config

    kubeconfig = os.path.join(workdir, "kubeconfig")
    with open(kubeconfig, "w") as fh:
        json.dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "stub",
            "clusters": [{"name": "stub", "cluster": {"server": apiserver_url}}],
            "contexts": [{"name": "stub", "context": {"cluster": "stub", "user": "stub"}}],
            "users": [{"name": "stub", "user": {"token": "stub-token"}}],
        }, fh)
    raw = load_raw_config(environment, config_dir, env={
        "CLUSTERAPI_BASE_URL": receiver_url, "PROD_CLUSTERAPI_API_KEY": API_KEY, "STAGING_CLUSTERAPI_API_KEY": API_KEY,
        "WATCHER_STATUS_TOKEN": STATUS_TOKEN,
        "WATCHER_CHECKPOINT_PATH": os.path.join(workdir, "checkpoint.json"),
        "WATCHER_HISTORY_DIR": os.path.join(workdir, "history"),
    })
    shipped = AppConfig.from_raw(raw, environment)
    if not (shipped.history.enabled and shipped.health.enabled and shipped.slo.enabled
            and shipped.tpu.node_watch_enabled):
        fail(f"the {environment} settings no longer enable the history, health, SLO and node planes")
    config = AppConfig.from_raw(deep_merge(raw, overlay), environment) if overlay else shipped
    return dataclasses.replace(
        config, serve=dataclasses.replace(config.serve, port=free_port()),
        watcher=dataclasses.replace(config.watcher, status_port=free_port()),
        tpu=dataclasses.replace(config.tpu, backend="gpu", resource_key=GPU_KEY, accelerator_label=GPU_PRODUCT_LABEL,
                                node_watch_label_selector=GPU_PRESENT_LABEL, probe_interval_seconds=probe_interval),
        kubernetes=dataclasses.replace(config.kubernetes, use_incluster_config=False, config_file=kubeconfig),
    )


def wait_until(predicate, timeout_s: float, poll_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(poll_s)
    return True


def app_runner(app):
    """``(app, its thread, errors)``: the thread runs ``app.run()`` once
    started, and anything it raises lands in ``errors``."""
    errors = []

    def run():
        try:
            app.run()
        except BaseException as exc:  # noqa: BLE001 — reported by the caller, fatal
            errors.append(exc)

    return app, threading.Thread(target=run, name="watcher", daemon=True), errors


def count_cycles(agent, build) -> list:
    """Each of the in-process probe agent's cycles, recorded on its thread
    as its report goes to the sink: health, duration, readings and the
    kernel launches since the last cycle."""
    cycles = []
    deliver = agent.sink

    def count_cycle(notification):
        counts = build.launch_counts()
        since = {k: counts[k] - sum(c["launches"][k] for c in cycles) for k in counts}
        payload = notification.payload
        cycles.append({"end": time.monotonic(), "healthy": payload["healthy"], "duration_ms": payload["duration_ms"],
                       "launches": since, "trend_alerts": payload["trend_alerts"],
                       "mxu_tflops": (payload.get("mxu") or {}).get("tflops_median"),
                       "hbm_read_gbps": (payload.get("hbm") or {}).get("read_gbps"),
                       "hbm_write_gbps": (payload.get("hbm_write") or {}).get("write_gbps")})
        deliver(notification)

    agent.sink = count_cycle
    return cycles


class NodeChurn(threading.Thread):
    """Phase 9's node churn. At each pause of the stub's pod churn: once the
    app has folded every event before it (its parsed-event count) and its
    notifications have drained, the position's node steps go to the node
    watch; once the node plane has notified each of them and that has
    drained, the pod churn is released. A failure is recorded and releases
    every pause, so the churn goes on and the caller fails the phase."""

    def __init__(self, app, stub: ClusterStub, cluster: GpuCluster):
        super().__init__(name="node-churn", daemon=True)
        self.app, self.stub, self.cluster = app, stub, cluster
        self.failures = []
        self.steps_s = []  # per pause: seconds from the node events to their last notification

    def _settle(self) -> None:
        time.sleep(0.3)  # the batch or node event being folded
        if not self.app.dispatcher.drain(60):
            raise RuntimeError("notifications did not drain at a node-churn pause")

    def run(self) -> None:
        app, stub, cluster = self.app, self.stub, self.cluster
        m = app.metrics
        parsed_before, n = [], 0  # events the watcher parses before each churn position
        for _, spec, *_ in cluster.churn:
            parsed_before.append(n)
            n += 1 if spec.gpus else 0
        notified = 0
        try:
            for position in sorted(stub.pauses):
                steps = [(kind, node, ready) for p, kind, node, ready in cluster.node_steps if p == position]
                if not wait_until(lambda: stub.paused_at == position, 180):
                    raise RuntimeError(f"the pod churn did not reach its pause at {position}")
                want = len(cluster.initial) + parsed_before[position]
                if not wait_until(lambda: m.counter("events_received").value >= want
                                  and app.ingest.queue.depth() == 0, 120):
                    raise RuntimeError(f"{m.counter('events_received').value} of {want} events folded at the pause")
                if not wait_until(lambda: app.node_watcher is not None and app.node_watcher.synced.is_set(), 60):
                    raise RuntimeError("the node watch did not sync")
                self._settle()
                notified += len(steps)
                t0 = time.monotonic()
                stub.emit_nodes(steps)
                if not wait_until(lambda: m.counter("node_notifications_enqueued").value >= notified, 60):
                    raise RuntimeError(f"{m.counter('node_notifications_enqueued').value} of {notified} node "
                                       f"payloads enqueued")
                self._settle()
                self.steps_s.append(time.monotonic() - t0)
                stub.release(position)
        except Exception as exc:  # noqa: BLE001 — reported by the caller, fatal
            self.failures.append(repr(exc))
            for event in stub.pauses.values():
                event.set()


def watcher_phase(dev, name: str, power_limit: str, bare_loop_ms: list, seed: int, quiet: dict, wal_hook=None,
                  **sizes) -> dict:
    """Phase 9: ``python -m k8s_watcher_tpu_torch production``'s ``WatcherApp``
    on the card against a seeded cluster of 2,048 GPU nodes and 50,000 pods
    served by ``ClusterStub``, through 60,000 watch events of churn, with
    ``SUBSCRIBERS`` watch streams and analytics requests beside it, then a
    restart from its checkpoint (``sizes`` override ``GpuCluster``'s).
    ``quiet`` holds phase 4's readings. Every check is fatal. Returns the
    kernel launches of the watcher's run.

    ``production`` runs as shipped, leader election and the node plane
    included, with ``watcher_config``'s overrides. The Lease must be created
    before the first pod LIST, renewed while the app runs, released (empty
    ``holderIdentity``) by the stop, and taken again by the restarted app. The
    node churn (``GpuCluster.node_steps``) reaches the node watch while the
    pod churn stands still at its two positions, each released once the app
    has folded every event before it and the node plane has handled the node
    events: the POSTed ``NODE_CONDITION_CHANGE``/``NODE_DELETED`` payloads
    must equal ``fold_node_payloads`` (their ``event_timestamp`` aside), and
    every slice transition the node events cause in ``fold_production`` (the
    slices of a NotReady or deleted node going Degraded, those of a node back
    Ready going Ready) must be among the POSTed ``SLICE_PHASE_CHANGE``
    payloads. ``wal_hook(wal_dir, nodes)`` runs once the restarted app has
    stopped, before the WAL's directory goes (``nodes``: those of the GPU
    workers)."""
    import torch

    from k8s_watcher_tpu_torch.analytics import parse_scenarios, python_reference_verdicts
    from k8s_watcher_tpu_torch.app import WatcherApp
    from k8s_watcher_tpu_torch.health.synthetic import synthetic_link_report
    from k8s_watcher_tpu_torch.history.wal import codec
    from k8s_watcher_tpu_torch.kernels import build
    from k8s_watcher_tpu_torch.serve import FleetView
    from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore

    t_phase = time.monotonic()
    cluster = GpuCluster(seed, **sizes)
    pauses = sorted({position for position, *_ in cluster.node_steps})
    stub = ClusterStub(cluster, pauses=pauses)
    t_built = time.monotonic()
    node_caused = []
    last, transitions = fold_production(
        GpuCluster.facts(cluster.initial) + GpuCluster.facts(cluster.churn),
        node_steps=[(len(cluster.initial) + p, *rest) for p, *rest in cluster.node_steps], node_caused=node_caused)
    want_nodes = fold_node_payloads(cluster.node_steps, "production")
    # the stub stands in for the apiserver, another process in a real
    # cluster: its ~1.2 million objects would otherwise sit in every full
    # cyclic collection the watcher's LIST triggers (~1 s each on the card's
    # host), so they are moved out of the collector's reach
    gc.collect()
    gc.freeze()
    apiserver = serve_handler(type("StubApi", (_StubHandler,), {"stub": stub}))
    receivers = [serve_handler(_ReceiverHandler, lock=threading.Lock(), payloads=[], item_posts=0, batch_posts=0)
                 for _ in range(2)]
    workdir = tempfile.TemporaryDirectory()
    api_url = f"http://127.0.0.1:{apiserver.server_address[1]}"
    configs = [watcher_config(os.path.join(REPO, "config"), f"http://127.0.0.1:{r.server_address[1]}", api_url,
                              workdir.name, probe_interval=1.0) for r in receivers]
    print("watcher cluster: " + json.dumps({
        "seed": seed, "nodes": cluster.nodes, "pods": len(cluster.initial), "churn_events": len(cluster.churn),
        "jobsets": len(transitions), "failed_jobsets": len(cluster.failed_jobsets),
        "list_bytes": stub.pod_bytes, "build_s": t_built - t_phase,
    }))

    def run_app(config):
        return app_runner(WatcherApp(config, device=dev))

    # the first watcher: LIST, churn, probe cycles, status routes, stop
    app, runner, errors = run_app(configs[0])
    cycles = count_cycles(app._probe_agent, build)
    source = app.ingest.sources[0]
    tracked_objects = {"scanned": len(gc.get_objects()), "frozen": gc.get_freeze_count()}
    pauses = GcPauses()
    build.reset_launch_counts()
    t_start = time.monotonic()
    runner.start()
    node_churn = NodeChurn(app, stub, cluster)
    node_churn.start()
    serve_port = app.config.serve.port
    if not wait_until(
            lambda: errors or app.serve.server is not None and http_get(serve_port, "/serve/healthz")[0] == 200, 30):
        fail(f"the serving plane did not answer on :{serve_port} within 30 s")
    if errors:
        fail(f"the watcher raised: {errors[0]!r}")
    subscribers = Subscribers(serve_port, STATUS_TOKEN, SUBSCRIBERS)
    poller = AnalyticsPoller(serve_port, STATUS_TOKEN)
    poller.start()
    streams_before_churn = stub.churn_t0 is None
    if not wait_until(lambda: stub.churn_t0 is not None or errors or not runner.is_alive(), 120):
        fail("the watcher's LIST did not reach the watch within 120 s")
    list_s, list_pages = stub.churn_t0 - t_start if stub.churn_t0 else None, stub.list_pages
    m = app.metrics
    gpu_churn = sum(1 for kind, spec, *_ in cluster.churn if spec.gpus)
    # cut one stream mid-churn; the child resumes it with its token
    wait_until(lambda: errors or m.counter("events_received").value >= len(cluster.initial) + gpu_churn // 2,
               CHURN_DRAIN_LIMIT_S)
    cut_at = {"events_received": m.counter("events_received").value, "view_rv": app.serve.view.rv,
              "s_after_churn_start": time.monotonic() - stub.churn_t0}
    # a resume token minted mid-churn, read again after the restart
    token = (cut_at["view_rv"], app.serve.view.instance)
    subscribers.send("cut")
    drained = wait_until(
        lambda: errors or (stub.churn_done.is_set() and source.resource_version == str(cluster.last_rv)
                           and m.counter("events_received").value >= len(cluster.initial) + gpu_churn
                           and app.ingest.queue.depth() == 0),
        CHURN_DRAIN_LIMIT_S)
    drained = drained and app.dispatcher.drain(max(1.0, CHURN_DRAIN_LIMIT_S - (time.monotonic() - stub.churn_t0)))
    t_drained = time.monotonic()
    if errors:
        fail(f"the watcher raised: {errors[0]!r}")
    if not drained:
        fail(f"the churn did not drain within {CHURN_DRAIN_LIMIT_S} s: rv {source.resource_version} of "
             f"{cluster.last_rv}, {m.counter('events_received').value} events through the pipeline")
    node_churn.join(10)
    if node_churn.failures or node_churn.is_alive():
        fail(f"the node churn: {node_churn.failures or 'still running'}")
    # watch frames handled: parsed ones reach the pipeline, the prefiltered
    # (no GPU key) are counted by the source
    churn_events = m.counter("events_received").value - len(cluster.initial) + m.counter("events_prefiltered").value
    churn_s = t_drained - stub.churn_t0
    if not wait_until(lambda: sum(1 for c in cycles if c["end"] > stub.churn_t0) >= WATCHER_PROBE_CYCLES, 60):
        fail(f"{sum(1 for c in cycles if c['end'] > stub.churn_t0)} probe cycles ran during and after the churn "
             f"in 60 s, want {WATCHER_PROBE_CYCLES}")
    # the what-if: baseline, a drain of the local cluster, 30 cordons
    nodes = sorted({spec.spec["nodeName"] for _, spec, *_ in cluster.initial if spec.gpus})
    raw = draw_scenarios(random.Random(seed), nodes)
    whatif_path = "/serve/analytics?scenarios=" + urllib.parse.quote(json.dumps(raw))
    whatifs = []
    for _ in range(4):
        t0 = time.monotonic()
        whatifs.append((t0, *http_get(serve_port, whatif_path, STATUS_TOKEN), time.monotonic()))
        time.sleep(0.3)
    too_many = http_get(serve_port, "/serve/analytics?scenarios=" + urllib.parse.quote(
        json.dumps(raw + [{"kind": "baseline"}])), STATUS_TOKEN)
    if not wait_until(lambda: sum(1 for c in cycles if c["end"] > whatifs[0][0]) >= 2, 30):
        fail("fewer than 2 probe cycles ran after the what-if requests began")
    poller.halt.set()
    poller.join(10)
    snapshot_status, snapshot = http_get(serve_port, "/serve/fleet", STATUS_TOKEN)
    serve_health = http_get(serve_port, "/serve/healthz")
    streams = subscribers.finish(snapshot["rv"])
    journal = app.serve.view.read_since(0, max_deltas=1 << 30)
    port = app.config.watcher.status_port
    routes = {r: http_get(port, r, STATUS_TOKEN) for r in ("/healthz", "/debug/slices", "/metrics",
                                                           "/debug/freshness")}
    # the history plane: the past at a mid-churn rv, rebuilt from the WAL
    at_read = http_get(serve_port, f"/serve/fleet?at={token[0]}", STATUS_TOKEN)
    # the health plane: every probe cycle's report reaches the detector
    health_plane = app.health
    n_cycles = len(cycles)
    tick_s = app.config.health.tick_seconds
    reports_seen = wait_until(lambda: health_plane.reports_observed >= n_cycles, 3 * tick_s)
    card_node = health_plane.snapshot()["subjects"].get(f"node/{NODE_NAME}", {}).get("state", "healthy")
    # ... then a degraded link on one node of a slice that only the synthetic
    # reports name (the phase source scores the cluster's own nodes against
    # their peers and confirms some of them on its own), one report a tick,
    # until it is confirmed
    drill_nodes = [f"drill-node-{i}" for i in range(4)]
    degraded = drill_nodes[2]
    drill_start_state = health_plane.snapshot()["subjects"].get(f"node/{degraded}", {}).get("state", "healthy")
    t_drill = time.monotonic()
    drill_reports = 0
    for _ in range(4 * app.config.health.confirm_cycles):
        ticks_before = health_plane.snapshot()["ticks"]
        health_plane.observe_report(synthetic_link_report(drill_nodes, degraded_node=degraded))
        drill_reports += 1
        wait_until(lambda: health_plane.snapshot()["ticks"] > ticks_before, 3 * tick_s)
        if health_plane.snapshot()["subjects"].get(f"node/{degraded}", {}).get("state") in ("confirmed", "remediating"):
            break
    confirm_s = time.monotonic() - t_drill

    def escalations():
        with receivers[0].lock:
            return [p for _, p in receivers[0].payloads if p.get("event_type") == "TPU_HEALTH"
                    and any(e.get("name") == degraded for e in p.get("escalated", ()))]

    notified = wait_until(lambda: escalations(), 10.0)
    drill_routes = {r: http_get(port, r, STATUS_TOKEN) for r in ("/healthz", "/debug/health")}
    # the SLO engine: a tick after the drain reads the run's histograms
    slo_ticks = app.slo.snapshot()["ticks"]
    wait_until(lambda: app.slo.snapshot()["ticks"] >= slo_ticks + 2, 4 * app.config.slo.tick_seconds)
    slo_route = http_get(port, "/debug/slo", STATUS_TOKEN)
    slo_metrics = http_get(port, "/metrics", STATUS_TOKEN)
    t0 = time.perf_counter()
    app.metrics.sample()
    sample_ms = 1e3 * (time.perf_counter() - t0)
    le = app.config.watcher.leader_election
    lease_key = (le.lease_namespace, le.lease_name)
    identity = app.elector.identity if app.elector is not None else None
    node_watch = {"synced": app.node_watcher is not None and app.node_watcher.synced.is_set(),
                  "relists": m.counter("node_relists").value}
    t_stop = time.monotonic()
    app.stop()
    runner.join(60)
    stop_s = time.monotonic() - t_stop
    with stub.lock:
        lease_after_stop = dict(stub.leases.get(lease_key, {}).get("spec") or {})
        lease_log = list(stub.lease_log)
    launches = build.launch_counts()
    pauses.close()
    final_rv = app.serve.view.rv
    wal = app.history.stats()
    wal_metrics = {k: m.counter(k).value for k in ("history_wal_deltas", "history_wal_records", "history_wal_bytes",
                                                    "history_snapshots", "history_wal_fsyncs",
                                                    "history_wal_overruns")}
    if runner.is_alive() or stop_s > STOP_LIMIT_S:
        fail(f"the watcher did not stop within {STOP_LIMIT_S} s: {stop_s:.2f} s")
    if errors:
        fail(f"the watcher raised: {errors[0]!r}")

    with receivers[0].lock:
        received = [p for _, p in receivers[0].payloads]
    during = [c for c in cycles if c["end"] > stub.churn_t0]
    latency = m.histogram("event_to_notify_latency").summary()
    print("watcher run: " + json.dumps({
        "list_s": list_s, "list_pages": list_pages, "churn_s": churn_s, "churn_watch_events": churn_events,
        "serve": {"view_rv": snapshot["rv"], "objects": len(snapshot["objects"]),
                  "deltas_published": m.counter("serve_deltas_published").value,
                  "frame_encodes": m.counter("serve_frame_encodes").value,
                  "streams_opened_before_churn": streams_before_churn, "cut_at": cut_at,
                  "resumed": streams["resumed"],
                  "stream_frames": sum(st["frames"] for st in streams["streams"]),
                  "compacted_batches": sum(st["compacted"] for st in streams["streams"]),
                  "publish": m.histogram("serve_publish_seconds").summary(),
                  "delta_lag": m.histogram("serve_delta_lag_seconds").summary()},
        "analytics": {"summaries": len(poller.calls),
                      "summary_ms": [1e3 * (t1 - t0) for t0, t1, _, _ in poller.calls],
                      "whatif_ms": [1e3 * (t1 - t0) for t0, _, _, t1 in whatifs],
                      "requests": m.counter("analytics_requests").value,
                      "kernel": m.histogram("analytics_kernel_seconds").summary(),
                      "encode": m.histogram("analytics_encode_seconds").summary()},
        # the churn stood still at the node churn's pauses
        "churn_paused_s": stub.paused_s,
        "pipeline_events_per_s": churn_events / (churn_s - stub.paused_s) if churn_s > stub.paused_s else None,
        "leader_election": {"identity": identity, "lease_writes": len(lease_log),
                            "renews": sum(1 for _, method, _ in lease_log if method == "PUT"),
                            "after_stop": lease_after_stop},
        "node_watch": {**node_watch, "steps": len(cluster.node_steps), "pause_to_notified_s": node_churn.steps_s,
                       "node_payloads": m.counter("node_notifications_enqueued").value},
        "event_to_notify_latency": latency,
        "item_posts": receivers[0].item_posts, "batch_posts": receivers[0].batch_posts,
        "payloads": len(received),
        "dispatch": {k: m.counter(k).value for k in ("dispatch_sent", "dispatch_batches", "dispatch_batch_items",
                                                     "dispatch_coalesced", "dispatch_failed",
                                                     "dispatch_dropped_overflow")},
        "probe_cycles_during_and_after_churn_ms": [c["duration_ms"] for c in during],
        "probe_cycles": [{**{k: v for k, v in c.items() if k != "end"},
                          "ended_s_after_churn_start": c["end"] - stub.churn_t0} for c in cycles],
        "bare_loop_cycles_ms": bare_loop_ms,
        # cyclic collections in the LIST, the churn, and from the drain to
        # the stop
        "gc_tracked_objects": tracked_objects,
        "gc_pauses": {"list": pauses.between(t_start, stub.churn_t0), "churn": pauses.between(stub.churn_t0, t_drained),
                      "after": pauses.between(t_drained, t_stop)},
        "stop_s": stop_s, "launches": launches, "device": name, "power_limit": power_limit,
    }))

    # 0. leader election: created before the first pod LIST, renewed, released
    # by the stop
    writes = [(t, method, spec) for t, method, spec in lease_log if spec.get("holderIdentity") == identity]
    renew_times = {spec.get("renewTime") for t, method, spec in writes if method == "PUT" and t < t_stop}
    if not lease_log or lease_log[0][1] != "POST" or stub.first_pod_list_t is None or \
            lease_log[0][0] >= stub.first_pod_list_t:
        fail(f"the Lease was not created before the first pod LIST: {lease_log[:2]}, LIST at {stub.first_pod_list_t}")
    if identity is None or len(renew_times) < 2:
        fail(f"the Lease was not renewed while the app ran: identity {identity}, {len(renew_times)} renewTimes")
    if lease_after_stop.get("holderIdentity") != "":
        fail(f"the stop did not release the Lease: {lease_after_stop}")
    # 1. notifications against the plain fold
    pod_last, slice_seen, node_seen, probes = {}, {}, {}, 0
    for payload in received:
        kind = payload.get("event_type")
        if kind == "TPU_PROBE":
            probes += 1
        elif kind in ("NODE_CONDITION_CHANGE", "NODE_DELETED"):
            node_seen.setdefault(payload["node"], []).append(
                {k: v for k, v in payload.items() if k != "event_timestamp"})
        elif kind == "SLICE_PHASE_CHANGE":
            slice_seen.setdefault(payload["slice"], []).append(
                (payload["phase_transition"]["from"], payload["phase_transition"]["to"]))
        elif kind in ("ADDED", "MODIFIED", "DELETED"):
            pod_last[payload["uid"]] = (kind, (payload.get("status") or {}).get("phase"), payload.get("namespace"),
                                        payload.get("name"))
    gpu_uids = {spec.uid for _, spec, *_ in cluster.initial + cluster.churn if spec.gpus}
    strays = [v for uid, v in pod_last.items() if uid not in gpu_uids or v[2] not in WATCHED_NAMESPACES]
    if strays:
        fail(f"payloads name pods the watcher must drop (no GPU or unwatched namespace): {strays[:5]}")
    if pod_last != last:
        wrong = sorted(set(pod_last.items()) ^ set(last.items()))[:6]
        fail(f"last pod payloads differ from the fold ({len(pod_last)} vs {len(last)}): {wrong}")
    degraded_seen = sorted(k for k, t in slice_seen.items() if any(to == "Degraded" for _, to in t))
    degraded_fold = sorted(k for k, t in transitions.items() if any(to == "Degraded" for _, to in t))
    if degraded_seen != degraded_fold or sorted(slice_seen) != sorted(transitions) or \
            not set(cluster.failed_jobsets) <= set(degraded_seen):
        fail(f"slice notifications: Degraded {degraded_seen}, the fold's {degraded_fold} (failed "
             f"{cluster.failed_jobsets}); {len(slice_seen)} slices named of {len(transitions)}")
    # the node plane: its payloads against their fold, and every slice
    # transition the node events cause among the POSTs
    if node_seen != want_nodes:
        wrong = sorted(set(node_seen) ^ set(want_nodes)) or sorted(k for k in node_seen if node_seen[k] != want_nodes[k])
        fail(f"node payloads differ from fold_node_payloads for {len(wrong)} nodes: {wrong[:4]}")
    missing = [(key, a, b) for key, a, b in node_caused if (a, b) not in slice_seen.get(key, ())]
    if len(node_caused) < len(cluster.flipped_nodes) or missing:
        fail(f"{len(missing)} of the {len(node_caused)} slice transitions the node churn causes are not among the "
             f"POSTs: {missing[:4]}")
    final_seen = {k: t[-1][1] for k, t in slice_seen.items()}
    if final_seen != {k: t[-1][1] for k, t in transitions.items()}:
        fail("the last slice notification per JobSet differs from the fold's last phase")
    # 2. drained without loss
    failed, overflow = m.counter("dispatch_failed").value, m.counter("dispatch_dropped_overflow").value
    if failed or overflow:
        fail(f"dispatch_failed {failed}, dispatch_dropped_overflow {overflow}")
    # 3. the probe through the churn
    for n, cycle in enumerate(cycles):
        want = {"read_sweep": 5, "fill": 5, "blocksums": 1}
        if not cycle["healthy"] or cycle["launches"] != want:
            fail(f"watcher probe cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']} (want {want})")
    if probes != len(cycles):
        fail(f"{probes} TPU_PROBE payloads for {len(cycles)} probe cycles")
    # 4. the status routes
    status, health = routes["/healthz"]
    if status != 200 or health.get("alive") is not True:
        fail(f"/healthz: {status} {health}")
    status, slices_body = routes["/debug/slices"]
    if status != 200 or len(slices_body["slices"]) != len(transitions):
        fail(f"/debug/slices: {status}, {len(slices_body.get('slices', {}))} slices of {len(transitions)}")
    status, metrics_body = routes["/metrics"]
    wanted = ("events_received", "notifications_enqueued", "slice_notifications_enqueued", "dispatch_sent",
              "dispatch_enqueued", "event_to_notify_latency")
    if status != 200 or any(k not in metrics_body for k in wanted):
        fail(f"/metrics: {status}, missing {[k for k in wanted if k not in metrics_body]}")
    # 5. a durable stop
    checkpoint = CheckpointStore(configs[0].state.checkpoint_path)
    checkpoint.attach_journaled_map("known_pods")
    checkpoint.attach_journaled_map("phases")
    known = set(checkpoint.get("known_pods") or {})
    with stub.lock:
        live = set(stub.objects)
    if checkpoint.resource_version() != str(cluster.last_rv) or known != live:
        fail(f"checkpoint: rv {checkpoint.resource_version()} (stub {cluster.last_rv}), known_pods "
             f"{len(known)} vs {len(live)} live ({len(known ^ live)} differ)")

    # 6. the serving plane: the snapshot against the plain fold, every stream
    # against the view at its rv, the resumed stream
    if snapshot_status != 200 or serve_health[0] != 200 or not serve_health[1].get("healthy"):
        fail(f"/serve/fleet {snapshot_status}, /serve/healthz {serve_health}")
    serve_fold = health.get("serve") or {}
    if not serve_fold.get("healthy") or not serve_fold.get("started") or serve_fold.get("io_loop", {}).get(
            "threads") != app.config.serve.io_threads:
        fail(f"/healthz carries no healthy serve fold: {serve_fold}")
    if routes["/debug/freshness"][0] != 200:
        fail(f"/debug/freshness: {routes['/debug/freshness']}")
    objects = {(o["kind"], o["key"]): o for o in snapshot["objects"]}
    pods = {key: o for (kind, key), o in objects.items() if kind == "pod"}
    want_pods = fold_view(cluster.initial + cluster.churn)
    if pods != want_pods:
        wrong = sorted(set(pods) ^ set(want_pods)) or sorted(k for k in pods if pods[k] != want_pods[k])
        fail(f"the snapshot's pods differ from fold_view ({len(pods)} vs {len(want_pods)}): {wrong[:5]}")
    slices_view = {key: o for (kind, key), o in objects.items() if kind == "slice"}
    if {k: o["phase"] for k, o in slices_view.items()} != {k: t[-1][1] for k, t in transitions.items()}:
        fail(f"the snapshot's {len(slices_view)} slices differ from the fold's {len(transitions)} last phases")
    probe_objects = [o for (kind, _), o in objects.items() if kind == "probe"]
    if len(probe_objects) != 1 or not probe_objects[0].get("healthy"):
        fail(f"the snapshot's probe verdicts: {probe_objects}")
    if journal.status != "ok" or journal.compacted or not len(journal.deltas) == journal.to_rv >= snapshot["rv"]:
        fail(f"the view's journal does not reach back to rv 0: {journal.status}, {len(journal.deltas)} deltas "
             f"to rv {journal.to_rv}")
    by_rv = states_at(journal.deltas, [snapshot["rv"]] + [st["at"][0] for st in streams["streams"] if st["at"]])
    if model_digest(by_rv[snapshot["rv"]]) != model_digest(objects):
        fail("the view's journal does not fold to its own snapshot")
    for i, st in enumerate(streams["streams"]):
        if (st["status"] != 200 or not st["open"] or st["gaps"] or st["dups"] or st["gone"] or not st["at"]
                or st["at"][1] != model_digest(by_rv[st["at"][0]])):
            fail(f"watch stream {i} does not fold to the view: {st}")
    resumed = streams["resumed"] or {}
    if resumed.get("status") != 200 or resumed.get("first_sync") != resumed.get("from_rv") or \
            resumed.get("deltas_after", 0) <= 0:
        fail(f"the cut stream did not resume with its token: {resumed}")
    # 7. analytics: every body against the numpy backend and the plain
    # reference over the view at the body's rv
    bodies = [(body, None) for _, _, status, body in poller.calls] + [(body, raw) for _, status, body, _ in whatifs]
    statuses = [c[2] for c in poller.calls] + [w[1] for w in whatifs]
    if len(poller.calls) < 4 or any(st != 200 for st in statuses):
        fail(f"{len(poller.calls)} analytics summaries, statuses {sorted(set(map(str, statuses)))}: "
             f"{[c[3] for c in poller.calls if c[2] != 200][:2]}")
    if too_many[0] != 400 or "max_scenarios" not in too_many[1].get("error", ""):
        fail(f"a request of {len(raw) + 1} scenarios: {too_many}")
    states = states_at(journal.deltas, [body["rv"] for body, _ in bodies])
    references = {}
    for body, scenarios in bodies:
        if body["backend"] != "torch" or not body["crosscheck"]["ok"]:
            fail(f"analytics body at rv {body['rv']}: backend {body['backend']}, {body['crosscheck']}")
        key = (body["rv"], scenarios is not None)
        if key not in references:
            state = states[body["rv"]]
            plain = numpy_plane(state, app.config.analytics)
            tables = tables_of(state)
            if scenarios is None:
                references[key] = (comparable(plain.summary()), comparable(
                    {"fleet": python_reference_verdicts(tables, parse_scenarios([{"kind": "baseline"}],
                                                                                max_scenarios=1))["baseline"]}))
            else:
                references[key] = (comparable(plain.evaluate(scenarios)), comparable(python_reference_verdicts(
                    tables, parse_scenarios(scenarios, max_scenarios=len(scenarios)))))
        on_numpy, on_reference = references[key]
        got = comparable(body)
        if got != on_numpy or {k: got[k] for k in on_reference} != on_reference:
            fail(f"analytics body at rv {body['rv']} ({'what-if' if scenarios else 'summary'}) differs from "
                 f"the numpy backend or the plain reference")
    if m.counter("analytics_crosscheck_failures").value:
        fail(f"analytics_crosscheck_failures {m.counter('analytics_crosscheck_failures').value}")
    # 8. the probe's readings while analytics requests ran
    requests_at = [(t0, t1) for t0, t1, _, _ in poller.calls] + [(t0, t1) for t0, _, _, t1 in whatifs]
    overlapping = [c for c in cycles
                   if any(t0 < c["end"] and t1 > c["end"] - c["duration_ms"] / 1e3 for t0, t1 in requests_at)]
    if not overlapping:
        fail("no probe cycle ran while an analytics request did")
    for c in overlapping:
        for reading in ("mxu_tflops", "hbm_read_gbps", "hbm_write_gbps"):
            if c[reading] is None or abs(c[reading] - quiet[reading]) > READING_TOLERANCE * quiet[reading]:
                fail(f"{reading} {c[reading]} while analytics ran, phase 4 read {quiet[reading]} "
                     f"(tolerance {READING_TOLERANCE:.0%})")
    print("watcher serve and analytics: " + json.dumps({
        "snapshot_rv": snapshot["rv"], "pods": len(pods), "slices": len(slices_view),
        "streams_folded": len(streams["streams"]), "stream_rvs": sorted({st["at"][0] for st in streams["streams"]}),
        "analytics_bodies_checked": len(bodies), "distinct_rvs": len(references),
        "cycles_beside_analytics": len(overlapping),
        "readings_beside_analytics": [{k: c[k] for k in ("mxu_tflops", "hbm_read_gbps", "hbm_write_gbps")}
                                      for c in overlapping],
        "quiet": quiet, "device": name, "power_limit": power_limit,
    }))
    # analytics at this size: the card against numpy and the plain reference
    sized = FleetView(compact_horizon=1 << 20)
    sized.apply_batch([(kind, key, obj) for (kind, key), obj in objects.items()])
    print("watcher analytics timings: " + json.dumps({
        **analytics_timings(torch, sized, raw, app.config.analytics, dev), "device": name,
        "power_limit": power_limit}))

    # 10. the history, health and SLO planes beside the probe
    history_summary = {
        "codec": codec(), "wal_total_bytes": wal["total_bytes"], "segments": len(wal["segments"]),
        "durable_rv": wal["durable_rv"], "final_view_rv": final_rv, **wal_metrics,
        "wal_bytes_per_s_over_churn": wal_metrics["history_wal_bytes"] / churn_s if churn_s > 0 else None,
        "write": m.histogram("history_wal_write_seconds").summary(), "stop_s": stop_s,
    }
    at_status, at_body = at_read
    at_state = {(o["kind"], o["key"]): o for o in at_body.get("objects", ())} if at_status == 200 else None
    want_at = states_at(journal.deltas, [token[0]])[token[0]]
    if at_status != 200 or not at_body.get("historical") or model_digest(at_state) != model_digest(want_at):
        fail(f"?at={token[0]}: {at_status}, {len(at_state or {})} objects against {len(want_at)} in the journal "
             f"folded to that rv")
    if wal["durable_rv"] != final_rv or wal_metrics["history_wal_overruns"] or wal["writer_alive"]:
        fail(f"the WAL after the stop: {history_summary}")
    serve_history = serve_fold.get("history") or {}
    if not serve_history.get("healthy") or not serve_history.get("writer_alive"):
        fail(f"/healthz's serve fold carries no live WAL writer: {serve_fold}")
    health_summary = {
        "tick_seconds": app.config.health.tick_seconds, "confirm_cycles": app.config.health.confirm_cycles,
        "reports_observed": health_plane.reports_observed, "probe_cycles_at_check": n_cycles,
        "card_node_state": card_node, "drill_node": degraded, "drill_start_state": drill_start_state,
        "drill_reports": drill_reports,
        "confirm_s": confirm_s, "escalations_received": len(escalations()), "node_patches": list(stub.patches),
        "tick": m.histogram("health_tick_seconds").summary(), "ticks": m.counter("health_ticks").value,
        "escalations": m.counter("health_escalations").value,
        "confirmed_at_drill": {k: len((drill_routes["/healthz"][1].get("health") or {}).get(k, ()))
                               for k in ("suspect", "confirmed", "remediating")},
    }
    if not reports_seen or card_node != "healthy":
        fail(f"the health plane and the probe: {health_summary}")
    if drill_start_state != "healthy" or drill_reports != app.config.health.confirm_cycles or not notified or \
            stub.patches:
        fail(f"the synthetic degraded node: {health_summary}")
    (hz_status, hz), (dh_status, dh) = drill_routes["/healthz"], drill_routes["/debug/health"]
    drill_subject = (dh.get("health") or {}).get("subjects", {}).get(f"node/{degraded}", {}) if dh_status == 200 else {}
    if hz_status != 200 or hz.get("alive") is not True or hz.get("health", {}).get("healthy") is not False or \
            drill_subject.get("state") not in ("confirmed", "remediating"):
        fail(f"/healthz {hz_status} {hz.get('health')}, /debug/health {dh_status} {drill_subject}")
    slo_status, slo_body = slo_route
    objectives = (slo_body.get("slo") or {}).get("objectives", {}) if slo_status == 200 else {}
    want_objectives = {o.name for o in app.config.slo.objectives}
    local = objectives.get("local-propagation-p99", {}).get("windows", {})
    local_count = slo_metrics[1].get("watch_to_local_view_seconds", {}).get("count")
    slo_summary = {
        "objectives": {name: {w: (r["windows"][w]["burn_rate"], r["windows"][w].get("observations"))
                              for w in ("fast", "slow")} for name, r in objectives.items()},
        "breaching": sorted(n for n, r in objectives.items() if r.get("breaching")),
        "local_propagation_observations": local.get("slow", {}).get("observations"),
        "metrics_count": local_count, "registry_sample_ms": sample_ms,
        "ticks": (slo_body.get("slo") or {}).get("ticks"),
    }
    if set(objectives) != want_objectives or any(set(r["windows"]) != {"fast", "slow"} for r in objectives.values()):
        fail(f"/debug/slo: {slo_status}, objectives {sorted(objectives)} against {sorted(want_objectives)}")
    if not local_count or local.get("slow", {}).get("observations") != local_count:
        fail(f"local-propagation-p99 read {slo_summary['local_propagation_observations']} samples, "
             f"/metrics counts {local_count}")
    print("watcher history, health and slo: " + json.dumps({
        "history": history_summary, "health": health_summary, "slo": slo_summary,
        "device": name, "power_limit": power_limit,
    }))

    # 11. deletions while down, then a restart from the checkpoint and the WAL
    stub.delete_while_down([uid for _, _, uid in cluster.down_deletions])
    # its ports are picked now, not when the first app started: a port picked
    # minutes earlier can be a live connection's local port by the restart
    restart_config = dataclasses.replace(
        configs[1], serve=dataclasses.replace(configs[1].serve, port=free_port()),
        watcher=dataclasses.replace(configs[1].watcher, status_port=free_port()))
    t_construct = time.monotonic()
    app2, runner2, errors2 = run_app(restart_config)  # recovers the checkpoint and the WAL
    construct_s = time.monotonic() - t_construct
    t_restart = time.monotonic()
    runner2.start()
    gone = {uid for _, _, uid in cluster.down_deletions}

    def tombstones():
        with receivers[1].lock:
            return {p["uid"] for _, p in receivers[1].payloads if p.get("event_type") == "DELETED"}

    restarted = wait_until(lambda: errors2 or tombstones() >= gone, 120)
    restart_s = time.monotonic() - t_restart
    if errors2:
        fail(f"the restarted watcher raised: {errors2[0]!r}")
    with stub.lock:
        lease_restart = dict(stub.leases.get(lease_key, {}).get("spec") or {})
    identity2 = app2.elector.identity if app2.elector is not None else None
    recovered = app2.history.recovered
    restored = {"instance_kept": app2.serve.view.instance == token[1], "clean": recovered.clean,
                "recovered_rv": recovered.rv, "journal": len(recovered.journal), "construct_s": construct_s}
    port2, serve_port2 = app2.config.watcher.status_port, app2.config.serve.port
    resumed = http_get(serve_port2, f"/serve/fleet?watch=1&once=1&timeout=1&rv={token[0]}&view={token[1]}",
                       STATUS_TOKEN)
    resumed_at = http_get(serve_port2, f"/serve/fleet?at={resumed[1].get('to_rv')}", STATUS_TOKEN) \
        if resumed[0] == 200 else (None, {})
    history_route = http_get(port2, "/debug/history", STATUS_TOKEN)
    app2.stop()
    runner2.join(60)
    stub.closing.set()
    for server in (apiserver, *receivers):
        server.shutdown()
        server.server_close()
    if wal_hook is not None and not runner2.is_alive():
        wal_hook(os.path.join(workdir.name, "history"), nodes)
    workdir.cleanup()
    gc.unfreeze()
    if errors2 or runner2.is_alive():
        fail(f"the restarted watcher: errors {errors2}, still running {runner2.is_alive()}")
    if identity2 is None or lease_restart.get("holderIdentity") != identity2 or \
            lease_restart.get("leaseTransitions") != lease_after_stop.get("leaseTransitions", 0) + 1:
        fail(f"the restarted app did not take the Lease again: {lease_restart} (identity {identity2})")
    if not restarted or tombstones() != gone:
        fail(f"the restart POSTed DELETED for {len(tombstones() & gone)} of the {len(gone)} pods deleted while "
             f"down (and {len(tombstones() - gone)} others)")
    if not restored["instance_kept"] or not restored["clean"] or restored["recovered_rv"] != final_rv:
        fail(f"the view was not restored from the WAL: {restored}, rv at the stop {final_rv}")
    status, body = resumed
    if status != 200 or body.get("from_rv") != token[0] or not body.get("items") or body["to_rv"] <= final_rv:
        fail(f"the token minted before the stop (rv {token[0]}) did not resume after the restart: {status} "
             f"{ {k: v for k, v in body.items() if k != 'items'} if isinstance(body, dict) else body}")
    folded = dict(want_at)
    for item in body["items"]:
        if item["type"] == "DELETE":
            folded.pop((item["kind"], item["key"]), None)
        else:
            folded[(item["kind"], item["key"])] = item["object"]
    at2_status, at2 = resumed_at
    if at2_status != 200 or model_digest(folded) != model_digest(
            {(o["kind"], o["key"]): o for o in at2.get("objects", ())}):
        fail(f"the resumed deltas do not fold to the WAL's state at rv {body['to_rv']} ({at2_status})")
    if history_route[0] != 200 or not history_route[1]["history"]["writer_alive"]:
        fail(f"/debug/history after the restart: {history_route}")
    restored.update({"resumed_from_rv": token[0], "resumed_to_rv": body["to_rv"], "resumed_deltas": len(body["items"]),
                     "resumed_compacted": body["compacted"]})
    print("watcher restart: " + json.dumps({
        "lease_after_restart": lease_restart,
        "deleted_while_down": len(gone), "synthesized_deleted": len(tombstones()), "restart_to_last_deleted_s":
        restart_s, "restored": restored, "phase_s": time.monotonic() - t_phase, "device": name,
        "power_limit": power_limit,
    }))
    return launches


def staging_phase(dev, name: str, power_limit: str, seed: int, **sizes) -> dict:
    """Phase 11: ``python -m k8s_watcher_tpu_torch staging``'s ``WatcherApp``
    as shipped (``watcher_config``'s overrides) on the card: two shard streams
    read by two spawned reader processes on the native prefilter, the node
    plane, the serving, analytics, history, health and SLO planes and the
    in-process probe, against ``GpuCluster(seed)`` with its JobSets and
    services in staging's watched namespaces (``sizes`` override its sizes).
    ``ClusterStub`` serves each shard stream the whole LIST and churn, as a
    stock apiserver does. Halfway through the churn reader 0 is SIGKILLed; it
    respawns and resumes from its shard checkpoints. Delivery is then
    at-least-once: a replayed event may POST an older state again, so the
    rule is that each pod's last POSTed payload equals ``fold_production``'s
    under the staging rules (every significant change notifies), each
    JobSet's last POSTed slice phase equals the fold's, every failed JobSet
    went Degraded in the pipeline's notifications (under backlog the egress
    lanes coalesce by key, so a later payload may replace that one on the
    wire), and nothing else is named. Also: both readers run the native
    scanner; the prefilter skipped frames and every other-shard GPU frame was
    skipped before a parse; ``/debug/processes`` lists both readers, one with
    one respawn; at least ``WATCHER_PROBE_CYCLES`` probe cycles ran healthy
    with every kernel launched in each; the node watch synced; the stop takes
    under ``STOP_LIMIT_S`` and leaves no reader process; each shard's
    checkpoint holds the last resourceVersion. Every check is fatal. Returns
    the kernel launches of the run."""
    import multiprocessing
    import signal

    from k8s_watcher_tpu_torch.app import WatcherApp
    from k8s_watcher_tpu_torch.config import load_app_config
    from k8s_watcher_tpu_torch.kernels import build
    from k8s_watcher_tpu_torch.native.build import build_fastscan, last_build_error
    from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore
    from k8s_watcher_tpu_torch.watch.procpool import worker_checkpoint_dir

    t_phase = time.monotonic()
    lib = build_fastscan()
    if lib is None:
        fail(f"the native scanner did not build: {last_build_error()}")
    namespaces = load_app_config("staging", os.path.join(REPO, "config"), env={}).watcher.namespaces
    cluster = GpuCluster(seed, namespaces=namespaces, jobset_namespace="staging", **sizes)
    stub = ClusterStub(cluster)
    last, transitions = fold_production(GpuCluster.facts(cluster.initial) + GpuCluster.facts(cluster.churn),
                                        namespaces=namespaces, critical=False)
    gc.collect()
    gc.freeze()
    apiserver = serve_handler(type("StubApi", (_StubHandler,), {"stub": stub}))
    receiver = serve_handler(_ReceiverHandler, lock=threading.Lock(), payloads=[], item_posts=0, batch_posts=0)
    workdir = tempfile.TemporaryDirectory()
    config = watcher_config(os.path.join(REPO, "config"), f"http://127.0.0.1:{receiver.server_address[1]}",
                            f"http://127.0.0.1:{apiserver.server_address[1]}", workdir.name, probe_interval=1.0,
                            environment="staging")
    ingest = config.ingest
    if (ingest.processes, ingest.shards, ingest.prefilter) != (2, 2, "auto"):
        fail(f"the staging settings no longer run 2 readers over 2 shards on prefilter auto: {ingest}")
    print("staging cluster: " + json.dumps({
        "seed": seed, "nodes": cluster.nodes, "pods": len(cluster.initial), "churn_events": len(cluster.churn),
        "namespaces": list(namespaces), "jobsets": len(transitions), "failed_jobsets": len(cluster.failed_jobsets),
        "list_bytes": stub.pod_bytes, "fastscan": os.path.relpath(str(lib), REPO),
    }))
    app, runner, errors = app_runner(WatcherApp(config, device=dev))
    cycles = count_cycles(app._probe_agent, build)
    m = app.metrics
    endpoints = app.ingest.endpoints
    # the slice transitions the pipeline hands to egress, before any coalescing
    emitted, to_egress = [], app.pipeline.sink

    def record(notification):
        if notification.kind == "slice":
            p = notification.payload
            emitted.append((p["slice"], p["phase_transition"]["from"], p["phase_transition"]["to"]))
        to_egress(notification)

    app.pipeline.sink = record

    def posted():
        with receiver.lock:
            return [p for _, p in receiver.payloads]

    def folds(payloads):
        pods, slices = {}, {}
        for p in payloads:
            kind = p.get("event_type")
            if kind == "SLICE_PHASE_CHANGE":
                slices.setdefault(p["slice"], []).append((p["phase_transition"]["from"], p["phase_transition"]["to"]))
            elif kind in ("ADDED", "MODIFIED", "DELETED"):
                pods[p["uid"]] = (kind, (p.get("status") or {}).get("phase"), p.get("namespace"), p.get("name"))
        return pods, slices

    final = {k: t[-1][1] for k, t in transitions.items()}

    def converged():
        pods, slices = folds(posted())
        return pods == last and {k: t[-1][1] for k, t in slices.items()} == final

    build.reset_launch_counts()
    t_start = time.monotonic()
    runner.start()
    if not wait_until(lambda: errors or all(e.last_hello for e in endpoints), 60):
        fail(f"the reader processes did not say hello within 60 s: {[e.last_hello for e in endpoints]}")
    hellos = [dict(e.last_hello) for e in endpoints]
    gpu_churn = sum(1 for _, spec, *_ in cluster.churn if spec.gpus)
    if not wait_until(lambda: errors or m.counter("events_received").value >= len(cluster.initial) + gpu_churn // 2,
                      CHURN_DRAIN_LIMIT_S):
        fail(f"half the churn did not arrive within {CHURN_DRAIN_LIMIT_S} s: "
             f"{m.counter('events_received').value} events")
    list_s = stub.churn_t0 - t_start if stub.churn_t0 else None
    victim = endpoints[0].pid
    t_kill = time.monotonic()
    killed_at = {"events_received": m.counter("events_received").value, "stub_published": stub.published,
                 "s_after_churn_start": t_kill - stub.churn_t0}
    os.kill(victim, signal.SIGKILL)
    if not wait_until(lambda: errors or (endpoints[0].respawns >= 1 and endpoints[0].pid not in (None, victim)
                                         and endpoints[0].last_hello.get("pid") != victim), 60):
        fail(f"reader 0 did not respawn within 60 s of its SIGKILL (respawns {endpoints[0].respawns})")
    respawn_s = time.monotonic() - t_kill
    respawn_hello = dict(endpoints[0].last_hello)
    drained = wait_until(lambda: errors or (stub.churn_done.is_set() and app.ingest.queue.depth() == 0
                                            and converged()), CHURN_DRAIN_LIMIT_S)
    drained = drained and app.dispatcher.drain(60)
    t_drained = time.monotonic()
    if errors:
        fail(f"the staging watcher raised: {errors[0]!r}")
    if not drained:
        pods, _ = folds(posted())
        fail(f"the staging churn did not converge within {CHURN_DRAIN_LIMIT_S} s: {len(pods)} pods POSTed of "
             f"{len(last)}, churn written {stub.churn_done.is_set()}")
    if not wait_until(lambda: sum(1 for c in cycles if c["end"] > stub.churn_t0) >= WATCHER_PROBE_CYCLES, 60):
        fail(f"{sum(1 for c in cycles if c['end'] > stub.churn_t0)} probe cycles ran during and after the churn")
    port = config.watcher.status_port
    routes = {r: http_get(port, r, STATUS_TOKEN) for r in ("/healthz", "/debug/processes")}
    node_watch = {"synced": app.node_watcher is not None and app.node_watcher.synced.is_set(),
                  "relists": m.counter("node_relists").value}
    counters = {k: m.counter(k).value for k in ("events_received", "events_prefiltered", "events_other_shard",
                                                "ingest_worker_respawns", "ingest_wire_gaps", "dispatch_sent",
                                                "dispatch_coalesced", "dispatch_failed", "dispatch_dropped_overflow",
                                                "relists")}
    pids = [p for p in app.ingest.worker_pids() if p]
    t_stop = time.monotonic()
    app.stop()
    runner.join(60)
    stop_s = time.monotonic() - t_stop
    launches = build.launch_counts()
    alive_after = [p for p in pids if os.path.exists(f"/proc/{p}")] + [c.pid for c in multiprocessing.active_children()]
    stub.closing.set()
    for server in (apiserver, receiver):
        server.shutdown()
        server.server_close()
    shard_dir = worker_checkpoint_dir(config.state.checkpoint_path)
    shard_rvs = [CheckpointStore(os.path.join(shard_dir, f"shard-{i}-of-2.json")).resource_version() for i in range(2)]
    workdir.cleanup()
    gc.unfreeze()

    payloads = posted()
    pods, slices = folds(payloads)
    churn_frames = stub.frames_written  # each shard stream is sent the whole churn; a resumed one the rest
    foreign_written = sum(stub.foreign_written.values())
    churn_s = t_drained - stub.churn_t0
    print("staging run: " + json.dumps({
        "list_s": list_s, "list_pages": stub.list_pages, "pod_lists": stub.pod_lists, "pod_watches": len(stub.watches),
        "churn_s": churn_s, "churn_frames": churn_frames,
        "churn_frames_per_s": churn_frames / churn_s if churn_s > 0 else None,
        "prefiltered_share": counters["events_prefiltered"] / churn_frames,
        "foreign_gpu_frames_written": foreign_written, "counters": counters,
        "killed_at": killed_at, "respawn_s": respawn_s, "hellos": hellos, "respawn_hello": respawn_hello,
        "processes": routes["/debug/processes"][1], "node_watch": node_watch,
        "payloads": len(payloads), "item_posts": receiver.item_posts, "batch_posts": receiver.batch_posts,
        "event_to_notify_latency": m.histogram("event_to_notify_latency").summary(),
        "probe_cycles": [{**{k: v for k, v in c.items() if k != "end"},
                          "ended_s_after_churn_start": c["end"] - stub.churn_t0} for c in cycles],
        "stop_s": stop_s, "shard_checkpoint_rvs": shard_rvs, "launches": launches,
        "phase_s": time.monotonic() - t_phase, "device": name, "power_limit": power_limit,
    }))

    if runner.is_alive() or stop_s > STOP_LIMIT_S or alive_after:
        fail(f"the staging watcher did not stop cleanly: {stop_s:.2f} s, reader processes left {alive_after}")
    if errors:
        fail(f"the staging watcher raised: {errors[0]!r}")
    # the readers: two processes, two shards, the native scanner in each
    if len({h["pid"] for h in hellos}) != 2 or sorted(h["shards"][0] for h in hellos) != [0, 1] or any(
            h.get("scanners") != ["NativeFrameScanner"] for h in hellos + [respawn_hello]):
        fail(f"reader hellos: {hellos}, after the respawn {respawn_hello}")
    if counters["events_prefiltered"] <= 0 or foreign_written <= 0 or counters["events_other_shard"]:
        fail(f"the prefilter: {counters['events_prefiltered']} frames skipped, {foreign_written} other-shard GPU "
             f"frames written, {counters['events_other_shard']} of them parsed")
    status, body = routes["/debug/processes"]
    rows = (body.get("processes") or {}).get("workers", []) if status == 200 else []
    if len(rows) != 2 or sorted(r["respawns"] for r in rows) != [0, 1] or any(r["wire_gaps"] for r in rows):
        fail(f"/debug/processes: {status} {rows}")
    health = routes["/healthz"][1]
    if routes["/healthz"][0] != 200 or health.get("alive") is not True or "processes" not in health:
        fail(f"/healthz: {routes['/healthz']}")
    # what was POSTed against the fold under the staging rules
    gpu_uids = {spec.uid for _, spec, *_ in cluster.initial + cluster.churn if spec.gpus}
    strays = [v for uid, v in pods.items() if uid not in gpu_uids or v[2] not in namespaces]
    if strays:
        fail(f"payloads name pods the watcher must drop: {strays[:5]}")
    if pods != last:
        wrong = sorted(set(pods.items()) ^ set(last.items()))[:6]
        fail(f"last pod payloads differ from the staging fold ({len(pods)} vs {len(last)}): {wrong}")
    degraded = {k for k, _, to in emitted if to == "Degraded"}
    if {k: t[-1][1] for k, t in slices.items()} != final or not set(cluster.failed_jobsets) <= degraded:
        fail(f"slice payloads: last phases differ from the fold, or a failed JobSet never went Degraded "
             f"({sorted(set(cluster.failed_jobsets) - degraded)})")
    if counters["dispatch_failed"] or counters["dispatch_dropped_overflow"]:
        fail(f"dispatch: {counters}")
    # the probe and the node plane beside the readers
    for n, cycle in enumerate(cycles):
        want = {"read_sweep": 5, "fill": 5, "blocksums": 1}
        if not cycle["healthy"] or cycle["launches"] != want:
            fail(f"staging probe cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']} (want {want})")
    if not node_watch["synced"] or node_watch["relists"] < 1:
        fail(f"the node watch: {node_watch}")
    if shard_rvs != [str(stub.rv)] * 2:
        fail(f"shard checkpoints at {shard_rvs}, the stub at {stub.rv}")
    return launches


def fleet_scale_view(seed: int, *, jobsets: int = 16384, workers: int = 8, nodes: int = 16384,
                     clusters=("", "cluster-b", "cluster-c"), down_share: float = 1 / 16):
    """Phase 10's fleet, built straight into a ``FleetView`` (no ingest):
    ``jobsets`` JobSets of ``workers`` GPU workers each, JobSet ``j`` in
    ``clusters[j % 3]`` (keys prefixed with the cluster's name, as a
    federator holds them) on ``workers`` distinct seeded nodes of ``nodes``,
    and ``down_share`` of all workers not up (Pending), drawn with ``seed``.
    Returns the view and the node names."""
    from k8s_watcher_tpu_torch.serve import FleetView

    rng = random.Random(seed)
    total = jobsets * workers
    down = set(rng.sample(range(total), int(total * down_share)))
    node_names = [f"gpu-node-{i:05d}" for i in range(nodes)]
    view = FleetView()
    items = []
    for j in range(jobsets):
        cluster = clusters[j % len(clusters)]
        prefix, tag = (f"{cluster}/", {"cluster": cluster}) if cluster else ("", {})
        jobset = f"train-{j:05d}"
        members = []
        for w, node in enumerate(rng.sample(node_names, workers)):
            i = j * workers + w
            up = i not in down
            name, uid = f"{jobset}-workers-0-{w}", f"{prefix}uid-{i:06d}"
            phase = "Running" if up else "Pending"
            items.append(("pod", uid, {"kind": "pod", "key": uid, "name": name, "namespace": "production",
                                       "phase": phase, "ready": up, "node": node, "pod_resource_version": str(i + 1),
                                       **tag}))
            members.append({"name": name, "worker_index": w, "phase": phase, "ready": up, "restarts": 0,
                            "node": node, "node_ready": True})
        key = f"{prefix}production/{jobset}/workers"
        ready = sum(1 for m in members if m["ready"])
        items.append(("slice", key, {"kind": "slice", "key": key, "slice": key, "namespace": "production",
                                     "name": jobset, "chips_per_worker": 8, "total_chips": 8 * workers,
                                     "expected_workers": None, "observed_workers": workers, "ready_workers": ready,
                                     "phase": "Ready" if ready == workers else "Degraded", "workers": members,
                                     **tag}))
        if len(items) >= 8192:
            view.apply_batch(items)
            items = []
    view.apply_batch(items)
    return view, node_names


def analytics_phase(torch, dev, name: str, power_limit: str, seed: int, config) -> dict:
    """Phase 10: analytics over ``fleet_scale_view`` on the card, on the
    numpy backend and through the plain reference (which must agree), with
    their times (returned). The plain reference takes seconds per
    32-scenario call, so it is timed over one call to keep the phase within
    30 s."""
    t0 = time.monotonic()
    view, nodes = fleet_scale_view(seed)
    _, cols = view.fleet_columns()
    built_s = time.monotonic() - t0
    raw = draw_scenarios(random.Random(seed + 10), nodes)
    timings = analytics_timings(torch, view, raw, config, dev, reference_calls=1)
    print("fleet analytics: " + json.dumps({
        "jobsets": int(cols.n_slices), "workers": int(cols.n_workers), "pods": int(cols.n_pods),
        "clusters": len(cols.clusters), "nodes": len(nodes), "workers_up": int(cols.w_up.sum()),
        "build_s": built_s, **timings, "phase_s": time.monotonic() - t0, "device": name, "power_limit": power_limit,
    }))
    return timings


# -- phases 12 and 13: the federator and the relay --------------------------------

#: the upstream clusters of phase 12, named so that ``shard_of(name, 2)``
#: gives each of two merge workers at least one (us-east and us-west on
#: worker 0, eu-west on worker 1)
FED_UPSTREAMS = ("us-east", "us-west", "eu-west")
FED_SUBSCRIBERS = 16
RELAY_SUBSCRIBERS = 64
FED_TRACE_EVERY = 16  # every 16th churn step's replacement pod carries a sampled journey
#: the WAL segment cap of phase 12's views. A segment rotates once its bytes,
#: the opening snapshot's included, reach the cap, so a snapshot past
#: production's 16 MiB (the global view's is ~50 MB, an upstream's ~16 MB)
#: would rewrite the whole view on every writer drain (both packages;
#: ROADMAP.md section C)
FLEET_SEGMENT_BYTES = 256 << 20


class FederatedFleet:
    """Phase 12's three upstream clusters, seeded: ``jobsets`` JobSets of
    ``workers`` GPU workers, JobSet ``j`` in ``clusters[j % 3]`` on
    ``workers`` distinct nodes of its own cluster (``nodes`` split evenly,
    named after the cluster), ``down_share`` of the workers Pending; the
    objects are those phase 10 builds, keyed as the upstream's own view
    holds them. ``step(cluster)`` is the next churn step of one cluster
    (each cluster churns from its own seeded stream): a JobSet loses a
    worker (Failed, its slice Degraded, the pod deleted) and gets a
    replacement on another of the cluster's nodes (Pending, then Running
    and ready, the slice back to its phase), seven view items in order."""

    def __init__(self, seed: int = 0, *, clusters=FED_UPSTREAMS, jobsets: int = 16384, workers: int = 8,
                 nodes: int = 16384, down_share: float = 1 / 16):
        rng = random.Random(seed)
        self.clusters = tuple(clusters)
        self.workers = workers
        k = len(self.clusters)
        self.nodes = fleet_nodes(self.clusters, nodes)
        total = jobsets * workers
        down = set(rng.sample(range(total), int(total * down_share)))
        self.pods = {c: {} for c in self.clusters}  # cluster -> uid -> object
        self.slices = {c: {} for c in self.clusters}  # cluster -> slice key -> [member uid per worker]
        self._serial = {c: 0 for c in self.clusters}
        self._rngs = {c: random.Random(seed * 1000 + 7 * n + 1) for n, c in enumerate(self.clusters)}
        self._keys = {c: [] for c in self.clusters}
        self.steps_taken = {c: 0 for c in self.clusters}
        for j in range(jobsets):
            cluster = self.clusters[j % k]
            jobset = f"train-{j:05d}"
            members = []
            for w, node in enumerate(rng.sample(self.nodes[cluster], workers)):
                up = j * workers + w not in down
                members.append(self._new_pod(cluster, jobset, w, node, "Running" if up else "Pending", up))
            self.slices[cluster][f"production/{jobset}/workers"] = members
            self._keys[cluster].append(f"production/{jobset}/workers")

    def _new_pod(self, cluster: str, jobset: str, w: int, node: str, phase: str, ready: bool) -> str:
        self._serial[cluster] += 1
        uid = f"{cluster}-uid-{self._serial[cluster]:06d}"
        self.pods[cluster][uid] = {"kind": "pod", "key": uid, "name": f"{jobset}-workers-0-{w}-{self._serial[cluster]}",
                                   "namespace": "production", "phase": phase, "ready": ready, "node": node,
                                   "pod_resource_version": str(self._serial[cluster])}
        return uid

    def _slice(self, cluster: str, key: str) -> dict:
        members = []
        for w, uid in enumerate(self.slices[cluster][key]):
            pod = self.pods[cluster][uid]
            members.append({"name": pod["name"], "worker_index": w, "phase": pod["phase"], "ready": pod["ready"],
                            "restarts": 0, "node": pod["node"], "node_ready": True})
        ready = sum(1 for m in members if m["ready"])
        name = key.split("/")[1]
        return {"kind": "slice", "key": key, "slice": key, "namespace": "production", "name": name,
                "chips_per_worker": 8, "total_chips": 8 * len(members), "expected_workers": None,
                "observed_workers": len(members), "ready_workers": ready,
                "phase": "Ready" if ready == len(members) else "Degraded", "workers": members}

    def objects(self, cluster: str) -> dict:
        """``{(kind, key): object}``: the cluster's current state."""
        out = {("pod", uid): dict(obj) for uid, obj in self.pods[cluster].items()}
        out.update({("slice", key): self._slice(cluster, key) for key in self.slices[cluster]})
        return out

    def initial(self, cluster: str) -> list:
        return [(kind, key, obj) for (kind, key), obj in self.objects(cluster).items()]

    def step(self, cluster: str) -> list:
        rng = self._rngs[cluster]
        key = rng.choice(self._keys[cluster])
        members = self.slices[cluster][key]
        w = rng.randrange(len(members))
        old = members[w]
        used = {self.pods[cluster][uid]["node"] for uid in members}
        free = [n for n in rng.sample(self.nodes[cluster], min(len(self.nodes[cluster]), len(used) + 8))
                if n not in used]
        node = rng.choice(free) if free else self.pods[cluster][old]["node"]
        items = []
        self.pods[cluster][old] = dict(self.pods[cluster][old], phase="Failed", ready=False)
        items += [("pod", old, dict(self.pods[cluster][old])), ("slice", key, self._slice(cluster, key))]
        del self.pods[cluster][old]
        new = self._new_pod(cluster, key.split("/")[1], w, node, "Pending", False)
        members[w] = new
        items += [("pod", old, None), ("pod", new, dict(self.pods[cluster][new])), ("slice", key, self._slice(cluster, key))]
        self.pods[cluster][new] = dict(self.pods[cluster][new], phase="Running", ready=True)
        items += [("pod", new, dict(self.pods[cluster][new])), ("slice", key, self._slice(cluster, key))]
        self.steps_taken[cluster] += 1
        return items


class UpstreamCluster:
    """One upstream of phase 12: the port's serving plane on 127.0.0.1 (a
    ``FleetView`` with a history WAL under ``directory`` and a
    bearer-authorized ``ServeServer`` on ``port``), as ``production``'s serve
    and history settings build it (``FLEET_SEGMENT_BYTES`` segments). ``stop()`` stops the server and drains
    the WAL; ``start()`` again builds a new plane on the same port and
    directory, its view restored from the WAL."""

    def __init__(self, name: str, directory: str, serve_config, history_config, port: int):
        from k8s_watcher_tpu_torch.trace import TraceRing

        self.name, self.directory = name, directory
        self.token = f"{name}-token"
        self.port = port
        self.serve_config = dataclasses.replace(serve_config, port=self.port)
        self.history_config = history_config
        self.plane = self.history = self.metrics = None
        self.ring = TraceRing(512)  # the sampled journeys, for a federator's lazy stitch
        self.lock = threading.Lock()  # held while churn is applied, and across a stop and restart

    def start(self) -> "UpstreamCluster":
        from k8s_watcher_tpu_torch.history import HistoryStore
        from k8s_watcher_tpu_torch.metrics import MetricsRegistry
        from k8s_watcher_tpu_torch.serve import ServePlane

        h = self.history_config
        self.metrics = MetricsRegistry()
        self.history = HistoryStore(self.directory, segment_max_bytes=FLEET_SEGMENT_BYTES,
                                    segment_max_age_seconds=h.segment_max_age_seconds,
                                    retain_segments=h.retain_segments, fsync=h.fsync,
                                    fsync_interval_seconds=h.fsync_interval_seconds, metrics=self.metrics)
        self.history.recover(journal_limit=self.serve_config.compact_horizon)
        self.plane = ServePlane(self.serve_config, metrics=self.metrics, auth_token=self.token,
                                history=self.history)
        self.plane.attach_trace(self.ring)
        self.plane.start()
        return self

    @property
    def view(self):
        return self.plane.view

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.plane.stop()
        self.history.close()

    def encodes(self) -> int:
        return sum(self.metrics.counter(k).value for k in (
            "serve_frame_encodes", "serve_frame_encodes_msgpack", "serve_frame_encodes_fresh",
            "serve_frame_encodes_trace"))


class Churn(threading.Thread):
    """Applies ``FederatedFleet`` churn steps to one upstream's view, one
    ``apply_batch`` a step (origin stamp: now), until ``steps`` are done.
    Every ``FED_TRACE_EVERY``-th step's replacement pod carries a sampled
    journey (a port ``Trace`` whose ``serve_fanout`` span is the upstream's
    own publish, after a ``pipeline`` span for the step's making), so
    ``?trace=1`` peers receive it; the finished journey goes to the
    upstream's ``/debug/trace`` ring."""

    def __init__(self, fleet: FederatedFleet, upstream: UpstreamCluster, steps: int, *, pace_s: float = 0.0):
        super().__init__(name=f"churn-{upstream.name}", daemon=True)
        self.fleet, self.upstream, self.steps, self.pace_s = fleet, upstream, steps, pace_s
        self.done = 0
        self.traced = []  # upstream uids of the sampled journeys
        self.failures = []

    def run(self) -> None:
        from k8s_watcher_tpu_torch.trace import Trace, new_trace_id

        try:
            for n in range(self.steps):
                with self.upstream.lock:  # held by the caller while this upstream is down
                    wall, t0 = time.time(), time.monotonic()
                    items = [(*item, wall) for item in self.fleet.step(self.upstream.name)]
                    trace = None
                    if self.fleet.steps_taken[self.upstream.name] % FED_TRACE_EVERY == 0:
                        kind, key, obj, _ = items[5]
                        trace = Trace(new_trace_id(), uid=key, name=obj["name"], namespace=obj["namespace"],
                                      event_type="MODIFIED", t0=t0)
                        # the step's making stands for the upstream's pipeline
                        trace.add_span("pipeline", t0, time.monotonic())
                        items[5] = (kind, key, obj, wall, trace)
                        self.traced.append(key)
                    t_pub = time.monotonic()
                    self.upstream.view.apply_batch(items)
                if trace is not None:
                    trace.add_span("serve_fanout", t_pub, time.monotonic())
                    trace.end, trace.outcome = time.monotonic(), "published"
                    self.upstream.ring.record(trace)
                self.done = n + 1
                if self.pace_s:
                    time.sleep(self.pace_s)
        except Exception as exc:  # noqa: BLE001 — reported by the caller, fatal
            self.failures.append(repr(exc))


def upstreams_main(args: dict) -> None:
    """The upstreams child's main (``UpstreamsChild``): builds
    ``FederatedFleet(args["seed"], **args["sizes"])`` into one
    ``UpstreamCluster`` per cluster on ``args["ports"]`` under
    ``args["dir"]``, prints one ready line, then answers one JSON line per
    JSON command on stdin: ``churn`` (start ``Churn`` threads), ``status``,
    ``stop``/``start`` (one upstream down and back: its churn waits on its
    lock meanwhile), ``step`` (churn steps applied at once), ``quit``."""
    from k8s_watcher_tpu_torch.config import load_app_config

    t0 = time.monotonic()
    fleet = FederatedFleet(args["seed"], **args["sizes"])
    shipped = load_app_config("production", os.path.join(REPO, "config"), env={})
    ups = {c: UpstreamCluster(c, os.path.join(args["dir"], c), shipped.serve, shipped.history, args["ports"][c]).start()
           for c in fleet.clusters}
    wall = time.time()
    for c, u in ups.items():
        items = fleet.initial(c)
        for i in range(0, len(items), 8192):
            u.view.apply_batch([(*item, wall) for item in items[i:i + 8192]])

    def state(u):
        return {"rv": u.view.rv, "instance": u.view.instance, "objects": len(u.view._objects), "encodes": u.encodes()}

    def say(body):
        sys.stdout.write(json.dumps(body) + "\n")
        sys.stdout.flush()

    say({"ready": True, "upstreams": {c: state(u) for c, u in ups.items()}, "build_s": time.monotonic() - t0})
    churns = {}
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["cmd"]
        u = ups.get(cmd.get("name"))
        if op == "churn":
            for c in cmd.get("names") or fleet.clusters:
                churns[c] = Churn(fleet, ups[c], cmd["steps"], pace_s=cmd["pace"])
                churns[c].start()
            say({"ok": True})
        elif op == "status":
            say({"upstreams": {c: state(v) for c, v in ups.items()},
                 "churn": {c: {"done": ch.done, "alive": ch.is_alive(), "failures": ch.failures,
                               "traced": ch.traced[-8:]} for c, ch in churns.items()}})
        elif op == "stop":
            u.lock.acquire()
            before = state(u)
            u.stop()
            say(before)
        elif op == "start":
            u.start()
            u.lock.release()
            say(state(u))
        elif op == "step":
            with u.lock:
                for _ in range(cmd["steps"]):
                    u.view.apply_batch([(*item, time.time()) for item in fleet.step(u.name)])
            say(state(u))
        elif op == "quit":
            break
    for u in ups.values():
        if u.plane.server is not None:
            u.stop()


UPSTREAMS_CHILD = "import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; " \
                  "chip_smoke.upstreams_main(json.loads(sys.argv[2]))"


class Upstream:
    """What the federator is told of one upstream."""

    def __init__(self, name: str, port: int):
        self.name, self.port = name, port
        self.token = f"{name}-token"
        self.url = f"http://127.0.0.1:{port}"


class UpstreamsChild:
    """Phase 12's upstreams in a child process, as other clusters' watchers
    are other processes: ``upstreams_main`` there, driven over its stdin.
    ``upstreams`` are the three ``Upstream`` s."""

    def __init__(self, seed: int, workdir: str, **sizes):
        self.upstreams = [Upstream(c, free_port()) for c in FED_UPSTREAMS]
        args = {"seed": seed, "sizes": sizes, "dir": workdir, "ports": {u.name: u.port for u in self.upstreams}}
        self.proc = subprocess.Popen([sys.executable, "-c", UPSTREAMS_CHILD, REPO, json.dumps(args)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.ready = self._line(300)

    def _line(self, timeout_s: float) -> dict:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.close()
            fail(f"the upstreams child gave no answer within {timeout_s} s (exit {self.proc.poll()})")
        return json.loads(line)

    def ask(self, timeout_s: float = 60.0, **cmd) -> dict:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self._line(timeout_s)

    def status(self) -> dict:
        return self.ask(cmd="status")

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
                self.proc.stdin.flush()
                self.proc.wait(30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()




def federator_overlay(upstreams, *, processes: int, trace_join: bool) -> dict:
    """Phase 12's overrides of ``production``: federation on over
    ``upstreams`` with their bearer tokens and ``processes`` merge workers,
    ``trace.federation`` as ``trace_join`` says, the health plane's freshness
    source on, and ``FLEET_SEGMENT_BYTES`` WAL segments."""
    return {
        "federation": {"enabled": True, "processes": processes,
                       "upstreams": [{"name": u.name, "url": u.url, "token": u.token} for u in upstreams]},
        "trace": {"federation": {"enabled": trace_join}},
        "health": {"sources": {"freshness": True}},
        "history": {"segment_max_bytes": FLEET_SEGMENT_BYTES},
    }


def federator_cluster(seed: int) -> GpuCluster:
    """The federator's own local cluster (its watch, leader election and
    node plane run as shipped): 128 nodes and 1,000 pods."""
    return GpuCluster(seed, nodes=128, pods=1000, jobsets=32, workers=8, churn=2000, failures=2, down_deletions=2,
                      node_flips=4)


def fleet_nodes(clusters, nodes: int) -> dict:
    """``FederatedFleet``'s node names: node ``i`` in ``clusters[i % k]``."""
    k = len(clusters)
    return {c: [f"{c}-gpu-node-{i:05d}" for i in range(n, nodes, k)] for n, c in enumerate(clusters)}


class ResumeConsumer(threading.Thread):
    """A port ``ResumeLoop`` on the federator's ``/serve/fleet``: one
    snapshot, then long-polls until ``halt``, then a drain."""

    def __init__(self, port: int, token: str):
        from k8s_watcher_tpu_torch.federate import FleetClient, ResumeLoop

        super().__init__(name="resume-consumer", daemon=True)
        self.loop = ResumeLoop(FleetClient(f"http://127.0.0.1:{port}", token=token, timeout=60.0))
        self.snapshot = self.loop.start()
        self.halt = threading.Event()
        self.failures = []

    def run(self) -> None:
        try:
            while not self.halt.is_set():
                self.loop.poll(timeout=1.0)
            self.loop.drain()
        except Exception as exc:  # noqa: BLE001 — reported by the caller, fatal
            self.failures.append(repr(exc))


def upstream_rvs(app) -> dict:
    """Each upstream's rv as the federator last applied it (in-process
    subscribers, or the merge workers' reports)."""
    fed = app.federation
    if fed.fanin is not None:
        return {name: body.get("rv") for name, body in fed.fanin.upstream_report().items()}
    return {u.name: u.subscriber.rv for u in fed.upstreams}


def merged_counts_match(app, status: dict) -> bool:
    merge = app.federation.merge
    return all(merge.cluster_object_count(name) == u["objects"] for name, u in status["upstreams"].items())


def fetch_union(app, upstreams, token: str):
    """``(federator snapshot, merged == union)`` over HTTP, each upstream's
    snapshot read with its own token."""
    from k8s_watcher_tpu_torch.federate import merged_equals_union

    snaps = {u.name: http_get(u.port, "/serve/fleet", u.token)[1]["objects"] for u in upstreams}
    status, merged = http_get(app.config.serve.port, "/serve/fleet", token)
    if status != 200:
        fail(f"the federator's /serve/fleet answered {status}")
    return merged, merged_equals_union(merged["objects"], snaps)


def federation_phase(dev, name: str, power_limit: str, seed: int, child: UpstreamsChild, nodes: list, *,
                     processes: int, churn_steps: int, pace_s: float, phase10: dict = None) -> dict:
    """Phase 12, one federator run: ``python -m k8s_watcher_tpu_torch
    production``'s ``WatcherApp`` with ``federator_overlay``'s and
    ``watcher_config``'s overrides, its local cluster ``federator_cluster``,
    federating ``child``'s three upstreams (over ``nodes``), while
    ``churn_steps`` churn steps a cluster run on all three at once
    (``pace_s`` between steps).

    With ``processes == 0`` (trace joining on): merged equals the union once
    materialized and at the end; a ``ResumeConsumer`` and ``FED_SUBSCRIBERS``
    watch streams in a child process fold the global view through the churn
    with no gap or duplicate, to the final snapshot; halfway through its
    churn the first upstream is stopped (its WAL drained), ``/healthz``
    reports ``federation.healthy`` false within ``stale_after_seconds`` plus
    5 s while liveness stays 200, the health plane's freshness source sees
    its watermark age grow, the other two keep flowing; restarted on the
    same port and directory, the federator resumes with its token (no
    resync, no snapshot) and ``/healthz`` recovers; analytics over the
    merged view on the card equals numpy and the plain reference (a summary,
    a ``SCENARIOS``-scenario what-if draining one upstream); a sampled pod's
    ``/debug/trace?uid=`` answers the joined journey and
    ``/debug/trace/diagnosis`` names a slowest stage per upstream.

    With ``processes == 2`` (trace joining off, as the schema requires):
    ``fanin_plans`` gives each worker an upstream, one worker is SIGKILLed
    mid-churn and respawns, merged equals the union at the end,
    ``/debug/processes`` lists the workers and the stop leaves none.

    Both: at least ``WATCHER_PROBE_CYCLES`` probe cycles healthy with every
    kernel launched, a stop under ``STOP_LIMIT_S``. Every check is fatal.
    Returns the run's numbers, its kernel launches under ``"launches"``."""
    import multiprocessing
    import signal

    import torch

    from k8s_watcher_tpu_torch.app import WatcherApp
    from k8s_watcher_tpu_torch.federate import fanin_plans, model_from_objects
    from k8s_watcher_tpu_torch.kernels import build
    from k8s_watcher_tpu_torch.serve import FleetView

    t_phase = time.monotonic()
    label = f"federator (processes {processes})"
    upstreams = child.upstreams
    cluster = federator_cluster(seed)
    stub = ClusterStub(cluster)
    apiserver = serve_handler(type("StubApi", (_StubHandler,), {"stub": stub}))
    receiver = serve_handler(_ReceiverHandler, lock=threading.Lock(), payloads=[], item_posts=0, batch_posts=0)
    workdir = tempfile.TemporaryDirectory()
    config = watcher_config(os.path.join(REPO, "config"), f"http://127.0.0.1:{receiver.server_address[1]}",
                            f"http://127.0.0.1:{apiserver.server_address[1]}", workdir.name, probe_interval=1.0,
                            overlay=federator_overlay(upstreams, processes=processes, trace_join=processes == 0))
    fed = config.federation
    plans = [{"worker": p.proc_index, "upstreams": list(p.owned)} for p in fanin_plans(fed)] if processes else []
    if processes and (len(plans) != processes or any(not p["upstreams"] for p in plans)):
        fail(f"fanin_plans leaves a merge worker without an upstream: {plans}")
    if not (config.history.enabled and config.analytics.enabled and config.health.enabled and config.slo.enabled
            and config.watcher.leader_election.enabled and config.tpu.node_watch_enabled):
        fail("the production settings no longer enable every plane beside federation")
    app, runner, errors = app_runner(WatcherApp(config, device=dev))
    cycles = count_cycles(app._probe_agent, build)
    m = app.metrics
    serve_port, status_port = config.serve.port, config.watcher.status_port
    build.reset_launch_counts()
    t_start = time.monotonic()
    runner.start()
    if not wait_until(lambda: errors or app.serve.server is not None and merged_counts_match(app, child.status()),
                      180, 0.5):
        fail(f"{label}: the upstreams did not materialize within 180 s: "
             f"{[(u.name, app.federation.merge.cluster_object_count(u.name)) for u in upstreams]}")
    if errors:
        fail(f"{label} raised: {errors[0]!r}")
    materialize_s = time.monotonic() - t_start
    merged, union = fetch_union(app, upstreams, STATUS_TOKEN)
    if not union:
        fail(f"{label}: merged != union once materialized")
    out = {"processes": processes, "materialize_s": materialize_s, "merged_objects": len(merged["objects"]),
           "plans": plans}
    consumer = subscribers = None
    if processes == 0:
        consumer = ResumeConsumer(serve_port, STATUS_TOKEN)
        consumer.start()
        subscribers = Subscribers(serve_port, STATUS_TOKEN, FED_SUBSCRIBERS)
        streams_rv = subscribers.ready["rv"]
    pids = [p for p in app.federation.fanin.worker_pids() if p] if processes else []
    resyncs0 = {k: m.counter(k).value for k in ("federation_resyncs", "federation_snapshots")}
    deltas0 = m.counter("federation_deltas_applied").value
    t_churn = time.monotonic()
    child.ask(cmd="churn", steps=churn_steps, pace=pace_s)
    victim = upstreams[0]

    def churned(name):
        return child.status()["churn"][name]["done"]

    if processes == 0:
        # the first upstream goes dark halfway through its churn
        if not wait_until(lambda: churned(victim.name) >= churn_steps // 2, 120, 0.1):
            fail(f"{label}: the churn did not reach its half: {churned(victim.name)}")
        t_down = time.monotonic()
        stopped = child.ask(cmd="stop", name=victim.name)
        others0 = upstream_rvs(app)
        stale_limit = fed.stale_after_seconds + 5.0
        degraded = wait_until(lambda: http_get(status_port, "/healthz")[1].get("federation", {})
                              .get("healthy") is False, stale_limit, 0.25)
        degrade_s = time.monotonic() - t_down
        healthz_down = http_get(status_port, "/healthz")
        # the health plane's freshness source: the victim's watermark age,
        # as the detector recorded it, tick by tick
        ages = []

        def age_grew():
            subject = app.health.snapshot()["subjects"].get(f"upstream/{victim.name}") or {}
            age = ((subject.get("signals") or {}).get("watermark_age_seconds") or {}).get("value")
            if age is not None and (not ages or age != ages[-1]):
                ages.append(age)
            return len(ages) >= 2 and ages[-1] > ages[0]

        grew = wait_until(age_grew, 4 * config.health.tick_seconds, 0.25)
        others1 = upstream_rvs(app)
        down_s = time.monotonic() - t_down
        # back on the same port and directory, the view restored from its WAL
        started = child.ask(cmd="start", name=victim.name)
        t_up = time.monotonic()
        restarted = (started["rv"], started["instance"]) == (stopped["rv"], stopped["instance"])
        recovered = wait_until(lambda: http_get(status_port, "/healthz")[1].get("federation", {})
                               .get("healthy") is True, 60, 0.25)
        recover_s = time.monotonic() - t_up
        resyncs1 = {k: m.counter(k).value for k in ("federation_resyncs", "federation_snapshots")}
        out["outage"] = {
            "degrade_s": degrade_s, "down_s": down_s, "recover_s": recover_s,
            "healthz_while_down": {"status": healthz_down[0], "alive": healthz_down[1].get("alive"),
                                   "federation": {k: (healthz_down[1].get("federation") or {}).get(k)
                                                  for k in ("healthy", "stale_after_seconds")}},
            "victim_watermark_ages": ages, "other_rvs_at_stop": others0, "other_rvs_at_restart": others1,
            "resyncs_before": resyncs0, "resyncs_after": resyncs1, "view_restored": restarted,
        }
        if not degraded or healthz_down[0] != 200 or healthz_down[1].get("alive") is not True:
            fail(f"{label}: /healthz did not report the dark upstream within {stale_limit} s with liveness "
                 f"200: {healthz_down}")
        if not grew:
            fail(f"{label}: the health plane's freshness source did not see {victim.name}'s watermark age grow: "
                 f"{ages}")
        if any(others1[u.name] <= others0[u.name] for u in upstreams[1:]):
            fail(f"{label}: the other upstreams stopped flowing while {victim.name} was down: {others0} -> {others1}")
        if not restarted:
            fail(f"{label}: {victim.name}'s view was not restored from its WAL")
        if not recovered or resyncs1 != resyncs0:
            fail(f"{label}: no token resume after the restart (recovered {recovered}, {resyncs0} -> {resyncs1})")
    else:
        # one merge worker SIGKILLed mid-churn
        if not wait_until(lambda: min(churned(u.name) for u in upstreams) >= churn_steps // 2, 120, 0.1):
            fail(f"{label}: the churn did not reach its half: {[churned(u.name) for u in upstreams]}")
        endpoint = app.federation.fanin.endpoints[0]
        killed = endpoint.pid
        t_kill = time.monotonic()
        os.kill(killed, signal.SIGKILL)
        if not wait_until(lambda: endpoint.respawns >= 1 and endpoint.pid not in (None, killed)
                          and (endpoint.last_hello or {}).get("pid") not in (None, killed), 60):
            fail(f"{label}: merge worker 0 did not respawn within 60 s of its SIGKILL")
        out["respawn_s"] = time.monotonic() - t_kill
        out["respawn_hello"] = dict(endpoint.last_hello)
    wait_until(lambda: not any(c["alive"] for c in child.status()["churn"].values()), 300, 0.2)
    churn_s = time.monotonic() - t_churn
    churn = child.status()
    failures = [f for c in churn["churn"].values() for f in c["failures"]]
    if failures or any(c["alive"] for c in churn["churn"].values()):
        fail(f"{label}: the churn failed: {failures or churn['churn']}")

    def caught_up():
        rvs = upstream_rvs(app)
        return merged_counts_match(app, churn) and all(rvs.get(n) == u["rv"] for n, u in churn["upstreams"].items())

    if not wait_until(lambda: errors or caught_up(), 120, 0.2):
        fail(f"{label}: the merged view did not catch up with the upstreams: {upstream_rvs(app)} vs "
             f"{ {n: u['rv'] for n, u in churn['upstreams'].items()} }")
    converged_s = time.monotonic() - t_churn
    merged, union = fetch_union(app, upstreams, STATUS_TOKEN)
    if not union:
        fail(f"{label}: merged != union after the churn")
    merged_deltas = m.counter("federation_deltas_applied").value - deltas0
    out.update(churn_s=churn_s, converged_s=converged_s, merged_deltas=merged_deltas,
               merged_deltas_per_s=merged_deltas / converged_s,
               churn_steps=churn_steps, pace_s=pace_s, final_rv=merged["rv"],
               watch_to_global_view=m.histogram("watch_to_global_view_seconds").summary(),
               serve_wire=m.histogram("serve_wire_seconds").summary(),
               health_tick=m.histogram("health_tick_seconds").summary(),
               counters={k: m.counter(k).value for k in (
                   "federation_resyncs", "federation_snapshots", "federation_reconnects",
                   "federation_heartbeat_stalls", "federation_batches_applied", "federation_stale_transitions",
                   "fanin_passthrough_frames", "fanin_worker_respawns", "fanin_wire_gaps")})
    for summary in (out["watch_to_global_view"], out["serve_wire"], out["health_tick"]):
        summary.pop("buckets_le_s", None)
    model = model_from_objects(merged["objects"])
    if processes == 0:
        consumer.halt.set()
        consumer.join(120)
        streams = subscribers.finish(merged["rv"])
        loop = consumer.loop
        tail = app.serve.view.read_since(merged["rv"], max_deltas=1 << 30)
        reached = [loop.rv] + [s["at"][0] for s in streams["streams"] if s["at"]]
        if tail.status != "ok" or tail.compacted or min(reached) < merged["rv"]:
            fail(f"{label}: the journal after rv {merged['rv']}: {tail.status}, compacted {tail.compacted}; "
                 f"consumers reached {sorted(set(reached))}")
        # the view keeps moving after the churn (the probe's reports fold
        # into it), so each consumer is held to the state at the rv it reached
        states = states_at(tail.deltas, reached, base=model)
        digests = {rv: model_digest(state) for rv, state in states.items()}
        out["resume_consumer"] = {"polls": loop.polls, "resyncs": loop.resyncs, "rv": loop.rv,
                                  "gaps": loop.checker.gaps, "dups": loop.checker.dups,
                                  "delivered": loop.checker.delivered}
        out["streams"] = {"n": len(streams["streams"]),
                          "deltas": sum(s["deltas"] for s in streams["streams"]),
                          "gaps": sum(s["gaps"] for s in streams["streams"]),
                          "dups": sum(s["dups"] for s in streams["streams"]),
                          "compacted": sum(s["compacted"] for s in streams["streams"]),
                          "gone": sum(s["gone"] for s in streams["streams"])}
        if consumer.failures or consumer.is_alive() or loop.resyncs or not loop.checker.clean \
                or loop.model != states[loop.rv]:
            fail(f"{label}: the resume consumer: {out['resume_consumer']} {consumer.failures}")
        bad = [s for s in streams["streams"] if not s["at"] or s["at"][1] != digests[s["at"][0]] or s["gaps"]
               or s["dups"] or s["gone"] or s["status"] != 200]
        if bad:
            fail(f"{label}: {len(bad)} of {FED_SUBSCRIBERS} watch streams did not fold to the final snapshot "
                 f"gaplessly (streams from rv {streams_rv}, the view at rv {merged['rv']} with oldest_rv "
                 f"{app.serve.view.oldest_rv}, {out['streams']}): {bad[:3]}")
        # analytics over the merged view: the card, numpy and the plain
        # reference, on the final snapshot's objects (the live view moves on
        # with every probe report), then the app's own plane over HTTP
        raw = draw_scenarios(random.Random(seed + 12), nodes, drain=upstreams[1].name)
        frozen = FleetView()
        frozen.apply_batch([(kind, key, obj) for (kind, key), obj in model.items()])
        timings = analytics_timings(torch, frozen, raw, config.analytics, dev, reference_calls=1)
        status, body = http_get(serve_port, "/serve/analytics?scenarios=" + urllib.parse.quote(json.dumps(raw)),
                                STATUS_TOKEN)
        want_body = numpy_plane(model, config.analytics).evaluate(raw)
        if status != 200 or body.get("backend") != "torch" or comparable(body) != comparable(want_body):
            fail(f"{label}: /serve/analytics on the card differs from the numpy backend ({status})")
        drained = next(s for s in body["scenarios"] if s["scenario"].get("kind") == "drain_cluster")
        out["analytics"] = {**timings, "phase10": phase10,
                            "drain_slices_losing_quorum": len(drained.get("slices_losing_quorum") or ())}
        # the joined journey of a sampled pod, and the per-upstream diagnosis
        traced = churn["churn"][upstreams[2].name]["traced"]
        uid = traced[-1] if traced else None
        trace = http_get(status_port, f"/debug/trace?uid={urllib.parse.quote(uid or '')}", STATUS_TOKEN)
        diagnosis = http_get(status_port, "/debug/trace/diagnosis", STATUS_TOKEN)
        joined = [t for t in (trace[1].get("traces") or []) if t.get("cluster") == upstreams[2].name]
        stages = [s["stage"] for s in joined[0]["spans"]] if joined else []
        tail = [s for s in stages if s in ("serve_wire", "federate_merge", "global_serve")]
        slowest = {u: d.get("slowest_stage") for u, d in (diagnosis[1].get("diagnosis") or {})
                   .get("upstreams", {}).items()}
        out["trace"] = {"uid": uid, "stages": stages, "stitched": len(trace[1].get("stitched") or []),
                        "slowest_stage": slowest,
                        "joined_traces": (diagnosis[1].get("diagnosis") or {}).get("joined_traces")}
        if trace[0] != 200 or tail != ["serve_wire", "federate_merge", "global_serve"] or stages[0] != "pipeline":
            fail(f"{label}: /debug/trace?uid={uid} did not answer the joined journey: {trace}")
        if diagnosis[0] != 200 or sorted(slowest) != sorted(u.name for u in upstreams) or not all(slowest.values()):
            fail(f"{label}: /debug/trace/diagnosis: {diagnosis}")
    else:
        processes_route = http_get(status_port, "/debug/processes", STATUS_TOKEN)
        rows = (processes_route[1].get("processes") or {}).get("workers", []) if processes_route[0] == 200 else []
        out["processes_route"] = [{k: r.get(k) for k in ("process", "pid", "respawns", "wire_gaps")} for r in rows]
        if len(rows) != processes or sorted(r["respawns"] for r in rows) != [0, 1] or any(
                r["wire_gaps"] for r in rows):
            fail(f"{label}: /debug/processes: {processes_route}")
        pids += [p for p in app.federation.fanin.worker_pids() if p]
    if not wait_until(lambda: sum(1 for c in cycles if c["end"] > t_churn) >= WATCHER_PROBE_CYCLES, 60):
        fail(f"{label}: {sum(1 for c in cycles if c['end'] > t_churn)} probe cycles ran during and after the churn")
    healthz = http_get(status_port, "/healthz")
    t_stop = time.monotonic()
    app.stop()
    runner.join(60)
    stop_s = time.monotonic() - t_stop
    launches = build.launch_counts()
    alive_after = [p for p in pids if os.path.exists(f"/proc/{p}")] + [c.pid for c in multiprocessing.active_children()]
    stub.closing.set()
    for server in (apiserver, receiver):
        server.shutdown()
        server.server_close()
    workdir.cleanup()
    out.update(healthz={"status": healthz[0], "alive": healthz[1].get("alive"),
                        "federation_healthy": (healthz[1].get("federation") or {}).get("healthy")},
               probe_cycles=[{k: c[k] for k in ("healthy", "duration_ms", "launches")} for c in cycles],
               stop_s=stop_s, launches=launches, phase_s=time.monotonic() - t_phase, device=name, power_limit=power_limit)
    print(f"{label}: " + json.dumps(out))
    if runner.is_alive() or stop_s > STOP_LIMIT_S or alive_after:
        fail(f"{label} did not stop cleanly: {stop_s:.2f} s, processes left {alive_after}")
    if errors:
        fail(f"{label} raised: {errors[0]!r}")
    if healthz[0] != 200 or healthz[1].get("alive") is not True or not (healthz[1].get("federation") or {}).get(
            "healthy"):
        fail(f"{label}: /healthz at the end: {healthz}")
    for n, cycle in enumerate(cycles):
        want = {"read_sweep": 5, "fill": 5, "blocksums": 1}
        if not cycle["healthy"] or cycle["launches"] != want:
            fail(f"{label} probe cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']} (want {want})")
    return out


def relay_phase(dev, name: str, power_limit: str, seed: int, child: UpstreamsChild, root: Upstream, *,
                churn_steps: int, pace_s: float) -> dict:
    """Phase 13: ``python -m k8s_watcher_tpu_torch production``'s
    ``WatcherApp`` with ``relay.enabled`` (serve only: history, federation,
    analytics, health and SLO off) and ``relay.upstream`` one of phase 12's
    upstreams (``root``), beside its own small cluster and the probe.
    ``RELAY_SUBSCRIBERS`` watch streams on the relay (a child process) fold
    through ``churn_steps`` churn steps on the root to the root's
    ``/serve/fleet``; the relay encodes no frame (its encode counters stay 0)
    while the root's rise; a token minted at the root resumes at the relay
    and one minted at the relay resumes at the root; ``/debug/relay``
    reports depth 1; a relay restarted with ``backfill`` resumes a token
    minted before its stop with deltas; the probe runs healthy with every
    kernel launched; each stop takes under ``STOP_LIMIT_S``. Every check is
    fatal. Returns the numbers, the kernel launches under ``"launches"``."""
    from k8s_watcher_tpu_torch.app import WatcherApp
    from k8s_watcher_tpu_torch.federate import FleetClient, ResyncRequired, model_from_objects
    from k8s_watcher_tpu_torch.kernels import build

    t_phase = time.monotonic()
    cluster = federator_cluster(seed + 13)
    stub = ClusterStub(cluster)
    apiserver = serve_handler(type("StubApi", (_StubHandler,), {"stub": stub}))
    receiver = serve_handler(_ReceiverHandler, lock=threading.Lock(), payloads=[], item_posts=0, batch_posts=0)
    workdir = tempfile.TemporaryDirectory()
    overlay = {"relay": {"enabled": True, "upstream": {"name": root.name, "url": root.url, "token": root.token}},
               **{plane: {"enabled": False} for plane in ("history", "analytics", "health", "slo")}}
    config = watcher_config(os.path.join(REPO, "config"), f"http://127.0.0.1:{receiver.server_address[1]}",
                            f"http://127.0.0.1:{apiserver.server_address[1]}", workdir.name, probe_interval=1.0,
                            overlay=overlay)
    serve_port, status_port = config.serve.port, config.watcher.status_port
    relay_url = f"http://127.0.0.1:{serve_port}"

    def start():
        app, runner, errors = app_runner(WatcherApp(config, device=dev))
        cycles = count_cycles(app._probe_agent, build)
        runner.start()
        if not wait_until(lambda: errors or app.serve.server is not None and app.relay.health().get("synced"), 60):
            fail(f"the relay did not sync with {root.name} within 60 s: {errors or app.relay.health()}")
        return app, runner, errors, cycles

    def stop(app, runner):
        t0 = time.monotonic()
        app.stop()
        runner.join(60)
        if runner.is_alive():
            fail("the relay did not stop")
        return time.monotonic() - t0

    build.reset_launch_counts()
    app, runner, errors, cycles = start()
    encodes0 = child.status()["upstreams"][root.name]["encodes"]
    # the streams ride the frame shape the relay's own upstream wire carries
    # (production's relay: codec auto, fresh on), so it encodes nothing
    subscribers = Subscribers(serve_port, STATUS_TOKEN, RELAY_SUBSCRIBERS, wire="msgpack")
    t_churn = time.monotonic()
    child.ask(cmd="churn", names=[root.name], steps=churn_steps, pace=pace_s)
    wait_until(lambda: not child.status()["churn"][root.name]["alive"], 300, 0.2)
    churn = child.status()
    if churn["churn"][root.name]["failures"] or churn["churn"][root.name]["alive"]:
        fail(f"the relay's root churn failed: {churn['churn'][root.name]}")
    root_rv = churn["upstreams"][root.name]["rv"]
    if not wait_until(lambda: app.serve.view.rv == root_rv, 60):
        fail(f"the relay did not catch up with its root: {app.serve.view.rv} vs {root_rv}")
    churn_s = time.monotonic() - t_churn
    status, snap = http_get(root.port, "/serve/fleet", root.token)
    model = model_from_objects(snap["objects"])
    streams = subscribers.finish(snap["rv"])
    relay_snap = http_get(serve_port, "/serve/fleet", STATUS_TOKEN)[1]
    relay_encodes = app.relay.frame_encodes()
    root_encodes = child.status()["upstreams"][root.name]["encodes"] - encodes0
    debug_relay = http_get(status_port, "/debug/relay", STATUS_TOKEN)
    serve_health = http_get(serve_port, "/serve/healthz")
    # resume tokens cross the tier both ways
    root_client = FleetClient(root.url, token=root.token, timeout=30.0)
    relay_client = FleetClient(relay_url, token=STATUS_TOKEN, timeout=30.0)
    tokens = {}
    for minted_at, reader in (("root", relay_client), ("relay", root_client)):
        minter = root_client if minted_at == "root" else relay_client
        start_snap = minter.snapshot()
        child.ask(cmd="step", name=root.name, steps=1)
        try:
            batch = reader.long_poll(start_snap.rv, view=start_snap.view, timeout=5.0)
            tokens[minted_at] = {"rv": start_snap.rv, "to_rv": batch.to_rv, "items": len(batch.items),
                                 "compacted": batch.compacted}
        except ResyncRequired as exc:
            tokens[minted_at] = {"rv": start_snap.rv, "error": str(exc)}
    if not wait_until(lambda: sum(1 for c in cycles if c["end"] > t_churn) >= WATCHER_PROBE_CYCLES, 60):
        fail(f"the relay: {sum(1 for c in cycles if c['end'] > t_churn)} probe cycles ran beside it")
    relay_health = app.relay.health()
    # a restart with backfill resumes a token minted before the stop
    pre_stop = relay_client.snapshot()
    stop_s = stop(app, runner)
    child.ask(cmd="step", name=root.name, steps=4)
    app2, runner2, errors2, cycles2 = start()
    try:
        resumed = relay_client.long_poll(pre_stop.rv, view=pre_stop.view, timeout=5.0)
        backfill = {"rv": pre_stop.rv, "to_rv": resumed.to_rv, "items": len(resumed.items),
                    "compacted": resumed.compacted, "relay_oldest_rv": app2.serve.view.oldest_rv}
    except ResyncRequired as exc:
        backfill = {"rv": pre_stop.rv, "error": str(exc)}
    stop2_s = stop(app2, runner2)
    launches = build.launch_counts()
    stub.closing.set()
    for server in (apiserver, receiver):
        server.shutdown()
        server.server_close()
    workdir.cleanup()
    out = {
        "root": root.name, "subscribers": len(streams["streams"]), "churn_steps": churn_steps, "churn_s": churn_s,
        "root_rv": snap["rv"],
        "streams": {"deltas": sum(s["deltas"] for s in streams["streams"]),
                    "gaps": sum(s["gaps"] for s in streams["streams"]),
                    "dups": sum(s["dups"] for s in streams["streams"]),
                    "gone": sum(s["gone"] for s in streams["streams"])},
        "relay_frame_encodes": relay_encodes, "root_frame_encodes": root_encodes,
        "relay_health": relay_health, "debug_relay": debug_relay[0], "tokens": tokens, "backfill": backfill,
        "probe_cycles": [{k: c[k] for k in ("healthy", "duration_ms", "launches")} for c in cycles + cycles2],
        "stop_s": [stop_s, stop2_s], "launches": launches, "phase_s": time.monotonic() - t_phase,
        "device": name, "power_limit": power_limit,
    }
    for key in ("relay_hop_seconds", "watch_to_relay_seconds"):
        summary = app.metrics.histogram(key).summary()
        summary.pop("buckets_le_s", None)
        out[key] = summary
    print("relay: " + json.dumps(out))
    if errors or errors2:
        fail(f"the relay raised: {(errors or errors2)[0]!r}")
    if max(stop_s, stop2_s) > STOP_LIMIT_S:
        fail(f"the relay's stops took {stop_s:.2f} s and {stop2_s:.2f} s")
    want = [snap["rv"], model_digest(model)]
    bad = [s for s in streams["streams"] if s["at"] != want or s["gaps"] or s["dups"] or s["gone"]
           or s["status"] != 200]
    if bad:
        fail(f"{len(bad)} of {RELAY_SUBSCRIBERS} relay streams did not fold to the root's snapshot: {bad[:3]}")
    if relay_snap.get("view") != snap["view"] or model_from_objects(relay_snap["objects"]) != model:
        fail("the relay's /serve/fleet differs from the root's")
    if relay_encodes != 0 or root_encodes <= 0:
        fail(f"frame encodes: relay {relay_encodes} (want 0), root {root_encodes} (want > 0)")
    depth = ((debug_relay[1] or {}).get("relay") or {}).get("depth")
    if debug_relay[0] != 200 or depth != 1 or (serve_health[1].get("relay") or {}).get("depth") != 1:
        fail(f"/debug/relay: {debug_relay}, /serve/healthz: {serve_health}")
    if any("error" in t or t["items"] < 1 or t["compacted"] for t in tokens.values()):
        fail(f"resume tokens across the relay: {tokens}")
    if "error" in backfill or backfill["items"] < 1:
        fail(f"the restarted relay did not resume a pre-stop token with deltas: {backfill}")
    # the restarted relay's cycles count launches from the phase's start, so
    # only the first app's are held to the per-cycle launch counts
    for n, cycle in enumerate(cycles):
        want_launches = {"read_sweep": 5, "fill": 5, "blocksums": 1}
        if not cycle["healthy"] or cycle["launches"] != want_launches:
            fail(f"relay probe cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']}")
    if not all(c["healthy"] for c in cycles2):
        fail(f"the restarted relay's probe cycles: {cycles2}")
    return out


def federation_phases(dev, name: str, power_limit: str, seed: int, phase10: dict, *, jobsets: int = 16384,
                      workers: int = 8, nodes: int = 16384, churn_steps=(1200, 600, 300),
                      paces=(0.025, 0.003, 0.01)) -> dict:
    """Phases 12 and 13 on one set of upstreams: ``FederatedFleet(seed)``
    (``jobsets`` JobSets of ``workers`` workers over ``nodes`` nodes, phase
    10's global size) in three ``UpstreamCluster`` s in an
    ``UpstreamsChild`` process, as ``production``'s serve and history
    settings build them; then ``federation_phase`` in process (trace joining
    on), ``federation_phase`` sharded over two merge workers, and
    ``relay_phase`` against the third upstream, with ``churn_steps`` and
    ``paces`` in that order. Returns each run's kernel launches."""
    workdir = tempfile.TemporaryDirectory()
    child = UpstreamsChild(seed, workdir.name, jobsets=jobsets, workers=workers, nodes=nodes)
    try:
        print("federation upstreams: " + json.dumps({
            "seed": seed, "clusters": [u.name for u in child.upstreams], "jobsets": jobsets,
            "workers": jobsets * workers, "nodes": nodes, "upstreams": child.ready["upstreams"],
            "build_s": child.ready["build_s"],
        }))
        names = [node for cluster in fleet_nodes(FED_UPSTREAMS, nodes).values() for node in cluster]
        runs = {}
        for label, processes, steps, pace in (("federator", 0, churn_steps[0], paces[0]),
                                              ("sharded federator", 2, churn_steps[1], paces[1])):
            runs[label] = federation_phase(dev, name, power_limit, seed, child, names,
                                           processes=processes, churn_steps=steps, pace_s=pace,
                                           phase10=phase10)["launches"]
        runs["relay"] = relay_phase(dev, name, power_limit, seed, child, child.upstreams[2],
                                    churn_steps=churn_steps[2], pace_s=paces[2])["launches"]
    finally:
        child.close()
        workdir.cleanup()
    return runs


# -- phase 14: the graft entry and the DaemonSet's command ------------------------

ENTRY_CALLS = 20


def graft_phase(torch, name: str, power_limit: str) -> None:
    """``entry()``'s step on the card against the CPU's f32 product of the
    same bf16 inputs; prints its median time over ``ENTRY_CALLS`` calls and
    the CUDA kernels one call launched."""
    from k8s_watcher_tpu_torch import graft

    step, (a, b) = graft.entry()
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 or tuple(a.shape) != graft.ENTRY_SHAPE:
        fail(f"entry() gave {a.dtype} {tuple(a.shape)} on {a.device}, not bf16 {graft.ENTRY_SHAPE} on the card")
    out = graft.gemm_f32(a, b)
    checksum = float(step(a, b))
    want = torch.mm(a.cpu().float(), b.cpu().float())
    out_err = (out.cpu() - want).abs().max().item()
    sum_err = abs(checksum - float(want.sum()))
    if out.dtype != torch.float32 or out_err > 1e-4 * want.abs().max().item():
        fail(f"entry()'s product ({out.dtype}) is {out_err} from the CPU's f32 product")
    if sum_err > 1e-5 * want.abs().sum().item():
        fail(f"entry()'s checksum {checksum} is {sum_err} from the CPU's {float(want.sum())}")
    poisoned = a.clone()
    poisoned[7, 11] = float("inf")
    if not torch.isnan(step(poisoned, b)).item():
        fail("entry()'s step gave a number for an inf input")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(a, b)
        torch.cuda.synchronize()
    kernels = sorted({e.key[:60] for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA})
    times = []
    for _ in range(ENTRY_CALLS + 3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(a, b)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times = times[3:]
    print("graft entry: " + json.dumps({
        "step_ms_median": statistics.median(times), "step_ms": times, "max_abs_err": out_err,
        "checksum": checksum, "checksum_err": sum_err, "cuda_kernels": kernels or "not measured",
        "device": name, "power_limit": power_limit,
    }))


def daemonset_phase(name: str, power_limit: str) -> None:
    """The DaemonSet manifest's container command with ``--once``, as a
    subprocess: ``production`` as shipped on the card. ``torchrun`` is run
    as ``python -m torch.distributed.run``, the same program."""
    import yaml

    with open(os.path.join(REPO, "deploy", "gpu-probe-daemonset.yaml")) as fh:
        (daemonset,) = [d for d in yaml.safe_load_all(fh) if d["kind"] == "DaemonSet"]
    (container,) = daemonset["spec"]["template"]["spec"]["containers"]
    command = container["command"]
    if command[0] != "torchrun" or command[-3:] != ["-m", "k8s_watcher_tpu_torch.probe_agent", "production"]:
        fail(f"the DaemonSet runs {command}")
    counts = tempfile.TemporaryDirectory()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(PROD_CLUSTERAPI_API_KEY=API_KEY, NODE_NAME=NODE_NAME, PYTHONPATH=REPO,
               K8S_WATCHER_TPU_LAUNCH_COUNTS=os.path.join(counts.name, "launches"))
    argv = [sys.executable, "-m", "torch.distributed.run", *command[1:], "--once"]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("the DaemonSet's command did not finish in 600 s")
    wall_s = time.monotonic() - t0
    if proc.returncode != 0:
        fail(f"the DaemonSet's command exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    payload = json.loads(proc.stdout[proc.stdout.index("{"):])
    with open(os.path.join(counts.name, "launches.0")) as fh:
        launches = json.load(fh)
    counts.cleanup()
    hbm, hbm_w = payload.get("hbm") or {}, payload.get("hbm_write") or {}
    print("daemonset command: " + json.dumps({
        "argv": command + ["--once"], "wall_s": wall_s, "healthy": payload["healthy"],
        "duration_ms": payload["duration_ms"], "launches": launches,
        "hbm_read_gbps": hbm.get("read_gbps"), "hbm_write_gbps": hbm_w.get("write_gbps"),
        "mxu_tflops_median": (payload.get("mxu") or {}).get("tflops_median"),
        "device": name, "power_limit": power_limit,
    }))
    if not payload["healthy"] or payload["devices"]["devices"][0]["platform"] != "cuda":
        fail(f"the DaemonSet's payload: healthy={payload['healthy']}, devices {payload['devices']}")
    for probe in (hbm, hbm_w):
        if probe.get("interpreted") or not probe.get("ok") or probe.get("integrity_ok") is not True:
            fail(f"the DaemonSet's HBM probe did not run on the card with integrity: {probe}")
    sizes = (hbm.get("bytes"), hbm.get("repeats"), payload["mxu"].get("size"), payload["ici"]["payload_bytes"])
    if sizes != (256 * MIB, 128, 1024, 4 * MIB):
        fail(f"the DaemonSet did not run production's sizes (hbm bytes, passes, GEMM, all-reduce): {sizes}")
    if min(launches.values()) <= 0:
        fail(f"the DaemonSet's run launched {launches}")


def dryrun_phase() -> None:
    """``dryrun_multichip(128)`` on this host's CPUs; its wall time and the
    host memory it took at the peak (``MemAvailable`` sampled every 0.2 s)."""
    from k8s_watcher_tpu_torch.graft import dryrun_multichip

    def available() -> int:
        with open("/proc/meminfo") as fh:
            return next(int(line.split()[1]) * 1024 for line in fh if line.startswith("MemAvailable:"))

    base = available()
    low = [base]
    done = threading.Event()

    def sample():
        while not done.wait(0.2):
            low[0] = min(low[0], available())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.monotonic()
    try:
        result = dryrun_multichip(128)
    except RuntimeError as exc:
        fail(f"dryrun_multichip(128) failed: {exc}")
    finally:
        done.set()
        sampler.join()
    print("graft dryrun: " + json.dumps({
        "wall_s": time.monotonic() - t0, "peak_host_bytes": base - low[0], "host_cpus": os.cpu_count(), **result}))
    if (result["hosts"], result["chips"], result["links"], result["dcn_pairs"]) != (8, 16, 256, 6):
        fail(f"dryrun_multichip(128) gave {result}")


# -- phase 15: the remediation loop --------------------------------------------

DRILL_RANKS = 8
REMEDIATION_NODE_INDEX = 42
CORRUPT_BLOCK = 137


def remediation_drill_phase() -> None:
    """15a: ``python -m k8s_watcher_tpu_torch.chaos_remediate --cpu-ranks 8``
    as a child on this host's CPUs: exit 0 with all eight stages passing."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO
    argv = [sys.executable, "-m", "k8s_watcher_tpu_torch.chaos_remediate", "--cpu-ranks", str(DRILL_RANKS)]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("the remediation drill did not finish in 600 s")
    wall_s = time.monotonic() - t0
    out = proc.stdout
    start = out.find("{\n")
    result = json.loads(out[start:out.rindex("}") + 1]) if start >= 0 else {}
    print("remediation drill: " + json.dumps({
        "argv": argv[1:], "rc": proc.returncode, "wall_s": wall_s, "host_cpus": os.cpu_count(),
        "suspect_devices": (result.get("links_cycle1") or {}).get("suspect_devices"),
        "actions": [(a["node"], a["applied"]) for a in result.get("actions") or []],
        "node_after": result.get("node_after"), "released": result.get("released"),
        "dcn_suspect_slices": (result.get("dcn_cycle1") or {}).get("dcn_suspect_slices"),
        "dcn_decisions": [(a["node"], a["dry_run"]) for a in result.get("dcn_actions") or []],
        "sink_payloads": [result.get("sink_remediation_payloads"), result.get("sink_dcn_payloads")],
        "failures": result.get("failures"),
    }))
    if proc.returncode != 0 or result.get("failures") != [] or "remediation drill: PASS" not in out:
        fail(f"the remediation drill exited {proc.returncode}:\n{out[-3000:]}\n{proc.stderr[-2000:]}")


def remediation_phase(dev, name: str, power_limit: str, *, nodes: int = 2048, block: int = CORRUPT_BLOCK,
                      hbm_bytes: int = 256 * MIB) -> None:
    """15b: the policy on the card against the port's mock apiserver. It
    holds phase 9's GPU nodes; the probe's node is one of them. Production's
    ``tpu.remediation`` with ``dry_run`` false and cooldown 0; each cycle's
    report carries the write probe at ``hbm_bytes`` with one element of block
    ``block`` changed. The node must be PATCHed only by the confirming cycle,
    the operator CLI must list it and release it, and a clean cycle must act
    on nothing."""
    import torch
    import yaml

    from k8s_watcher_tpu_torch.config import load_config
    from k8s_watcher_tpu_torch.drill_common import start_sink
    from k8s_watcher_tpu_torch.k8s.client import K8sClient
    from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
    from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer, MockCluster
    from k8s_watcher_tpu_torch.kernels import build
    from k8s_watcher_tpu_torch.kernels import hbm as K
    from k8s_watcher_tpu_torch.notify.client import ClusterApiClient
    from k8s_watcher_tpu_torch.notify.dispatcher import Dispatcher
    from k8s_watcher_tpu_torch.probe.device import enumerate_devices, host_identity_map
    from k8s_watcher_tpu_torch.probe.hbm import run_hbm_write_probe
    from k8s_watcher_tpu_torch.probe.report import ProbeReport
    from k8s_watcher_tpu_torch.remediate import build_actuator, build_policy
    from k8s_watcher_tpu_torch.remediate.policy import local_findings

    node = f"gpu-node-{REMEDIATION_NODE_INDEX:04d}"
    shipped = load_config("production", os.path.join(REPO, "config"))
    if not (shipped.remediation_enabled and shipped.remediation_dry_run):
        fail("the production settings no longer arm dry-run remediation")
    tpu = dataclasses.replace(shipped, remediation_dry_run=False, remediation_cooldown_seconds=0.0)
    cuts = {"remediation_dry_run": [shipped.remediation_dry_run, False],
            "remediation_cooldown_seconds": [shipped.remediation_cooldown_seconds, 0.0]}
    print("remediation settings: " + json.dumps({
        "environment": "production", "cuts": cuts, "confirm_cycles": tpu.remediation_confirm_cycles,
        "taint": [tpu.remediation_taint_key, tpu.remediation_taint_value, tpu.remediation_taint_effect],
        "cordon": tpu.remediation_cordon, "max_actions_per_hour": tpu.remediation_max_actions_per_hour,
        "max_quarantined_nodes": tpu.remediation_max_quarantined_nodes, "nodes": nodes, "node": node,
        "hbm_bytes": hbm_bytes, "corrupt_block": block,
    }))

    cluster = MockCluster()
    for i in range(nodes):
        cluster.add_node(GpuCluster.node(f"gpu-node-{i:04d}", True, i + 1))
    patches = []
    patch_node = cluster.patch_node

    def recording_patch(patched, body):
        patches.append((time.monotonic(), patched, body))
        return patch_node(patched, body)

    cluster.patch_node = recording_patch
    received, received_lock = [], threading.Lock()

    def on_payload(body, _now):
        with received_lock:
            received.append(body)

    sink = start_sink(on_payload)
    old_node_name = os.environ.get("NODE_NAME")
    os.environ["NODE_NAME"] = node
    workdir = tempfile.TemporaryDirectory()
    try:
        with MockApiServer(cluster) as api:
            client = K8sClient(K8sConnection(server=api.url), request_timeout=10.0)
            dispatcher = Dispatcher(ClusterApiClient(f"http://127.0.0.1:{sink.server_address[1]}", API_KEY,
                                                     10.0).update_pod_status, capacity=64, workers=1)
            dispatcher.start()
            actuator = build_actuator(client, tpu)
            policy = build_policy(actuator, tpu, dispatcher=dispatcher, environment="production")
            devices = enumerate_devices(dev, expected_platform=dev.type)
            hosts = host_identity_map(dev)
            seen = {}

            def corrupt(y):
                # one element of block ``block``; kept to hold the kernel's
                # verdict against the plain block sums
                y.view(-1, K.WRITE_BLOCK_ELEMS)[block, 4099] += 1e6
                seen["buffer"] = y
                return y

            cycles = []

            def cycle(hook):
                t0 = time.monotonic()
                probe = run_hbm_write_probe(hbm_bytes, device=dev, corrupt_hook=hook)
                report = ProbeReport(environment="production", devices=devices, hbm_write=probe, hosts=hosts)
                t_report = time.monotonic()
                actions = policy.observe_report(report)
                cycles.append({"ms": 1e3 * (time.monotonic() - t0), "write_gbps": probe.get("write_gbps"),
                               "bad_blocks": probe.get("bad_blocks"), "actions": [a.to_dict() for a in actions]})
                return probe, report, actions, t_report

            build.reset_launch_counts()
            confirm = tpu.remediation_confirm_cycles
            findings, t_confirmed = [], None
            for n in range(1, confirm + 1):
                probe, report, actions, t_report = cycle(corrupt)
                if probe.get("ok") is not False or probe.get("error"):
                    fail(f"cycle {n}: the write probe missed the corruption: {probe}")
                want = [{"block": block, "byte_offset": block << 19}]
                got = [{k: b[k] for k in ("block", "byte_offset")} for b in probe["bad_blocks"]]
                if got != want or K.WRITE_BYTES_PER_BLOCK != 1 << 19:
                    fail(f"cycle {n}: bad_blocks {got}, not {want}")
                plain = K.blocksums_plain(seen.pop("buffer")).double().view(-1).cpu()
                expected = torch.arange(1, plain.numel() + 1, dtype=torch.float64) * K.WRITE_BLOCK_ELEMS
                plain_bad = ((plain - expected).abs() > 1e-5 * expected).nonzero().view(-1).tolist()
                if plain_bad != [block]:
                    fail(f"cycle {n}: the plain block sums name {plain_bad}, the kernel {block}")
                findings = local_findings(report)
                if n < confirm and (actions or patches):
                    fail(f"cycle {n} of {confirm} acted: {[a.to_dict() for a in actions]}, {len(patches)} PATCHes")
                if n == confirm:
                    t_confirmed = t_report
            launches = build.launch_counts()
            applied = [a for a in actions if a.ok and a.applied]
            if len(applied) != 1 or applied[0].node != node:
                fail(f"the confirming cycle did not quarantine {node}: {[a.to_dict() for a in actions]}")
            if [patched for _, patched, _ in patches] != [node]:
                fail(f"PATCHes: {[(patched, body) for _, patched, body in patches]}, not one for {node}")
            patch_ms = 1e3 * (patches[0][0] - t_confirmed)
            spec = cluster.get_node(node)["spec"]
            taint = {"key": tpu.remediation_taint_key, "value": tpu.remediation_taint_value,
                     "effect": tpu.remediation_taint_effect}
            if spec.get("unschedulable") is not True or [
                    {k: t.get(k) for k in ("key", "value", "effect")} for t in spec.get("taints") or []] != [taint]:
                fail(f"{node} after the confirming cycle: {spec}")
            if min(launches.get("fill", 0), launches.get("blocksums", 0)) <= 0:
                fail(f"the remediation cycles launched {launches}")
            dispatcher.drain(10.0)
            with received_lock:
                payloads = [p for p in received if p.get("event_type") == "TPU_REMEDIATION"]
            acted = [p for p in payloads if p.get("actions")]
            if len(acted) != 1 or acted[0]["implicated"] != {node: findings} or findings != [
                    "hbm write probe: 1 HBM block(s) failed pattern readback"]:
                fail(f"TPU_REMEDIATION payloads with actions: {acted}; local findings {findings}")
            if any(set(p["implicated"]) != {node} for p in payloads):
                fail(f"a payload implicated another node: {[p['implicated'] for p in payloads]}")

            # the operator CLI, from a config directory pointed at the mock
            config_dir = os.path.join(workdir.name, "config")
            os.makedirs(config_dir)
            kubeconfig = os.path.join(workdir.name, "kubeconfig")
            with open(kubeconfig, "w") as fh:
                json.dump({
                    "apiVersion": "v1", "kind": "Config", "current-context": "mock",
                    "clusters": [{"name": "mock", "cluster": {"server": api.url}}],
                    "contexts": [{"name": "mock", "context": {"cluster": "mock", "user": "mock"}}],
                    "users": [{"name": "mock", "user": {"token": "mock-token"}}],
                }, fh)
            with open(os.path.join(REPO, "config", "base.yaml")) as src, \
                    open(os.path.join(config_dir, "base.yaml"), "w") as dst:
                dst.write(src.read())
            with open(os.path.join(REPO, "config", "production.yaml")) as fh:
                overlay = yaml.safe_load(fh)
            overlay["kubernetes"] = dict(overlay.get("kubernetes") or {}, use_incluster_config=False,
                                         config_file=kubeconfig)
            with open(os.path.join(config_dir, "production.yaml"), "w") as fh:
                yaml.safe_dump(overlay, fh)
            env = {k: v for k, v in os.environ.items() if k != "ENVIRONMENT"}
            env.update(PYTHONPATH=REPO, PROD_CLUSTERAPI_API_KEY=API_KEY)

            def ctl(*args):
                t0 = time.monotonic()
                proc = subprocess.run([sys.executable, "-m", "k8s_watcher_tpu_torch.remediate_ctl", "production",
                                       *args], cwd=workdir.name, env=env, capture_output=True, text=True, timeout=120)
                wall = time.monotonic() - t0
                if proc.returncode != 0:
                    fail(f"remediate_ctl {' '.join(args)} exited {proc.returncode}: {proc.stderr[-2000:]}")
                return json.loads(proc.stdout), wall

            status, status_s = ctl("status")
            listed = [q["node"] for q in status["quarantined"]]
            if listed != [node] or status["taint_key"] != tpu.remediation_taint_key:
                fail(f"remediate_ctl status listed {listed} under {status['taint_key']}, not [{node}]")
            released, release_s = ctl("release", node, "--no-dry-run")
            spec = cluster.get_node(node)["spec"]
            if not released["ok"] or released["dry_run"] or not released["applied"] or spec.get(
                    "unschedulable") or spec.get("taints"):
                fail(f"remediate_ctl release: {released}; {node} left with {spec}")
            after, after_s = ctl("status")
            if after["quarantined"]:
                fail(f"remediate_ctl status after the release: {after}")

            # one clean cycle acts on nothing
            n_patches = len(patches)
            probe, _, actions, _ = cycle(None)
            if not probe.get("ok") or probe.get("bad_blocks") or actions or len(patches) != n_patches:
                fail(f"the clean cycle: ok={probe.get('ok')}, bad {probe.get('bad_blocks')}, actions {actions}")
            if policy.snapshot()["streaks"]:
                fail(f"a clean cycle left streaks: {policy.snapshot()}")
            dispatcher.stop()
    finally:
        if old_node_name is None:
            os.environ.pop("NODE_NAME", None)
        else:
            os.environ["NODE_NAME"] = old_node_name
        sink.shutdown()
        sink.server_close()
        workdir.cleanup()
    print("remediation loop: " + json.dumps({
        "node": node, "cycle_ms": [c["ms"] for c in cycles], "write_gbps": [c["write_gbps"] for c in cycles],
        "bad_blocks": cycles[0]["bad_blocks"], "launches": launches, "confirm_cycles": confirm,
        "confirming_cycle_to_patch_ms": patch_ms, "patch": patches[0][2], "payloads": len(payloads),
        "evidence": findings, "cli_wall_s": {"status": status_s, "release": release_s, "status_after": after_s},
        "device": name, "power_limit": power_limit,
    }))


# -- phase 16: the soak, the offline replay and the acceptance drill -------------

SOAK_MINUTES = 1.0
SOAK_INTERVAL_S = 3.0
SOAK_CYCLES = 10
ACCEPT_SECONDS = 30.0
CORDONED_NODES = 16
_RANK_ENV = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _RANK_ENV}
    env.update(PYTHONPATH=REPO, **extra)
    return env


def soak_phase(name: str, power_limit: str) -> dict:
    """16a: ``python -m k8s_watcher_tpu_torch.probe_soak --minutes 1 --interval
    3`` as a subprocess on the card, at the soak's settings (4096 x 128 GEMM
    chain, 128 MiB HBM buffers, 256 passes): exit 0, at least 10 cycles, all
    healthy, no trend alert, no band's max above the card's peak x 1.05, and
    every kernel launched in every cycle. Returns the kernels' launches over
    the soak, read through ``K8S_WATCHER_TPU_LAUNCH_COUNTS``."""
    work = tempfile.TemporaryDirectory()
    out = os.path.join(work.name, "soak.json")
    argv = [sys.executable, "-m", "k8s_watcher_tpu_torch.probe_soak", "--minutes", str(SOAK_MINUTES),
            "--interval", str(SOAK_INTERVAL_S), "--out", out]
    samples, done = [], threading.Event()

    def sample_clocks():
        # the SM clock, the power draw and the temperature beside the soak
        while not done.wait(2.0):
            smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                                  "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
            if smi.returncode == 0:
                samples.append([float(v) for v in smi.stdout.strip().splitlines()[0].split(",")])

    sampler = threading.Thread(target=sample_clocks, daemon=True)
    sampler.start()
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, cwd=work.name, env=_child_env(K8S_WATCHER_TPU_LAUNCH_COUNTS=os.path.join(
            work.name, "launches")), capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("the soak did not finish in 300 s")
    finally:
        done.set()
        sampler.join()
    wall_s = time.monotonic() - t0
    clocks = {key: {"min": min(col), "median": statistics.median(col), "max": max(col)}
              for key, col in zip(("sm_mhz", "power_w", "temperature_c"), zip(*samples))} if samples else {}
    if proc.returncode != 0 or not os.path.exists(out):
        fail(f"the soak exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")
    with open(out) as fh:
        artifact = json.load(fh)
    with open(os.path.join(work.name, "launches.0")) as fh:
        launches = json.load(fh)
    on_device = json.loads(next(line for line in proc.stdout.splitlines()
                                if line.startswith("soak device: "))[len("soak device: "):])
    work.cleanup()
    bands = artifact["bands"]
    gemm_ms = [c["gemm_ms_median"] for c in on_device["cycles"]]
    print("soak: " + json.dumps({
        "argv": argv[1:-2], "wall_s": wall_s, "cycles": artifact["cycles_completed"],
        "healthy": artifact["cycles_healthy"], "heartbeats": artifact["heartbeats"],
        "trend_alerts": artifact["trend_alerts_raised"], "bands": bands, "launches": launches,
        "launches_per_cycle": [c["launches"] for c in on_device["cycles"]],
        "gemm_ms_per_call_median": statistics.median(gemm_ms), "gemm_ms_per_call": gemm_ms,
        "max_memory_allocated": on_device["max_memory_allocated"],
        "cycle_duration_ms_median": bands["cycle_duration_ms"].get("median"),
        "clocks": clocks, "trend_state": artifact["trend_state"], "device": name, "power_limit": power_limit,
    }))
    if not artifact["ok"] or artifact["cycles_completed"] < SOAK_CYCLES or artifact["trend_alerts_raised"] or \
            artifact["cycles_healthy"] != artifact["cycles_completed"]:
        fail(f"the soak: {artifact['cycles_healthy']} of {artifact['cycles_completed']} cycles healthy, "
             f"{artifact['trend_alerts_raised']} trend alerts, ok {artifact['ok']}")
    peaks = {"mxu_tflops_median": BF16_TFLOPS * PEAK_SLACK, "hbm_read_gbps": HBM_BYTES_PER_S / 1e9 * PEAK_SLACK,
             "hbm_write_gbps": HBM_BYTES_PER_S / 1e9 * PEAK_SLACK}
    for key, peak in peaks.items():
        if not bands[key] or bands[key]["max"] > peak:
            fail(f"the soak's {key} band {bands[key]} is above the card's peak x {PEAK_SLACK} ({peak})")
    for n, cycle in enumerate(on_device["cycles"]):
        if min(cycle["launches"].values()) <= 0:
            fail(f"soak cycle {n} launched {cycle['launches']}")
    return launches


def replay_phase(wal_dir: str, nodes: list, seed: int, name: str, power_limit: str) -> None:
    """16b: ``python -m k8s_watcher_tpu_torch.history_replay --wal <phase 9's
    WAL> --verify --analytics --scenarios [drain the local cluster, cordon 16
    nodes]`` on the card and with ``--device cpu``, side by side: both exit
    0, ``verified_deterministic``, ``crosscheck.ok``, and the card's report
    equal to the CPU's. Then one replay and one analytics pass in this
    process, timed."""
    from k8s_watcher_tpu_torch.analytics import FleetKernels, parse_scenarios, resolve_backend, verdicts_from_objects
    from k8s_watcher_tpu_torch.history.replay import replay_wal

    raw = [{"kind": "drain_cluster", "cluster": ""},
           {"kind": "cordon_nodes", "nodes": random.Random(seed + 16).sample(nodes, CORDONED_NODES)}]
    argv = [sys.executable, "-m", "k8s_watcher_tpu_torch.history_replay", "--wal", wal_dir, "--verify",
            "--analytics", "--scenarios", json.dumps(raw)]
    t0 = time.monotonic()
    procs = {dev: subprocess.Popen(argv + (["--device", "cpu"] if dev == "cpu" else []), cwd=REPO, env=_child_env(),
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for dev in ("cuda", "cpu")}
    outs, walls = {}, {}
    for dev, proc in procs.items():
        try:
            outs[dev] = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            fail(f"the offline replay on {dev} did not finish in 300 s")
        walls[dev] = time.monotonic() - t0
        if proc.returncode != 0:
            fail(f"the offline replay on {dev} exited {proc.returncode}:\n{outs[dev][0][-2000:]}\n{outs[dev][1][-2000:]}")
    reports = {dev: json.loads(out) for dev, (out, _) in outs.items()}
    card = reports["cuda"]
    t0 = time.monotonic()
    terminal = replay_wal(wal_dir)
    replay_s = time.monotonic() - t0
    kernels = FleetKernels(resolve_backend("auto", device="cuda"))
    scenarios = parse_scenarios(raw, max_scenarios=64)
    verdicts_from_objects(terminal.objects, scenarios, kernels=kernels)  # warm
    t0 = time.monotonic()
    again = verdicts_from_objects(terminal.objects, scenarios, kernels=kernels)
    analytics_s = time.monotonic() - t0
    print("offline replay: " + json.dumps({
        "wal_bytes": sum(os.path.getsize(os.path.join(wal_dir, f)) for f in os.listdir(wal_dir)),
        "rv": card["rv"], "objects": card["objects"], "deltas_applied": card["deltas_applied"],
        "segments": card["segments"], "verified_deterministic": card.get("verified_deterministic"),
        "crosscheck": card["analytics"]["crosscheck"]["ok"], "card_equals_cpu": card == reports["cpu"],
        "baseline": card["analytics"]["baseline"],
        "scenarios": [{k: v for k, v in row.items() if k != "slices_losing_quorum"}
                      | {"slices_losing_quorum": len(row["slices_losing_quorum"])}
                      for row in card["analytics"]["scenarios"]],
        "cli_wall_s": walls, "replay_s": replay_s, "analytics_s": analytics_s,
        "device": name, "power_limit": power_limit,
    }))
    if card.get("verified_deterministic") is not True or not card["analytics"]["crosscheck"]["ok"]:
        fail(f"the offline replay on the card: {card}")
    if card != reports["cpu"]:
        fail(f"the card's offline replay differs from the CPU's:\n{card}\n{reports['cpu']}")
    if again != card["analytics"]:
        fail("the in-process analytics pass differs from the CLI's report")


def acceptance_phase() -> None:
    """16c: ``python -m k8s_watcher_tpu_torch.acceptance_drill --cpu-ranks 8
    --seconds 30`` as a child on this host's CPUs: exit 0 with every gate."""
    work = tempfile.TemporaryDirectory()
    out = os.path.join(work.name, "acceptance.json")
    argv = [sys.executable, "-m", "k8s_watcher_tpu_torch.acceptance_drill", "--cpu-ranks", str(DRILL_RANKS),
            "--seconds", str(ACCEPT_SECONDS), "--out", out]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, cwd=REPO, env=_child_env(), capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("the acceptance drill did not finish in 600 s")
    wall_s = time.monotonic() - t0
    result = {}
    if os.path.exists(out):
        with open(out) as fh:
            result = json.load(fh)
    work.cleanup()
    probe = result.get("probe") or {}
    print("acceptance drill: " + json.dumps({
        "argv": argv[1:-2], "rc": proc.returncode, "wall_s": wall_s, "host_cpus": os.cpu_count(),
        "realized_events_per_min": result.get("realized_events_per_min"), "latency_ms": result.get("latency_ms"),
        "tracers": result.get("tracers"), "preemptions": result.get("preemptions"),
        "reschedules": result.get("reschedules"), "overflow_drops": result.get("overflow_drops"),
        "probe_cycles": probe.get("cycles"), "dcn_suspects": probe.get("dcn_suspects_per_cycle"),
        "decisions": len(probe.get("decisions") or []),
        "first_decision": next(((d["node"], d["dry_run"], d["applied"]) for d in probe.get("decisions") or []), None),
        "failures": result.get("failures"),
    }))
    if proc.returncode != 0 or result.get("failures") != [] or "acceptance drill: PASS" not in proc.stdout:
        fail(f"the acceptance drill exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")


# -- phase 17: the smoke drills, the connection checks and the integration tier --

#: each smoke drill's twin and its time limit on the card's host, in the
#: order they run (one after another: their timing-bound checks share the
#: host's CPUs)
SMOKE_TIMEOUT_S = {
    "serve_smoke": 120, "history_smoke": 120, "analytics_smoke": 120, "columnar_smoke": 300,
    "health_smoke": 300, "obs_smoke": 240, "trace_smoke": 180, "ingest_smoke": 240,
    "federation_smoke": 240, "fanin_smoke": 240, "relay_smoke": 240,
}


def _histogram_ms(histogram: dict) -> dict:
    return {k: histogram.get(k) for k in ("count", "mean_ms", "p50_ms", "p99_ms", "max_ms")}


def _run_twin(argv: list, timeout_s: float) -> tuple:
    t0 = time.monotonic()
    try:
        proc = subprocess.run(argv, cwd=REPO, env=_child_env(), capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        fail(f"{' '.join(argv[1:])} did not finish in {timeout_s} s")
    return proc, time.monotonic() - t0


def smoke_phase(name: str, power_limit: str) -> None:
    """17: the connection checks against the port's mock apiserver, each
    smoke drill's twin on the card (``--out`` in a temporary directory), then
    the integration tier with ``--backend auto``. Every twin must exit 0 with
    ``ok: true`` and exactly its declared checks, all true."""
    import importlib
    from pathlib import Path

    from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
    from k8s_watcher_tpu_torch.smoke_common import write_kubeconfig
    from k8s_watcher_tpu_torch.watch.fake import build_pod

    print(f"smoke twins on: {name}, {power_limit}")
    work = tempfile.TemporaryDirectory()
    with MockApiServer() as server:
        for i in range(3):
            server.cluster.add_pod(build_pod(f"check-pod-{i}", "default", uid=f"check-uid-{i}", tpu_chips=4))
        kubeconfig = write_kubeconfig(Path(work.name) / "kubeconfig.json", server.url)
        for module in ("check_connection", "check_mock"):
            proc, wall_s = _run_twin([sys.executable, "-m", f"k8s_watcher_tpu_torch.{module}", kubeconfig], 120)
            steps = [line.split(" - ")[0].strip() for line in proc.stdout.splitlines()
                     if line.startswith(("   OK", "   WARN", "   FAIL"))]
            row = {"twin": module, "rc": proc.returncode, "wall_s": wall_s, "steps": steps}
            print("smoke twin: " + json.dumps(row))
            if proc.returncode != 0 or "FAIL" in steps:
                fail(f"{module} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    for module, timeout_s in SMOKE_TIMEOUT_S.items():
        out = os.path.join(work.name, f"{module}.json")
        proc, wall_s = _run_twin([sys.executable, "-m", f"k8s_watcher_tpu_torch.{module}", "--out", out], timeout_s)
        artifact = {}
        if os.path.exists(out):
            with open(out) as fh:
                artifact = json.load(fh)
        checks = artifact.get("checks") or {}
        declared = list(importlib.import_module(f"k8s_watcher_tpu_torch.{module}").CHECKS)
        row = {"twin": module, "rc": proc.returncode, "wall_s": wall_s, "checks": len(checks),
               "checks_passed": sum(1 for v in checks.values() if v is True), "ok": artifact.get("ok")}
        if module == "analytics_smoke" and artifact:
            row["analytics_ms"] = {k: _histogram_ms(v) for k, v in artifact["analytics_histograms"].items()}
            row["request_ms"] = artifact["request_ms"]
        if module == "columnar_smoke" and artifact:
            row.update(pods=artifact["pods"], objects=artifact.get("objects"), memory=artifact.get("memory"),
                       body_mb=artifact.get("body_mb"), analytics_summary_ms=artifact.get("analytics_summary_ms"),
                       analytics_ms={core: {k: _histogram_ms(v) for k, v in hist.items()}
                                     for core, hist in (artifact.get("analytics_histograms") or {}).items()})
        print("smoke twin: " + json.dumps(row))
        if proc.returncode != 0 or artifact.get("ok") is not True or list(checks) != declared or \
                not all(v is True for v in checks.values()):
            failed = [k for k, v in checks.items() if v is not True]
            fail(f"{module} exited {proc.returncode}, ok {artifact.get('ok')}, failed checks {failed}, "
                 f"checks {sorted(checks)} against {sorted(declared)}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    out = os.path.join(work.name, "integration.json")
    proc, wall_s = _run_twin([sys.executable, "-m", "k8s_watcher_tpu_torch.integration_tier", "--backend", "auto",
                              "--out", out], 600)
    result = {}
    if os.path.exists(out):
        with open(out) as fh:
            result = json.load(fh)
    row = {"twin": "integration_tier", "rc": proc.returncode, "wall_s": wall_s, "backend": result.get("backend"),
           "write_tier": result.get("write_tier"), "summary": result.get("summary"), "ok": result.get("ok")}
    print("smoke twin: " + json.dumps(row))
    work.cleanup()
    if proc.returncode != 0 or result.get("ok") is not True:
        fail(f"integration_tier exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{result.get('log_tail', '')[-3000:]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        from k8s_watcher_tpu_torch import probe_agent, probe_soak
        from k8s_watcher_tpu_torch.config import load_agent_config, load_config
        from k8s_watcher_tpu_torch.kernels import build
        from k8s_watcher_tpu_torch.kernels import hbm as K
        from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
        from k8s_watcher_tpu_torch.probe.hbm import _pick_repeats
        from k8s_watcher_tpu_torch.probe.ici import mxu_chain
    except ImportError as exc:
        fail(f"the port's package is not importable beside this script: {exc}")

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device: {name} (count {count})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi_line}")
    power_limit = smi_line.split(",")[-1].strip()

    # 2. build
    lib_path = build.build()
    build.load()
    print(f"built {os.path.relpath(lib_path, REPO)}")
    print(build.build_log.strip() or "(library reused: no build output)")

    # 3. kernels against their plain versions at 256 MiB
    kernel_errors = compare_kernels(torch, K, dev, 256 * MIB, 2)
    print(f"kernels match plain versions at 256 MiB: read_sweep exact, fill bitwise, "
          f"blocksums max abs err {kernel_errors['blocksums']} with the planted bad blocks named")

    # 4. the main path: the production settings as they are
    config = load_config("production", os.path.join(REPO, "config"))
    if not config.probe_links_enabled:
        fail("the production settings no longer enable the per-link walk")
    build.reset_launch_counts()
    report = ProbeAgent(config, environment="production", sink=lambda n: None, device=dev).run_once()
    launches = build.launch_counts()
    payload = report.to_payload()
    ici, mxu, hbm, hbm_w, links = (payload[k] for k in ("ici", "mxu", "hbm", "hbm_write", "links"))
    readings = {
        "healthy": report.healthy,
        "psum_rtt_ms": ici["psum_rtt_ms"],
        "psum_correct": ici["psum_correct"],
        "mxu_tflops_median": mxu.get("tflops_median"),
        "hbm_read_gbps": hbm.get("read_gbps"),
        "hbm_write_gbps": hbm_w.get("write_gbps"),
        "hbm_bytes": hbm.get("bytes"),
        "repeats": hbm.get("repeats"),
        "bad_block_count": hbm_w.get("bad_block_count"),
        "links": links and {k: links[k] for k in ("ok", "n_links", "n_observed", "compile_ms", "error")},
        "duration_ms": payload["duration_ms"],
        # first call of each sub-probe: includes NCCL and library set-up
        "first_call_ms": {"ici": ici["compile_ms"], "hbm": hbm.get("compile_ms"),
                          "hbm_write": hbm_w.get("compile_ms")},
        "mxu_time_median_ms": mxu.get("time_median_ms"),
        "hbm_pass_ms": hbm.get("time_ms"),
        "hbm_write_pass_ms": hbm_w.get("time_ms"),
        "launches": launches,
    }
    print("main path readings: " + json.dumps(readings))
    for part, sub in (("ici", ici), ("mxu", mxu), ("hbm", hbm), ("hbm_write", hbm_w), ("links", links)):
        if not sub or not sub.get("ok") or sub.get("error"):
            fail(f"{part} probe not ok: {sub}")
    if links["n_links"] != 0 or links["n_observed"] != 0:
        fail(f"a one-card grid has no link, but the walk measured {links['n_observed']}")
    if not report.healthy:
        fail(f"the cycle is unhealthy: devices {payload['devices']}, trend {payload['trend_alerts']}")
    for part, sub in (("hbm", hbm), ("hbm_write", hbm_w)):
        if sub["interpreted"] is not False or sub["bandwidth_unreliable"] is not False:
            fail(f"{part}: interpreted={sub['interpreted']} bandwidth_unreliable={sub['bandwidth_unreliable']}")
        if sub["bytes"] != 256 * MIB or sub["repeats"] != 128:
            fail(f"{part} did not run at the production size: {sub['bytes']} bytes x {sub['repeats']}")
    for kernel, n in launches.items():
        if n <= 0:
            fail(f"kernel {kernel} was not launched by the main path")
    peak_gbps = HBM_BYTES_PER_S / 1e9 * PEAK_SLACK
    if hbm["read_gbps"] > peak_gbps or hbm_w["write_gbps"] > peak_gbps:
        fail(f"HBM reading above the card's peak: read {hbm['read_gbps']}, write {hbm_w['write_gbps']} GB/s")
    if mxu["tflops_median"] > BF16_TFLOPS * PEAK_SLACK:
        fail(f"MXU reading above the card's bf16 peak: {mxu['tflops_median']} TFLOP/s")

    # the GEMM chain on the card against the same chain on the CPU
    a = torch.randn((256, 256), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    b = torch.randn((256, 256), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    on_card = mxu_chain(a.to(dev), b.to(dev), 8, 1 / 16).float().cpu()
    on_cpu = mxu_chain(a, b, 8, 1 / 16).float()
    # bf16 rounds the product at each of 8 steps; sums run in another order
    rel = ((on_card - on_cpu).norm() / on_cpu.norm()).item()
    if not rel < 2e-2:
        fail(f"GEMM chain on the card differs from the CPU chain: relative error {rel}")
    print(f"GEMM chain card vs CPU: relative error {rel}")

    # 5. one cycle with the multislice probe on: one card is one slice
    build.reset_launch_counts()
    ms_report = ProbeAgent(dataclasses.replace(config, probe_multislice_enabled=True),
                           environment="production", sink=lambda n: None, device=dev).run_once()
    ms_launches = build.launch_counts()
    ms = ms_report.to_payload()["multislice"]
    print("multislice cycle: " + json.dumps({
        "healthy": ms_report.healthy, "duration_ms": ms_report.duration_ms, "launches": ms_launches,
        **{k: ms[k] for k in ("ok", "n_slices", "per_slice_sums", "ici_rtt_ms", "total_rtt_ms",
                              "dcn_overhead_ms", "compile_ms", "pair_rtts", "error")},
    }))
    if not ms["ok"] or ms["error"] or ms["n_slices"] != 1 or ms["pair_rtts"] or ms["per_slice_sums"] != [1.0]:
        fail(f"multislice probe on one card: {ms}")
    if not ms_report.healthy or min(ms_launches.values()) <= 0:
        fail(f"multislice cycle: healthy={ms_report.healthy}, launches {ms_launches}")

    # 6. the loop: LOOP_CYCLES cycles at a 1 s interval
    cycles, beats = [], []
    enough = threading.Event()

    def observe(cycle_report):
        # on the agent thread, after the cycle's heartbeat: the launches since
        # the last cycle are this cycle's
        counts = build.launch_counts()
        since = {k: counts[k] - sum(c["launches"][k] for c in cycles) for k in counts}
        cycles.append({"healthy": cycle_report.healthy, "duration_ms": cycle_report.duration_ms,
                       "launches": since})
        if len(cycles) >= LOOP_CYCLES:
            enough.set()

    loop_agent = ProbeAgent(dataclasses.replace(config, probe_interval_seconds=1.0), environment="production",
                            sink=lambda n: None, device=dev, heartbeat=lambda: beats.append(1))
    loop_agent.report_observer = observe
    build.reset_launch_counts()
    loop_agent.start()
    thread = loop_agent._thread
    finished = enough.wait(120)
    loop_agent.stop()
    if not finished or thread.is_alive():
        fail(f"the loop ran {len(cycles)} of {LOOP_CYCLES} cycles in 120 s (thread alive: {thread.is_alive()})")
    errors = loop_agent.metrics.counter("probe_errors").value
    print("loop cycles: " + json.dumps({"cycles": cycles, "heartbeats": len(beats), "probe_errors": errors}))
    if len(beats) != len(cycles) or errors:
        fail(f"{len(beats)} heartbeats and {errors} failed cycles for {len(cycles)} cycles")
    for n, cycle in enumerate(cycles):
        if not cycle["healthy"] or min(cycle["launches"].values()) <= 0:
            fail(f"loop cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']}")
    steady_ms = statistics.median(c["duration_ms"] for c in cycles)
    print(json.dumps({
        "first_cycle_duration_ms": payload["duration_ms"],
        "steady_cycle_duration_ms_median": steady_ms,
        "steady_cycle_duration_ms": [c["duration_ms"] for c in cycles],
        "link_walk_compile_ms": links["compile_ms"],
        "device": name, "power_limit": power_limit,
    }))

    # 7. times at the main path's shapes, then at the soak's (phase 16a)
    soak_bytes = probe_soak.soak_config(SOAK_INTERVAL_S).probe_hbm_bytes
    soak_repeats = _pick_repeats(soak_bytes)
    soak_errors = compare_kernels(torch, K, dev, soak_bytes, soak_repeats)
    print(f"kernels match plain versions at the soak's {soak_bytes // MIB} MiB x {soak_repeats} passes: "
          f"{json.dumps(soak_errors)}")
    kernels = []
    for row in kernel_timings(torch, K, dev, 256 * MIB, hbm["repeats"]):
        print(json.dumps({
            "kernel": row["name"], "kernel_ms": row["ms"], "bound_ms": row["bound_ms"], "plain_ms": row["plain_ms"],
            "library_ms": row["library_ms"], "launches_per_cycle": launches[row["name"]],
            "device": name, "power_limit": power_limit,
        }))
        kernels.append(dict(row, route="cuda", source=SOURCE, launches=launches[row["name"]],
                            max_abs_err=max(kernel_errors[row["name"]], soak_errors[row["name"]])))
    for row in kernel_timings(torch, K, dev, soak_bytes, soak_repeats):
        print("soak shape: " + json.dumps({**row, "bytes": soak_bytes, "repeats": soak_repeats,
                                           "max_abs_err": soak_errors[row["name"]], "device": name,
                                           "power_limit": power_limit}))
    # whether the soak's buffer is served from L2: its rate beside larger
    # buffers' at the same bytes a call (a 32 MiB buffer fits in L2 whole)
    sweep = size_sweep(torch, K, dev, soak_bytes * soak_repeats, (32, soak_bytes // MIB, 256, 512, 1024))
    larger = [r for r in sweep["rows"] if r["mib"] * MIB > soak_bytes]
    soak_row = next(r for r in sweep["rows"] if r["mib"] * MIB == soak_bytes)
    sweep["soak_faster_beyond_spread"] = {
        k: soak_row[k]["min"] > max(r[k]["max"] for r in larger) for k in ("read_sweep", "fill")}
    print("size sweep: " + json.dumps({**sweep, "device": name, "power_limit": power_limit}))

    # 8. the deployment loop, as the DaemonSet runs it, against local servers
    receiver, apiserver = serve("Receiver"), serve("ApiServer")
    status_port = free_port()
    kubeconfig_dir = tempfile.TemporaryDirectory()
    kubeconfig = os.path.join(kubeconfig_dir.name, "kubeconfig")
    with open(kubeconfig, "w") as fh:
        json.dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "stub",
            "clusters": [{"name": "stub", "cluster": {"server": f"http://127.0.0.1:{apiserver.server_address[1]}"}}],
            "contexts": [{"name": "stub", "context": {"cluster": "stub", "user": "stub"}}],
            "users": [{"name": "stub", "user": {"token": "stub-token"}}],
        }, fh)
    agent_config = load_agent_config("production", os.path.join(REPO, "config"), env={
        "CLUSTERAPI_BASE_URL": f"http://127.0.0.1:{receiver.server_address[1]}", "PROD_CLUSTERAPI_API_KEY": API_KEY,
    })
    agent_config = dataclasses.replace(
        agent_config,
        kubernetes=dataclasses.replace(agent_config.kubernetes, use_incluster_config=False, config_file=kubeconfig),
        tpu=dataclasses.replace(agent_config.tpu, probe_interval_seconds=1.0, probe_status_port=status_port),
    )
    if not (agent_config.tpu.remediation_enabled and agent_config.tpu.remediation_dry_run):
        fail("the production settings no longer arm dry-run remediation")
    os.environ["NODE_NAME"] = NODE_NAME
    loop_cycles, built = [], []
    enough, stop = threading.Event(), threading.Event()

    def started(loop):
        # count each cycle's launches on the agent thread, then run the policy
        policy_observer = loop.agent.report_observer

        def observe(cycle_report):
            counts = build.launch_counts()
            since = {k: counts[k] - sum(c["launches"][k] for c in loop_cycles) for k in counts}
            loop_cycles.append({"healthy": cycle_report.healthy, "duration_ms": cycle_report.duration_ms,
                                "launches": since})
            if policy_observer is not None:
                policy_observer(cycle_report)
            if len(loop_cycles) >= LOOP_CYCLES:
                enough.set()

        loop.agent.report_observer = observe
        built.append(loop)

    errors = []

    def run():
        try:
            probe_agent.run_loop(agent_config, "production", stop, device=dev, started=started)
        except BaseException as exc:  # noqa: BLE001 — reported below, fatal
            errors.append(exc)
            enough.set()

    build.reset_launch_counts()
    runner = threading.Thread(target=run, name="agent-loop", daemon=True)
    runner.start()
    finished = enough.wait(180)
    routes = {}
    if finished and not errors:
        n_seen = len(loop_cycles)
        for route in ("/healthz", "/metrics?format=prometheus", "/debug/probes?n=5", "/debug/trend",
                      "/debug/remediation"):
            routes[route] = http_get(status_port, route)
    t_stop = time.monotonic()
    stop.set()
    runner.join(60)
    stop_s = time.monotonic() - t_stop
    receiver.shutdown(), apiserver.shutdown()
    receiver.server_close(), apiserver.server_close()
    kubeconfig_dir.cleanup()
    if errors:
        fail(f"the agent loop raised: {errors[0]!r}")
    if not finished or not built:
        fail(f"the agent loop ran {len(loop_cycles)} of {LOOP_CYCLES} cycles in 180 s")
    if runner.is_alive() or stop_s > STOP_LIMIT_S or not built[0].joined:
        fail(f"the loop did not stop within {STOP_LIMIT_S} s: {stop_s:.1f} s, joined={built[0].joined}")
    loop = built[0]
    posts = [r for r in receiver.RequestHandlerClass.requests if r[0] == "POST"]
    api_calls = [(m, p) for m, p, _, _ in apiserver.RequestHandlerClass.requests]
    counters = {k: loop.agent.metrics.counter(k).value for k in ("probe_runs", "probe_errors", "probe_observer_errors")}
    counters.update({k: loop.dispatcher.metrics.counter(k).value for k in ("dispatch_sent", "dispatch_failed")})
    durations = [c["duration_ms"] for c in loop_cycles]
    print("deployment loop: " + json.dumps({
        "cycles": len(loop_cycles), "launches_per_cycle": [c["launches"] for c in loop_cycles],
        "posts": len(posts), "apiserver_requests": api_calls, "counters": counters, "stop_s": stop_s,
        "routes": {r: (status, body if isinstance(body, dict) else len(body)) for r, (status, body) in routes.items()},
    }))
    for n, cycle in enumerate(loop_cycles):
        if not cycle["healthy"] or min(cycle["launches"].values()) <= 0:
            fail(f"deployment loop cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']}")
    if counters["probe_errors"] or counters["probe_observer_errors"]:
        fail(f"deployment loop counters: {counters}")
    if len(posts) != len(loop_cycles) or any(
            path != "/api/pods/update" or auth != f"Bearer {API_KEY}" or body.get("event_type") != "TPU_PROBE"
            for _, path, auth, body in posts):
        fail(f"{len(posts)} POSTs for {len(loop_cycles)} cycles: {[(p, a) for _, p, a, _ in posts]}")
    status, health = routes["/healthz"]
    if status != 200 or health.get("alive") is not True:
        fail(f"/healthz: {status} {health}")
    status, text = routes["/metrics?format=prometheus"]
    values = dict(line.rsplit(" ", 1) for line in text.decode().splitlines() if not line.startswith("#"))
    runs = float(values.get("k8s_watcher_probe_runs_total", 0))
    gauges = ("k8s_watcher_probe_hbm_read_gbps", "k8s_watcher_probe_hbm_write_gbps",
              "k8s_watcher_probe_mxu_tflops_median")
    if status != 200 or runs < n_seen or any(g not in values for g in gauges):
        fail(f"/metrics: {status}, probe_runs {runs} for {n_seen} cycles, gauges {[g in values for g in gauges]}")
    status, probes = routes["/debug/probes?n=5"]
    if status != 200 or len(probes["probes"]) != 5 or not all(p["healthy"] for p in probes["probes"]):
        fail(f"/debug/probes?n=5: {status} {probes}")
    if routes["/debug/trend"][0] != 200:
        fail(f"/debug/trend: {routes['/debug/trend']}")
    status, remediation = routes["/debug/remediation"]
    state = remediation.get("remediation") or {}
    if status != 200 or state.get("dry_run") is not True or state.get("streaks") != {}:
        fail(f"/debug/remediation: {status} {remediation}")
    if ("GET", "/version") not in api_calls or not any(
            m == "GET" and p.split("?")[0] == "/api/v1/nodes" for m, p in api_calls) or any(
            m == "PATCH" for m, _ in api_calls):
        fail(f"apiserver requests: {api_calls}")
    print(json.dumps({
        "deployment_loop_cycle_duration_ms": durations,
        "deployment_loop_cycle_duration_ms_median": statistics.median(durations),
        "stop_s": stop_s, "device": name, "power_limit": power_limit,
    }))

    # 9. the watcher on the card: list+watch, pipeline, slices, notify, probe
    seed = int(sys.argv[sys.argv.index("--seed") + 1]) if "--seed" in sys.argv else 0
    quiet = {"mxu_tflops": mxu["tflops_median"], "hbm_read_gbps": hbm["read_gbps"],
             "hbm_write_gbps": hbm_w["write_gbps"]}
    # 16b runs inside it, on its WAL: the offline replay with analytics
    watcher_launches = watcher_phase(dev, name, power_limit, [c["duration_ms"] for c in cycles], seed, quiet,
                                     wal_hook=lambda wal_dir, nodes: replay_phase(wal_dir, nodes, seed, name,
                                                                                  power_limit))
    for kernel in kernels:
        if watcher_launches[kernel["name"]] <= 0:
            fail(f"kernel {kernel['name']} was not launched by the watcher's run")

    # 10. analytics at the size of a federator's global fleet
    from k8s_watcher_tpu_torch.config import load_app_config

    phase10 = analytics_phase(torch, dev, name, power_limit, seed,
                              load_app_config("production", os.path.join(REPO, "config"), env={}).analytics)

    # 11. staging as shipped: two spawned reader processes on the native
    # prefilter, one killed and respawned, beside the probe
    staging_launches = staging_phase(dev, name, power_limit, seed)
    for kernel in kernels:
        if staging_launches[kernel["name"]] <= 0:
            fail(f"kernel {kernel['name']} was not launched by the staging watcher's run")

    # 12. the federator over three upstreams at the fleet's size, in process
    # and then sharded over two merge workers; 13. a relay of one upstream
    for run, launches in federation_phases(dev, name, power_limit, seed, phase10).items():
        for kernel in kernels:
            if launches[kernel["name"]] <= 0:
                fail(f"kernel {kernel['name']} was not launched by the {run}'s run")

    # 14. the graft entry, and the DaemonSet's own command
    graft_phase(torch, name, power_limit)
    daemonset_phase(name, power_limit)
    dryrun_phase()

    # 15. the remediation loop: the drill on this host's CPU ranks, then a
    # fault on the card quarantined and released over the port's apiserver
    remediation_drill_phase()
    remediation_phase(dev, name, power_limit)

    # 16. the agent soak on the card (16b ran within phase 9), then the
    # acceptance drill on this host's CPU ranks
    soak_launches = soak_phase(name, power_limit)
    for kernel in kernels:
        kernel["path_launches"] = {"16a": soak_launches[kernel["name"]]}
    acceptance_phase()

    # 17. the JAX package's tooling as the port's twins: the connection
    # checks, the eleven smoke drills and the integration tier
    t0 = time.monotonic()
    smoke_phase(name, power_limit)
    print("smoke phase: " + json.dumps({"wall_s": time.monotonic() - t0, "device": name, "power_limit": power_limit}))

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
