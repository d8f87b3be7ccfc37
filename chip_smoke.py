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
7. each kernel's time beside its bound, its plain version's and one
   PyTorch library call's, at the main path's shapes;
8. the deployment loop: ``probe_agent.run_loop`` with the ``production``
   settings (notifier, status server, dry-run remediation), pointed at a
   receiver and a stub apiserver that the script serves on 127.0.0.1, for
   at least 5 cycles at a 1 s interval; every cycle healthy with every
   kernel launched, one POSTed probe payload per cycle, the status routes
   answering, no node patched, and the stop within 10 s.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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


def http_get(port: int, path: str):
    """(status, body) of one GET to 127.0.0.1:port, JSON decoded where it is JSON."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        from k8s_watcher_tpu_torch import probe_agent
        from k8s_watcher_tpu_torch.config import load_agent_config, load_config
        from k8s_watcher_tpu_torch.kernels import build
        from k8s_watcher_tpu_torch.kernels import hbm as K
        from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
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
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = 256 * MIB // K.BYTES_PER_BLOCK * K.BLOCK_ROWS
    x = torch.randint(0, 4, (rows, K.WIDTH), generator=gen, device=dev).to(torch.float32)
    got, want = K.read_sweep(x, 2), K.read_sweep_plain(x, 2)
    read_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        fail(f"read_sweep differs from read_sweep_plain (max abs err {read_err})")
    num_blocks = 256 * MIB // K.WRITE_BYTES_PER_BLOCK
    seed3 = torch.full((1, 1), 3.0, device=dev)
    got, want = K.fill(seed3, num_blocks, 2), K.fill_plain(seed3, num_blocks, 2)
    fill_err = (got - want).abs().max().item()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"fill is not bitwise equal to fill_plain (max abs err {fill_err})")
    y = K.fill_plain(torch.zeros((1, 1), device=dev), num_blocks, 1)
    corrupted = [5, 200, num_blocks - 1]
    y.view(num_blocks, -1)[corrupted, 17] += 1e6
    got, want = K.blocksums(y), K.blocksums_plain(y)
    torch.cuda.synchronize()
    sums_err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        fail(f"blocksums differs from blocksums_plain beyond rel 1e-5 (max abs err {sums_err})")
    expected = torch.arange(1, num_blocks + 1, device=dev, dtype=torch.float64) * K.WRITE_BLOCK_ELEMS

    def bad(sums):
        return torch.nonzero((sums.double().view(-1) - expected).abs() > 1e-5 * expected).view(-1).tolist()

    if bad(got) != corrupted or bad(want) != corrupted:
        fail(f"bad blocks: kernel {bad(got)}, plain {bad(want)}, corrupted {corrupted}")
    print(f"kernels match plain versions at 256 MiB: read_sweep exact, fill bitwise, "
          f"blocksums max abs err {sums_err} with bad blocks {corrupted}")
    del x, got, want, y

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

    # 7. times at the main path's shapes
    repeats = hbm["repeats"]
    x = torch.ones((rows, K.WIDTH), dtype=torch.float32, device=dev)
    y = K.fill_plain(torch.zeros((1, 1), device=dev), num_blocks, 1)
    buf = 256 * MIB

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
         bound(buf * repeats + 4 * K.WIDTH, buf // 4 * repeats), read_err, 5),
        ("fill", "k8s_watcher_tpu/probe/hbm.py:107 (_fill_kernel; pallas_call :135)",
         lambda: K.fill(seed3, num_blocks, repeats), lambda: K.fill_plain(seed3, num_blocks, repeats),
         library_fill, bound(buf * repeats + 4, buf // 4 * repeats), fill_err, 5),
        ("blocksums", "k8s_watcher_tpu/probe/hbm.py:117 (_blocksum_kernel; pallas_call :145)",
         lambda: K.blocksums(y), lambda: K.blocksums_plain(y),
         lambda: y.view(num_blocks, -1).sum(1), bound(buf + 4 * num_blocks, buf // 4), sums_err, 50),
    ]
    kernels = []
    for kname, replaces, kernel_fn, plain_fn, library_fn, (bound_ms, bound_by), err, n in specs:
        kernel_ms = cuda_ms(torch, kernel_fn, n=n)
        plain_ms = cuda_ms(torch, plain_fn, n=max(3, n // 2))
        library_ms = cuda_ms(torch, library_fn, n=max(3, n // 2))
        print(json.dumps({
            "kernel": kname, "kernel_ms": kernel_ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "launches_per_cycle": launches[kname],
            "device": name, "power_limit": power_limit,
        }))
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })

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

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
