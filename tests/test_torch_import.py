"""Import gate: the port imports nothing of JAX, nothing of the JAX package,
and neither ``requests`` nor ``urllib3`` (its HTTP runs on the standard
library).

A subprocess, because ``tests/conftest.py`` imports jax into this one. It
imports every module of ``k8s_watcher_tpu_torch`` and the root's
``__graft_entry_gpu__.py``, runs one CPU probe cycle through the
``probe_agent`` entry point with the ``production`` settings (the per-link
walk on), and reports what ``sys.modules`` holds afterwards. A second test
runs the entry point's loop mode as a process, against a local receiver, and
stops it with SIGINT; a third runs it under ``torchrun`` with two ranks on
one node, where only local rank 0 serves the status port. Another runs
the watcher, ``python -m k8s_watcher_tpu_torch development --cpu``, with the
``development`` planes as shipped (serve, analytics, health, SLO) on a
temporary config that points it at a local receiver and turns the probe on:
it must notify, answer ``/healthz`` (with the health and SLO folds),
``/serve/fleet`` and ``/serve/analytics``, hold no JAX module, and exit 0
within 10 s of SIGINT. ``staging --cpu`` and ``production --cpu`` run the
same way against a mock apiserver that serves Leases and nodes, with no plane
switched off. A spawned ingest reader process, after the imports a
production reader makes, holds neither torch nor jax, and neither does a
spawned federation merge worker. The standalone mock apiserver
(``python -m k8s_watcher_tpu_torch.mock_apiserver``) serves its seeded
cluster and stops within 10 s of SIGINT. The soak, the offline replay's
analytics, the acceptance drill and every smoke drill's twin, asked for the
card without CUDA, exit non-zero with an error naming CUDA. No module of the
port loads a file of ``scripts/``.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
#: the port's twins of the JAX package's ``scripts/*_smoke.py``
SMOKES = ("serve_smoke", "history_smoke", "analytics_smoke", "columnar_smoke", "health_smoke", "obs_smoke",
          "trace_smoke", "ingest_smoke", "federation_smoke", "fanin_smoke", "relay_smoke")

_GATE = """
import contextlib, importlib, io, json, pkgutil, sys
import os
import k8s_watcher_tpu_torch
scripts = os.path.join(os.path.dirname(os.path.dirname(k8s_watcher_tpu_torch.__file__)), "scripts") + os.sep
names = [m.name for m in pkgutil.walk_packages(k8s_watcher_tpu_torch.__path__, "k8s_watcher_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import __graft_entry_gpu__
from k8s_watcher_tpu_torch import probe_agent
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = probe_agent.main(["production", "--once", "--cpu"])
payload = json.loads(out.getvalue())
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
                or m == "k8s_watcher_tpu" or m.startswith("k8s_watcher_tpu.")
                or m == "requests" or m.startswith("requests.") or m == "urllib3" or m.startswith("urllib3.")
                or (getattr(sys.modules[m], "__file__", None) or "").startswith(scripts))
print(json.dumps({"modules": names, "rc": rc, "healthy": payload["healthy"], "links": payload["links"],
                  "forbidden": loaded, "graft_entry": callable(__graft_entry_gpu__.entry)}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _GATE], cwd=str(REPO), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == [] and result["graft_entry"] is True
    assert result["rc"] == 0 and result["healthy"] is True
    assert result["links"] is not None and result["links"]["ok"]
    for module in ("config", "metrics", "carry", "probe_agent", "logging_setup", "status", "app", "cli",
                   "__main__", "trace", "audit", "http", "watch.source", "watch.sharded", "watch.fake",
                   "state.dirty", "state.checkpoint", "pipeline.filters", "pipeline.phase", "pipeline.extract",
                   "pipeline.pipeline", "slices.topology", "slices.tracker", "native.scanner", "k8s.watch",
                   "probe.timing", "probe.device", "probe.hbm", "probe.ici", "probe.trend",
                   "probe.report", "probe.agent", "probe.links", "probe.multislice",
                   "kernels.build", "kernels.hbm",
                   "faults.ici", "parallel.mesh", "parallel.collectives",
                   "notify.client", "notify.dispatcher", "k8s.kubeconfig", "k8s.client",
                   "remediate", "remediate.actuator", "remediate.policy",
                   "serve", "serve.view", "serve.columns", "serve.broadcast", "serve.server",
                   "k8s.leader", "nodes", "nodes.tracker", "nodes.watcher", "native.build",
                   "parallel.procpool", "watch.procpool",
                   "analytics", "analytics.encode", "analytics.backend", "analytics.kernels",
                   "analytics.whatif", "analytics.plane", "trace.trace", "trace.federation",
                   "federate", "federate.client", "federate.merge", "federate.plane", "federate.fanin",
                   "relay", "relay.plane", "graft", "chaos_probe", "parallel.cpu_ranks",
                   "k8s.mock_server", "faults.injection", "mock_apiserver", "remediate_ctl", "chaos_remediate",
                   "drill_common", "probe_soak", "history_replay", "acceptance_drill",
                   "smoke_common", "check_connection", "check_mock", "integration_tier", *SMOKES):
        assert f"k8s_watcher_tpu_torch.{module}" in result["modules"], module


@pytest.mark.parametrize("module, argv", [
    ("probe_soak", ["--minutes", "0.01"]),
    ("history_replay", ["--analytics"]),
    ("acceptance_drill", ["--seconds", "1"]),
    *((smoke, []) for smoke in SMOKES),
])
def test_entry_point_without_cuda_or_its_cpu_flag_fails_naming_cuda(module, argv, tmp_path):
    """Asked for the card where there is none, each entry point exits
    non-zero with an error naming CUDA, and writes nothing."""
    out = tmp_path / "out.json"
    argv = argv + (["--wal", str(tmp_path)] if module == "history_replay" else ["--out", str(out)])
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", f"k8s_watcher_tpu_torch.{module}", *argv], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "RuntimeError" in proc.stderr, proc.stderr[-2000:]
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not out.exists() and proc.stdout.strip() == ""


class _Receiver(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    posts: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.posts.append((self.path, self.headers.get("Authorization"), json.loads(body)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_probe_agent_loop_mode_serves_reports_and_stops_on_sigint(tmp_path):
    """``probe_agent development --cpu`` without ``--once``: the loop POSTs
    probe payloads to the receiver, serves /healthz, and exits 0 on SIGINT."""
    handler = type("Receiver", (_Receiver,), {"posts": []})
    receiver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=receiver.serve_forever, daemon=True).start()
    status_port = _free_port()
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    shutil.copy(REPO / "config" / "base.yaml", config_dir / "base.yaml")
    overlay = yaml.safe_load((REPO / "config" / "development.yaml").read_text())
    overlay["clusterapi"]["base_url"] = f"http://127.0.0.1:{receiver.server_address[1]}"
    # small sizes: every part of the cycle runs, at CPU speed
    overlay.setdefault("tpu", {})["probe"] = {
        "enabled": True, "interval_seconds": 0.2, "status_port": status_port,
        "hbm_bytes": 2 << 20, "matmul_size": 64, "payload_bytes": 4096,
    }
    (config_dir / "development.yaml").write_text(yaml.safe_dump(overlay))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), CLUSTERAPI_API_KEY="test-key", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_watcher_tpu_torch.probe_agent", "development", "--cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        healthz = None
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            if handler.posts and healthz is None:
                with urllib.request.urlopen(f"http://127.0.0.1:{status_port}/healthz", timeout=5) as r:
                    healthz = (r.status, json.loads(r.read()))
            if healthz is not None:
                break
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        receiver.shutdown()
        receiver.server_close()
    assert proc.returncode == 0, out[-3000:]
    assert healthz is not None, out[-3000:]
    assert healthz[0] == 200 and healthz[1]["alive"] is True
    path, auth, payload = handler.posts[0]
    assert path == "/api/pods/update" and auth == "Bearer test-key"
    assert payload["event_type"] == "TPU_PROBE" and payload["healthy"] is True
    assert f"probe status endpoint on :{status_port}" in out


def _listeners(port: int) -> int:
    """How many sockets listen on TCP ``port`` on this host (``/proc/net``)."""
    count = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        if not os.path.exists(table):
            continue
        with open(table) as fh:
            for line in fh.readlines()[1:]:
                local, state = line.split()[1], line.split()[3]
                count += state == "0A" and int(local.rsplit(":", 1)[1], 16) == port
    return count


def _torchrun_workers(agent_pid: int) -> dict:
    """``LOCAL_RANK -> pid`` of the processes a ``torchrun`` agent started."""
    out = {}
    for task in os.listdir(f"/proc/{agent_pid}/task"):
        with open(f"/proc/{agent_pid}/task/{task}/children") as fh:
            for pid in map(int, fh.read().split()):
                with open(f"/proc/{pid}/environ", "rb") as env:
                    variables = dict(v.split(b"=", 1) for v in env.read().split(b"\0") if b"=" in v)
                if b"LOCAL_RANK" in variables:
                    out[int(variables[b"LOCAL_RANK"])] = pid
    return out


def test_probe_agent_loop_under_torchrun_serves_one_status_server_per_node(tmp_path):
    """``torchrun --nproc-per-node 2 -m k8s_watcher_tpu_torch.probe_agent
    production --cpu``, the DaemonSet's process on a node of two GPUs: the
    ranks share the node's network, and only local rank 0 binds the status
    port. Both ranks cycle (every cycle's collectives join them); when rank 1
    stops, rank 0's heartbeat stops with it, and comes back when it resumes.
    SIGTERM to ``torchrun`` stops both ranks cleanly."""
    handler = type("Receiver", (_Receiver,), {"posts": []})
    receiver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=receiver.serve_forever, daemon=True).start()
    status_port = _free_port()
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    shutil.copy(REPO / "config" / "base.yaml", config_dir / "base.yaml")
    overlay = yaml.safe_load((REPO / "config" / "production.yaml").read_text())
    overlay["clusterapi"]["base_url"] = f"http://127.0.0.1:{receiver.server_address[1]}"
    # latency limits far above a loaded CPU's jitter: only the stopped rank
    # may make a cycle unhealthy
    overlay["tpu"]["probe"].update({"interval_seconds": 0.2, "status_port": status_port, "hbm_bytes": 2 << 20,
                                    "matmul_size": 64, "payload_bytes": 4096, "link_rtt_floor_ms": 250.0,
                                    "rtt_warn_ms": 1000.0})
    (config_dir / "production.yaml").write_text(yaml.safe_dump(overlay))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=str(REPO), PROD_CLUSTERAPI_API_KEY="test-key", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        # nice: the ranks' torch imports yield to the suite's other workers
        ["nice", "-n", "10", sys.executable, "-m", "torch.distributed.run", "--standalone", "--nnodes=1",
         "--nproc-per-node=2", "-m", "k8s_watcher_tpu_torch.probe_agent", "production", "--cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )

    def healthz():
        with urllib.request.urlopen(f"http://127.0.0.1:{status_port}/healthz", timeout=5) as r:
            return r.status, json.loads(r.read())

    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None and len(handler.posts) < 3:
            time.sleep(0.2)
        assert proc.poll() is None and len(handler.posts) >= 3, proc.stdout.read()[-3000:]
        status, body = healthz()
        listeners = _listeners(status_port)
        workers = _torchrun_workers(proc.pid)
        # the cycle that waits on the stopped rank reads a long all-reduce
        # and is unhealthy: only the reports before it are held to health
        before = list(handler.posts)
        os.kill(workers[1], signal.SIGSTOP)
        try:
            time.sleep(3.0)
            stalled = healthz()[1]["last_heartbeat_age_seconds"]
        finally:
            os.kill(workers[1], signal.SIGCONT)
        time.sleep(2.0)
        resumed = healthz()[1]["last_heartbeat_age_seconds"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        receiver.shutdown()
        receiver.server_close()
    assert status == 200 and body["alive"] is True, out[-3000:]
    assert listeners == 1 and sorted(workers) == [0, 1]
    assert "Address already in use" not in out
    assert out.count(f"probe status endpoint on :{status_port}") == 1
    # rank 0 reports for the group; each cycle's collectives spanned both ranks
    for path, auth, payload in before:
        assert path == "/api/pods/update" and auth == "Bearer test-key"
        assert payload["event_type"] == "TPU_PROBE" and payload["healthy"] is True
        assert payload["devices"]["process_index"] == 0 and sorted(payload["hosts"]) == ["0", "1"]
        assert payload["ici"]["n_devices"] == 2 and payload["links"]["n_observed"] == 1
    assert stalled >= 2.0 and resumed < 1.5, (stalled, resumed)
    assert "probe agent stopped (rank 0)" in out and "probe agent stopped (rank 1)" in out, out[-3000:]
    # torchrun itself reports the signal it forwarded (torch.distributed.elastic
    # raises SignalException after its workers have stopped)
    assert proc.returncode == 0 or "got signal: 15" in out, out[-3000:]


_WATCHER = """
import atexit, json, runpy, sys
out_path = sys.argv[2]
def report():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "k8s_watcher_tpu"))
    with open(out_path, "w") as fh:
        json.dump(loaded, fh)
atexit.register(report)
sys.argv = ["k8s_watcher_tpu_torch", sys.argv[1], "--cpu"]
runpy.run_module("k8s_watcher_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _payloads(posts):
    """``(path, auth, payload)`` per payload, batched POSTs unpacked."""
    return [(path, auth, p) for path, auth, body in list(posts)
            for p in (body["updates"] if path.endswith("update_batch") else [body])]


def test_watcher_entry_point_runs_on_the_cpu_and_stops_on_sigint(tmp_path):
    handler = type("Receiver", (_Receiver,), {"posts": []})
    receiver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=receiver.serve_forever, daemon=True).start()
    status_port, serve_port = _free_port(), _free_port()
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    shutil.copy(REPO / "config" / "base.yaml", config_dir / "base.yaml")
    overlay = yaml.safe_load((REPO / "config" / "development.yaml").read_text())
    overlay["clusterapi"]["base_url"] = f"http://127.0.0.1:{receiver.server_address[1]}"
    overlay["watcher"]["status_port"] = status_port
    # every plane as shipped: serve, analytics, health and SLO on
    assert overlay["serve"]["enabled"] and overlay["analytics"]["enabled"]
    assert overlay["health"]["enabled"] and overlay["slo"]["enabled"]
    overlay["serve"]["port"] = serve_port
    overlay.setdefault("tpu", {})["probe"] = {
        "enabled": True, "interval_seconds": 0.2, "hbm_bytes": 2 << 20, "matmul_size": 64, "payload_bytes": 4096,
    }
    (config_dir / "development.yaml").write_text(yaml.safe_dump(overlay))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), CLUSTERAPI_API_KEY="test-key", OMP_NUM_THREADS="1")
    modules = tmp_path / "modules.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", _WATCHER, "development", str(modules)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        healthz = fleet = analytics = None
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            if {"TPU_PROBE", "ADDED"} <= {p.get("event_type") for _, _, p in _payloads(handler.posts)}:
                with urllib.request.urlopen(f"http://127.0.0.1:{status_port}/healthz", timeout=5) as r:
                    healthz = (r.status, json.loads(r.read()))
                with urllib.request.urlopen(f"http://127.0.0.1:{serve_port}/serve/fleet", timeout=5) as r:
                    fleet = json.loads(r.read())
                with urllib.request.urlopen(f"http://127.0.0.1:{serve_port}/serve/analytics?drain_cluster=",
                                            timeout=5) as r:
                    analytics = json.loads(r.read())
                break
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        proc.send_signal(signal.SIGINT)
        t0 = time.monotonic()
        out, _ = proc.communicate(timeout=30)
        stop_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        receiver.shutdown()
        receiver.server_close()
    assert proc.returncode == 0, out[-3000:]
    assert stop_s < 10.0
    assert healthz is not None and healthz[0] == 200 and healthz[1]["alive"] is True, out[-3000:]
    assert healthz[1]["serve"]["healthy"] is True and healthz[1]["serve"]["started"] is True
    # the health plane's and the SLO engine's verdicts ride the body
    assert healthz[1]["health"]["thread_alive"] is True and healthz[1]["slo"]["thread_alive"] is True
    # the probe's verdict is live; the fake pod's lifecycle (added, then
    # deleted) shows in the rv
    assert "probe" in {o["kind"] for o in fleet["objects"]} and fleet["rv"] > len(fleet["objects"]), fleet
    assert analytics["backend"] == "torch" and analytics["scenarios"][0]["scenario"] == {
        "kind": "drain_cluster", "cluster": ""}
    assert json.loads(modules.read_text()) == []
    pods = [p for _, _, p in _payloads(handler.posts) if p.get("event_type") in ("ADDED", "MODIFIED", "DELETED")]
    assert pods and all(auth == "Bearer test-key" for _, auth, _ in handler.posts)
    assert pods[0]["name"] == "mock-tpu-pod"
    assert "Starting k8s-watcher-tpu (PyTorch) in 'development' environment" in out


def test_spawned_reader_imports_no_torch():
    from k8s_watcher_tpu_torch.watch.procpool import ProcessShardedWatchSource, WorkerPlan
    from test_torch_proc_factories import modules_factory

    source = ProcessShardedWatchSource([WorkerPlan(proc_index=0, processes=1, owned_shards=(0,), shards=1,
                                                   source_factory=modules_factory)])
    got = [event for batch in source.batches() for event in batch]
    assert [e.name for e in got] == ["modules"]
    assert json.loads(got[0].pod["metadata"]["annotations"]["loaded"]) == []
    assert source.worker_stats()["hellos"][0]["pid"] != os.getpid()


def test_spawned_merge_worker_imports_no_torch(tmp_path):
    """A fan-in merge worker (``federation.processes``) is spawned, folds an
    upstream's snapshot and drains on SIGTERM; by the time it built its
    client it held neither torch nor jax (it never touches the card)."""
    from k8s_watcher_tpu_torch.config import FederationConfig
    from k8s_watcher_tpu_torch.federate.fanin import FaninEndpoint, fanin_plans
    from k8s_watcher_tpu_torch.serve import FleetView, ServeServer, SubscriptionHub
    from test_torch_proc_factories import fanin_modules_factory

    view = FleetView()
    view.apply_batch([("pod", f"uid-{i}", {"kind": "pod", "key": f"uid-{i}", "phase": "Running"}) for i in range(5)])
    server = ServeServer(view, SubscriptionHub(view), host="127.0.0.1", port=0).start()
    try:
        config = FederationConfig.from_raw({"enabled": True, "processes": 1, "upstreams": [
            {"name": "c0", "url": f"http://127.0.0.1:{server.port}"}]})
        (plan,) = fanin_plans(config, str(tmp_path))
        plan.client_factory = fanin_modules_factory
        endpoint = FaninEndpoint(plan)
        frames = endpoint.frames()
        first = next(frames)
        endpoint.stop()
        rest = []
        drain = threading.Thread(target=lambda: rest.extend(frames), daemon=True)
        drain.start()
        drain.join(30)
    finally:
        server.stop()
    assert not drain.is_alive() and endpoint.last_hello["pid"] != os.getpid()
    assert first["c"] == "c0" and first["r"] == 1 and len(first["b"]) == 5
    assert json.loads((tmp_path / "modules.json").read_text()) == []


def _shipped_overlay(tmp_path, environment, receiver_port, apiserver_url):
    """A config dir where ``environment`` is as shipped, pointed at local
    servers (kubeconfig, receiver), free ports, a small probe, the state
    under ``tmp_path``."""
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    shutil.copy(REPO / "config" / "base.yaml", config_dir / "base.yaml")
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "m",
        "clusters": [{"name": "m", "cluster": {"server": apiserver_url}}],
        "contexts": [{"name": "m", "context": {"cluster": "m", "user": "m"}}],
        "users": [{"name": "m", "user": {"token": "t"}}],
    }))
    overlay = yaml.safe_load((REPO / "config" / f"{environment}.yaml").read_text())
    overlay["kubernetes"] = {"use_incluster_config": False, "config_file": str(kubeconfig)}
    overlay["clusterapi"]["base_url"] = f"http://127.0.0.1:{receiver_port}"
    overlay["watcher"]["status_port"] = _free_port()
    overlay["serve"]["port"] = _free_port()
    overlay["tpu"]["probe"].update({"interval_seconds": 0.5, "hbm_bytes": 2 << 20, "matmul_size": 64,
                                    "payload_bytes": 4096})
    (config_dir / f"{environment}.yaml").write_text(yaml.safe_dump(overlay))
    return overlay


@pytest.mark.parametrize("environment", ["staging", "production"])
def test_shipped_environment_entry_point_runs_on_the_cpu(tmp_path, environment):
    from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
    from k8s_watcher_tpu.watch.fake import build_node, build_pod

    cluster = MockCluster()
    cluster.add_node(build_node("tpu-node-0"))
    cluster.add_pod(build_pod("w-0", "default", uid="uid-w-0", phase="Running", tpu_chips=4, node_name="tpu-node-0"))
    handler = type("Receiver", (_Receiver,), {"posts": []})
    receiver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=receiver.serve_forever, daemon=True).start()
    server = MockApiServer(cluster).start()
    overlay = _shipped_overlay(tmp_path, environment, receiver.server_address[1], server.url)
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", WATCHER_STATUS_TOKEN="tok",
               STAGING_CLUSTERAPI_API_KEY="k", PROD_CLUSTERAPI_API_KEY="k",
               WATCHER_CHECKPOINT_PATH=str(tmp_path / "ck.json"), WATCHER_HISTORY_DIR=str(tmp_path / "history"))
    modules = tmp_path / "modules.json"
    proc = subprocess.Popen([sys.executable, "-c", _WATCHER, environment, str(modules)], cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    status_port = overlay["watcher"]["status_port"]
    try:
        healthz = processes = None
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            if "TPU_PROBE" in {p.get("event_type") for _, _, p in _payloads(handler.posts)} and \
                    (environment == "production" or "ADDED" in {p.get("event_type")
                                                                for _, _, p in _payloads(handler.posts)}):
                with urllib.request.urlopen(f"http://127.0.0.1:{status_port}/healthz", timeout=5) as r:
                    healthz = json.loads(r.read())
                request = urllib.request.Request(f"http://127.0.0.1:{status_port}/debug/processes",
                                                 headers={"Authorization": "Bearer tok"})
                try:
                    with urllib.request.urlopen(request, timeout=5) as r:
                        processes = json.loads(r.read())
                except urllib.error.HTTPError as exc:
                    processes = exc.code
                break
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        # the node watch is live: a NotReady node is notified
        cluster.set_node_ready("tpu-node-0", False)
        while time.monotonic() < deadline and "NODE_CONDITION_CHANGE" not in {
                p.get("event_type") for _, _, p in _payloads(handler.posts)}:
            time.sleep(0.1)
        lease = cluster.get_lease("default", "k8s-watcher-tpu")
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        receiver.shutdown()
        receiver.server_close()
        server.stop()
    assert proc.returncode == 0, out[-3000:]
    assert "config key" not in out and healthz is not None and healthz["alive"] is True, out[-3000:]
    assert json.loads(modules.read_text()) == []
    assert "NODE_CONDITION_CHANGE" in {p.get("event_type") for _, _, p in _payloads(handler.posts)}
    if environment == "staging":
        assert [w["process"] for w in processes["processes"]["workers"]] == ["ingest-shard-0", "ingest-shard-1"]
    else:
        assert processes == 404 and lease["spec"]["holderIdentity"]
        assert cluster.get_lease("default", "k8s-watcher-tpu")["spec"]["holderIdentity"] == ""


def test_mock_apiserver_serves_and_stops_on_sigint():
    """``python -m k8s_watcher_tpu_torch.mock_apiserver PORT --churn``: the
    seeded slice and nodes answer LISTs, and SIGINT stops it with exit 0
    within 10 s."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "k8s_watcher_tpu_torch.mock_apiserver", str(port), "--churn"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        listening = proc.stdout.readline().strip()
        assert listening == f"mock k8s API server listening on http://127.0.0.1:{port} (Ctrl-C to stop)"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/v1/pods", timeout=10) as resp:
            pods = json.loads(resp.read())["items"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/v1/nodes", timeout=10) as resp:
            nodes = json.loads(resp.read())["items"]
        assert sorted(p["metadata"]["name"] for p in pods) == [f"train-{w}" for w in range(4)]
        assert sorted(n["metadata"]["name"] for n in nodes) == ["tpu-node-0", "tpu-node-1"]
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=10)
        assert rc == 0 and time.monotonic() - t0 < 10
        assert "stopping" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
