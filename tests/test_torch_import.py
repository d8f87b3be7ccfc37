"""Import gate: the port imports nothing of JAX, nothing of the JAX package,
and neither ``requests`` nor ``urllib3`` (its HTTP runs on the standard
library).

A subprocess, because ``tests/conftest.py`` imports jax into this one. It
imports every module of ``k8s_watcher_tpu_torch``, runs one CPU probe cycle
through the ``probe_agent`` entry point with the ``production`` settings
(the per-link walk on), and reports what ``sys.modules``
holds afterwards. A second test runs the entry point's loop mode as a
process, against a local receiver, and stops it with SIGINT.
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
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parent.parent

_GATE = """
import contextlib, importlib, io, json, pkgutil, sys
import k8s_watcher_tpu_torch
names = [m.name for m in pkgutil.walk_packages(k8s_watcher_tpu_torch.__path__, "k8s_watcher_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from k8s_watcher_tpu_torch import probe_agent
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = probe_agent.main(["production", "--once", "--cpu"])
payload = json.loads(out.getvalue())
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
                or m == "k8s_watcher_tpu" or m.startswith("k8s_watcher_tpu.")
                or m == "requests" or m.startswith("requests.") or m == "urllib3" or m.startswith("urllib3."))
print(json.dumps({"modules": names, "rc": rc, "healthy": payload["healthy"], "links": payload["links"],
                  "forbidden": loaded}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _GATE], cwd=str(REPO), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == []
    assert result["rc"] == 0 and result["healthy"] is True
    assert result["links"] is not None and result["links"]["ok"]
    for module in ("config", "metrics", "notification", "carry", "probe_agent", "logging_setup", "status",
                   "probe.timing", "probe.device", "probe.hbm", "probe.ici", "probe.trend",
                   "probe.report", "probe.agent", "probe.links", "probe.multislice",
                   "kernels.build", "kernels.hbm",
                   "faults.ici", "parallel.mesh", "parallel.collectives",
                   "notify.client", "notify.dispatcher", "k8s.kubeconfig", "k8s.client",
                   "remediate", "remediate.actuator", "remediate.policy"):
        assert f"k8s_watcher_tpu_torch.{module}" in result["modules"], module


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
