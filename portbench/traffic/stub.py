"""The apiserver and the notification sink the probe agent talks to.

:class:`NodeStub` answers what the agent's remediation asks of an apiserver
on a quiet node: ``GET /version``, the node LIST (paged, by label selector)
and WATCH (a BOOKMARK a second), and node PATCHes, which it counts and
answers 404: a dry run sends none. Its nodes are GPU nodes as the NVIDIA GPU
operator labels them (a copy of ``chip_smoke.py``'s ``GpuCluster.node``).
:class:`Sink` records every payload the program POSTs with its arrival time.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

GPU_KEY = "nvidia.com/gpu"
GPU_PRESENT_LABEL = "nvidia.com/gpu.present"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
GPU_PRODUCT = "NVIDIA-H100-80GB-HBM3"
T0 = "2026-10-01T00:00:00Z"


def node(name: str, ready: bool, rv: int) -> dict:
    """A Node as the apiserver serves it: the GPU operator's labels and
    ``nvidia.com/gpu: 8`` capacity on the GPU nodes, and a Ready condition."""
    labels = {"kubernetes.io/hostname": name, "kubernetes.io/os": "linux"}
    capacity = {"cpu": "96", "memory": "1056Gi", "pods": "110"}
    if name.startswith("gpu-"):
        labels.update({GPU_PRESENT_LABEL: "true", GPU_PRODUCT_LABEL: GPU_PRODUCT, "nvidia.com/gpu.count": "8"})
        capacity[GPU_KEY] = "8"
    conditions = [
        {"type": kind, "status": "False", "reason": f"KubeletHas{suffix}", "message": f"kubelet has {text}",
         "lastHeartbeatTime": T0, "lastTransitionTime": T0}
        for kind, suffix, text in (("MemoryPressure", "SufficientMemory", "sufficient memory available"),
                                   ("DiskPressure", "NoDiskPressure", "no disk pressure"))
    ] + [{"type": "Ready", "status": "True" if ready else "False",
          "reason": "KubeletReady" if ready else "KubeletNotReady",
          "message": "kubelet is posting ready status" if ready else "Kubelet stopped posting node status.",
          "lastHeartbeatTime": T0, "lastTransitionTime": T0}]
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "uid": f"node-{name}", "resourceVersion": str(rv), "labels": labels,
                         "creationTimestamp": T0},
            "spec": {"podCIDR": "10.64.0.0/24"},
            "status": {"capacity": capacity, "allocatable": dict(capacity), "conditions": conditions}}


class NodeStub:
    def __init__(self, node_names):
        self.lock = threading.Lock()
        self.closing = threading.Event()
        self.patches = []
        self.nodes = {name: node(name, True, 1) for name in node_names}
        self.node_rv = 1

    @staticmethod
    def _selected(item: dict, selector: str) -> bool:
        labels = item["metadata"]["labels"]
        for term in filter(None, (t.strip() for t in selector.split(","))):
            key, eq, value = term.partition("=")
            if key not in labels or (eq and labels[key] != value):
                return False
        return True

    def node_page(self, params: dict) -> bytes:
        selector = params.get("labelSelector") or ""
        items = [n for _, n in sorted(self.nodes.items()) if self._selected(n, selector)]
        offset = int(params.get("continue") or 0)
        limit = int(params.get("limit") or 0) or len(items)
        body = {"kind": "NodeList", "apiVersion": "v1", "metadata": {"resourceVersion": str(self.node_rv)},
                "items": items[offset:offset + limit]}
        if offset + limit < len(items):
            body["metadata"]["continue"] = str(offset + limit)
        return json.dumps(body).encode()

    def node_watch(self, handler, params: dict) -> None:
        """No node changes: a BOOKMARK a second."""
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        out = handler.wfile
        deadline = time.monotonic() + int(params.get("timeoutSeconds") or 300)
        try:
            while not self.closing.wait(1.0) and time.monotonic() < deadline:
                data = b'{"type":"BOOKMARK","object":{"kind":"Node","metadata":{"resourceVersion":"%d"}}}\n' % (
                    self.node_rv)
                out.write(b"%x\r\n%s\r\n" % (len(data), data))
                out.flush()
            out.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass


class _StubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    stub: NodeStub = None

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
        else:
            self.answer(404, {"kind": "Status", "code": 404})

    def do_PATCH(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
        with self.stub.lock:
            self.stub.patches.append(self.path)
        self.answer(404, {"kind": "Status", "code": 404})


class Sink:
    """Every payload POSTed, per item or batched, as ``(arrival, payload)``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.payloads = []

    def record(self, items) -> None:
        now = time.monotonic()
        with self.lock:
            self.payloads.extend((now, p) for p in items)


class _SinkHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    sink: Sink = None

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0) or 0)))
        if self.path.endswith("/update_batch"):
            self.sink.record(body["updates"])
            data = json.dumps({"results": [True] * len(body["updates"])}).encode()
        else:
            self.sink.record([body])
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
    daemon_threads = True

    def handle_error(self, request, client_address):
        if not isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError, TimeoutError)):
            super().handle_error(request, client_address)


def serve(handler: type, **attrs) -> ThreadingHTTPServer:
    """``handler`` with ``attrs`` on 127.0.0.1, on a free port, on a thread."""
    server = _QuietServer(("127.0.0.1", 0), type(handler.__name__, (handler,), attrs))
    threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.1}, daemon=True).start()
    return server
