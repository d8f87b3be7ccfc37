"""Shared pieces of the drills (the JAX package's ``scripts/_drill_common.py``):
the mock node a drill quarantines and the recording HTTP sink that stands in
for clusterapi. The JAX package's virtual CPU mesh has its counterpart in
``parallel/cpu_ranks.py``."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional


def tpu_node(name: str) -> Dict:
    """A Ready mock TPU node manifest (the drills' quarantine target)."""
    return {
        "metadata": {
            "name": name,
            "labels": {"cloud.google.com/gke-tpu-accelerator": "tpu-v5p"},
        },
        "spec": {},
        "status": {"conditions": [{"type": "Ready", "status": "True"}]},
    }


def start_sink(on_payload: Optional[Callable[[dict, float], None]] = None) -> ThreadingHTTPServer:
    """A live HTTP sink standing in for clusterapi; calls ``on_payload``
    with (body, arrival_monotonic) under no lock — the callback owns its
    own synchronization. Returns the running ThreadingHTTPServer
    (``server_address[1]`` is the port; call shutdown()+server_close())."""

    class Sink(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # without TCP_NODELAY, Nagle + delayed-ACK adds ~40 ms per POST
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def do_POST(self):
            now = time.monotonic()
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
            if on_payload is not None:
                on_payload(body, now)
            out = b'{"ok": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    server = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
