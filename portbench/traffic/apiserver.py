"""The watcher cell's traffic: a seeded GPU cluster's apiserver and the
notification sink, in a process of its own on the CPUs the harness gives it,
as ``server.py``'s are for the probe cells. The child imports nothing of the
port and never touches the device.

:class:`ChurnApi` serves:

- ``GET /version``;
- the pod LIST in pages (``limit`` and ``continue``), each LIST a snapshot of
  the pods at its first page (:class:`PodsAndLeases`);
- the pod WATCH from the LIST's resourceVersion: the open churn
  (``GpuCluster.open_churn``), its frames encoded a second ahead of the
  writes on a thread of its own once the first LIST is served, and written
  from the parent's ``churn`` on at ``rate_per_s``, each write holding every
  event due by then (at most ``BLOCK``), until the parent's ``stop_churn``; a
  BOOKMARK a second while no event is due. A watch from another
  resourceVersion than the last one written gets 410 Gone;
- the node LIST and WATCH, and node PATCHes, which it counts and answers 404
  (``stub.NodeStub``);
- Leases (``coordination.k8s.io/v1``): GET, POST (409 when it exists) and
  PUT (409 on a stale ``metadata.resourceVersion``).

The sink records every payload POSTed. ``report`` folds the LIST and the
events the WATCH delivered (``portbench.reference.watcher``) and holds the
sink's payloads to the fold.

The parent (:class:`ChurnTraffic`) speaks to the child in JSON lines, as
``server.TrafficProcess`` does: ``start``, ``status``, ``churn``,
``stop_churn``, ``report`` and ``stop``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse

from portbench.reference.watcher import compare, fold_production, received_item
from portbench.traffic.cluster import GpuCluster
from portbench.traffic.server import ROOT, TrafficProcess
from portbench.traffic.stub import NodeStub, Sink, _SinkHandler, _StubHandler, serve

LEASE_PATH = "/apis/coordination.k8s.io/v1/namespaces/"
BLOCK = 512  # the most events one write to the watch holds
TICK_S = 0.001  # the schedule's step: each write holds the events due by then
LEAD_S, LEAD_MIN = 1.0, 4096  # the churn's frames encoded ahead of the writer: a second's worth, at least
ENCODE_BLOCK = 256


class PodsAndLeases:
    """The pod LIST, the Leases and chunked answers of an apiserver stub. The
    subclass sets ``lock``, ``objects`` (uid -> the pod's JSON bytes), ``rv``,
    ``snapshots``, ``pod_lists``, ``list_pages``, ``first_pod_list_t``,
    ``leases``, ``lease_rv`` and ``lease_log``."""

    def page(self, params: dict) -> bytes:
        limit = int(params.get("limit") or 0) or len(self.objects)
        token = params.get("continue")
        with self.lock:
            if token:
                list_id, offset = (int(x) for x in token.split(":"))
                items, rv = self.snapshots[list_id]
            else:
                list_id, offset = self.pod_lists, 0
                items, rv = list(self.objects.values()), self.rv
                self.snapshots[list_id] = (items, rv)
                self.pod_lists += 1
                if self.first_pod_list_t is None:
                    self.first_pod_list_t = time.monotonic()
            self.list_pages += 1
        end = offset + limit
        more = f',"continue":"{list_id}:{end}"' if end < len(items) else ""
        if not more:
            with self.lock:
                self.snapshots.pop(list_id, None)
        return (f'{{"kind":"PodList","apiVersion":"v1","metadata":{{"resourceVersion":"{rv}"{more}}},"items":['
                .encode() + b",".join(items[offset:end]) + b"]}")

    @staticmethod
    def _chunked(handler):
        """Start a chunked 200 answer: ``(the stream, write one chunk)``."""
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        out = handler.wfile

        def write(data: bytes) -> None:
            out.write(b"%x\r\n%s\r\n" % (len(data), data))

        return out, write

    def lease(self, method: str, path: str, body) -> tuple:
        parts = path[len(LEASE_PATH):].split("/")  # {ns}/leases[/{name}]
        namespace, name = parts[0], (parts[2] if len(parts) > 2 else (body or {}).get("metadata", {}).get("name"))
        key = (namespace, name)
        with self.lock:
            current = self.leases.get(key)
            if method == "GET":
                return (200, current) if current else (404, {"kind": "Status", "code": 404})
            if method == "POST" and current is not None:
                return 409, {"kind": "Status", "code": 409, "reason": "AlreadyExists"}
            if method == "PUT":
                if current is None:
                    return 404, {"kind": "Status", "code": 404}
                if (body.get("metadata") or {}).get("resourceVersion") != current["metadata"]["resourceVersion"]:
                    return 409, {"kind": "Status", "code": 409, "reason": "Conflict"}
            self.lease_rv += 1
            lease = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                     "metadata": {"name": name, "namespace": namespace, "resourceVersion": str(self.lease_rv)},
                     "spec": dict(body.get("spec") or {})}
            self.leases[key] = lease
            self.lease_log.append((time.monotonic(), method, dict(lease["spec"])))
            return (201 if method == "POST" else 200), lease


class ChurnApi(NodeStub, PodsAndLeases):
    """The cell's apiserver, over ``params``' seeded cluster (see the module)."""

    def __init__(self, params: dict):
        t0 = time.monotonic()
        c = params["cluster"]
        self.cluster = GpuCluster(params["seed"], nodes=c["nodes"], pods=c["pods"], jobsets=c["jobsets"],
                                  workers=c["workers"], batch_share=c["batch_share"], churn=0, failures=0,
                                  down_deletions=0, node_flips=0, listed_ready=True)
        super().__init__(self.cluster.node_names())
        self.objects = {spec.uid: spec.encode(rv, phase, ready, restarts)
                        for _, spec, phase, ready, restarts, rv in self.cluster.initial}
        self.list_bytes = sum(len(b) for b in self.objects.values())
        self.list_rv = self.rv = self.cluster.list_rv
        self.snapshots, self.pod_lists, self.list_pages, self.first_pod_list_t = {}, 0, 0, None
        self.leases, self.lease_rv, self.lease_log = {}, 0, []
        self.rate = float(params["rate_per_s"])
        self.pool = int(params["pool_events"])
        self.lead = max(LEAD_MIN, int(self.rate * LEAD_S))
        self.steps = []  # every step of the churn made so far, for the fold
        self.frames = collections.deque()  # the frames of steps[written:], encoded ahead of the schedule
        self.written = 0  # steps written to the watch
        self.changed = {}  # uid -> its last frame written (None: deleted), for a later LIST
        self.t0 = self.stop_at = None
        self.watching = threading.Event()
        self.listed = threading.Event()  # the first LIST's last page is served
        self.behind = 0  # the most events a write wanted that were not yet encoded: the generator running late
        self.write_s = 0.0  # in the WATCH's writes, blocked on the watcher's socket or not
        self.build_s = time.monotonic() - t0
        self.encoder = threading.Thread(target=self.encode, args=(params,), name="churn-encoder", daemon=True)
        self.encoder.start()

    def encode(self, params: dict) -> None:
        """After the first LIST, keep ``lead`` frames encoded ahead of the
        writer, until ``pool`` steps are made."""
        self.listed.wait()
        steps = self.cluster.open_churn(params["seed"], gpu_share=params["gpu_share"])
        while len(self.steps) < self.pool and not self.closing.is_set():
            if len(self.steps) - self.written >= self.lead:
                time.sleep(TICK_S)
                continue
            for _ in range(min(ENCODE_BLOCK, self.pool - len(self.steps))):
                step = next(steps)
                kind, spec, phase, ready, restarts, rv = step
                # the frame first: the writer reads len(self.steps)
                self.frames.append(spec.frame(kind, rv, phase, ready, restarts))
                self.steps.append(step)

    def page(self, params: dict) -> bytes:
        if not params.get("continue"):
            with self.lock:  # a new LIST holds every event written
                for uid, frame in self.changed.items():
                    if frame is None:
                        self.objects.pop(uid, None)
                    else:
                        self.objects[uid] = frame[frame.index(b'"object":') + 9:-2]
                self.changed.clear()
        body = super().page(params)
        if b'"continue"' not in body[:200]:
            self.listed.set()
        return body

    def due(self) -> int:
        if self.t0 is None:
            return 0
        n = int((time.monotonic() - self.t0) * self.rate)
        return min(n, self.pool if self.stop_at is None else self.stop_at)

    def watch(self, handler, params: dict) -> None:
        rv = int(params.get("resourceVersion") or 0)
        with self.lock:
            if rv != self.list_rv + self.written or self.watching.is_set():
                handler.answer(410, {"kind": "Status", "code": 410, "message": "too old resource version"})
                return
            self.watching.set()
        out, write = self._chunked(handler)
        deadline = time.monotonic() + int(params.get("timeoutSeconds") or 300)
        bookmark = time.monotonic()
        try:
            while not self.closing.is_set() and time.monotonic() < deadline:
                due = self.due()
                end = min(due, len(self.steps), self.written + BLOCK)
                # the events this write wants that are not encoded yet
                self.behind = max(self.behind, min(due, self.written + BLOCK) - len(self.steps))
                if end > self.written:
                    start = self.written
                    frames = [self.frames.popleft() for _ in range(end - start)]
                    t0 = time.monotonic()
                    write(b"".join(frames))
                    self.write_s += time.monotonic() - t0
                    with self.lock:
                        for (kind, spec, *_), frame in zip(self.steps[start:end], frames):
                            self.changed[spec.uid] = None if kind == "DELETED" else frame
                        self.written = end
                        self.rv = self.list_rv + end
                    continue
                now = time.monotonic()
                if now - bookmark >= 1.0:
                    write(b'{"type":"BOOKMARK","object":{"kind":"Pod","metadata":{"resourceVersion":"%d"}}}\n'
                          % self.rv)
                    bookmark = now
                time.sleep(TICK_S)
            out.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the watcher closed the stream (its stop)
        finally:
            self.watching.clear()

    def report(self, payloads) -> dict:
        sent = []
        facts = GpuCluster.facts(self.cluster.initial) + GpuCluster.facts(self.steps[:self.written])
        fold_production(facts, sent=sent)
        received = [item for item in map(received_item, payloads) if item is not None]
        kinds = {}
        for p in payloads:
            kinds[p.get("event_type")] = kinds.get(p.get("event_type"), 0) + 1
        probes = [p for p in payloads if p.get("event_type") == "TPU_PROBE"]
        return {**compare(sent, received), "notifications": len(sent), "received": len(received),
                "payloads": kinds, "probe_payloads": len(probes),
                "trend_alerts": sum(len(p.get("trend_alerts") or ()) for p in probes),
                "patches": len(self.patches), "pod_lists": self.pod_lists, "list_pages": self.list_pages,
                "written": self.written, "behind": self.behind, "write_s": self.write_s,
                "lease_writes": len(self.lease_log)}


class ChurnHandler(_StubHandler):
    def do_GET(self):  # noqa: N802
        path, _, query = self.path.partition("?")
        params = dict(urllib.parse.parse_qsl(query))
        if path == "/api/v1/pods" and params.get("watch") == "true":
            self.stub.watch(self, params)
        elif path == "/api/v1/pods":
            self.answer(200, self.stub.page(params))
        elif path.startswith(LEASE_PATH):
            self.answer(*self.stub.lease("GET", path, None))
        else:
            super().do_GET()

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


class ChurnTraffic(TrafficProcess):
    """The parent's handle on the child, started at once with ``params``:
    ``seed``, ``cluster`` (``nodes``, ``pods``, ``jobsets``, ``workers``,
    ``batch_share``), ``rate_per_s``, ``gpu_share`` and ``pool_events``, the
    most events the WATCH may deliver."""

    def __init__(self, params: dict, cpus=None):
        self.proc = subprocess.Popen([sys.executable, "-m", "portbench.traffic.apiserver"], cwd=ROOT,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if cpus:
            os.sched_setaffinity(self.proc.pid, cpus)
        self._send({"cmd": "start", **params})


# -- the child ----------------------------------------------------------------


class Child:
    def __init__(self, params: dict):
        self.api = ChurnApi(params)
        self.sink = Sink()
        self.servers = [serve(ChurnHandler, stub=self.api), serve(_SinkHandler, sink=self.sink)]
        self.reply = {"api": self.servers[0].server_address[1], "sink": self.servers[1].server_address[1],
                      "list_rv": self.api.list_rv, "pods": len(self.api.objects), "list_bytes": self.api.list_bytes,
                      "build_s": self.api.build_s}

    def status(self) -> dict:
        api = self.api
        return {"pod_lists": api.pod_lists, "list_pages": api.list_pages, "watching": api.watching.is_set(),
                "encoded": len(api.steps), "written": api.written, "due": api.due()}

    def churn(self) -> dict:
        """Start the schedule once the encoder is a lead ahead (or done)."""
        api = self.api
        t0 = time.monotonic()
        while len(api.steps) < min(api.lead, api.pool) and api.encoder.is_alive():
            time.sleep(0.01)
        api.t0 = time.monotonic()
        return {"t0": api.t0, "waited_s": api.t0 - t0, "encoded": len(api.steps)}

    def stop_churn(self) -> dict:
        """The schedule ends at the events due now; returns how many."""
        api = self.api
        api.stop_at = api.due()
        return {"stop_at": api.stop_at, "t": time.monotonic(), "written": api.written}

    def report(self, wait_s: float) -> dict:
        """Once the WATCH has written every event up to the schedule's end
        (or ``wait_s`` passed), the sink held to the fold."""
        api = self.api
        deadline = time.monotonic() + wait_s
        while api.written < (api.stop_at or 0) and time.monotonic() < deadline:
            time.sleep(0.05)
        with self.sink.lock:
            payloads = [p for _, p in self.sink.payloads]
        return {**api.report(payloads), "stop_at": api.stop_at}

    def stop(self) -> None:
        self.api.closing.set()
        for server in self.servers:
            server.shutdown()
            server.server_close()


def main() -> int:
    child = None
    for line in sys.stdin:
        message = json.loads(line)
        cmd = message.pop("cmd")
        if cmd == "stop":
            break
        if cmd == "start":
            child = Child(message)
            out = child.reply
        elif cmd == "status":
            out = child.status()
        elif cmd == "churn":
            out = child.churn()
        elif cmd == "stop_churn":
            out = child.stop_churn()
        elif cmd == "report":
            out = child.report(message["wait_s"])
        else:
            out = {"error": f"unknown command {cmd}"}
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()
    if child is not None:
        child.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
