"""The traffic side of a run, in a process of its own.

The apiserver stub and the notification sink run in a child process, so they
never wait on the interpreter of the system under test, nor it on theirs.
The child imports nothing of the port and never touches the device.

The parent (:class:`TrafficProcess`) speaks to it in JSON lines on its
standard input and output: ``start``, ``report`` and ``stop``.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TrafficProcess:
    """The parent's handle on the child, started at once."""

    def __init__(self, params: dict, cpus=None):
        self.proc = subprocess.Popen([sys.executable, "-m", "portbench.traffic.server"], cwd=ROOT,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        if cpus:
            os.sched_setaffinity(self.proc.pid, cpus)
        self._send({"cmd": "start", **params})

    def _send(self, message: dict) -> None:
        self.proc.stdin.write(json.dumps(message) + "\n")
        self.proc.stdin.flush()

    def reply(self, timeout_s: float) -> dict:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise RuntimeError(f"the traffic process gave no reply in {timeout_s} s (exit {self.proc.poll()})")
        return json.loads(line)

    def ask(self, timeout_s: float = 60.0, **message) -> dict:
        self._send(message)
        return self.reply(timeout_s)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self._send({"cmd": "stop"})
                self.proc.wait(10)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(10)
        self.proc.stdin.close()
        self.proc.stdout.close()


# -- the child ----------------------------------------------------------------


class Child:
    def __init__(self, params: dict):
        from portbench.traffic.stub import NodeStub, Sink, _SinkHandler, _StubHandler, serve

        self.stub = NodeStub(params["node_names"])
        self.sink = Sink()
        self.servers = [serve(_StubHandler, stub=self.stub), serve(_SinkHandler, sink=self.sink)]
        self.reply = {"api": self.servers[0].server_address[1], "sink": self.servers[1].server_address[1]}

    def report(self) -> dict:
        with self.sink.lock:
            payloads = list(self.sink.payloads)
        return {"probe_payloads": sum(1 for _, p in payloads if p.get("event_type") == "TPU_PROBE"),
                "patches": len(self.stub.patches)}

    def stop(self) -> None:
        self.stub.closing.set()
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
        elif cmd == "report":
            out = child.report()
        else:
            out = {"error": f"unknown command {cmd}"}
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()
    if child is not None:
        child.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
