"""Shared pieces of the smoke drills (each of the JAX package's
``scripts/*_smoke.py`` repeats them): the repo's paths, a free port, a
kubeconfig for a mock apiserver, an HTTP GET on the standard library in
place of ``requests``, the command line every drill takes (``--device``,
``--out``) and the artifact write.

A drill's apps and analytics run on ``--device`` (default ``cuda:0``); asked
for CUDA where there is none, :func:`smoke_args` raises before anything
runs. ``--device cpu`` runs them on the CPU, for tests. Nothing falls back
to the CPU or to numpy on its own.
"""

from __future__ import annotations

import argparse
import http.client
import json
import socket
import urllib.parse
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
DEFAULT_DEVICE = "cuda:0"

#: what ``requests.RequestException`` covers for a drill: a transport error
#: (refused, reset, timed out, a malformed status line) or a body that does
#: not decode as JSON
RequestError = (OSError, http.client.HTTPException, ValueError)

quote = urllib.parse.quote


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_kubeconfig(path: Path, server_url: str) -> str:
    """A token-auth kubeconfig for the mock apiserver at ``server_url``,
    written to ``path`` unless it is there already (a drill's restarted app
    reuses its first one)."""
    if not path.exists():
        path.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "m", "cluster": {"server": server_url}}],
            "contexts": [{"name": "m", "context": {"cluster": "m", "user": "m"}}],
            "current-context": "m",
            "users": [{"name": "m", "user": {"token": "t"}}],
        }))
    return str(path)


class Response:
    """The part of a ``requests`` response a drill reads."""

    def __init__(self, status_code: int, headers: http.client.HTTPMessage, content: bytes):
        self.status_code = status_code
        self.headers = headers  # case-insensitive .get(), as requests' headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise http.client.HTTPException(f"HTTP {self.status_code}: {self.text[:200]}")


def http_get(url: str, *, headers: Optional[Mapping[str, str]] = None,
             params: Optional[Mapping[str, Any]] = None, timeout: float = 5.0) -> Response:
    """One GET on a connection of its own, as ``requests.get`` without a
    session; ``params`` are url-encoded onto the query."""
    parts = urllib.parse.urlsplit(url)
    target = parts.path or "/"
    query = parts.query
    if params:
        query = "&".join(filter(None, (query, urllib.parse.urlencode(params))))
    if query:
        target = f"{target}?{query}"
    conn = http.client.HTTPConnection(parts.hostname, parts.port or 80, timeout=timeout)
    try:
        conn.request("GET", target, headers=dict(headers or {}))
        resp = conn.getresponse()
        return Response(resp.status, resp.msg, resp.read())
    finally:
        conn.close()


def smoke_args(description: str, name: str, argv: Optional[Sequence[str]],
               parser: Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
    """Parse a drill's command line: ``--device`` (resolved here, so a run
    asked for on a missing GPU fails before it starts) and ``--out``
    (default ``artifacts/<name>_gpu.json``)."""
    from k8s_watcher_tpu_torch.probe.device import resolve_device

    parser = parser or argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where the apps' analytics run (default cuda:0; raises without CUDA; cpu for tests)")
    parser.add_argument("--out", default=str(ARTIFACTS / f"{name}_gpu.json"), help="the artifact's path")
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def write_artifact(result: Dict[str, Any], out: str, indent: int = 2) -> Path:
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=indent, default=str) + "\n")
    return path


def checks_line(checks: Dict[str, bool]) -> str:
    return ", ".join(f"{k}={'PASS' if v else 'FAIL'}" for k, v in checks.items())

