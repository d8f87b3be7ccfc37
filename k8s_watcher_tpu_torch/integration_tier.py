"""Run acceptance tier #2 on the port (tests/test_torch_integration_cluster.py)
and record the result as an artifact: the port's twin of the JAX package's
``scripts/run_integration_tier.py``, with the same backends and result keys.

BASELINE.md acceptance config #2 is "kind local cluster: 3-pod namespace
watch". The gated tests need a kubeconfig; this runner provisions one and
runs the test file with ``--noconftest`` (it imports no JAX, and the suite's
conftest does):

- ``--backend kind`` (default when ``kind`` is on PATH): create a throwaway
  kind cluster from deploy/kind-config.yaml, run the tier INCLUDING the
  write path (real pod create/delete over REST through K8sClient — no
  kubectl needed), tear the cluster down.
- ``--backend binary``: a REAL kube-apiserver without Docker — start
  ``etcd`` + ``kube-apiserver`` binaries from PATH (throwaway certs/keys
  generated with openssl, static token auth, AlwaysAllow), point the
  kubeconfig at the live HTTPS endpoint, run the full tier including the
  write path, tear everything down.
- ``--backend mock``: serve the port's mock apiserver
  (k8s_watcher_tpu_torch/k8s/mock_server.py) over HTTP, point a generated
  kubeconfig at it, and run the FULL tier — including the write path —
  through the SAME gate. This is NOT a substitute for the kind artifact — it
  proves the gated test path works end-to-end on hosts without Docker (the
  artifact is labelled with its backend).

``auto`` prefers kind > binary > mock and, when it must fall back to the
mock, records ``integration_env_constraints_gpu.json`` beside the artifact:
which of the binaries the real tiers need the host lacks. Unlike the JAX
package's runner it opens no connection outside the host, so the record says
that egress was not probed.

Usage:
    python -m k8s_watcher_tpu_torch.integration_tier [--backend kind|binary|mock|auto] [--out F]

Artifact: ``artifacts/integration_<backend>_gpu.json`` (``--out``). Exit 0
when the tier passes.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "artifacts"
TEST_FILE = "tests/test_torch_integration_cluster.py"
CLUSTER_NAME = "watcher-it"


def run_pytest(kubeconfig: str, write: bool) -> dict:
    env = dict(os.environ)
    env["WATCHER_INTEGRATION_KUBECONFIG"] = kubeconfig
    if write:
        env["WATCHER_INTEGRATION_WRITE"] = "1"
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [
            sys.executable, "-m", "pytest",
            TEST_FILE, "--noconftest", "-v",
            "--tb=short",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    tail = proc.stdout[-4000:]
    summary_line = next(
        (l for l in reversed(proc.stdout.splitlines()) if "passed" in l or "failed" in l or "error" in l),
        "",
    )
    return {
        "rc": proc.returncode,
        "summary": summary_line.strip().strip("="),
        "log_tail": tail,
    }


def _mkstemp_path(prefix: str) -> Path:
    fd, path = tempfile.mkstemp(prefix=prefix)
    os.close(fd)
    return Path(path)


def backend_kind() -> dict:
    created = False
    kubeconfig = _mkstemp_path("kind-kubeconfig-")
    try:
        existing = subprocess.run(
            ["kind", "get", "clusters"], capture_output=True, text=True, timeout=60
        )
        if CLUSTER_NAME not in existing.stdout.split():
            subprocess.run(
                ["kind", "create", "cluster", "--name", CLUSTER_NAME,
                 "--config", str(REPO / "deploy" / "kind-config.yaml"),
                 "--wait", "120s"],
                check=True, timeout=600,
            )
            created = True
        subprocess.run(
            ["kind", "export", "kubeconfig", "--name", CLUSTER_NAME,
             "--kubeconfig", str(kubeconfig)],
            check=True, timeout=60,
        )
        # the write path drives create/delete through K8sClient itself —
        # no kubectl needed on any backend
        result = run_pytest(str(kubeconfig), write=True)
        result["backend"] = "kind"
        result["write_tier"] = True
        return result
    finally:
        kubeconfig.unlink(missing_ok=True)
        if created:
            subprocess.run(["kind", "delete", "cluster", "--name", CLUSTER_NAME], timeout=300)


def _wait_http_ready(url: str, timeout_s: float = 60.0) -> bool:
    import ssl
    import time
    import urllib.request

    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, context=ctx, timeout=3):
                return True
        except Exception:
            time.sleep(0.5)
    return False


def backend_binary() -> dict:
    """A real kube-apiserver from PATH binaries: etcd + kube-apiserver +
    openssl-generated throwaway PKI, no container runtime needed."""
    import socket

    for binary in ("etcd", "kube-apiserver", "openssl"):
        if not shutil.which(binary):
            raise RuntimeError(f"--backend binary needs `{binary}` on PATH")

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    procs: list = []
    logs: list = []
    tmp = Path(tempfile.mkdtemp(prefix="watcher-binary-apiserver-"))
    try:
        sa_key = tmp / "sa.key"
        serving_key, serving_crt = tmp / "serving.key", tmp / "serving.crt"
        subprocess.run(
            ["openssl", "genrsa", "-out", str(sa_key), "2048"],
            check=True, capture_output=True, timeout=60,
        )
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(serving_key), "-out", str(serving_crt),
             "-days", "1", "-subj", "/CN=127.0.0.1",
             "-addext", "subjectAltName=IP:127.0.0.1"],
            check=True, capture_output=True, timeout=60,
        )
        token = "watcher-integration-token"
        token_file = tmp / "tokens.csv"
        token_file.write_text(f"{token},watcher,watcher-uid,system:masters\n")

        etcd_client_port, etcd_peer_port = free_port(), free_port()
        api_port = free_port()
        etcd_log = open(tmp / "etcd.log", "w")
        logs.append(etcd_log)
        procs.append(subprocess.Popen(
            ["etcd",
             "--data-dir", str(tmp / "etcd-data"),
             "--listen-client-urls", f"http://127.0.0.1:{etcd_client_port}",
             "--advertise-client-urls", f"http://127.0.0.1:{etcd_client_port}",
             "--listen-peer-urls", f"http://127.0.0.1:{etcd_peer_port}"],
            stdout=etcd_log, stderr=subprocess.STDOUT,
        ))
        if not _wait_http_ready(f"http://127.0.0.1:{etcd_client_port}/health", 30):
            raise RuntimeError("etcd never became healthy")
        api_log = open(tmp / "apiserver.log", "w")
        logs.append(api_log)
        procs.append(subprocess.Popen(
            ["kube-apiserver",
             "--etcd-servers", f"http://127.0.0.1:{etcd_client_port}",
             "--bind-address", "127.0.0.1",
             "--secure-port", str(api_port),
             "--tls-cert-file", str(serving_crt),
             "--tls-private-key-file", str(serving_key),
             "--service-account-key-file", str(sa_key),
             "--service-account-signing-key-file", str(sa_key),
             "--service-account-issuer", "https://kubernetes.default.svc",
             "--token-auth-file", str(token_file),
             "--authorization-mode", "AlwaysAllow",
             "--allow-privileged=false"],
            stdout=api_log, stderr=subprocess.STDOUT,
        ))
        server = f"https://127.0.0.1:{api_port}"
        if not _wait_http_ready(f"{server}/version", 90):
            raise RuntimeError(
                "kube-apiserver never became ready; see " + str(tmp / "apiserver.log")
            )
        kubeconfig = {
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "binary", "cluster": {
                "server": server, "insecure-skip-tls-verify": True,
            }}],
            "contexts": [{"name": "binary", "context": {"cluster": "binary", "user": "binary"}}],
            "current-context": "binary",
            "users": [{"name": "binary", "user": {"token": token}}],
        }
        path = _mkstemp_path("binary-kubeconfig-")
        try:
            path.write_text(json.dumps(kubeconfig))
            result = run_pytest(str(path), write=True)
        finally:
            path.unlink(missing_ok=True)
        result["backend"] = "binary"
        result["write_tier"] = True
        return result
    finally:
        for proc in reversed(procs):
            proc.terminate()
        for proc in reversed(procs):
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def record_env_constraints(out: Path) -> Path:
    """Dated evidence of WHY only the mock tier could run on this host,
    written to ``out``. The conclusion is computed from the binaries found,
    as the JAX package's runner computes it; egress is not probed (the
    runner opens no connection outside the host)."""
    binaries = {
        b: (shutil.which(b) or "absent")
        for b in ("kind", "docker", "podman", "kube-apiserver", "etcd",
                  "k3s", "minikube", "kubectl")
    }
    constraints = {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "binaries": binaries,
        "egress": "not probed",
        "conclusion": env_conclusion(binaries),
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(constraints, indent=2) + "\n")
    return out


def env_conclusion(binaries: dict) -> str:
    # computed from the binaries found — a hardcoded sentence next to
    # contradicting findings would defeat the record's purpose as evidence
    missing = sorted(b for b, path in binaries.items() if path == "absent")
    present = sorted(b for b, path in binaries.items() if path != "absent")
    parts = []
    if missing:
        parts.append(f"missing binaries: {', '.join(missing)}")
    if present:
        parts.append(f"present: {', '.join(present)}")
    parts.append("network egress not probed")
    return (
        "The kind and binary backends could not run on this host ("
        + "; ".join(parts)
        + "). The mock artifact is the only tier runnable here."
    )


def backend_mock() -> dict:
    from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
    from k8s_watcher_tpu_torch.watch.fake import build_pod

    with MockApiServer() as server:
        # the "3-pod namespace watch" shape from acceptance config #2
        for i in range(3):
            server.cluster.add_pod(build_pod(f"seed-pod-{i}", "default", tpu_chips=4))
        kubeconfig = {
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "mock", "cluster": {"server": server.url}}],
            "contexts": [{"name": "mock", "context": {"cluster": "mock", "user": "mock"}}],
            "current-context": "mock",
            "users": [{"name": "mock", "user": {"token": "mock-token"}}],
        }
        path = _mkstemp_path("mock-kubeconfig-")
        try:
            path.write_text(json.dumps(kubeconfig))
            result = run_pytest(str(path), write=True)
        finally:
            path.unlink(missing_ok=True)
        result["backend"] = "mock"
        result["write_tier"] = True
        return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backend", choices=["kind", "binary", "mock", "auto"], default="auto")
    parser.add_argument("--out", default=None,
                        help="the artifact's path (default artifacts/integration_<backend>_gpu.json)")
    args = parser.parse_args(argv)

    backend = args.backend
    out_dir = Path(args.out).parent if args.out else ARTIFACTS
    if backend == "auto":
        if shutil.which("kind"):
            backend = "kind"
        elif shutil.which("kube-apiserver") and shutil.which("etcd"):
            backend = "binary"
        else:
            backend = "mock"
            constraints = record_env_constraints(out_dir / "integration_env_constraints_gpu.json")
            print(
                "kind/kube-apiserver not on PATH; falling back to the port's "
                f"mock apiserver backend (host constraints recorded: {constraints})"
            )

    backends = {"kind": backend_kind, "binary": backend_binary, "mock": backend_mock}
    result = backends[backend]()
    result["timestamp_utc"] = datetime.datetime.now(datetime.timezone.utc).isoformat()
    result["ok"] = result["rc"] == 0

    out = Path(args.out) if args.out else ARTIFACTS / f"integration_{result['backend']}_gpu.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2) + "\n")
    print(f"{'PASS' if result['ok'] else 'FAIL'} ({result['backend']}): {result['summary']}")
    print(f"artifact: {out}")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
