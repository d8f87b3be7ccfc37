"""Apiserver connection: kubeconfig parsing and in-cluster credentials (the
JAX package's ``k8s/kubeconfig.py``).

Three ways to connect, in this order of precedence (:func:`load_connection`):

1. in-cluster service-account credentials (``use_incluster_config``), with
   the token file re-read as the kubelet rotates it;
2. an explicit kubeconfig path;
3. the default kubeconfig (``$KUBECONFIG`` or ``~/.kube/config``).

The kubeconfig subset parsed: clusters (server, CA data or file,
insecure-skip-tls-verify), users (token, client cert/key as data or file,
exec credential plugins per the client.authentication.k8s.io contract),
contexts and current-context. An exec plugin is run, its ExecCredential
JSON parsed and its token cached until ``expirationTimestamp``. Interactive
plugins and the legacy ``auth-provider`` stanza raise.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import json
import logging
import os
import ssl
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import yaml

logger = logging.getLogger(__name__)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeconfigError(Exception):
    """Unreadable/unsupported kubeconfig or in-cluster environment."""


# refresh this long before expirationTimestamp so a token never expires
# mid-request (matches client-go's expiry delta)
_EXEC_EXPIRY_SKEW_S = 60.0


class ExecCredential:
    """A ``users[].user.exec`` credential plugin (client.authentication.k8s.io).

    Runs the configured command, parses the ExecCredential JSON it prints,
    caches the token, and re-runs the plugin when ``expirationTimestamp``
    (minus a skew) passes. Thread-safe: one plugin run at a time, shared by
    the pod- and node-plane clients that share a ``K8sConnection``.
    """

    def __init__(
        self,
        command: str,
        args: Optional[List[str]] = None,
        env: Optional[List[Dict[str, str]]] = None,
        api_version: str = "client.authentication.k8s.io/v1beta1",
        provide_cluster_info: bool = False,
        cluster_info: Optional[Dict[str, Any]] = None,
        timeout: float = 60.0,
    ):
        self.command = command
        self.args = list(args or [])
        self.env = list(env or [])
        self.api_version = api_version
        self.provide_cluster_info = provide_cluster_info
        self.cluster_info = cluster_info or {}
        self.timeout = timeout
        self._lock = threading.Lock()
        self._token: Optional[str] = None
        self._expires_at: Optional[float] = None  # unix seconds

    def token(self) -> str:
        with self._lock:
            if self._token is not None and not self._expired():
                return self._token
            self._refresh_locked()
            return self._token  # type: ignore[return-value]

    def invalidate(self) -> None:
        """Drop the cached token (e.g. after a 401): next use re-runs the
        plugin even if expirationTimestamp hasn't passed."""
        with self._lock:
            self._token = None
            self._expires_at = None

    def _expired(self) -> bool:
        if self._expires_at is None:
            return False  # no expirationTimestamp: cache for process life
        import time

        return time.time() >= self._expires_at - _EXEC_EXPIRY_SKEW_S

    def _refresh_locked(self) -> None:
        env = dict(os.environ)
        for entry in self.env:
            name = entry.get("name")
            if name:
                env[name] = entry.get("value", "")
        exec_info: Dict[str, Any] = {
            "apiVersion": self.api_version,
            "kind": "ExecCredential",
            "spec": {"interactive": False},
        }
        if self.provide_cluster_info:
            exec_info["spec"]["cluster"] = self.cluster_info
        env["KUBERNETES_EXEC_INFO"] = json.dumps(exec_info)
        try:
            proc = subprocess.run(
                [self.command, *self.args],
                env=env,
                capture_output=True,
                text=True,
                timeout=self.timeout,
            )
        except FileNotFoundError as exc:
            raise KubeconfigError(
                f"exec credential plugin {self.command!r} not found on PATH"
            ) from exc
        except subprocess.TimeoutExpired as exc:
            raise KubeconfigError(
                f"exec credential plugin {self.command!r} timed out after {self.timeout:.0f}s"
            ) from exc
        if proc.returncode != 0:
            raise KubeconfigError(
                f"exec credential plugin {self.command!r} failed "
                f"(rc={proc.returncode}): {proc.stderr.strip()[:500]}"
            )
        try:
            doc = json.loads(proc.stdout)
        except json.JSONDecodeError as exc:
            raise KubeconfigError(
                f"exec credential plugin {self.command!r} printed invalid JSON"
            ) from exc
        status = doc.get("status") or {}
        token = status.get("token")
        if not token:
            if status.get("clientCertificateData"):
                raise KubeconfigError(
                    f"exec credential plugin {self.command!r} returned a client "
                    "certificate; only token-based exec credentials are supported"
                )
            raise KubeconfigError(
                f"exec credential plugin {self.command!r} returned no status.token"
            )
        self._token = token
        self._expires_at = _parse_rfc3339(status.get("expirationTimestamp"))


def _parse_rfc3339(value: Optional[str]) -> Optional[float]:
    """RFC3339 timestamp -> unix seconds, or None (bad/missing → None, so
    the token is cached for the process lifetime per the exec contract)."""
    if not value:
        return None
    try:
        text = value.replace("Z", "+00:00")
        return datetime.datetime.fromisoformat(text).timestamp()
    except ValueError:
        logger.warning("exec credential: unparseable expirationTimestamp %r", value)
        return None


# bound service-account tokens are rotated on disk by the kubelet; re-read
# at most this often (client-go uses a similar period for file reloads)
_TOKEN_FILE_TTL_S = 60.0


@dataclasses.dataclass
class K8sConnection:
    """Everything needed to open an authenticated session to an API server."""

    server: str
    token: Optional[str] = None
    ca_file: Optional[str] = None
    client_cert: Optional[Tuple[str, str]] = None  # (certfile, keyfile)
    verify_tls: bool = True
    exec_credential: Optional[ExecCredential] = None
    # re-read this file for the token (in-cluster bound SA tokens rotate
    # ~hourly; a once-read token would 401 a long-lived watcher mid-life)
    token_file: Optional[str] = None

    @property
    def dynamic_auth(self) -> bool:
        """True when the token can change mid-process (exec plugin or
        rotating token file) and a 401 is worth an invalidate-and-retry."""
        return self.exec_credential is not None or self.token_file is not None

    def auth_token(self) -> Optional[str]:
        """The bearer token to send right now: exec plugins re-run on
        expiry, token files re-read on a TTL, static tokens pass through."""
        if self.exec_credential is not None:
            return self.exec_credential.token()
        if self.token_file:
            import time

            cached = getattr(self, "_file_token_cache", None)
            if cached is None or time.monotonic() - cached[1] > _TOKEN_FILE_TTL_S:
                try:
                    self.token = Path(self.token_file).read_text().strip()
                except OSError as exc:
                    logger.warning("Could not re-read token file %s: %s", self.token_file, exc)
                self._file_token_cache = (self.token, time.monotonic())
        return self.token

    def invalidate_token(self) -> None:
        """Drop cached credentials after a 401 so the next request
        re-derives them (plugin re-run / token-file re-read)."""
        if self.exec_credential is not None:
            self.exec_credential.invalidate()
        self._file_token_cache = None

    def ssl_context(self) -> ssl.SSLContext:
        """The TLS context of an https connection: the cluster's CA (or the
        system's), no verification with ``verify_tls`` off, and the client
        certificate when there is one."""
        context = ssl.create_default_context(cafile=self.ca_file if self.verify_tls else None)
        if not self.verify_tls:
            context.check_hostname = False
            context.verify_mode = ssl.CERT_NONE
        if self.client_cert:
            context.load_cert_chain(*self.client_cert)
        return context


def _materialize(data_b64: Optional[str], file_path: Optional[str], label: str) -> Optional[str]:
    """Return a filesystem path for cert material given either inline base64
    data or a path; inline data is written to a private temp file."""
    if file_path:
        return file_path
    if not data_b64:
        return None
    try:
        raw = base64.b64decode(data_b64)
    except Exception as exc:
        raise KubeconfigError(f"invalid base64 in kubeconfig {label}") from exc
    fd, path = tempfile.mkstemp(prefix=f"kwt-{label}-", suffix=".pem")
    with os.fdopen(fd, "wb") as fh:
        fh.write(raw)
    return path


def _index_by_name(items: Any, label: str) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for item in items or []:
        if isinstance(item, dict) and "name" in item:
            out[item["name"]] = item
    if not out:
        raise KubeconfigError(f"kubeconfig has no {label}")
    return out


def load_kubeconfig(path: Union[str, os.PathLike], context: Optional[str] = None) -> K8sConnection:
    """Parse a kubeconfig file into a ``K8sConnection``."""
    path = Path(path)
    if not path.exists():
        raise KubeconfigError(f"Kubeconfig file not found: {path}")
    try:
        doc = yaml.safe_load(path.read_text()) or {}
    except yaml.YAMLError as exc:
        raise KubeconfigError(f"Malformed kubeconfig {path}: {exc}") from exc

    contexts = _index_by_name(doc.get("contexts"), "contexts")
    clusters = _index_by_name(doc.get("clusters"), "clusters")
    users = _index_by_name(doc.get("users"), "users")

    ctx_name = context or doc.get("current-context")
    if not ctx_name or ctx_name not in contexts:
        raise KubeconfigError(f"kubeconfig {path}: unknown context {ctx_name!r}")
    ctx = contexts[ctx_name].get("context") or {}

    cluster_entry = clusters.get(ctx.get("cluster", ""))
    if cluster_entry is None:
        raise KubeconfigError(f"kubeconfig {path}: context references unknown cluster {ctx.get('cluster')!r}")
    cluster = cluster_entry.get("cluster") or {}
    server = cluster.get("server")
    if not server:
        raise KubeconfigError(f"kubeconfig {path}: cluster has no server URL")

    user_entry = users.get(ctx.get("user", "")) or {"user": {}}
    user = user_entry.get("user") or {}
    if "auth-provider" in user:
        # legacy stanza removed in client-go 1.26; its gcp/azure providers
        # were interactive-or-SDK-bound, so there is nothing to run headless
        raise KubeconfigError(
            f"kubeconfig {path}: legacy auth-provider credential plugins are not "
            "supported; migrate to an exec plugin (e.g. gke-gcloud-auth-plugin) "
            "or a token/client-certificate kubeconfig"
        )

    exec_credential = None
    if "exec" in user:
        # an empty/null exec stanza must fail HERE with a clear message,
        # not connect anonymously and 401 later
        exec_spec = user.get("exec") or {}
        if exec_spec.get("interactiveMode") == "Always":
            raise KubeconfigError(
                f"kubeconfig {path}: exec plugin requires interactiveMode=Always, "
                "which a headless watcher cannot satisfy"
            )
        command = exec_spec.get("command")
        if not command:
            raise KubeconfigError(f"kubeconfig {path}: exec stanza has no command")
        if os.sep in command and not os.path.isabs(command):
            # client-go contract: relative plugin paths resolve against the
            # kubeconfig's directory, not the process CWD
            command = str(path.parent / command)
        exec_credential = ExecCredential(
            command=command,
            args=exec_spec.get("args"),
            env=exec_spec.get("env"),
            api_version=exec_spec.get("apiVersion", "client.authentication.k8s.io/v1beta1"),
            provide_cluster_info=bool(exec_spec.get("provideClusterInfo")),
            cluster_info={
                "server": server,
                "certificate-authority-data": cluster.get("certificate-authority-data"),
                "insecure-skip-tls-verify": bool(cluster.get("insecure-skip-tls-verify", False)),
            },
        )

    ca_file = _materialize(cluster.get("certificate-authority-data"), cluster.get("certificate-authority"), "ca")
    cert_file = _materialize(user.get("client-certificate-data"), user.get("client-certificate"), "cert")
    key_file = _materialize(user.get("client-key-data"), user.get("client-key"), "key")
    client_cert = (cert_file, key_file) if cert_file and key_file else None

    return K8sConnection(
        server=server.rstrip("/"),
        token=user.get("token"),
        ca_file=ca_file,
        client_cert=client_cert,
        verify_tls=not cluster.get("insecure-skip-tls-verify", False),
        exec_credential=exec_credential,
    )


def load_incluster(sa_dir: Union[str, os.PathLike] = SERVICE_ACCOUNT_DIR) -> K8sConnection:
    """Build a connection from the pod's mounted service-account credentials."""
    sa_dir = Path(sa_dir)
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = sa_dir / "token"
    if not host or not token_path.exists():
        raise KubeconfigError(
            "Not running in a cluster: KUBERNETES_SERVICE_HOST unset or service-account token missing"
        )
    ca_path = sa_dir / "ca.crt"
    return K8sConnection(
        server=f"https://{host}:{port}",
        token=token_path.read_text().strip(),
        ca_file=str(ca_path) if ca_path.exists() else None,
        # bound SA tokens rotate on disk ~hourly; keep re-reading
        token_file=str(token_path),
    )


def load_connection(
    *,
    use_incluster: bool = False,
    config_file: Optional[str] = None,
    verify_tls: bool = True,
) -> K8sConnection:
    """Resolve a connection: in-cluster, explicit kubeconfig, default
    kubeconfig (``$KUBECONFIG`` or ``~/.kube/config``)."""
    if use_incluster:
        logger.info("Using in-cluster configuration")
        conn = load_incluster()
    elif config_file:
        logger.info("Loading kubeconfig from: %s", config_file)
        conn = load_kubeconfig(config_file)
    else:
        default = os.environ.get("KUBECONFIG", str(Path.home() / ".kube" / "config"))
        logger.info("Using default kubeconfig: %s", default)
        conn = load_kubeconfig(default)
    if not verify_tls:
        conn.verify_tls = False
    return conn
