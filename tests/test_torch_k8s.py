"""The port's apiserver connection and node client held against the JAX
package's: the kubeconfig, exec-credential and rotating-token cases of
``tests/test_k8s.py`` run through both packages against the in-repo mock
apiserver, and the node surface remediation uses (version, paged node list,
get, merge-patch, error mapping) compared call for call."""

import sys
import textwrap

import pytest

from k8s_watcher_tpu.k8s import client as ref_client
from k8s_watcher_tpu.k8s import kubeconfig as ref_kubeconfig
from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu_torch.k8s import client as port_client
from k8s_watcher_tpu_torch.k8s import kubeconfig as port_kubeconfig
from k8s_watcher_tpu_torch.metrics import MetricsRegistry

PACKAGES = {"ref": (ref_client, ref_kubeconfig, RefRegistry), "port": (port_client, port_kubeconfig, MetricsRegistry)}

KUBECONFIG_YAML = """
apiVersion: v1
kind: Config
clusters:
- cluster:
    server: {server}
  name: mock
contexts:
- context:
    cluster: mock
    user: mockuser
  name: mock
current-context: mock
users:
- name: mockuser
  user:
    token: test-token-123
"""

EXEC_KUBECONFIG_YAML = """
apiVersion: v1
kind: Config
clusters:
- cluster:
    server: {server}
  name: mock
contexts:
- context:
    cluster: mock
    user: execuser
  name: mock
current-context: mock
users:
- name: execuser
  user:
    exec:
      apiVersion: client.authentication.k8s.io/v1beta1
      command: {command}
      args: [{args}]
      env:
      - name: FAKE_PLUGIN_MARKER
        value: marker-value
      interactiveMode: Never
"""


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return request.param


def node_cluster():
    cluster = MockCluster()
    for i in range(7):
        cluster.add_node({"metadata": {"name": f"node-{i}", "labels": {"pool": "a" if i % 2 else "b"}},
                          "spec": {}})
    return cluster


@pytest.fixture
def mock_api():
    with MockApiServer(node_cluster()) as server:
        yield server


def fake_plugin(tmp_path, *, token="exec-token-1", expiry_s=None, fail=False):
    """An exec credential plugin that counts its runs in calls.txt."""
    script, calls = tmp_path / "fake-auth-plugin.py", tmp_path / "calls.txt"
    expiry = ""
    if expiry_s is not None:
        expiry = (f"exp = datetime.datetime.now(datetime.timezone.utc) + datetime.timedelta(seconds={expiry_s})\n"
                  "status['expirationTimestamp'] = exp.strftime('%Y-%m-%dT%H:%M:%SZ')\n")
    script.write_text(textwrap.dedent(f"""
        import datetime, json, os, sys
        assert json.loads(os.environ["KUBERNETES_EXEC_INFO"])["kind"] == "ExecCredential"
        assert os.environ.get("FAKE_PLUGIN_MARKER") == "marker-value"
        with open({str(calls)!r}, "a") as fh:
            fh.write("call\\n")
        if {fail!r}:
            print("simulated auth failure", file=sys.stderr)
            sys.exit(3)
        status = {{"token": {token!r}}}
    """) + expiry + 'print(json.dumps({"kind": "ExecCredential", "status": status}))\n')
    return script, calls


def exec_kubeconfig(tmp_path, script, server="https://k8s.example:6443"):
    p = tmp_path / "config"
    p.write_text(EXEC_KUBECONFIG_YAML.format(server=server, command=sys.executable, args=f'"{script}"'))
    return p


def runs(calls):
    return calls.read_text().count("call")


def test_token_kubeconfig_parses_alike(tmp_path):
    p = tmp_path / "config"
    p.write_text(KUBECONFIG_YAML.format(server="https://k8s.example:6443/"))
    want = ref_kubeconfig.load_connection(config_file=str(p), verify_tls=False)
    got = port_kubeconfig.load_connection(config_file=str(p), verify_tls=False)
    assert (got.server, got.token, got.ca_file, got.client_cert, got.verify_tls, got.dynamic_auth) == (
        want.server, want.token, want.ca_file, want.client_cert, want.verify_tls, want.dynamic_auth)
    assert got.server == "https://k8s.example:6443" and got.token == "test-token-123"


def test_cert_material_is_materialized_alike(tmp_path):
    import base64

    p = tmp_path / "config"
    text = KUBECONFIG_YAML.format(server="https://k8s.example:6443").replace(
        "    server: https://k8s.example:6443",
        "    server: https://k8s.example:6443\n"
        f"    certificate-authority-data: {base64.b64encode(b'CA PEM').decode()}\n"
        "    insecure-skip-tls-verify: true",
    ).replace("    token: test-token-123",
              "    token: test-token-123\n"
              f"    client-certificate-data: {base64.b64encode(b'CERT').decode()}\n"
              f"    client-key-data: {base64.b64encode(b'KEY').decode()}")
    p.write_text(text)
    want, got = ref_kubeconfig.load_kubeconfig(p), port_kubeconfig.load_kubeconfig(p)
    read = lambda path: open(path, "rb").read()  # noqa: E731
    assert read(got.ca_file) == read(want.ca_file) == b"CA PEM"
    assert [read(f) for f in got.client_cert] == [read(f) for f in want.client_cert] == [b"CERT", b"KEY"]
    assert got.verify_tls is want.verify_tls is False


@pytest.mark.parametrize("case, text, match", [
    ("missing", None, "not found"),
    ("interactive", EXEC_KUBECONFIG_YAML.format(server="https://x:1", command="whatever", args='"x"').replace(
        "interactiveMode: Never", "interactiveMode: Always"), "interactiveMode"),
    ("auth-provider", KUBECONFIG_YAML.format(server="https://x:1").replace(
        "token: test-token-123", "auth-provider: {name: gcp}"), "auth-provider"),
    ("empty-exec", KUBECONFIG_YAML.format(server="https://x:1").replace("token: test-token-123", "exec: {}"),
     "no command"),
    ("unknown-context", KUBECONFIG_YAML.format(server="https://x:1").replace("current-context: mock",
                                                                           "current-context: other"), "context"),
    ("no-server", KUBECONFIG_YAML.replace("    server: {server}\n", ""), "no server"),
])
def test_bad_kubeconfigs_rejected_alike(tmp_path, pkg, case, text, match):
    p = tmp_path / "config"
    if text is not None:
        p.write_text(text)
    with pytest.raises(PACKAGES[pkg][1].KubeconfigError, match=match):
        PACKAGES[pkg][1].load_kubeconfig(p)


def test_incluster_requires_env_and_carries_token_file(tmp_path, pkg, monkeypatch):
    kubeconfig = PACKAGES[pkg][1]
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(kubeconfig.KubeconfigError, match="Not running in a cluster"):
        kubeconfig.load_connection(use_incluster=True)
    (tmp_path / "token").write_text("sa-token\n")
    (tmp_path / "ca.crt").write_text("ca")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    conn = kubeconfig.load_incluster(sa_dir=tmp_path)
    assert (conn.server, conn.token, conn.ca_file, conn.token_file, conn.dynamic_auth) == (
        "https://10.0.0.1:443", "sa-token", str(tmp_path / "ca.crt"), str(tmp_path / "token"), True)


@pytest.mark.parametrize("expiry_s, want_runs", [(None, 1), (5, 2)])
def test_exec_token_cached_until_expiry(tmp_path, pkg, expiry_s, want_runs):
    script, calls = fake_plugin(tmp_path, token="tok-A", expiry_s=expiry_s)
    conn = PACKAGES[pkg][1].load_kubeconfig(exec_kubeconfig(tmp_path, script))
    assert conn.auth_token() == conn.auth_token() == "tok-A"
    assert runs(calls) == want_runs
    conn.exec_credential.invalidate()
    assert conn.auth_token() == "tok-A" and runs(calls) == want_runs + 1


def test_exec_token_rides_requests_and_401_reruns_the_plugin(tmp_path, pkg, mock_api):
    client_mod, kubeconfig, _ = PACKAGES[pkg]
    script, calls = fake_plugin(tmp_path, token="tok-C")
    client = client_mod.K8sClient(kubeconfig.load_kubeconfig(exec_kubeconfig(tmp_path, script, mock_api.url)),
                                  request_timeout=5.0)
    assert client.get_api_version().startswith("v")
    assert mock_api.request_headers[-1].get("Authorization") == "Bearer tok-C"
    before = runs(calls)
    mock_api.cluster.fail_next(status=401)
    assert client.get_node("node-0")["metadata"]["name"] == "node-0"
    assert runs(calls) == before + 1


def test_plugin_failure_surfaces_as_api_error(tmp_path, pkg, mock_api):
    client_mod, kubeconfig, _ = PACKAGES[pkg]
    script, _ = fake_plugin(tmp_path, fail=True)
    conn = kubeconfig.load_kubeconfig(exec_kubeconfig(tmp_path, script, mock_api.url))
    with pytest.raises(kubeconfig.KubeconfigError, match="simulated auth failure"):
        conn.auth_token()
    with pytest.raises(client_mod.K8sApiError, match="credential refresh failed"):
        client_mod.K8sClient(conn, request_timeout=5.0).get_api_version()


def test_401_rereads_a_rotated_token_file(tmp_path, pkg, mock_api):
    client_mod, kubeconfig, _ = PACKAGES[pkg]
    token_file = tmp_path / "token"
    token_file.write_text("stale-token")
    client = client_mod.K8sClient(kubeconfig.K8sConnection(server=mock_api.url, token="stale-token",
                                                           token_file=str(token_file)), request_timeout=5.0)
    client.get_api_version()
    token_file.write_text("fresh-token")
    mock_api.cluster.fail_next(status=401)
    client.get_api_version()
    assert mock_api.request_headers[-1]["Authorization"] == "Bearer fresh-token"


def test_static_401_is_not_retried(pkg, mock_api):
    client_mod, kubeconfig, _ = PACKAGES[pkg]
    client = client_mod.K8sClient(kubeconfig.K8sConnection(server=mock_api.url, token="t"), request_timeout=5.0)
    n = len(mock_api.request_headers)
    mock_api.cluster.fail_next(status=401)
    with pytest.raises(client_mod.K8sApiError) as info:
        client.get_api_version()
    assert info.value.status == 401 and len(mock_api.request_headers) == n + 1


def _node_calls(pkg, server):
    client_mod, kubeconfig, registry_cls = PACKAGES[pkg]
    client = client_mod.K8sClient(kubeconfig.K8sConnection(server=server.url), request_timeout=5.0)
    metrics = registry_cls()
    pages = list(client_mod.K8sClient.iter_list_pages(client.list_nodes_paged(page_size=3), metrics=metrics,
                                                      metric_prefix="adopt_scan"))
    out = {
        "version": client.get_api_version(),
        "pages": [(rv is not None, [n["metadata"]["name"] for n in items], changed) for rv, items, changed in pages],
        "selected": [n["metadata"]["name"] for n in client.list_nodes(label_selector="pool=a")["items"]],
        "metrics": (metrics.counter("adopt_scans").value, metrics.counter("adopt_scan_pages").value,
                    metrics.histogram("adopt_scan_duration").count),
        "patched": client.patch_node("node-1", {"spec": {"unschedulable": True, "taints": [{"key": "k"}]}})["spec"],
        "unpatched": client.patch_node("node-1", {"spec": {"unschedulable": None}})["spec"],
    }
    for name, call in (("missing", lambda: client.get_node("nope")),
                       ("conflict", lambda: client.patch_node("node-2", {"metadata": {"resourceVersion": "1"},
                                                                          "spec": {}})),
                       ("server_error", lambda: (server.cluster.fail_next(1, status=503), client.get_node("node-0"))),
                       ("bad_token", lambda: client.list_nodes(continue_token="garbage", limit=2))):
        try:
            call()
            out[name] = None
        except client_mod.K8sApiError as exc:
            out[name] = (type(exc).__name__, exc.status)
    return out


def test_node_surface_matches(mock_api):
    want = _node_calls("ref", mock_api)
    with MockApiServer(node_cluster()) as other:
        got = _node_calls("port", other)
    assert got == want
    assert [names for _, names, _ in got["pages"]] == [["node-0", "node-1", "node-2"], ["node-3", "node-4", "node-5"],
                                                       ["node-6"]]
    assert got["metrics"] == (1, 3, 1) and got["missing"] == ("K8sNotFoundError", 404)
    assert got["conflict"] == ("K8sConflictError", 409)


def test_https_client_builds_its_tls_context_from_the_connection(tmp_path):
    conn = port_kubeconfig.K8sConnection(server="https://k8s.example:6443", verify_tls=False)
    client = port_client.K8sClient(conn)
    assert client._ssl_context is not None and not client._ssl_context.check_hostname
    assert port_client.K8sClient(port_kubeconfig.K8sConnection(server="http://h:1"))._ssl_context is None
    with pytest.raises(ValueError):
        port_client.K8sClient(port_kubeconfig.K8sConnection(server="ftp://h"))
