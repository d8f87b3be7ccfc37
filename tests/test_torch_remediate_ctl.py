"""The port's operator CLI (``python -m k8s_watcher_tpu_torch.remediate_ctl``)
held against the JAX package's ``scripts/remediate_ctl.py``.

Each CLI runs against its own package's mock apiserver holding the same
nodes (one already quarantined by an earlier run, one cordoned by someone
else), from a config directory whose kubeconfig points at that server. The
same commands in the same order (``status``, ``quarantine`` and ``release``
with and without ``--no-dry-run``, ``health`` against a stub status
server and an unreachable one, ``health release``, and the usage errors)
must give the same exit codes, print the same output and send the same
PATCH bodies, in ``development`` and in ``production``.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import yaml

from k8s_watcher_tpu.k8s import mock_server as ref_mock
from k8s_watcher_tpu_torch import remediate_ctl
from k8s_watcher_tpu_torch.k8s import mock_server

REPO = Path(__file__).resolve().parent.parent
TAINT = {"key": "k8s-watcher-tpu/ici-fault", "value": "suspect", "effect": "NoSchedule"}
KUBECONFIG = """
apiVersion: v1
kind: Config
clusters:
- cluster:
    server: {server}
  name: mock
contexts:
- context:
    cluster: mock
    user: u
  name: mock
current-context: mock
users:
- name: u
  user:
    token: t
"""
COMMANDS = [
    ["status"],
    ["quarantine", "tpu-node-1"],
    ["quarantine", "tpu-node-1", "--no-dry-run", "--reason=hbm block 3 failed readback"],
    ["status"],
    ["release", "tpu-node-1"],
    ["release", "tpu-node-1", "--no-dry-run"],
    ["health", "release", "tpu-node-0", "--no-dry-run"],
    ["status"],
    ["quarantine", "no-such-node", "--no-dry-run"],
    ["quarantine"],
    ["health", "release"],
    [],
    ["frobnicate"],
]


HEALTH = {"health": {"suspect_z": 4.0, "subjects": {"node/tpu-node-1": {"state": "confirmed", "score": 0.16}}}}


class _Health(BaseHTTPRequestHandler):
    """A watcher's ``GET /debug/health``; records each Authorization header."""

    seen: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):  # noqa: N802
        self.seen.append((self.path, self.headers.get("Authorization")))
        data = json.dumps(HEALTH).encode()
        self.send_response(200 if self.path == "/debug/health" else 404)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def health_url():
    server = ThreadingHTTPServer(("127.0.0.1", 0), type("Health", (_Health,), {"seen": []}))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server.RequestHandlerClass.seen
    server.shutdown()
    server.server_close()


def _cluster(mock):
    cluster = mock.MockCluster()
    for i, spec in enumerate(({"unschedulable": True, "taints": [TAINT]}, {}, {"unschedulable": True}, {})):
        cluster.add_node({"metadata": {"name": f"tpu-node-{i}", "labels": {"pool": "tpu"}}, "spec": spec,
                          "status": {"conditions": [{"type": "Ready", "status": "True"}]}})
    return cluster


def config_dir(tmp_path, environment, server_url):
    """``tmp_path`` holding ``config/`` (the repo's base and ``environment``
    files, the latter pointed at ``server_url``'s kubeconfig)."""
    (tmp_path / "config").mkdir(parents=True)
    (tmp_path / "kubeconfig").write_text(KUBECONFIG.format(server=server_url))
    (tmp_path / "config" / "base.yaml").write_text((REPO / "config" / "base.yaml").read_text())
    overlay = yaml.safe_load((REPO / "config" / f"{environment}.yaml").read_text())
    overlay.setdefault("kubernetes", {}).update(use_incluster_config=False, use_mock=False,
                                                config_file=str(tmp_path / "kubeconfig"))
    (tmp_path / "config" / f"{environment}.yaml").write_text(yaml.safe_dump(overlay))
    return tmp_path


def _reference_main():
    spec = importlib.util.spec_from_file_location("ref_remediate_ctl", REPO / "scripts" / "remediate_ctl.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def run_cli(pkg, environment, tmp_path, monkeypatch, capsys, health_url):
    """Every command of ``COMMANDS``, then the ``health`` reads, through
    ``pkg``'s CLI; ``(exit code, stdout)`` per command, the PATCH bodies and
    the nodes left."""
    commands = COMMANDS + [["health", f"--url={health_url}/", "--token=operator"],
                           ["health", "--url=http://127.0.0.1:9"]]
    mock = ref_mock if pkg == "ref" else mock_server
    cluster = _cluster(mock)
    patches = []
    patch_node = cluster.patch_node

    def recording_patch(name, body):
        patches.append((name, body))
        return patch_node(name, body)

    cluster.patch_node = recording_patch
    main = _reference_main() if pkg == "ref" else remediate_ctl.main
    out = []
    with mock.MockApiServer(cluster) as server:
        monkeypatch.chdir(config_dir(tmp_path / pkg, environment, server.url))
        for argv in commands:
            capsys.readouterr()
            if pkg == "ref":
                monkeypatch.setattr(sys, "argv", ["remediate_ctl.py", environment, *argv])
                rc = main()
            else:
                rc = main([environment, *argv])
            printed = capsys.readouterr().out
            usage = rc == 2 and not printed.startswith("{")
            out.append((argv, rc, printed if usage else json.loads(printed or "null")))
    nodes = {n["metadata"]["name"]: n["spec"] for n in json.loads(cluster.list_nodes()[1].encode())["items"]}
    return out, patches, nodes


def usage_lines(text):
    return [line.strip() for line in text.splitlines() if line.strip().startswith("python ")]


@pytest.mark.parametrize("environment", ["development", "production"])
def test_same_commands_same_output_and_patches(environment, tmp_path, monkeypatch, capsys, health_url):
    monkeypatch.setenv("PROD_CLUSTERAPI_API_KEY", "k")
    url, seen = health_url
    ref = run_cli("ref", environment, tmp_path, monkeypatch, capsys, url)
    got = run_cli("port", environment, tmp_path, monkeypatch, capsys, url)
    ref_out, ref_patches, ref_nodes = ref
    out, patches, nodes = got
    for (argv, rc, printed), (_, ref_rc, ref_printed) in zip(out, ref_out):
        assert rc == ref_rc, argv
        if isinstance(ref_printed, str) and "Usage:" in ref_printed:
            # the same usage lines, each naming its own package's command
            assert usage_lines(printed) == usage_lines(ref_printed.replace(
                "python scripts/remediate_ctl.py", "python -m k8s_watcher_tpu_torch.remediate_ctl")), argv
            continue
        assert printed == ref_printed, argv
    assert patches == ref_patches
    assert nodes == ref_nodes
    # what the commands did
    rcs = [rc for _, rc, _ in out]
    assert rcs == [0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 0, 1]
    assert out[-2][2] == HEALTH and seen == [("/debug/health", "Bearer operator")] * 2
    status = [printed for argv, _, printed in out if argv == ["status"]]
    assert [[q["node"] for q in s["quarantined"]] for s in status] == [
        ["tpu-node-0", "tpu-node-2"], ["tpu-node-0", "tpu-node-1", "tpu-node-2"], ["tpu-node-2"]]
    assert out[1][2]["dry_run"] is True and out[1][2]["applied"] is False
    assert out[2][2]["applied"] is True and out[2][2]["reason"] == "hbm block 3 failed readback"
    assert [name for name, _ in patches] == ["tpu-node-1", "tpu-node-1", "tpu-node-0"]
    assert nodes["tpu-node-1"] == {} and nodes["tpu-node-0"] == {} and nodes["tpu-node-2"] == {"unschedulable": True}


def test_the_module_entry_point_reports_status_and_an_unreachable_apiserver(tmp_path):
    """``python -m k8s_watcher_tpu_torch.remediate_ctl`` from a config
    directory: ``status`` lists the quarantined nodes; with the apiserver
    gone it exits non-zero, as the JAX package's CLI does."""
    env = {k: v for k, v in os.environ.items() if k != "ENVIRONMENT"}
    env["PYTHONPATH"] = str(REPO)
    cmd = [sys.executable, "-m", "k8s_watcher_tpu_torch.remediate_ctl", "development", "status"]
    with mock_server.MockApiServer(_cluster(mock_server)) as server:
        cwd = config_dir(tmp_path, "development", server.url)
        t0 = time.monotonic()
        proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
        wall = time.monotonic() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [q["node"] for q in json.loads(proc.stdout)["quarantined"]] == ["tpu-node-0", "tpu-node-2"]
    assert "jax" not in proc.stderr and wall < 120
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
