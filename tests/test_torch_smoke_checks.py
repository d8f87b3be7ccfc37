"""The port's connection checks and integration tier held against the JAX
package's ``scripts/check_connection.py``, ``scripts/check_mock.py`` and
``scripts/run_integration_tier.py``.

Both packages' ``check_connection`` and ``check_mock`` run against one of the
port's ``MockApiServer``s: for a good kubeconfig they print the same lines
(``check_mock``: the same step and verdict markers; its bounded watch sees
churn whose timing differs) and return True; for a missing kubeconfig and
for one pointing at a closed port they return False after the same lines.
``python -m k8s_watcher_tpu_torch.integration_tier --backend mock`` runs
``tests/test_torch_integration_cluster.py`` (``--noconftest``) against the
port's mock: ``ok``, ``backend: mock``, ``write_tier: true``, with the same
``rc`` and passed count as the reference runner's ``backend_mock``. With
``--backend auto`` on a host without kind or kube-apiserver it falls back to
the mock and records the missing binaries beside its artifact.
"""

import contextlib
import importlib.util
import io
import json
import re
import shutil
import threading
import time
from pathlib import Path

import pytest

from k8s_watcher_tpu_torch import check_connection, check_mock, integration_tier
from k8s_watcher_tpu_torch.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.smoke_common import free_port, write_kubeconfig
from k8s_watcher_tpu_torch.watch.fake import build_pod

REPO = Path(__file__).resolve().parent.parent
_MARKER = re.compile(r"^(\d\.|   (OK|FAIL|WARN) -|Mock diagnostics complete|All connectivity checks passed)")


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(fn, kubeconfig: str) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ok = fn(kubeconfig)
    return ok, out.getvalue().splitlines()


@pytest.fixture
def mock(tmp_path):
    with MockApiServer() as server:
        for i in range(3):
            server.cluster.add_pod(build_pod(f"check-pod-{i}", "default", uid=f"check-uid-{i}", tpu_chips=4))
        yield server, write_kubeconfig(tmp_path / "kubeconfig.json", server.url)


def test_check_connection_same_lines_as_the_reference(mock):
    _, kubeconfig = mock
    ref_ok, ref_lines = _run(_reference("check_connection").check_connection, kubeconfig)
    ok, lines = _run(check_connection.check_connection, kubeconfig)
    assert ref_ok is ok is True
    assert lines == ref_lines and lines[-1] == "All connectivity checks passed"


def test_check_mock_same_markers_as_the_reference(mock):
    server, kubeconfig = mock
    stop = threading.Event()

    def churn():
        phases, r = ("Running", "Pending"), 0
        while not stop.wait(0.05):
            server.cluster.set_phase("default", f"check-pod-{r % 3}", phases[(r // 3) % 2])
            r += 1

    churner = threading.Thread(target=churn, daemon=True)
    churner.start()
    try:
        ref_ok, ref_lines = _run(_reference("check_mock").check_mock, kubeconfig)
        ok, lines = _run(check_mock.check_mock, kubeconfig)
    finally:
        stop.set()
        churner.join(timeout=5)
    assert ref_ok is ok is True
    markers = [[line.split(" - ")[0] for line in side if _MARKER.match(line)] for side in (ref_lines, lines)]
    assert markers[0] == markers[1] and markers[1][-1] == "Mock diagnostics complete"
    assert sum(line.startswith("   event:") for line in lines) >= 1


@pytest.mark.parametrize("bad", ["missing", "closed_port"])
@pytest.mark.parametrize("check", ["check_connection", "check_mock"])
def test_bad_kubeconfig_same_return_and_lines(bad, check, tmp_path):
    if bad == "missing":
        kubeconfig = str(tmp_path / "no-such-kubeconfig")
    else:
        kubeconfig = write_kubeconfig(tmp_path / "kubeconfig.json", f"http://127.0.0.1:{free_port()}")
    ref_ok, ref_lines = _run(getattr(_reference(check), check), kubeconfig)
    ok, lines = _run(getattr({"check_connection": check_connection, "check_mock": check_mock}[check], check),
                     kubeconfig)
    assert ref_ok is ok is False
    assert [line.split(" - ")[0] for line in lines] == [line.split(" - ")[0] for line in ref_lines]
    assert lines[-1].startswith("   FAIL - ")


def _passed(summary: str) -> int:
    match = re.search(r"(\d+) passed", summary)
    return int(match.group(1)) if match else 0


def test_integration_tier_mock_matches_the_reference_runner(tmp_path):
    out = tmp_path / "integration.json"
    t0 = time.monotonic()
    assert integration_tier.main(["--backend", "mock", "--out", str(out)]) == 0
    port = json.loads(out.read_text())
    assert port["ok"] is True and port["backend"] == "mock" and port["write_tier"] is True
    assert time.monotonic() - t0 < 300
    reference = _reference("run_integration_tier").backend_mock()
    assert reference["rc"] == port["rc"] == 0
    assert _passed(reference["summary"]) == _passed(port["summary"]) == 4


@pytest.mark.skipif(bool(shutil.which("kind") or (shutil.which("kube-apiserver") and shutil.which("etcd"))),
                    reason="this host can run a real apiserver tier; auto would not fall back to the mock")
def test_integration_tier_auto_falls_back_to_the_mock_and_records_why(tmp_path):
    out = tmp_path / "integration.json"
    assert integration_tier.main(["--backend", "auto", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["backend"] == "mock"
    constraints = json.loads((tmp_path / "integration_env_constraints_gpu.json").read_text())
    missing = sorted(b for b, path in constraints["binaries"].items() if path == "absent")
    assert "kind" in missing and constraints["egress"] == "not probed"
    assert f"missing binaries: {', '.join(missing)}" in constraints["conclusion"]
