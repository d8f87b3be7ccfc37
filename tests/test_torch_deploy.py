"""The port's GPU manifests and image, checked against the code they run.

``deploy/gpu-probe-daemonset.yaml`` (one ``torchrun`` group per node) and
``deploy/gpu-probe-statefulset.yaml`` (one group across N nodes) must run the
port's probe agent, set the environment its modules read, use the
ServiceAccount ``deploy/rbac.yaml`` defines and expose the status port the
``production`` settings serve. The StatefulSet's own container command runs
here as two ``torchrun`` agents on 127.0.0.1 (its two nodes), each with two
CPU ranks, ``--once --cpu`` and a small-size overlay. ``deploy/Dockerfile.gpu``
copies only paths that exist. Nobody builds the image here: there is no
``nvcc`` and no network.
"""

import inspect
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml

from k8s_watcher_tpu_torch.config import load_agent_config
from k8s_watcher_tpu_torch.parallel import mesh
from k8s_watcher_tpu_torch.probe import device

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy"
MODULE = "k8s_watcher_tpu_torch.probe_agent"
# what torchrun sets for each rank it starts
TORCHRUN_ENV = {"MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"}


def _docs(name):
    return list(yaml.safe_load_all((DEPLOY / name).read_text()))


def _kind(docs, kind):
    (doc,) = [d for d in docs if d["kind"] == kind]
    return doc


def _container(workload):
    (container,) = workload["spec"]["template"]["spec"]["containers"]
    return container


@pytest.fixture(scope="module")
def daemonset():
    return _docs("gpu-probe-daemonset.yaml")


@pytest.fixture(scope="module")
def statefulset():
    return _docs("gpu-probe-statefulset.yaml")


@pytest.fixture(scope="module")
def production():
    return load_agent_config("production", REPO / "config", env={"PROD_CLUSTERAPI_API_KEY": "k"})


@pytest.mark.parametrize("name", ["gpu-probe-daemonset.yaml", "gpu-probe-statefulset.yaml"])
def test_the_container_runs_the_ports_agent_under_torchrun(name, production):
    docs = _docs(name)
    workload = _kind(docs, "DaemonSet" if "daemonset" in name else "StatefulSet")
    container = _container(workload)
    command = container["command"]
    assert command[0] == "torchrun" and "--nproc-per-node=gpu" in command
    assert command[-3:] == ["-m", MODULE, "production"]
    assert (REPO / (MODULE.replace(".", "/") + ".py")).is_file()
    env = {e["name"]: e for e in container["env"]}
    # every $(VAR) of the command is set in the container's env
    assert set(re.findall(r"\$\((\w+)\)", " ".join(command))) <= set(env)
    # the node name the identity gather carries; torchrun sets the rest of
    # what parallel/mesh.py and probe/device.py read
    assert env["NODE_NAME"]["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName"
    read = set(re.findall(r'"([A-Z_]+)"', inspect.getsource(mesh) + inspect.getsource(device)))
    assert "NODE_NAME" in read and read - {"NODE_NAME"} <= TORCHRUN_ENV
    assert not TORCHRUN_ENV & set(env)
    # the secrets are the ones the production settings substitute
    settings = (REPO / "config" / "production.yaml").read_text()
    for secret in ("PROD_CLUSTERAPI_API_KEY", "WATCHER_STATUS_TOKEN"):
        assert "${" + secret in settings and "secretKeyRef" in env[secret]["valueFrom"]
    assert env["WATCHER_STATUS_TOKEN"]["valueFrom"]["secretKeyRef"]["optional"] is True
    spec = workload["spec"]["template"]["spec"]
    accounts = [d["metadata"]["name"] for d in _docs("rbac.yaml") if d["kind"] == "ServiceAccount"]
    assert spec["serviceAccountName"] == "k8s-watcher-tpu-probe" in accounts
    (port,) = [p for p in container["ports"] if p["name"] == "probe-status"]
    assert port["containerPort"] == production.tpu.probe_status_port == 8081
    assert spec["nodeSelector"] == {"nvidia.com/gpu.present": "true"}
    assert {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"} in spec["tolerations"]
    assert container["resources"]["requests"]["nvidia.com/gpu"] == container["resources"]["limits"][
        "nvidia.com/gpu"] == 8


def test_daemonset_is_one_group_per_node_with_a_liveness_probe(daemonset):
    workload = _kind(daemonset, "DaemonSet")
    container = _container(workload)
    assert "--standalone" in container["command"] and "--nnodes=1" in container["command"]
    labels = workload["spec"]["template"]["metadata"]["labels"]
    assert labels == workload["spec"]["selector"]["matchLabels"] == {"app": "k8s-watcher-gpu-probe"}
    assert container["livenessProbe"]["httpGet"] == {"path": "/healthz", "port": "probe-status"}
    policy = _kind(daemonset, "NetworkPolicy")
    assert policy["spec"]["podSelector"]["matchLabels"] == labels
    (rule,) = policy["spec"]["ingress"]
    assert rule["ports"] == [{"protocol": "TCP", "port": 8081}]
    assert rule["from"] == [{"podSelector": {"matchLabels": {"app.kubernetes.io/name": "prometheus"}}}]
    # the repository's other NetworkPolicies select other pods
    others = [d["spec"]["podSelector"] for d in _docs("network-policy.yaml")]
    assert all(s["matchLabels"] != labels for s in others)


def _flags(command):
    return dict(a[2:].split("=", 1) for a in command if a.startswith("--") and "=" in a)


def test_statefulset_gives_each_node_its_rank_and_one_master(statefulset):
    service, workload = _kind(statefulset, "Service"), _kind(statefulset, "StatefulSet")
    assert service["spec"]["clusterIP"] == "None" and service["spec"]["publishNotReadyAddresses"] is True
    assert [p["port"] for p in service["spec"]["ports"]] == [29500]
    spec = workload["spec"]
    assert spec["serviceName"] == service["metadata"]["name"] and spec["podManagementPolicy"] == "Parallel"
    labels = spec["template"]["metadata"]["labels"]
    assert service["spec"]["selector"] == labels == spec["selector"]["matchLabels"]
    pod = spec["template"]["spec"]
    (term,) = pod["affinity"]["podAntiAffinity"]["requiredDuringSchedulingIgnoredDuringExecution"]
    assert term["topologyKey"] == "kubernetes.io/hostname" and term["labelSelector"]["matchLabels"] == labels
    assert pod["hostNetwork"] is True and pod["dnsPolicy"] == "ClusterFirstWithHostNet"
    container = _container(workload)
    assert "livenessProbe" not in container
    flags = _flags(container["command"])
    namespace = workload["metadata"]["namespace"]
    assert flags["master-addr"] == (
        f"{workload['metadata']['name']}-0.{service['metadata']['name']}.{namespace}.svc.cluster.local")
    assert flags["master-port"] == "29500" and flags["nnodes"] == "$(NNODES)" and flags["node-rank"] == "$(POD_INDEX)"
    env = {e["name"]: e for e in container["env"]}
    assert env["NNODES"]["value"] == str(spec["replicas"])
    assert env["POD_INDEX"]["valueFrom"]["fieldRef"]["fieldPath"] == "metadata.labels['apps.kubernetes.io/pod-index']"


def test_dockerfile_copies_what_exists_and_builds_the_kernels():
    text = (DEPLOY / "Dockerfile.gpu").read_text()
    lines = [line.strip() for line in text.replace("\\\n", " ").splitlines() if line.strip()
             and not line.startswith("#")]
    assert lines[0].startswith("FROM nvidia/cuda:") and "-devel-" in lines[0]
    copies = [line.split()[1:-1] for line in lines if line.startswith("COPY")]
    assert copies and all((REPO / src).exists() for sources in copies for src in sources)
    assert sorted(src for sources in copies for src in sources) == ["config/", "k8s_watcher_tpu_torch/"]
    assert 'RUN python -c "from k8s_watcher_tpu_torch.kernels import build; build.build()"' in lines
    from k8s_watcher_tpu_torch.kernels import build

    assert callable(build.build) and all(src.is_file() for src in build.SOURCES)
    cmd = json.loads(next(line for line in lines if line.startswith("CMD"))[3:])
    assert cmd == _container(_kind(_docs("gpu-probe-daemonset.yaml"), "DaemonSet"))["command"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_statefulset_command_forms_one_group_across_two_nodes(statefulset, tmp_path):
    """Two ``torchrun`` agents run the StatefulSet's own argv, node ranks 0
    and 1 of ``NNODES=2``, two ranks each, with the master address on
    127.0.0.1 and ``--once --cpu`` appended: one group of 4 ranks over 2 nodes,
    and every rank's report names all of them."""
    container = _container(_kind(statefulset, "StatefulSet"))
    port = _free_port()
    config_dir = tmp_path / "config"
    config_dir.mkdir()
    shutil.copy(REPO / "config" / "base.yaml", config_dir / "base.yaml")
    overlay = yaml.safe_load((REPO / "config" / "production.yaml").read_text())
    # small sizes, and latency limits far above a loaded CPU's jitter: the
    # test asserts the group's shape, not its latency
    overlay["tpu"]["probe"].update({"hbm_bytes": 2 << 20, "matmul_size": 64, "payload_bytes": 4096,
                                    "link_rtt_floor_ms": 250.0, "rtt_warn_ms": 1000.0})
    (config_dir / "production.yaml").write_text(yaml.safe_dump(overlay))
    procs = []
    for node in range(2):
        argv = []
        for arg in container["command"]:
            arg = arg.replace("$(NNODES)", "2").replace("$(POD_INDEX)", str(node))
            if arg.startswith("--master-addr="):
                arg = "--master-addr=127.0.0.1"
            elif arg.startswith("--master-port="):
                arg = f"--master-port={port}"
            elif arg == "--nproc-per-node=gpu":
                arg = "--nproc-per-node=2"
            argv.append(arg)
        assert argv[0] == "torchrun"
        # each rank's output to its own file, so the reports do not interleave
        # nice: the agents' torch imports yield to the suite's other workers
        argv = ["nice", "-n", "10", sys.executable, "-m", "torch.distributed.run",
                f"--log-dir={tmp_path / f'logs{node}'}", "--redirects=3", *argv[1:], "--once", "--cpu"]
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", NODE_NAME=f"gpu-node-{node}",
                   PROD_CLUSTERAPI_API_KEY="k", PYTHONFAULTHANDLER="1")
        procs.append(subprocess.Popen(argv, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, start_new_session=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        # a rank that hangs prints its stack (PYTHONFAULTHANDLER) into its log
        for proc in procs:
            os.killpg(proc.pid, signal.SIGABRT)
        time.sleep(2)
        logs = "".join(f"{path}:\n{path.read_text()[-2000:]}\n" for path in tmp_path.rglob("stderr.log"))
        pytest.fail(f"the two torchrun agents did not finish in 120 s:\n{logs}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-3000:]
    payloads = {}
    for node in range(2):
        for path in sorted((tmp_path / f"logs{node}").rglob("stdout.log")):
            payload = json.loads(path.read_text())
            payloads[payload["devices"]["process_index"]] = (node, payload)
    assert sorted(payloads) == [0, 1, 2, 3]
    for rank, (node, payload) in payloads.items():
        assert rank // 2 == node and payload["healthy"] is True and payload["ici"]["n_devices"] == 4
        assert {r: h["node_name"] for r, h in payload["hosts"].items()} == {
            "0": "gpu-node-0", "1": "gpu-node-0", "2": "gpu-node-1", "3": "gpu-node-1"}
        assert payload["hosts"][str(rank)]["local_rank"] == str(rank % 2)
