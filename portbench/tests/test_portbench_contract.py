"""The benchmark's files against its contract: everything is found by name,
every name and unit is of the allowed characters, and no run loads JAX or the
JAX package."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in bench["paths"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_what_the_contract_asks(bench):
    cells = {w["name"] for w in bench["workloads"]}
    assert {w["config"] for w in bench["workloads"]} == {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for cell in cells:
        mine, layer = harness.cell_metrics(bench, cell)
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2 and layer


def test_files_are_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert harness.load_json("configs", f"{c['name']}.json")["name"] == c["name"]
    for w in bench["workloads"]:
        workload = harness.load_json("workloads", f"{w['name']}.json")
        assert workload["config"] == w["config"] and workload["traffic"] == w["traffic"]
        assert os.path.isfile(os.path.join(harness.PACKAGE_DIR, "drivers", f"{workload['driver']}.py"))
        assert set(workload["end_to_end"]) == {m["name"] for m in harness.cell_metrics(bench, w["name"])[0]}
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A copy of the benchmark with one more cell, added as a workload file and
    an entry, and one more per-layer metric with its reader: the harness
    finds both without an edit to its code."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PACKAGE_DIR, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    bench["workloads"].append({"name": "node-probe-idle", "config": "h100-node-agent", "traffic": "dummy",
                               "chips": 1, "why": "a dummy cell"})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "agent", "moves": "setup_s", "workloads": ["node-probe-idle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    workload = harness.load_json("workloads", "node-probe-loop.json")
    (root / "portbench" / "workloads" / "node-probe-idle.json").write_text(
        json.dumps({**workload, "name": "node-probe-idle", "traffic": "dummy"}))
    (root / "portbench" / "metrics" / "dummy_ms.py").write_text("def read(obs):\n    return 1.5\n")
    probe = ("import json, sys; sys.path.insert(0, sys.argv[1]); from portbench import harness; "
             "b = harness.benchmark(); e, l = harness.cell_metrics(b, 'node-probe-idle'); "
             "print(json.dumps([[m['name'] for m in e], [m['name'] for m in l], "
             "harness.load_reader('dummy_ms')({}), harness.load_json('workloads', 'node-probe-idle.json')['driver']]))")
    out = subprocess.run([sys.executable, "-c", probe, str(root)], capture_output=True, text=True, cwd=root,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    e2e, layer, value, driver = json.loads(out.stdout)
    assert "setup_s" in e2e and "dummy_ms" in layer and value == 1.5 and driver == "probe_loop"


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["k8s_watcher_tpu_torch", "k8s_watcher_tpu_torch.app", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "k8s_watcher_tpu", "k8s_watcher_tpu.probe", "flax", "jaxlib"]) \
        == ["flax", "jax.numpy", "jaxlib", "k8s_watcher_tpu", "k8s_watcher_tpu.probe"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; import portbench.harness as h, portbench.devtrace, portbench.spans, portbench.deploy, "
            "portbench.traffic.server, portbench.traffic.stub, portbench.reference.probe, "
            "portbench.drivers.probe_loop; import k8s_watcher_tpu_torch.probe_agent; "
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(harness.PACKAGE_DIR))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_or_without_the_port_gives_no_result(tmp_path):
    root = os.path.dirname(harness.PACKAGE_DIR)
    args = ["--workload", "node-probe-loop", "--seed", "3000000019", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "-m", "portbench.run", *args], capture_output=True, text=True,
                         timeout=120, cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(harness.PACKAGE_DIR, bare / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "BENCHMARK.json"), bare / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", *args], capture_output=True, text=True,
                         timeout=120, cwd=bare)
    assert out.returncode != 0 and out.stdout.strip() == ""
