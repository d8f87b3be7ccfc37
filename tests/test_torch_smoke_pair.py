"""Runs one smoke drill through both packages, for the ``test_torch_smoke_*``
files. This file holds no tests.

:func:`run_pair` loads the JAX package's ``scripts/<name>.py`` by path,
points its module-level ``ARTIFACTS`` at ``tmp_path`` (the script's file is
not touched) and calls its ``main()`` under the suite's ``JAX_PLATFORMS=cpu``;
then it runs the port's twin in process with ``--device cpu --out``. Both
must exit 0 with ``ok: true``, the two ``checks`` key sets must equal the
twin's declared ``CHECKS``, and every check must be true. It returns both
artifacts, for the caller's comparison of the deterministic fields.
"""

import importlib
import importlib.util
import json
import math
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_reference(name: str, tmp_path: Path, monkeypatch) -> dict:
    spec = importlib.util.spec_from_file_location(f"reference_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "ARTIFACTS", tmp_path / "reference")
    assert module.main() == 0
    return json.loads((tmp_path / "reference" / f"{name}.json").read_text())


def run_twin(name: str, tmp_path: Path, *argv: str) -> dict:
    module = importlib.import_module(f"k8s_watcher_tpu_torch.{name}")
    out = tmp_path / "port" / f"{name}_gpu.json"
    assert module.main(["--device", "cpu", "--out", str(out), *argv]) == 0
    return json.loads(out.read_text())


def run_pair(name: str, tmp_path: Path, monkeypatch, *twin_argv: str) -> tuple:
    reference = run_reference(name, tmp_path, monkeypatch)
    port = run_twin(name, tmp_path, *twin_argv)
    declared = importlib.import_module(f"k8s_watcher_tpu_torch.{name}").CHECKS
    for side in (reference, port):
        assert side["ok"] is True, side["checks"]
        assert list(side["checks"]) == list(declared)
        assert all(side["checks"].values()), side["checks"]
    return reference, port


def assert_equal(reference, port, path: str = "", rel: float = 1e-6) -> None:
    """Equal structure, keys and values; a float may differ by ``rel``
    relative (the reference's analytics run on JAX, the port's on torch)."""
    if isinstance(reference, dict):
        assert isinstance(port, dict) and set(reference) == set(port), (path, reference, port)
        for key in reference:
            assert_equal(reference[key], port[key], f"{path}.{key}", rel)
    elif isinstance(reference, list):
        assert isinstance(port, list) and len(reference) == len(port), (path, reference, port)
        for i, (a, b) in enumerate(zip(reference, port)):
            assert_equal(a, b, f"{path}[{i}]", rel)
    elif isinstance(reference, float) and not isinstance(port, bool):
        assert math.isclose(reference, port, rel_tol=rel, abs_tol=0.0), (path, reference, port)
    else:
        assert reference == port and type(reference) is type(port), (path, reference, port)


def pick(artifact: dict, *paths: str) -> dict:
    """The fields at dotted ``paths`` of an artifact."""
    out = {}
    for path in paths:
        value = artifact
        for part in path.split("."):
            value = value[part]
        out[path] = value
    return out
