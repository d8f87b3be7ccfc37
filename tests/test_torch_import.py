"""Import gate: the port imports nothing of JAX and nothing of the JAX package.

A subprocess, because ``tests/conftest.py`` imports jax into this one. It
imports every module of ``k8s_watcher_tpu_torch``, runs one CPU probe cycle
through the ``probe_agent`` entry point with the ``production`` settings
(the per-link walk on), and reports what ``sys.modules``
holds afterwards.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_GATE = """
import contextlib, importlib, io, json, pkgutil, sys
import k8s_watcher_tpu_torch
names = [m.name for m in pkgutil.walk_packages(k8s_watcher_tpu_torch.__path__, "k8s_watcher_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from k8s_watcher_tpu_torch import probe_agent
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = probe_agent.main(["production", "--once", "--cpu"])
payload = json.loads(out.getvalue())
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
                or m == "k8s_watcher_tpu" or m.startswith("k8s_watcher_tpu."))
print(json.dumps({"modules": names, "rc": rc, "healthy": payload["healthy"], "links": payload["links"],
                  "forbidden": loaded}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _GATE], cwd=str(REPO), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["forbidden"] == []
    assert result["rc"] == 0 and result["healthy"] is True
    assert result["links"] is not None and result["links"]["ok"]
    for module in ("config", "metrics", "notification", "carry", "probe_agent",
                   "probe.timing", "probe.device", "probe.hbm", "probe.ici", "probe.trend",
                   "probe.report", "probe.agent", "probe.links", "probe.multislice",
                   "kernels.build", "kernels.hbm",
                   "faults.ici", "parallel.mesh", "parallel.collectives"):
        assert f"k8s_watcher_tpu_torch.{module}" in result["modules"], module


def test_probe_agent_refuses_loop_mode():
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_watcher_tpu_torch.probe_agent", "development"],
        cwd=str(REPO), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2 and "--once" in proc.stderr
