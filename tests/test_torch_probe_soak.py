"""The port's probe soak (``python -m k8s_watcher_tpu_torch.probe_soak``)
held against the JAX package's ``scripts/probe_soak.py``, which is never run
(it writes a fixed path under ``artifacts/``).

The soak's config must equal the reference's: the ``TpuConfig(...)``
keywords of ``scripts/probe_soak.py`` are read with ``ast``, without
importing the script. ``run_soak`` then runs on the CPU at a 0.25 s cadence
with a narrow GEMM (64, 2 products) for 6 s (12 cycles or more) and must write an
artifact with the reference's keys that passes.

On the CPU the GEMM's reading is the host clock around 0.5 MFLOP: on a
shared host it swings 35-75% from cycle to cycle (a drop of the recent
median below 0.75 of the anchor raised trend alerts in 2 of 6 quiet 3.6 s
runs of 14 cycles), where the card's reading is device time. So the tests that
judge the trend pin the GEMM's time to its first reading: the real GEMM runs
every cycle, and its time is the one the soak's ``ok`` rule must judge. A
reading that halves midway must then raise trend alerts and fail the soak.
"""

import ast
import dataclasses
import json
from pathlib import Path

import pytest

import k8s_watcher_tpu_torch.probe.agent as agent_mod
from k8s_watcher_tpu_torch import probe_soak

REPO = Path(__file__).resolve().parent.parent
CADENCE_S = 0.25
# 6 s: about 22 cycles at the cadence on a quiet host, 12 or more beside the
# suite's other workers (the first cycle joins a process group)
MINUTES = 0.1
ARTIFACT_KEYS = {
    "timestamp_utc", "wall_minutes", "cadence_seconds", "cycles_completed", "cycles_healthy", "heartbeats",
    "trend_alerts_raised", "trend_alerts", "trend_state", "bands", "reports_sunk", "ok",
}


def reference_config_keywords():
    """``{keyword: value}`` of the ``TpuConfig(...)`` call in the reference
    script, with ``args.interval`` standing as the name ``INTERVAL``."""
    tree = ast.parse((REPO / "scripts" / "probe_soak.py").read_text())
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "TpuConfig"]
    out = {}
    for kw in call.keywords:
        if isinstance(kw.value, ast.Attribute) and kw.value.attr == "interval":
            out[kw.arg] = "INTERVAL"
        else:
            out[kw.arg] = eval(compile(ast.Expression(kw.value), "<kw>", "eval"))  # literals and products only
    return out


def narrow():
    return dataclasses.replace(probe_soak.soak_config(CADENCE_S), probe_matmul_size=64, probe_matmul_inner_iters=2)


@pytest.fixture
def pinned_gemm(monkeypatch):
    """The agent's GEMM probe, run for real, its time held at the first
    reading times ``factor[0]`` (a test sets the factor mid-soak)."""
    real = agent_mod.run_mxu_probe
    first, factor = {}, [1.0]

    def pinned(*args, **kwargs):
        out = real(*args, **kwargs)
        first.setdefault("time_median_ms", out["time_median_ms"])
        out["time_median_ms"] = first["time_median_ms"] * factor[0]
        out["tflops_median"] = 2.0 * out["size"] ** 3 * out["inner_iters"] / (out["time_median_ms"] / 1e3) / 1e12
        return out

    monkeypatch.setattr(agent_mod, "run_mxu_probe", pinned)
    return factor


def test_config_equals_the_reference():
    want = reference_config_keywords()
    got = probe_soak.soak_config(7.5)
    assert want.pop("probe_interval_seconds") == "INTERVAL" and got.probe_interval_seconds == 7.5
    assert want == {k: getattr(got, k) for k in want}
    assert (got.probe_matmul_size, got.probe_matmul_inner_iters, got.probe_hbm_bytes) == (4096, 128, 128 << 20)
    # every other field stays at the schema's default, as in the reference
    defaults = type(got)()
    rest = {f.name for f in dataclasses.fields(got)} - set(want) - {"probe_interval_seconds"}
    assert {k: getattr(got, k) for k in rest} == {k: getattr(defaults, k) for k in rest}


def test_soak_on_the_cpu_writes_a_passing_artifact(pinned_gemm, tmp_path):
    out = tmp_path / "soak" / "soak.json"
    artifact, on_device = probe_soak.run_soak(narrow(), MINUTES, "cpu", out)
    written = json.loads(out.read_text())
    assert set(written) == ARTIFACT_KEYS
    assert written == json.loads(json.dumps(artifact))
    assert artifact["ok"] is True, {k: v for k, v in artifact.items() if k != "trend_state"}
    assert artifact["cycles_completed"] >= 10 and artifact["cycles_healthy"] == artifact["cycles_completed"]
    assert artifact["trend_alerts_raised"] == 0 and artifact["trend_alerts"] == []
    assert artifact["heartbeats"] == artifact["cycles_completed"] == artifact["reports_sunk"]
    assert artifact["wall_minutes"] >= MINUTES * 0.99 and artifact["cadence_seconds"] == CADENCE_S
    assert set(artifact["bands"]) == {"mxu_tflops_median", "hbm_read_gbps", "hbm_write_gbps", "cycle_duration_ms"}
    # the GEMM's reading is the only trended one on the CPU (the HBM sweeps
    # there are the kernels' plain versions: no bandwidth to trend)
    assert set(artifact["trend_state"]) == {"mxu_tflops_median"}
    assert on_device["device"] == "cpu" and len(on_device["cycles"]) == artifact["cycles_completed"]
    # the plain versions ran on the CPU, no kernel was launched
    assert all(set(c["launches"].values()) <= {0} for c in on_device["cycles"])


def test_a_reading_that_halves_fails_the_soak(pinned_gemm, tmp_path):
    config = narrow()
    seen = []
    real_observe = agent_mod.ProbeAgent._record_cycle

    def record(self, report):
        seen.append(1)
        if len(seen) == 8:
            pinned_gemm[0] = 2.0  # from cycle 9 on the GEMM takes twice as long
        real_observe(self, report)

    agent_mod.ProbeAgent._record_cycle = record
    try:
        artifact, _ = probe_soak.run_soak(config, MINUTES, "cpu", None)
    finally:
        agent_mod.ProbeAgent._record_cycle = real_observe
    assert artifact["cycles_completed"] >= 10
    assert artifact["trend_alerts_raised"] >= 1 and artifact["ok"] is False
    assert {a["metric"] for a in artifact["trend_alerts"]} == {"mxu_tflops_median"}
    assert all(a["direction"] == "drop" for a in artifact["trend_alerts"])


def test_main_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_soak.main(["--minutes", "0.01", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_main_honours_out_and_writes_nothing_under_artifacts(monkeypatch, capsys, tmp_path):
    """``main()`` with ``--device cpu``, its config narrowed as above (the
    CLI's own 4096 x 128 chain is 17.6 TFLOP a timed call: hours on a CPU)."""
    config = narrow()
    monkeypatch.setattr(probe_soak, "soak_config",
                        lambda interval: dataclasses.replace(config, probe_interval_seconds=interval))
    artifacts = REPO / "artifacts"
    before = sorted(p.name for p in artifacts.iterdir()) if artifacts.is_dir() else []
    out = tmp_path / "cli.json"
    # 0.6 s is too short for 10 cycles: the soak runs, writes and fails
    code = probe_soak.main(["--minutes", "0.01", "--interval", str(CADENCE_S), "--device", "cpu", "--out", str(out)])
    stdout = capsys.readouterr().out
    assert code == 1 and "soak: FAIL" in stdout and f"artifact: {out}" in stdout
    assert set(json.loads(out.read_text())) == ARTIFACT_KEYS
    device_line = next(line for line in stdout.splitlines() if line.startswith("soak device: "))
    assert json.loads(device_line[len("soak device: "):])["device"] == "cpu"
    assert (sorted(p.name for p in artifacts.iterdir()) if artifacts.is_dir() else []) == before
    assert str(probe_soak.DEFAULT_OUT) == str(artifacts / "probe_soak_gpu.json")
