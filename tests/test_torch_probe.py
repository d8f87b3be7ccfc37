"""The port's probe cycle held against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs on the suite's virtual CPU devices; the port runs gloo process
groups (one rank in this process; four ranks forked from one spawned process,
tests/test_torch_ranks.py).
"""

import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_watcher_tpu.config.loader import load_config as ref_load_config
from k8s_watcher_tpu.config.schema import SchemaError
from k8s_watcher_tpu.config.schema import TpuConfig as RefTpuConfig
from k8s_watcher_tpu.faults.ici import IciFaultSpec as RefFaultSpec
from k8s_watcher_tpu.parallel import collectives as ref_coll
from k8s_watcher_tpu.parallel.mesh import host_chip_mesh as ref_mesh
from k8s_watcher_tpu.probe import device as ref_device
from k8s_watcher_tpu.probe.agent import ProbeAgent as RefAgent
from k8s_watcher_tpu.probe.ici import run_ici_probe as ref_run_ici_probe
from k8s_watcher_tpu.probe.trend import TrendTracker as RefTrendTracker
from k8s_watcher_tpu_torch import carry, probe_agent
from k8s_watcher_tpu_torch.config import ConfigError, TpuConfig, load_config
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec, apply_fault
from k8s_watcher_tpu_torch.pipeline.pipeline import Notification
from k8s_watcher_tpu_torch.parallel import collectives
from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh, rank_grid
from k8s_watcher_tpu_torch.probe import device
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
from k8s_watcher_tpu_torch.probe.ici import mxu_chain, run_ici_probe
from k8s_watcher_tpu_torch.probe.timing import TimedStats, timed_fenced
from k8s_watcher_tpu_torch.probe.trend import TrendTracker
from test_torch_ranks import run_ranks

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
ICI_ARGS = dict(payload_bytes=1 << 14, iters=2, inner_iters=4)


def test_mxu_chain_matches_jnp():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    inv_scale = 1.0 / 8.0
    aj, bj = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)

    def body(_, c):  # k8s_watcher_tpu/probe/ici.py:170-174
        y = jnp.dot(c, bj, preferred_element_type=jnp.float32)
        return (y * inv_scale).astype(jnp.bfloat16)

    want = np.asarray(jax.lax.fori_loop(0, 8, body, aj).astype(jnp.float32))
    got = carry.from_port(mxu_chain(
        carry.to_port(a, CPU, torch.bfloat16), carry.to_port(b, CPU, torch.bfloat16), 8, inv_scale))
    # same bf16 operands and the same rounding points, but each framework's
    # GEMM may sum in its own order, so a product can land on the other side
    # of a bf16 rounding boundary (one ulp, 2^-8 relative) and the chain
    # carries that on: allow four ulps, not an exact match
    np.testing.assert_allclose(got, want, rtol=2**-6, atol=2**-6)


def test_bus_bandwidth_formula_matches():
    for args in [(1 << 30, 8, 1.0), (4 << 20, 4, 1e-3), (1 << 14, 1, 0.5), (1 << 20, 8, 0.0), (1, 0, 1.0)]:
        assert collectives.allreduce_bus_bandwidth_gbps(*args) == ref_coll.allreduce_bus_bandwidth_gbps(*args)


def test_one_rank_matches_one_device_mesh():
    mesh = ref_mesh(jax.devices()[:1])
    want = ref_run_ici_probe(mesh, **ICI_ARGS)
    got = run_ici_probe(device="cpu", **ICI_ARGS)
    for key in ("ok", "psum_correct", "n_devices", "n_hosts", "bandwidth_gbps", "error"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.ok and got.n_devices == 1 and got.bandwidth_gbps == 0.0
    assert set(got.to_dict()) == set(want.to_dict())
    ref_out = ref_coll.make_psum_probe(mesh, 4)(ref_coll.psum_probe_input(mesh))
    port_mesh = host_chip_mesh(CPU)
    port_out = collectives.make_psum_probe(port_mesh, 4)(collectives.psum_probe_input(port_mesh))
    np.testing.assert_array_equal(carry.from_port(port_out), np.asarray(ref_out))


_RANK_WORKER = """
from k8s_watcher_tpu_torch.probe import device
os.environ["NODE_NAME"] = ["gpu-node-0", "\\u00fc" * 300, "gpu-node-1", "gpu-node-1"][rank]
if rank == 3:
    device._encode_identity_wire = lambda identity: b"\\xff\\xfe{"
identities = device.host_identity_map()
cached = device.host_identity_map() is identities
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.parallel import collectives as c
from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh
from k8s_watcher_tpu_torch.probe.ici import run_ici_probe
mesh = host_chip_mesh(torch.device("cpu"))
fault = IciFaultSpec(corrupt_rank=2)
args = dict(payload_bytes=1 << 14, iters=2, inner_iters=4)
out = {
    "clean": run_ici_probe(mesh, **args).to_dict(),
    "faulty": run_ici_probe(mesh, fault=fault, **args).to_dict(),
    "psum": c.make_psum_probe(mesh, 4)(c.psum_probe_input(mesh)).tolist(),
    "psum_faulty": c.make_psum_probe(mesh, 4, fault)(c.psum_probe_input(mesh)).tolist(),
    "identities": identities,
    "identity_cached": cached,
    "identity": device.host_identity(),
}
with open(out_path, "w") as fh:
    json.dump(out, fh)
"""


def test_four_ranks_match_four_device_mesh(tmp_path):
    results = run_ranks(_RANK_WORKER, 4, tmp_path)

    devices = jax.devices()[:4]
    mesh = ref_mesh(devices)
    ref_fault = RefFaultSpec(corrupt_device_id=devices[2].id)
    want_clean = ref_run_ici_probe(mesh, **ICI_ARGS)
    want_faulty = ref_run_ici_probe(mesh, fault=ref_fault, **ICI_ARGS)
    x = ref_coll.psum_probe_input(mesh)
    want_psum = np.asarray(ref_coll.make_psum_probe(mesh, 4)(x)).tolist()
    want_psum_faulty = np.asarray(ref_coll.make_psum_probe(mesh, 4, ref_fault)(x)).tolist()
    assert want_psum == [2.5]  # the (n + 1) / 2 fixed point

    for got in results:
        assert got["psum"] == want_psum
        assert got["psum_faulty"] == want_psum_faulty
        for key in ("ok", "psum_correct", "n_devices", "n_hosts", "error"):
            assert got["clean"][key] == getattr(want_clean, key), key
            assert got["faulty"][key] == getattr(want_faulty, key), key
        assert set(got["clean"]) == set(want_clean.to_dict())
        assert got["clean"]["psum_correct"] and not got["faulty"]["psum_correct"]
        assert got["clean"]["n_devices"] == 4
        assert got["clean"]["bandwidth_gbps"] > 0 and want_clean.bandwidth_gbps > 0

    # the identity gather: every rank holds every rank's identity, as the
    # reference's wire format clips it, with a row that does not decode
    # mapped to an error under its index
    want_identities = {
        str(r): json.loads(ref_device._encode_identity_wire(results[r]["identity"])) for r in range(3)
    }
    want_identities["3"] = {"process_index": 3, "error": "identity decode failed"}
    assert want_identities["1"]["node_name"] == "\u00fc" * 90  # clipped to 180 bytes
    for got in results:
        assert got["identities"] == want_identities
        assert got["identity_cached"] is True


def test_apply_fault_names_one_rank():
    x = torch.ones(3)
    assert apply_fault(x, None, 0) is x
    assert apply_fault(x, IciFaultSpec(corrupt_rank=1), 0) is x
    assert torch.equal(apply_fault(x, IciFaultSpec(corrupt_rank=1, corrupt_magnitude=5.0), 1), x + 5.0)
    slow = apply_fault(x, IciFaultSpec(slow_rank=0, slow_matmul_size=16, slow_iters=3), 0)
    torch.testing.assert_close(slow, x)  # the delay adds a negligible term
    assert IciFaultSpec(slow_rank=0).active and not IciFaultSpec().active


def test_trend_alerts_match():
    kwargs = dict(window=8, recent=3, drop_factor=0.75, rise_factor=2.5, min_history=4)
    port, ref = TrendTracker(**kwargs), RefTrendTracker(**kwargs)
    rng = np.random.default_rng(3)
    script = []
    for i in range(40):
        healthy = i % 7 != 5
        bw = 1000.0 * (1 + 0.05 * rng.standard_normal()) * (0.5 if 20 <= i < 30 else 1.0)
        rtt = 0.1 * (1 + 0.05 * rng.standard_normal()) * (4.0 if 25 <= i < 35 else 1.0)
        script += [("hbm_read_gbps", bw, True, healthy), ("psum_rtt_median_ms", rtt, False, healthy)]
    alerts = []
    for name, value, higher, healthy in script:
        got = port.observe(name, value, higher_is_better=higher, contribute_baseline=healthy)
        want = ref.observe(name, value, higher_is_better=higher, contribute_baseline=healthy)
        assert (got and got.to_dict()) == (want and want.to_dict())
        alerts.append(got)
    assert sum(a is not None for a in alerts) > 0
    assert port.snapshot() == ref.snapshot()


SLICE_CONFIG = dict(
    probe_enabled=True, probe_payload_bytes=1 << 14, probe_matmul_size=64,
    probe_rtt_warn_ms=10_000.0, probe_hbm_bytes=1 << 22,
)


def test_slice_gate_one_cycle_matches():
    want = RefAgent(RefTpuConfig(**SLICE_CONFIG), environment="development",
                    sink=lambda n: None, expected_platform="cpu").run_once()
    got = ProbeAgent(TpuConfig(**SLICE_CONFIG), environment="development",
                     sink=lambda n: None, expected_platform="cpu", device="cpu").run_once()
    assert got.healthy is want.healthy is True
    gp, wp = got.to_payload(), want.to_payload()
    assert set(gp) == set(wp)
    for part in ("ici", "mxu", "hbm", "hbm_write", "devices"):
        assert set(gp[part]) == set(wp[part]), part
    assert set(gp["devices"]["devices"][0]) == set(wp["devices"]["devices"][0])
    assert gp["hbm"]["interpreted"] is True and gp["hbm_write"]["bad_blocks"] == []


class TestConfig:
    @pytest.mark.parametrize("environment", ["development", "staging", "production"])
    def test_probe_settings_match_reference(self, environment):
        want = ref_load_config(environment, REPO / "config", env={}).tpu
        got = load_config(environment, REPO / "config", env={})
        for field in TpuConfig.__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), field

    def test_defaults_match_reference(self):
        for field in TpuConfig.__dataclass_fields__:
            assert getattr(TpuConfig(), field) == getattr(RefTpuConfig(), field), field

    @pytest.mark.parametrize("probe", [
        {"bogus_key": 1},
        {"trend_drop_factor": 1.5},
        {"trend_rise_factor": 0.5},
        {"trend_recent": 20},
        {"trend_min_history": 2},
        {"matmul_size": "big"},
        {"hbm_write_enabled": "maybe"},
    ])
    def test_rejects_what_the_reference_rejects(self, probe):
        with pytest.raises(SchemaError):
            RefTpuConfig.from_raw({"probe": probe})
        with pytest.raises(ConfigError):
            TpuConfig.from_raw({"probe": probe})

    def test_env_substitution(self):
        cfg = load_config("production", REPO / "config", env={"WATCHER_STATUS_TOKEN": "s3cret"})
        assert cfg.probe_status_auth_token == "s3cret"
        assert cfg.probe_links_enabled is True and cfg.probe_hbm_bytes == 256 << 20


class TestDevice:
    def test_identity_wire_matches_reference(self):
        for identity in (
            {"hostname": "host-a", "process_index": 3, "node_name": "n1"},
            {"hostname": "h" * 300, "process_index": 7, "node_name": "ü" * 300},
            {"hostname": "€" * 400, "process_index": 1, "node_name": "€" * 400},
        ):
            assert device._encode_identity_wire(identity) == ref_device._encode_identity_wire(identity)

    def test_host_identity_reads_rank_env(self, monkeypatch):
        monkeypatch.setenv("NODE_NAME", "gpu-node-7")
        monkeypatch.setenv("RANK", "5")
        monkeypatch.setenv("LOCAL_RANK", "1")
        ident = device.host_identity()
        assert ident["node_name"] == "gpu-node-7" and ident["rank"] == "5" and ident["local_rank"] == "1"
        assert device.host_identity_map() == {str(ident["process_index"]): ident}

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            device.resolve_device(None)
        with pytest.raises(RuntimeError):
            device.local_devices("cuda")

    def test_inventory_verdicts(self):
        out = device.enumerate_devices(CPU, expected_per_host=2, expected_platform="cuda")
        assert out["healthy_devices"] == 1 and out["devices"][0]["alive"] is True
        assert out["missing_local_devices"] == 1 and out["platform_mismatch"] == 1
        assert device.enumerate_devices(CPU, check_liveness=False)["devices"][0]["alive"] is None

    def test_inventory_touches_only_its_own_gpu(self, monkeypatch):
        # a node of four GPUs, this rank driving cuda:2: only cuda:2 gets a
        # liveness computation and a memory query (each would make a context)
        touched = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: SimpleNamespace(name="H100"))
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: touched.append(("memory", d)) or (3, 10))
        monkeypatch.setattr(device, "_device_alive", lambda d: touched.append(("alive", d)) or True)
        own = torch.device("cuda", 2)
        out = device.enumerate_devices(own, expected_per_host=4, expected_platform="cuda")
        assert touched == [("memory", own), ("alive", own)]
        assert [d["alive"] for d in out["devices"]] == [None, None, True, None]
        assert [d["process_index"] for d in out["devices"]] == [None, None, 0, None]
        assert "memory" in out["devices"][2] and "memory" not in out["devices"][0]
        assert out["visible_devices"] == out["local_devices"] == out["healthy_devices"] == 4
        assert out["missing_local_devices"] == 0 and out["platform_mismatch"] == 0
        # the reference's remote chips are listed the same way
        assert set(out["devices"][0]) | {"memory"} == set(out["devices"][2])


class TestAgent:
    def make(self, **overrides):
        cfg = dict(SLICE_CONFIG, probe_hbm_bytes=0, **overrides)
        return ProbeAgent(TpuConfig(**cfg), environment="test", sink=self.sent.append,
                          expected_platform="cpu", device="cpu")

    def setup_method(self):
        self.sent = []

    @pytest.mark.parametrize("flag", ["probe_links_enabled", "probe_multislice_enabled"])
    def test_unported_sub_probes_raise(self, flag):
        """The optional sub-probes run on one rank, land in the report and
        the flight recorder, and keep the cycle healthy, as in the reference."""
        cfg = dict(SLICE_CONFIG, probe_hbm_bytes=0, **{flag: True})
        want = RefAgent(RefTpuConfig(**cfg), environment="test", sink=lambda n: None,
                        mesh=ref_mesh(jax.devices()[:1]), expected_platform="cpu").run_once()
        report = self.make(**{flag: True}).run_once()
        assert report.healthy is want.healthy is True
        part = "links" if flag == "probe_links_enabled" else "multislice"
        got, ref = report.to_payload()[part], want.to_payload()[part]
        assert got is not None and got["ok"] and got["error"] is None
        assert set(got) == set(ref)
        cycle = self.make(**{flag: True})
        cycle.run_once()
        entry = cycle.recent_cycles(1)[0]
        assert entry["link_suspects" if part == "links" else "dcn_suspect_slices"] in (0, [])

    def test_entry_point_refuses_unported_production_links(self, monkeypatch, capsys):
        """``production`` (links_enabled) runs through the entry point on the CPU."""
        monkeypatch.chdir(REPO)
        assert probe_agent.main(["production", "--once", "--cpu"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["healthy"] is True
        assert payload["links"] is not None and payload["links"]["ok"] and payload["links"]["n_links"] == 0

    def test_loop_heartbeat_and_observer_errors(self):
        beats, seen = [], []
        done = threading.Event()

        def observer(report):
            seen.append(report.healthy)
            if len(seen) >= 3:
                done.set()
            raise RuntimeError("observer bug")

        agent = ProbeAgent(TpuConfig(**dict(SLICE_CONFIG, probe_hbm_bytes=0, probe_interval_seconds=0.01)),
                           environment="test", sink=self.sent.append, expected_platform="cpu",
                           device="cpu", heartbeat=lambda: beats.append(1))
        agent.report_observer = observer
        agent.start()
        agent.start()  # a second start is a no-op
        thread = agent._thread
        try:
            assert done.wait(60)
        finally:
            agent.stop()
        assert not thread.is_alive() and agent._thread is None
        cycles = agent.metrics.counter("probe_runs").value
        assert cycles >= 3 and len(beats) == len(seen) == cycles and all(seen)
        assert agent.metrics.counter("probe_observer_errors").value == cycles
        assert len(self.sent) == cycles  # rank 0 reports every cycle
        assert agent.metrics.counter("probe_errors").value == 0

    def test_loop_counts_a_failed_cycle(self, monkeypatch):
        agent = self.make(probe_interval_seconds=0.01)
        calls = []

        def failing():
            calls.append(1)
            raise RuntimeError("cycle failed")

        monkeypatch.setattr(agent, "run_once", failing)
        agent.start()
        try:
            deadline = time.monotonic() + 30
            while agent.metrics.counter("probe_errors").value < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            agent.stop()
        assert agent.metrics.counter("probe_errors").value >= 2 and self.sent == []

    def test_auto_platform_is_cuda(self):
        agent = ProbeAgent(TpuConfig(**dict(SLICE_CONFIG, probe_hbm_bytes=0)), environment="test",
                           sink=lambda n: None, device="cpu")
        report = agent.run_once()
        assert report.devices["expected_platform"] == "cuda" and not report.healthy

    def test_report_gauges_and_flight_recorder(self):
        agent = self.make()
        report = agent.run_once()
        agent._report(report)
        assert len(self.sent) == 1 and isinstance(self.sent[0], Notification)
        assert self.sent[0].kind == "probe" and self.sent[0].payload["healthy"] is True
        assert agent.metrics.counter("probe_runs").value == 1
        assert agent.metrics.histogram("probe_psum_rtt").count == 1
        assert agent.metrics.gauge("probe_mxu_tflops_median").read() > 0
        assert agent.metrics.gauge("probe_hbm_read_gbps").read() is None  # did not run
        # one rank: the all-reduce readings publish but never fold a trend
        assert agent.metrics.gauge("probe_psum_rtt_median_ms").read() > 0
        assert "psum_rtt_median_ms" not in agent.trend.snapshot()
        assert agent.recent_cycles(5)[0]["healthy"] is True

    def test_profile_traces_written_and_pruned(self, tmp_path, monkeypatch):
        agent = self.make(probe_profile_dir=str(tmp_path))
        monkeypatch.setattr(ProbeAgent, "MAX_PROFILE_RUNS", 1)
        assert agent.run_once().healthy
        agent.run_once()
        traces = list(tmp_path.glob("probe-*.pt.trace.json"))
        assert len(traces) == 1
        assert "traceEvents" in json.loads(traces[0].read_text())


def test_timing_flags():
    stats = timed_fenced(lambda t: t + 1, torch.zeros(2), 3, baseline_ms=0.0)
    assert isinstance(stats, TimedStats) and len(stats) == 3
    assert stats[0] <= stats.median <= stats[2] and not stats.unreliable
    # a baseline far above the work marks the reading unreliable
    assert timed_fenced(lambda t: t, torch.zeros(2), 2, baseline_ms=1e4).unreliable


def test_rank_grid():
    assert rank_grid(8, 4).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert rank_grid(6, 4).shape == (1, 6)
    assert rank_grid(1, 1).shape == (1, 1)
