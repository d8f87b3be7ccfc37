"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is False, deciding inside a
fixture. This file imports nothing of JAX, so it also runs on a machine with
PyTorch for CUDA and no JAX, without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from k8s_watcher_tpu_torch import carry
from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.kernels import build
from k8s_watcher_tpu_torch.kernels import hbm as K
from k8s_watcher_tpu_torch.probe import hbm as port
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def test_kernels_match_plain_versions(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(0, 4, (4 * K.BLOCK_ROWS, K.WIDTH), generator=gen, device=cuda_device).float()
    assert torch.equal(K.read_sweep(x, 3), K.read_sweep_plain(x, 3))
    seed = carry.seed(3.0, cuda_device)
    y = K.fill(seed, 8, 2)
    assert torch.equal(y.view(torch.int32), K.fill_plain(seed, 8, 2).view(torch.int32))
    y.view(8, -1)[[2, 5], 11] += 1e6
    # the kernel's tree and PyTorch's reduction add in other orders
    assert torch.allclose(K.blocksums(y), K.blocksums_plain(y), rtol=1e-5, atol=0.0)


def test_probes_launch_the_kernels(cuda_device):
    build.reset_launch_counts()
    assert port.run_hbm_probe(16 << 20, iters=2, device=cuda_device)["interpreted"] is False
    out = port.run_hbm_write_probe(16 << 20, iters=2, device=cuda_device)
    assert out["ok"] and out["interpreted"] is False
    assert build.launch_counts() == {"read_sweep": 3, "fill": 3, "blocksums": 1}


def test_write_probe_localizes_corruption_on_card(cuda_device):
    def corrupt(y):
        y = y.clone()
        y[K.WRITE_BLOCK_ROWS * 3 + 7, 3] += 1e6
        return y

    out = port.run_hbm_write_probe(8 << 20, iters=1, device=cuda_device, corrupt_hook=corrupt)
    assert not out["ok"]
    assert [b["block"] for b in out["bad_blocks"]] == [3]


def test_one_cycle_on_card_is_healthy(cuda_device):
    config = TpuConfig(probe_payload_bytes=1 << 20, probe_hbm_bytes=32 << 20)
    report = ProbeAgent(config, environment="development", sink=lambda n: None, device=cuda_device).run_once()
    assert report.healthy, report.to_payload()
    assert report.hbm["interpreted"] is False and report.hbm_write["interpreted"] is False


def test_device_timing_ignores_threads_holding_the_interpreter(cuda_device):
    """The watcher runs the probe beside ingest threads busy in Python. The
    GEMM chain's and the HBM sweeps' readings must be the card's: timed by
    the C side around one launch, threads hogging the interpreter lock
    cannot slow them down (timed from Python, the chain read tens of times
    slower)."""
    import threading

    from k8s_watcher_tpu_torch.probe.ici import run_mxu_probe

    def readings():
        return (run_mxu_probe(1024, inner_iters=8, device=cuda_device),
                port.run_hbm_probe(64 << 20, device=cuda_device),
                port.run_hbm_write_probe(64 << 20, device=cuda_device))

    quiet = readings()
    stop = threading.Event()

    def hog():
        n = 0
        while not stop.is_set():
            n = (n * 31 + 7) % 1000003  # pure Python: holds the lock between switches

    threads = [threading.Thread(target=hog, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        busy = readings()
    finally:
        stop.set()
        for t in threads:
            t.join(5)
    assert all(r["ok"] for r in quiet + busy), (quiet, busy)
    assert busy[0]["tflops_median"] > 0.7 * quiet[0]["tflops_median"], (quiet[0], busy[0])
    assert busy[1]["read_gbps"] > 0.8 * quiet[1]["read_gbps"], (quiet[1], busy[1])
    assert busy[2]["write_gbps"] > 0.8 * quiet[2]["write_gbps"], (quiet[2], busy[2])


def test_kernels_time_themselves(cuda_device):
    import ctypes

    x = torch.ones((64 * K.BLOCK_ROWS, K.WIDTH), device=cuda_device)
    timer = ctypes.c_float()
    out = K.read_sweep(x, 4, timer=timer)
    assert torch.equal(out, K.read_sweep_plain(x, 4)) and timer.value > 0
    fill_timer = ctypes.c_float()
    K.fill(carry.seed(1.0, cuda_device), 64, 4, timer=fill_timer)
    assert fill_timer.value > 0


def _fleet_columns(seed, n_slices):
    """Seeded columns: JobSet slices of 1-8 workers over three clusters and
    shared nodes, some workers down, one pod per worker."""
    import numpy as np

    from k8s_watcher_tpu_torch.analytics import FleetEncoder

    rng = np.random.default_rng(seed)
    tables = {"pod": [], "slice": []}
    for s in range(n_slices):
        cluster = (None, "east", "west")[s % 3]
        workers = [{"name": f"s{s}-w{i}", "phase": "Running" if up else "Pending", "ready": bool(up),
                    "node": f"n-{(s * 3 + i) % 97}", "node_ready": True}
                   for i, up in enumerate(rng.random(int(rng.integers(1, 9))) < 0.85)]
        key = f"{cluster + '/' if cluster else ''}default/slice-{s}"
        tables["slice"].append({
            "kind": "slice", "key": key, "expected_workers": None if s % 5 == 0 else len(workers),
            "observed_workers": len(workers), "chips_per_worker": int(rng.integers(1, 9)),
            "ready_workers": sum(w["ready"] for w in workers), "workers": workers,
            **({"cluster": cluster} if cluster else {}),
        })
        tables["pod"] += [{"kind": "pod", "key": f"{key}/{w['name']}", "phase": w["phase"], "ready": w["ready"],
                           "node": w["node"], **({"cluster": cluster} if cluster else {})} for w in workers]
    encoder = FleetEncoder()
    encoder.reset(tables)
    return tables, encoder.columns()


def test_analytics_on_card_equals_numpy(cuda_device):
    from k8s_watcher_tpu_torch.analytics import (
        FleetKernels,
        Scenario,
        build_masks,
        evaluate_scenarios,
        python_reference_verdicts,
        resolve_backend,
    )

    tables, cols = _fleet_columns(3, 300)
    card = FleetKernels(resolve_backend("auto"))
    assert card.backend.name == "torch" and card.backend.device.type == "cuda"
    plain = FleetKernels(resolve_backend("numpy"))
    scenarios = [Scenario("baseline"), Scenario("drain_cluster", cluster="east"),
                 Scenario("drain_cluster", cluster="")]
    scenarios += [Scenario("cordon_nodes", nodes=tuple(f"n-{(7 * k + j) % 97}" for j in range(k)))
                  for k in range(1, 30)]
    masks = build_masks(cols, scenarios)
    for a, b in zip(card.slice_rollup(cols) + card.what_if(cols, masks),
                    plain.slice_rollup(cols) + plain.what_if(cols, masks)):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert card.pod_phase_counts(cols).tolist() == plain.pod_phase_counts(cols).tolist()
    verdicts = evaluate_scenarios(cols, scenarios, card)
    assert verdicts == evaluate_scenarios(cols, scenarios, plain) == python_reference_verdicts(tables, scenarios)


def test_analytics_runs_on_its_own_stream(cuda_device):
    """An analytics request must not queue behind (or inside) the probe's
    launches on the default stream: with the default stream held busy by a
    spin kernel, a request completes while the spin still runs."""
    import time

    from k8s_watcher_tpu_torch.analytics import FleetKernels, Scenario, build_masks, resolve_backend

    _, cols = _fleet_columns(4, 200)
    kernels = FleetKernels(resolve_backend("auto", device=cuda_device))
    stream = kernels.backend.stream
    assert stream is not None and stream.device == cuda_device and stream != torch.cuda.default_stream(cuda_device)
    masks = build_masks(cols, [Scenario("baseline"), Scenario("drain_cluster", cluster="east")])
    want = kernels.what_if(cols, masks)  # warm: first launches set up
    torch.cuda._sleep(int(2e9))  # about a second of spinning on the default stream
    t0 = time.monotonic()
    got = kernels.what_if(cols, masks)
    elapsed = time.monotonic() - t0
    busy = not torch.cuda.default_stream(cuda_device).query()
    torch.cuda.synchronize(cuda_device)
    assert [a.tolist() for a in got] == [a.tolist() for a in want]
    assert busy and elapsed < 0.25, (busy, elapsed)


def test_graph_capture_beside_analytics_threads(cuda_device):
    """The probe captures its GEMM chain into a CUDA graph, and replays the
    kept one, while the watcher's HTTP threads serve analytics requests
    (copies, launches and a stream synchronize each). Neither may break the
    other. The size alternates in pairs, so every other reading captures
    afresh (a new key) and the rest replay."""
    import threading

    from k8s_watcher_tpu_torch.analytics import FleetKernels, Scenario, build_masks, resolve_backend
    from k8s_watcher_tpu_torch.probe.ici import run_mxu_probe

    _, cols = _fleet_columns(5, 200)
    kernels = FleetKernels(resolve_backend("auto", device=cuda_device))
    masks = build_masks(cols, [Scenario("baseline"), Scenario("drain_cluster", cluster="west")])
    want = [a.tolist() for a in kernels.what_if(cols, masks)]
    stop, errors, done = threading.Event(), [], []

    def requests():
        while not stop.is_set():
            try:
                got = [a.tolist() for a in kernels.what_if(cols, masks)]
                done.append(got == want)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)
                return

    threads = [threading.Thread(target=requests, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        readings = [run_mxu_probe(size, inner_iters=8, iters=3, device=cuda_device)
                    for size in [256, 256, 512, 512] * 5]
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not errors, errors
    assert done and all(done)
    assert all(r["ok"] and not r.get("error") for r in readings), [r for r in readings if not r["ok"]][:1]


def test_graph_timing_ignores_busy_host_cores(cuda_device):
    """The GEMM chain's graph runs for about 0.1 ms: a timing window opened on
    an idle stream would also time the host's submission of the graph, which
    stretches when every core is busy (the watcher's threads, other
    processes). Behind its gate, the reading stays the card's."""
    import os
    import statistics
    import subprocess
    import sys

    from k8s_watcher_tpu_torch.probe.ici import run_mxu_probe

    def reading():
        return statistics.median(run_mxu_probe(1024, inner_iters=8, iters=5, device=cuda_device)["tflops_median"]
                                 for _ in range(5))

    quiet = reading()
    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(2 * (os.cpu_count() or 4))]
    try:
        busy = reading()
    finally:
        for hog in hogs:
            hog.kill()
            hog.wait()
    assert busy > 0.9 * quiet, (quiet, busy)


def test_a_collectives_graph_is_timed_without_its_barrier(cuda_device):
    """A collective of several ranks is timed on the device as a kept graph
    (probe/timing.py:collective_times_ms): the barrier graph launched ahead
    of each timed launch (here a kernel that sleeps) waits outside the
    window, and each launch's output is read back."""
    from k8s_watcher_tpu_torch.probe.timing import capture_graph, collective_times_ms

    x = torch.ones(1024, device=cuda_device)
    graph, out = capture_graph(lambda: x * 2 + 1, cuda_device)
    barrier, _ = capture_graph(lambda: torch.cuda._sleep(20_000_000), cuda_device)
    timed = collective_times_ms(graph, out, barrier, 3, cuda_device)
    assert [value for _, value in timed] == [3.0] * 3
    assert max(ms for ms, _ in timed) < 2.0, timed
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    barrier.replay()
    graph.replay()
    end.record()
    end.synchronize()
    assert start.elapsed_time(end) >= 5.0  # the barrier, timed with the call


FOUR_RANKS = r"""
import json, os, sys
import torch
from k8s_watcher_tpu_torch.config import TpuConfig
from k8s_watcher_tpu_torch.faults.ici import IciFaultSpec
from k8s_watcher_tpu_torch.probe.ici import run_ici_probe
from k8s_watcher_tpu_torch.probe.links import run_link_probe
from k8s_watcher_tpu_torch.probe.timing import COLLECTIVE_GRAPHS
import torch.distributed as dist

rank = int(os.environ["RANK"])
device = torch.device("cuda", rank)
torch.cuda.set_device(device)
floor = TpuConfig().probe_link_rtt_floor_ms
out = {}
for case, fault in (("quiet", None), ("slow", IciFaultSpec(slow_rank=2)), ("corrupt", IciFaultSpec(corrupt_rank=2))):
    for _ in range(3):  # the first cycle of a fault captures its graphs
        walk = run_link_probe(device=device, fault=fault, rtt_floor_ms=floor)
        ici = run_ici_probe(device=device, fault=fault, payload_bytes=4 << 20)
    out[case] = {"hops": {link.name: link.rtt_ms for link in walk.links}, "error": walk.error,
                 "suspect_devices": walk.suspect_devices, "suspects": [s["name"] for s in walk.suspect_links],
                 "chain_round_ms": ici.psum_rtt_median_ms, "bus_gbps": ici.bandwidth_gbps_median,
                 "ici_ok": ici.ok}
print("RESULT " + json.dumps(out), flush=True)
COLLECTIVE_GRAPHS.drop()  # no graph outlives the group's communicators
dist.destroy_process_group()
"""


def test_four_cards_time_the_walk_on_the_device_and_name_a_bad_gpu():
    """Four NCCL ranks, one a card, walk the ring of 4 as the DaemonSet's
    agents do, each link's exchanges a kept graph timed on the device: on a
    quiet node no link is a suspect and every hop reads under the floor
    (``link_rtt_floor_ms``); a slow rank's two links read over the floor and
    three times the quiet links' hops; a corrupt rank is named. (On a ring of
    4 a slow rank taints half the links, so the median rule cannot name it;
    the ring of 8 the DaemonSet runs can.)"""
    import json
    import os
    import socket
    import subprocess
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: the group is four ranks, one a card")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(4):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "4", "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        procs.append(subprocess.Popen([sys.executable, "-c", FOUR_RANKS], cwd=root, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = {}
    for rank, proc in enumerate(procs):
        text, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, text[-3000:]
        results[rank] = json.loads(next(l for l in text.splitlines() if l.startswith("RESULT "))[7:])
    print(json.dumps(results))
    floor = TpuConfig().probe_link_rtt_floor_ms
    hops = {case: {name: ms for r in results.values() for name, ms in r[case]["hops"].items()}
            for case in ("quiet", "slow", "corrupt")}
    for case in hops:
        assert len(hops[case]) == 4, hops  # the ring's 4 links, each on its owner
    quiet = results[0]["quiet"]
    assert quiet["error"] is None and quiet["suspect_devices"] == [] and quiet["suspects"] == []
    assert quiet["ici_ok"] and quiet["chain_round_ms"] > 0.0 and quiet["bus_gbps"] > 0.0
    assert all(0.0 < ms < floor for ms in hops["quiet"].values()), hops
    slow = hops["slow"]
    tainted = {name: ms for name, ms in slow.items() if "chip2" in name}
    healthy = {name: ms for name, ms in slow.items() if "chip2" not in name}
    assert len(tainted) == 2 and min(tainted.values()) > max(floor, 3.0 * max(healthy.values())), slow
    corrupt = results[0]["corrupt"]
    assert corrupt["suspect_devices"] == [2] and sorted(corrupt["suspects"]) == sorted(tainted), corrupt


def test_a_cycle_on_card_counts_its_capture_and_device_allocations(cuda_device, monkeypatch):
    """On the card the GEMM stage captures its graph inside its set-up in the
    first cycle of its key, and replays it after: later cycles count no
    capture and no device allocation (a capture empties the caching
    allocator). The kept graph's output stays the chain's, and no readback
    span falls inside a timed launch."""
    from k8s_watcher_tpu_torch.probe import ici, spans

    monkeypatch.setattr(ici, "GRAPHS", ici.GemmGraphs())  # a first cycle, whatever ran before
    config = TpuConfig(probe_payload_bytes=1 << 20, probe_hbm_bytes=32 << 20)
    agent = ProbeAgent(config, environment="development", sink=lambda n: None, device=cuda_device)
    cycles, entries = [], []
    for _ in range(3):
        assert agent.run_once().healthy
        cycles.append(spans.RECORDER.last())
        entries.append(agent.recent_cycles(1)[0])
    (capture,) = cycles[0].named("probe.mxu.capture")
    assert capture.parent.name == "probe.mxu.setup"
    assert [c.counters["graph_captures"] for c in cycles] == [1, 0, 0]
    assert [e["graph_captures"] for e in entries] == [1, 0, 0]
    assert [len(c.named("probe.mxu.capture")) for c in cycles[1:]] == [0, 0]
    assert cycles[0].counters["device_allocs"] >= 0
    assert [c.counters["device_allocs"] for c in cycles[1:]] == [0, 0]
    for cycle, entry in zip(cycles, entries):
        counters = cycle.counters
        assert entry["device_allocs"] == counters["device_allocs"]
        assert entry["syncs"] == counters["syncs"] == len(cycle.named("probe.sync"))
        for name in ("probe.mxu.timed", "probe.hbm_read.timed", "probe.hbm_write.timed"):
            (timed,) = cycle.named(name)
            assert not any(s.parent is timed for s in cycle.named("probe.sync")), name
    size, inner = config.probe_matmul_size, config.probe_matmul_inner_iters
    with ici.GRAPHS.hold((cuda_device.index, size, inner)) as kept:
        got = kept.out.double()
        carry, b = (t.double() for t in kept.operands)
    for _ in range(inner):
        carry = carry @ b / size**0.5
    gap = float(torch.linalg.norm(got - carry) / torch.linalg.norm(carry))
    assert bool(torch.isfinite(got).all()) and gap < 0.03, gap
    print("card cycles: counters", [c.counters for c in cycles], "gemm_chain_gap", gap,
          "stages_ms", [e["stages_ms"] for e in entries])
