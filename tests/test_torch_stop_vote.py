"""The probe group stops as one (probe/agent.py's stop vote), on four gloo
ranks in CPU processes (parallel/cpu_ranks.py), and at one rank.

Each of the four ranks first runs the collectives the cycle is made of once
outside any cycle (the latency chain, the bandwidth all-reduce, the pair
exchanges of its links in the ring, the findings gather) and keeps what they
returned; then it runs ``probe_agent.run_loop`` on the CPU until the group
stops. One rank is asked to stop in the middle of a cycle (from the report's
observer, before the cycle's vote): every rank must end after the same cycle,
each cycle ending in the vote, and every ``run_loop`` must return with its
loop joined. The values are held to ``portbench/reference/ranks.py``, which
works them out from the stages' definitions, as are the collective calls the
``collectives`` counter counts in each cycle.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from k8s_watcher_tpu_torch.config import AgentConfig, ClusterApiConfig, TpuConfig
from k8s_watcher_tpu_torch.parallel.cpu_ranks import run_cpu_ranks
from k8s_watcher_tpu_torch.probe import spans
from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
from portbench.reference.ranks import (
    CollectivePlan,
    bandwidth_elements,
    bandwidth_sum,
    chain_fixed_point,
    gathered_rows_off,
    pair_round_trip,
    ring_links,
)

WORLD = 4
STOP_RANK, STOP_AFTER = 2, 3  # rank 2 is asked to stop in its third cycle
PAYLOAD = 4096
# every stage at CPU sizes; latency limits far above a loaded CPU's jitter,
# so only a fault could make a cycle unhealthy
PROBE = dict(probe_enabled=True, probe_interval_seconds=0.0, probe_payload_bytes=PAYLOAD, probe_matmul_size=64,
             probe_hbm_bytes=1 << 20, probe_trend_enabled=False, probe_links_enabled=True,
             probe_link_rtt_floor_ms=250.0, probe_rtt_warn_ms=1000.0)


def collective_values(rank: int, world: int) -> dict:
    """What this rank's collectives return, run once outside any cycle."""
    from k8s_watcher_tpu_torch.parallel.collectives import (
        bandwidth_probe_input,
        make_allreduce_bandwidth_probe,
        make_pair_probe,
        make_psum_probe,
        pair_probe_input,
        psum_probe_input,
    )
    from k8s_watcher_tpu_torch.parallel.mesh import host_chip_mesh
    from k8s_watcher_tpu_torch.probe.device import all_gather_rows

    mesh = host_chip_mesh(torch.device("cpu"))
    chain = make_psum_probe(mesh, 10)(psum_probe_input(mesh))
    total = make_allreduce_bandwidth_probe(mesh, PAYLOAD)(bandwidth_probe_input(mesh, PAYLOAD))
    pairs = {}
    for name, a, b in ring_links(world):  # in the walk's order, so overlapping pairs meet
        if rank in (a, b):
            fn, _ = make_pair_probe(a, b, 8)
            pairs[name] = fn(pair_probe_input(a, b, torch.device("cpu"))).item()
    mine = json.dumps([f"rank {rank}"]).encode()
    rows = all_gather_rows(mine)
    return {"chain": chain.tolist(), "bandwidth": [total.numel(), sorted(set(total.float().reshape(-1).tolist()))],
            "pairs": pairs, "gather": [mine.decode(), [r.decode() for r in rows]]}


def stand_in_for_graphs() -> None:
    """The card's path on the CPU: the group's timed collectives kept as
    graphs (probe/timing.py:CollectiveGraphs), a capture standing in as two
    runs of the call (the run ahead of the capture, and the capture), a
    launch as nothing and a timed launch as a 0.01 ms reading of the output."""
    from k8s_watcher_tpu_torch.probe import ici, links, timing

    class Graph:
        def replay(self):
            pass

    def capture(fn, device):
        fn()
        return Graph(), fn()

    ici.times_on_device = links.times_on_device = lambda device, n: n > 1
    timing.capture_graph = capture
    timing.collective_times_ms = lambda graph, out, barrier, iters, device: [(0.01, timing.read_scalar(out))] * iters


def rank_loop(rank: int, world: int, *, sink_url: str, graphs: bool = False) -> dict:
    """One rank: its collectives' values, then its loop until the group
    stops; every cycle's spans (name, parent) and counters. With ``graphs``
    the timed collectives take the card's path (:func:`stand_in_for_graphs`)."""
    from k8s_watcher_tpu_torch.probe_agent import run_loop

    if graphs:
        stand_in_for_graphs()
    os.environ.update(LOCAL_RANK=str(rank), NODE_NAME="cpu-node-0")
    values = collective_values(rank, world)
    config = AgentConfig(tpu=TpuConfig(**PROBE), clusterapi=ClusterApiConfig(base_url=sink_url, api_key="k"))
    stop, asked = threading.Event(), []

    def started(loop):
        def observer(report):
            asked.append(stop.is_set())
            if rank == STOP_RANK and len(asked) == STOP_AFTER:
                stop.set()  # inside the cycle: its vote comes after the observer

        loop.agent.report_observer = observer

    t0 = time.monotonic()
    loop = run_loop(config, "test", stop, device="cpu", expected_platform="cpu", started=started)
    cycles = spans.cycles_between(t0, time.monotonic())
    return {
        "values": values,
        "joined": loop.joined,
        "stopped": loop.agent.stopped.is_set(),
        "cycles": [{"spans": [[s.name, s.parent.name if s.parent else None, s.start] for s in c.spans],
                    "collectives": c.counters["collectives"], "syncs": c.counters["syncs"]} for c in cycles],
        "entries": loop.agent.recent_cycles(64)[::-1],
    }


class _Sink(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 — http.server's name
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def run_ranks(**kwargs) -> list:
    sink = ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{sink.server_port}"
        return run_cpu_ranks("tests.test_torch_stop_vote:rank_loop", WORLD, {"sink_url": url, **kwargs})
    finally:
        sink.shutdown()
        sink.server_close()


@pytest.fixture(scope="module")
def ranks():
    return run_ranks()


@pytest.fixture(scope="module")
def graphed_ranks():
    return run_ranks(graphs=True)


def test_a_stop_asked_of_one_rank_mid_cycle_ends_every_rank_after_the_same_cycle(ranks):
    counts = [len(r["cycles"]) for r in ranks]
    assert counts == [counts[0]] * WORLD and counts[0] >= STOP_AFTER, counts
    assert all(r["joined"] is True and r["stopped"] for r in ranks)
    for r in ranks:
        # every cycle ends in the vote, and the group's last vote was its only stop
        for c in r["cycles"]:
            last = max((s for s in c["spans"] if s[1] == "probe.cycle"), key=lambda s: s[2])
            assert last[0] == "probe.stop_vote", last


def test_the_new_spans_nest_as_stated(ranks):
    for r in ranks:
        for c in r["cycles"]:
            parents = {}
            for name, parent, _ in c["spans"]:
                parents.setdefault(name, set()).add(parent)
            assert parents["probe.ici.bandwidth"] == {"probe.ici.timed"}
            assert parents["probe.gather"] == {"probe.cycle"}
            assert parents["probe.stop_vote"] == {"probe.cycle"}
            assert parents["probe.report"] == {"probe.cycle"} and parents["probe.observer"] == {"probe.report"}
            assert "probe.stop_vote" in parents["probe.sync"]  # the vote's readback
        for entry in r["entries"]:
            assert {"gather", "stop_vote", "report", "links"} <= set(entry["stages_ms"])


def test_collectives_counts_the_calls_the_plan_says(ranks):
    plan = CollectivePlan(WORLD, links_enabled=True)
    for rank, r in enumerate(ranks):
        got = [c["collectives"] for c in r["cycles"]]
        assert got == [plan.total(rank, first=k == 0) for k in range(len(got))], (rank, got)
        assert [e["collectives"] for e in r["entries"]] == got  # /debug/probes shows it beside syncs
        assert [e["syncs"] for e in r["entries"]] == [c["syncs"] for c in r["cycles"]]
    # each rank walks the two links of the ring that touch it
    assert plan.calls(0, first=False)["exchange"] == 2 * 6 * 9


def test_on_the_cards_path_collectives_counts_the_calls_the_plan_says(graphed_ranks):
    """Kept as graphs, the timed collectives call into torch.distributed only
    in the group's first cycle, as ``CollectivePlan(on_card=True)`` says;
    the group still stops as one."""
    plan = CollectivePlan(WORLD, links_enabled=True, on_card=True)
    counts = [len(r["cycles"]) for r in graphed_ranks]
    assert counts == [counts[0]] * WORLD and counts[0] >= STOP_AFTER, counts
    for rank, r in enumerate(graphed_ranks):
        got = [c["collectives"] for c in r["cycles"]]
        assert got == [plan.total(rank, first=k == 0) for k in range(len(got))], (rank, got)
        assert r["joined"] is True and all(e["healthy"] for e in r["entries"]), r["entries"]


def test_the_references_values_equal_the_programs(ranks):
    inputs = [r["values"]["gather"][0] for r in ranks]
    for rank, r in enumerate(ranks):
        v = r["values"]
        assert v["chain"] == [chain_fixed_point(WORLD)] == [2.5]
        assert v["bandwidth"] == [bandwidth_elements(PAYLOAD), [bandwidth_sum(WORLD)]]
        mine = {name for name, a, b in ring_links(WORLD) if rank in (a, b)}
        assert set(v["pairs"]) == mine and all(x == pair_round_trip() == 3.0 for x in v["pairs"].values())
        assert gathered_rows_off(inputs, v["gather"][1]) == 0
    assert gathered_rows_off(inputs, inputs[:1] + ['["other"]'] + inputs[2:]) == 1
    assert [name for name, _, _ in ring_links(WORLD)] == [
        "host0/chip0-chip1", "host0/chip1-chip2", "host0/chip2-chip3", "host0/chip3-chip0"]


def test_at_one_rank_the_loop_makes_no_stop_vote_and_no_collective_for_it(monkeypatch):
    """A group of one rank has no peer to ask: no vote, no gather, and no
    collective but the latency chain's all-reduces over its group of one."""
    import torch.distributed as dist

    calls = []

    def counted(name, real):
        def call(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return call

    for name in ("all_reduce", "all_gather_into_tensor", "batch_isend_irecv"):
        monkeypatch.setattr(dist, name, counted(name, getattr(dist, name)))
    done, seen = threading.Event(), []
    probe = ProbeAgent(TpuConfig(**dict(PROBE, probe_interval_seconds=0.01)), environment="test",
                       sink=lambda n: None, expected_platform="cpu", device="cpu")
    probe.report_observer = lambda report: (seen.append(report), len(seen) >= 2 and done.set())
    t0 = time.monotonic()
    probe.start()
    thread = probe._thread
    try:
        assert done.wait(60)
    finally:
        assert probe.stop()
        if dist.is_initialized():  # the first cycle started a group of one; end it as run_loop would
            dist.destroy_process_group()
    assert not thread.is_alive() and probe.stopped.is_set()
    cycles = [c for c in spans.cycles_between(t0, time.monotonic()) if c.span.thread == thread.native_id]
    assert len(cycles) >= 2
    chain = CollectivePlan(1).calls(0, first=True)
    assert chain == {"all_reduce": 110, "all_gather": 0, "exchange": 0}
    for c in cycles:
        assert not c.named("probe.stop_vote") and not c.named("probe.gather")
        assert c.counters["collectives"] == chain["all_reduce"]
    assert calls == ["all_reduce"] * chain["all_reduce"] * len(cycles)
