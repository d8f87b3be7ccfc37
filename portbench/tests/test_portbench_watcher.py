"""``watcher-churn-probe``'s plain reference (``reference/watcher.py``), its
churn (``traffic/cluster.py``) and its driver (``drivers/watcher_churn.py``)
on the CPU at a tiny size: production's ``WatcherApp`` with its in-process
probe against a seeded 16-node, 300-pod cluster and 2,000 churn events. A
sound run is correct, with every compared number 0 but the GEMM's; the
counter of watch events equals the events the WATCH delivered; and each of
three faults in the program's egress reads over its limit."""

from __future__ import annotations

import itertools
import threading

import pytest

from portbench import harness
from portbench.reference.watcher import compare, fold_production, received_item
from portbench.tests.watcher_tiny import COMPARED, NEW, TINY_CLUSTER, failing, run_tiny_watcher
from portbench.traffic.cluster import UNWATCHED_NAMESPACE, GpuCluster


def tiny_cluster(seed: int = 7, **sizes) -> GpuCluster:
    return GpuCluster(seed, **{**TINY_CLUSTER, **sizes}, churn=0, failures=0, down_deletions=0, node_flips=0,
                      listed_ready=True)


def test_open_churn_is_seeded_and_holds_its_shares():
    # JobSets enough that an episode seldom waits for one (one open at a time in each)
    sizes = {"nodes": 256, "pods": 3000, "jobsets": 32}
    cluster = tiny_cluster(**sizes)
    steps = list(itertools.islice(cluster.open_churn(11), 40000))
    again = list(itertools.islice(tiny_cluster(**sizes).open_churn(11), 40000))
    assert [(k, s.uid, p, r, n, rv) for k, s, p, r, n, rv in steps] == \
        [(k, s.uid, p, r, n, rv) for k, s, p, r, n, rv in again]
    assert [rv for *_, rv in steps] == list(range(cluster.list_rv + 1, cluster.list_rv + 1 + len(steps)))
    workers = [s for s in steps if s[1].gpus and s[1].namespace != UNWATCHED_NAMESPACE]
    assert 0.005 < len(workers) / len(steps) < 0.015
    assert {(k, p) for k, _, p, *_ in workers} >= {("MODIFIED", "Failed"), ("MODIFIED", "Succeeded"),
                                                 ("DELETED", "Running"), ("ADDED", "Pending"), ("MODIFIED", "Running")}
    routine = [s for s in steps if not (s[1].gpus and s[1].namespace != UNWATCHED_NAMESPACE)]
    assert {k for k, *_ in routine} == {"MODIFIED"}
    # every pod is 2-4 KiB as listed
    sizes = [len(s.encode(rv, p, r, n)) for _, s, p, r, n, rv in cluster.initial]
    assert 2048 <= min(sizes) and max(sizes) <= 4096


def test_the_fold_calls_for_each_notification_and_compare_finds_each_fault():
    cluster = tiny_cluster()
    steps = list(itertools.islice(cluster.open_churn(11), 6000))
    sent = []
    last, transitions = fold_production(GpuCluster.facts(cluster.initial) + GpuCluster.facts(steps), sent=sent)
    pods = [item for _, item in sent if item[0] == "pod"]
    assert {item[1] for item in pods} == {"MODIFIED", "DELETED"}  # the critical gate: terminal or gone
    assert len([i for _, i in sent if i[0] == "slice"]) == sum(len(t) for t in transitions.values())
    assert {uid: (i[1], i[5], i[3], i[4]) for uid, i in sent if i[0] == "pod"} == last
    assert compare(sent, sent) == {"payloads_wrong": 0, "notifications_lost": 0, "out_of_order": 0}
    assert compare(sent, sent[1:])["notifications_lost"] == 1
    key, item = next((k, i) for k, i in sent if i[0] == "pod")
    altered = [(k, i[:7] + ("elsewhere",) + i[8:] if (k, i) == (key, item) else i) for k, i in sent]
    assert compare(sent, altered)["payloads_wrong"] == 1
    twice = next(k for k, _ in sent if sum(1 for j, _ in sent if j == k) >= 2)
    a, b = [n for n, (k, _) in enumerate(sent) if k == twice][:2]
    swapped = list(sent)
    swapped[a], swapped[b] = swapped[b], swapped[a]
    assert compare(sent, swapped) == {"payloads_wrong": 0, "notifications_lost": 0, "out_of_order": 1}


def test_received_payloads_read_as_the_fold_has_them():
    slice_payload = {"event_type": "SLICE_PHASE_CHANGE", "slice": "production/train-000/workers",
                     "phase_transition": {"from": "Ready", "to": "Degraded"}}
    assert received_item(slice_payload) == ("production/train-000/workers",
                                            ("slice", "production/train-000/workers", "Ready", "Degraded"))
    assert received_item({"event_type": "TPU_PROBE", "healthy": True}) is None
    assert received_item({"event_type": "TPU_HEALTH"}) is None


def test_the_cell_runs_and_is_correct():
    result, outcome = run_tiny_watcher()
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2, result
    assert set(result["metrics"]) == {"probe_cycle_ms", "setup_s"}
    assert set(result["compared"]) == COMPARED
    assert all(v["value"] == 0.0 for k, v in result["compared"].items() if k != "gemm_chain_gap")
    obs = outcome.observation
    # the watch_events counter is every event the WATCH delivered
    assert obs["events_delivered"] == 2000 and obs["events_taken"] == obs["events_delivered"]
    read = {name: harness.load_reader(name)(obs) for name in NEW}
    assert read["watch_batch_ms.watch"] > 0 and read["egress_post_ms.watch"] > 0
    assert 500 < read["events_taken_per_s.watch"] < 1500  # 1,000 offered a second


class EgressFault:
    """One fault in what the program's egress POSTs, put in
    ``ClusterApiClient``'s two send calls: ``fault(payloads)`` gives what is
    sent in their place."""

    def __init__(self, monkeypatch, fault):
        from k8s_watcher_tpu_torch.notify.client import ClusterApiClient

        self.fault, self.lock, self.fired = fault, threading.Lock(), 0
        one, many = ClusterApiClient.update_pod_status, ClusterApiClient.update_pod_statuses

        def update_pod_status(client, payload):
            return all([one(client, p) for p in self.apply([payload])])

        def update_pod_statuses(client, payloads):
            sent = self.apply(list(payloads))
            if sent:
                many(client, sent)
            return [True] * len(payloads)

        monkeypatch.setattr(ClusterApiClient, "update_pod_status", update_pod_status)
        monkeypatch.setattr(ClusterApiClient, "update_pod_statuses", update_pod_statuses)

    def apply(self, payloads):
        with self.lock:
            return self.fault(self, payloads)


def drop_a_deleted(fault, payloads):
    keep = [p for p in payloads if fault.fired or p.get("event_type") != "DELETED"]
    fault.fired += len(payloads) - len(keep)
    return keep


def alter_a_node(fault, payloads):
    out = []
    for p in payloads:
        if not fault.fired and p.get("event_type") in ("MODIFIED", "DELETED"):
            p = dict(p, spec=dict(p["spec"], node_name="gpu-node-9999"))
            fault.fired += 1
        out.append(p)
    return out


def hold_a_slice_change(fault, payloads):
    """The first Ready -> Degraded of a slice waits for that slice's next."""
    out = []
    for p in payloads:
        key = p.get("slice") if p.get("event_type") == "SLICE_PHASE_CHANGE" else None
        if key and not fault.fired and p["phase_transition"]["from"] == "Ready":
            fault.held, fault.fired = (key, p), 1
            continue
        out.append(p)
        held = getattr(fault, "held", None)
        if held and held[0] == key:
            out.append(held[1])
            fault.held = None
    return out


@pytest.mark.parametrize("fault, number", [(drop_a_deleted, "notifications_lost"),
                                           (alter_a_node, "payloads_wrong"),
                                           (hold_a_slice_change, "out_of_order")])
def test_each_fault_in_the_egress_reads_over_its_limit(monkeypatch, fault, number):
    egress = EgressFault(monkeypatch, fault)
    result, _ = run_tiny_watcher()
    assert egress.fired == 1
    assert result["correct"] is False and number in failing(result), result["compared"]
