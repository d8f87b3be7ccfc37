"""The port's federation, fan-in and relay smokes (``python -m
k8s_watcher_tpu_torch.federation_smoke`` / ``.fanin_smoke`` /
``.relay_smoke``) held against the JAX package's scripts of the same names
at the reference's own sizes, the port's apps on the CPU
(``test_torch_smoke_pair.run_pair``: both exit 0, equal check sets, every
check true). The drills share a file, so that they run one after another on
one worker. federation: two upstreams and a federator, an upstream stopped
and restarted. fan-in: ``federation.processes: 2``, a merge worker
SIGKILLed, an upstream darkened. relay: the relay a real subprocess
(``python -m k8s_watcher_tpu_torch.relay_smoke --relay-child``), killed and
restarted.

Fields compared, besides the checks. federation: the global consumer's gaps,
dups, resyncs and model match, the merged object count, each upstream's
object count (cluster-b's while cluster-a was dark, both at the end) and the
negotiated codecs. fan-in: the global consumer's gaps, dups, resyncs and
model match, the merged object count and the workers' pipe sequence gaps.
relay: the consumer's gaps, dups and resyncs, and the relay fold's depth,
sync and frame encodes before and after the restart. Delivered and frame
counts, pids, rvs, ports and transport errors are left out.
"""

from test_torch_smoke_pair import assert_equal, pick, run_pair


def test_federation_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("federation_smoke", tmp_path, monkeypatch)
    fields = ("consumer.gaps", "consumer.dups", "consumer.resyncs", "consumer.model_matches_snapshot",
              "metrics.federation_merged_objects.value", "degraded_health.cluster_b_objects", "upstream_a.objects",
              "upstream_b.objects", "codecs")
    assert_equal(pick(reference, *fields), pick(port, *fields))


def test_fanin_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("fanin_smoke", tmp_path, monkeypatch)
    fields = ("consumer.gaps", "consumer.dups", "consumer.resyncs", "consumer.model_matches_snapshot",
              "metrics.federation_merged_objects.value", "worker_stats.wire_gaps")
    assert_equal(pick(reference, *fields), pick(port, *fields))


def test_relay_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("relay_smoke", tmp_path, monkeypatch)
    fields = ("consumer.gaps", "consumer.dups", "consumer.resyncs", "relay_fold_pre_restart.depth",
              "relay_fold_pre_restart.frame_encodes", "relay_fold_post_restart.synced",
              "relay_fold_post_restart.frame_encodes", "relay_fold_post_restart.depth")
    assert_equal(pick(reference, *fields), pick(port, *fields))
