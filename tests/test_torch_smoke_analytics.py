"""The port's analytics and columnar smokes (``python -m
k8s_watcher_tpu_torch.analytics_smoke`` / ``.columnar_smoke``) held against
the JAX package's scripts of the same names, the port's analytics on the CPU
(``test_torch_smoke_pair.run_pair``: both exit 0, equal check sets, every
check true). The analytics smoke runs at the reference's own size. The
columnar smoke runs on both sides at ``COLUMNAR_SMOKE_PODS=2000`` (the
reference reads it at import; the twin takes ``--pods 2000``) instead of
its default of 50,000, so that it fits the tier; its churn, parked and
deleted counts scale from it as in the reference.

Fields compared, besides the checks. analytics: the local and merged
``/serve/analytics`` summaries (all but ``rv`` and ``backend``, which says
``jax`` against ``torch``), the drain-cluster-a and cordon-la-1 verdicts,
and the bulk replay's scenario count and batched verdicts. columnar:
``pods``, ``churned``, ``parked_pending``, ``deleted``, ``objects``,
``health_subjects``, ``health_ticks`` and the analytics fleet rollup.
Floats may differ by 1e-6 relative (JAX on the CPU against torch).
"""

from test_torch_smoke_pair import assert_equal, pick, run_pair


def _summary(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("rv", "backend")}


def test_analytics_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("analytics_smoke", tmp_path, monkeypatch)
    for key in ("local_summary", "merged_summary"):
        assert reference[key]["backend"] == "jax" and port[key]["backend"] == "torch"
        assert_equal(_summary(reference[key]), _summary(port[key]))
    fields = ("drain_cluster_a", "cordon_la_1", "replay.scenarios", "replay.batched")
    assert_equal(pick(reference, *fields), pick(port, *fields))
    assert port["analytics_histograms"]["analytics_kernel_seconds"]["count"] > 0


def test_columnar_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("COLUMNAR_SMOKE_PODS", "2000")
    reference, port = run_pair("columnar_smoke", tmp_path, monkeypatch, "--pods", "2000")
    fields = ("pods", "churned", "parked_pending", "deleted", "objects", "health_subjects", "health_ticks",
              "analytics_fleet")
    assert_equal(pick(reference, *fields), pick(port, *fields))
    assert reference["pods"] == 2000
