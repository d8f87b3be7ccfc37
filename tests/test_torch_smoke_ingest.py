"""The port's multi-process ingest and observability smokes (``python -m
k8s_watcher_tpu_torch.ingest_smoke`` / ``.obs_smoke``) held against the JAX
package's scripts of the same names at the reference's own sizes, windows
and deadlines, the port's apps on the CPU (``test_torch_smoke_pair.run_pair``:
both exit 0, equal check sets, every check true). The drills share a file,
so that they run one after another on one worker. ingest: two spawned
reader processes, one SIGKILLed and respawned. obs: freshness and SLO legs,
then the multi-process leg.

Fields compared, besides the checks. ingest: the process and shard counts,
the consumer's gaps, dups and resyncs, the readers' wire gaps and the
per-shard checkpoint files (less a write caught in flight). obs: the
``/healthz`` status and the breaching objectives at the pause, the ghost
upstream's name, the worker processes ``/debug/processes`` lists and the
``/healthz`` processes fold's health and count. Pids, rates, watermark ages,
latencies and timings are left out.
"""

from test_torch_smoke_pair import assert_equal, pick, run_pair


def test_ingest_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("ingest_smoke", tmp_path, monkeypatch)
    fields = ("processes", "shards", "consumer.gaps", "consumer.dups", "consumer.resyncs", "final_stats.wire_gaps")
    assert_equal(pick(reference, *fields), pick(port, *fields))
    # the drill lists the shard directory while the readers still write it: a
    # write in flight (``<file>XXXXXXXX.tmp``, random) is no checkpoint file
    committed = [sorted(f for f in side["checkpoint_files"] if not f.endswith(".tmp")) for side in (reference, port)]
    assert committed[0] == committed[1]
    assert all(f"shard-{i}-of-2.json" in committed[1] for i in range(2))


def test_obs_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("obs_smoke", tmp_path, monkeypatch)
    fields = ("healthz_at_breach.status", "healthz_at_breach.slo.breaching", "multiproc.ghost_upstream",
              "multiproc.healthz_processes.healthy", "multiproc.healthz_processes.processes")
    assert_equal(pick(reference, *fields), pick(port, *fields))
    rows = [sorted(r["process"] for r in side["multiproc"]["process_rows"]) for side in (reference, port)]
    assert rows[0] == rows[1]
