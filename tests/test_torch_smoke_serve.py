"""The port's serve, history and trace smokes (``python -m
k8s_watcher_tpu_torch.serve_smoke`` / ``.history_smoke`` / ``.trace_smoke``)
held against the JAX package's scripts of the same names, at the
reference's own sizes, the port's apps on the CPU
(``test_torch_smoke_pair.run_pair``: both exit 0, equal check sets, every
check true). The drills share a file, so that they run one after another on
one worker.

Fields compared, besides the checks. serve: ``compact_horizon``, the
snapshot's object count, both clients' codecs, the resume loop's gaps, dups,
resyncs and model match, the stream's frame types, both 410 legs and the
``/healthz`` serve fold's health and subscribers. history: the capture's and
the resumed consumer's gaps, dups and resyncs, the model match, the ``?at=``
status, object count and match, and the offline replays' rv mismatches (the
two replays' agreement is the ``replay_byte_identical`` check). trace: the
sample rate, the six-stage trace's sampling, outcome and stage set, and the
joined journey's outcome and cluster, each side's holding the whole
watch-to-global-view path. Timing fields, span times, rvs and ports are
left out.
"""

from k8s_watcher_tpu_torch.trace_smoke import JOURNEY_STAGES
from test_torch_smoke_pair import assert_equal, pick, run_pair


def test_serve_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("serve_smoke", tmp_path, monkeypatch)
    fields = ("compact_horizon", "snapshot.objects", "codecs", "resume_loop.gaps", "resume_loop.dups",
              "resume_loop.resyncs", "resume_loop.model_matches_snapshot", "stream.types", "gone.gone_410",
              "gone.stale_epoch_410", "healthz_serve.healthy", "healthz_serve.subscribers")
    assert_equal(pick(reference, *fields), pick(port, *fields))


def test_history_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("history_smoke", tmp_path, monkeypatch)
    fields = ("capture.gaps", "capture.dups", "capture.resyncs", "resume.gaps", "resume.dups", "resume.resyncs",
              "resume.model_matches_snapshot", "time_travel.status", "time_travel.objects", "time_travel.matches",
              "replay.rv_mismatches")
    assert_equal(pick(reference, *fields), pick(port, *fields))


def _trace_shape(trace: dict, *keys: str) -> dict:
    return {**{k: trace[k] for k in keys}, "stages": sorted({s["stage"] for s in trace["spans"]})}


def test_trace_smoke_twin_matches_the_reference(tmp_path, monkeypatch):
    reference, port = run_pair("trace_smoke", tmp_path, monkeypatch)
    assert reference["sample_rate"] == port["sample_rate"]
    assert_equal(*(_trace_shape(side["six_stage_trace"], "sampled_by", "outcome") for side in (reference, port)))
    joined = [side["federation"]["joined_trace"] for side in (reference, port)]
    assert_equal(*({k: trace[k] for k in ("outcome", "cluster")} for trace in joined))
    for trace in joined:
        assert set(JOURNEY_STAGES) <= {s["stage"] for s in trace["spans"]}
