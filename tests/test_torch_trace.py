"""The port's tracing plane held against the JAX package's.

The same seeded event streams go through both packages' sharded ingest,
pipeline and keyed dispatcher (sending to a recording function), with the
same sample rate: the head-sampling decisions (which uids carry a trace, on
which shard), the ring's entries (outcome, kind, shard, lane, sampling, stage
names in order) and the per-stage histogram counts must match. The
reference's own tracing scenarios (``tests/test_trace.py``) are replayed
through the port whole: the serve wire's ``?trace=1`` frames, the
federator's trace joining (``FleetTraceCollector``), ``/debug/trace/diagnosis``
and the ``trace.federation`` schema included.
"""

import numpy as np
import pytest

from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu.notify.dispatcher import Dispatcher as RefDispatcher
from k8s_watcher_tpu.pipeline.pipeline import EventPipeline as RefPipeline
from k8s_watcher_tpu.slices.tracker import SliceTracker as RefSliceTracker
from k8s_watcher_tpu.trace import ALL_STAGES as REF_ALL_STAGES
from k8s_watcher_tpu.trace import STAGES as REF_STAGES
from k8s_watcher_tpu.trace import Tracer as RefTracer
from k8s_watcher_tpu.watch.fake import build_pod
from k8s_watcher_tpu.watch.fake import sharded_fake_sources as ref_sharded_fake_sources
from k8s_watcher_tpu.watch.sharded import ShardedWatchSource as RefSharded
from k8s_watcher_tpu.watch.source import WatchEvent as RefWatchEvent
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.notify.dispatcher import Dispatcher
from k8s_watcher_tpu_torch.pipeline.pipeline import EventPipeline
from k8s_watcher_tpu_torch.slices.tracker import SliceTracker
from k8s_watcher_tpu_torch.trace import ALL_STAGES, STAGES, Tracer
from k8s_watcher_tpu_torch.watch.fake import sharded_fake_sources
from k8s_watcher_tpu_torch.watch.sharded import ShardedWatchSource
from k8s_watcher_tpu_torch.watch.source import WatchEvent
from test_torch_replay import replay, replayed_tests

PACKAGES = {
    "ref": (RefRegistry, RefDispatcher, RefPipeline, RefSliceTracker, RefTracer, ref_sharded_fake_sources,
            RefSharded, RefWatchEvent),
    "port": (MetricsRegistry, Dispatcher, EventPipeline, SliceTracker, Tracer, sharded_fake_sources,
             ShardedWatchSource, WatchEvent),
}


def script(seed, n=300):
    """Seeded (type, pod) pairs: accelerator and plain pods, phase churn,
    deletions, bookmarks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        uid = int(rng.integers(60))
        roll = rng.random()
        if roll < 0.05:
            out.append(("BOOKMARK", {"metadata": {"resourceVersion": str(i)}}))
            continue
        kind = "DELETED" if roll < 0.12 else ("ADDED" if roll < 0.3 else "MODIFIED")
        out.append((kind, build_pod(f"p{uid}", uid=f"uid-{uid}", tpu_chips=4 if uid % 3 else 0,
                                    phase=str(rng.choice(["Pending", "Running", "Failed"])))))
    return out


def run(pkg, events, *, rate, shards, fail_every=0):
    registry_cls, dispatcher_cls, pipeline_cls, slice_cls, tracer_cls, fakes, sharded_cls, event_cls = PACKAGES[pkg]
    metrics = registry_cls()
    tracer = tracer_cls(sample_rate=rate, ring_size=512, metrics=metrics)
    sent = []

    def send(payload):
        sent.append(payload.get("uid"))
        # deterministic failures: every fail_every-th POST of the run fails
        return not fail_every or len(sent) % fail_every != 0

    # one worker: a deterministic lane and delivery order
    dispatcher = dispatcher_cls(send, workers=1, capacity=4096, coalesce=False, metrics=metrics, tracer=tracer)
    pipeline = pipeline_cls(environment="development", sink=dispatcher.submit,
                            slice_tracker=slice_cls("development"), metrics=metrics, tracer=tracer)
    stream = [event_cls(type=t, pod=p) for t, p in events]
    source = sharded_cls(fakes(stream, shards), batch_max=16, queue_capacity=4096, tracer=tracer)
    for batch in source.batches():
        pipeline.process_batch(batch)
    assert dispatcher.drain(10.0)
    dispatcher.stop()
    sampled = sorted((e.uid, e.type, e.trace.shard) for e in stream if e.trace is not None)
    entries = sorted((
        (t["uid"], t["outcome"], t["kind"], t["shard"], t["lane"], t["sampled_by"], t["anomaly"],
         t["attempts"], tuple(s["stage"] for s in t["spans"]))
        for t in tracer.ring.snapshot()
    ), key=repr)
    counts = {k: v["count"] for k, v in metrics.dump().items() if k.startswith("trace_")}
    return sampled, entries, counts


@pytest.mark.parametrize("rate", [1, 4, 256])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_same_samples_spans_and_counts(seed, shards, rate):
    events = script(seed)
    want = run("ref", events, rate=rate, shards=shards, fail_every=7)
    got = run("port", events, rate=rate, shards=shards, fail_every=7)
    assert got == want
    sampled, entries, _ = got
    assert sampled
    if rate == 1:
        # failed sends are anomalies; clean ones carry every stage but the
        # pooled client's conn_borrow (the send here is a plain function)
        assert any(e[1] == "failed" and e[6] for e in entries)
        five = [s for s in STAGES if s != "conn_borrow"]
        assert any(e[1] == "sent" and list(e[-1]) == five for e in entries)


def test_stage_vocabulary_matches():
    assert STAGES == REF_STAGES and ALL_STAGES == REF_ALL_STAGES


_REWRITES = [
    ("k8s_watcher_tpu.metrics.server", "k8s_watcher_tpu_torch.status"),
    ("k8s_watcher_tpu.metrics.audit", "k8s_watcher_tpu_torch.audit"),
    ("k8s_watcher_tpu.config.schema import AppConfig, SchemaError",
     "k8s_watcher_tpu_torch.config import AppConfig, ConfigError as SchemaError"),
    ("k8s_watcher_tpu.config.schema", "k8s_watcher_tpu_torch.config"),
]
globals().update(replayed_tests(replay("test_trace.py", rewrites=_REWRITES)))


def test_every_name_of_the_single_module_trace_still_imports():
    """The tracing plane became a package (``trace/trace.py`` and
    ``trace/federation.py``); every name the single module exported still
    imports from ``k8s_watcher_tpu_torch.trace`` and is the module's own."""
    import k8s_watcher_tpu_torch.trace.trace as module
    from k8s_watcher_tpu_torch.trace import (  # noqa: F401
        ALL_STAGES,
        ANOMALY_OUTCOMES,
        FEDERATE_MERGE_STAGE,
        FEDERATION_STAGES,
        GLOBAL_SERVE_STAGE,
        SERVE_STAGE,
        SERVE_WIRE_STAGE,
        STAGES,
        WAL_STAGE,
        Trace,
        TraceRing,
        TraceSampler,
        Tracer,
        clear_current_traces,
        current_traces,
        export_trace,
        logger,
        new_trace_id,
        note_send_attempt,
        observe_conn_borrow,
        send_attempts,
        set_current_traces,
        trace_from_wire,
        wire_trace,
    )

    names = dict(locals())
    del names["module"]
    assert len(names) == 24
    assert all(getattr(module, name) is obj for name, obj in names.items())
