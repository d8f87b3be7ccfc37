"""Reader-process factories for the replays of ``tests/test_ingest_procs.py``
and ``tests/test_proc_obs.py`` through the port (``test_torch_ingest_procs.py``,
``test_torch_proc_obs.py``).

A ``WorkerPlan`` and a supervised target are pickled into a spawned child,
which re-imports them by module name. The replayed test modules exist only in
the parent (they are executed from source), so the functions a child must
resolve live here, in a module the child can import. It imports the port
alone, neither jax nor torch, so a spawn pays neither import. Each function
is the one of the same name in its test file, with the port's modules. This
file holds no tests.
"""

import json
import os

from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.parallel.procpool import pack
from k8s_watcher_tpu_torch.trace import Tracer, export_trace
from k8s_watcher_tpu_torch.watch.fake import FakeWatchSource, build_pod, shard_streams
from k8s_watcher_tpu_torch.watch.source import WatchEvent


def _events(n: int, prefix: str):
    return [
        WatchEvent(
            type="ADDED",
            pod=build_pod(f"{prefix}-{i}", uid=f"{prefix}-uid-{i}", resource_version=str(i + 1), tpu_chips=4),
            resource_version=str(i + 1),
        )
        for i in range(n)
    ]


# -- tests/test_ingest_procs.py (pods "pp-*") ----------------------------------


def ingest_replay_factory(plan):
    """Finite scripted streams, rebuilt deterministically in the child."""
    n, shards = plan.factory_arg
    streams = shard_streams(_events(n, "pp"), shards)
    return [FakeWatchSource(streams[s]) for s in plan.owned_shards]


def ingest_slow_holdopen_factory(plan):
    """Slow hold-open streams: stay alive until stopped (kill targets)."""
    n, shards = plan.factory_arg
    streams = shard_streams(_events(n, "pp"), shards)
    return [FakeWatchSource(streams[s], delay_seconds=0.01, hold_open=True) for s in plan.owned_shards]


class _CountingReplaySource:
    """Replays raw frames through the decode seam (``decode_watch_chunks`` +
    ``PythonFrameScanner``), counting the skipped frames."""

    def __init__(self, n, keep_every):
        self.n = n
        self.keep_every = keep_every
        self.prefiltered = 0
        self._stop = False

    def events(self):
        from k8s_watcher_tpu_torch.k8s.client import decode_watch_chunks
        from k8s_watcher_tpu_torch.native.scanner import PythonFrameScanner

        frames = [
            json.dumps({
                "type": "MODIFIED",
                "object": build_pod(f"c-{i}", uid=f"c-uid-{i}", tpu_chips=8 if i % self.keep_every == 0 else 0,
                                    resource_version=str(i + 1)),
            }).encode()
            for i in range(self.n)
        ]
        stream = b"\n".join(frames) + b"\n"
        for raw in decode_watch_chunks(iter([stream]), PythonFrameScanner("google.com/tpu")):
            if self._stop:
                return
            if raw.get("type") == "PREFILTERED":
                self.prefiltered += raw.get("count", 1)
                continue
            obj = raw.get("object") or {}
            yield WatchEvent(type=raw["type"], pod=obj,
                             resource_version=(obj.get("metadata") or {}).get("resourceVersion"))

    def stop(self):
        self._stop = True


def ingest_prefilter_factory(plan):
    n, keep_every = plan.factory_arg
    return [_CountingReplaySource(n, keep_every)]


# -- tests/test_proc_obs.py (pods "po-*") --------------------------------------


def obs_holdopen_factory(plan):
    """Hold-open streams: replay, then stay alive (kill targets; a respawned
    incarnation replays from the start: no checkpoints)."""
    n, shards = plan.factory_arg
    streams = shard_streams(_events(n, "po"), shards)
    return [FakeWatchSource(streams[s], delay_seconds=0.005, hold_open=True) for s in plan.owned_shards]


def obs_replay_factory(plan):
    n, shards = plan.factory_arg
    streams = shard_streams(_events(n, "po"), shards)
    return [FakeWatchSource(streams[s]) for s in plan.owned_shards]


def obs_scripted_stale_entry(plan, conn):
    """One stats frame of the current generation, then the same cumulative
    sample stamped with the previous generation (a stale frame drained off a
    killed worker's pipe after a respawn), then EOS."""
    reg = MetricsRegistry()
    reg.counter("scripted_work").inc(5)
    tracer = Tracer(sample_rate=0, ring_size=8, metrics=reg, export_buffer=None)
    trace = tracer.start_anomaly(uid="po-uid-3", name="po-3", kind="pod")
    tracer.finish(trace, "failed")
    sample = reg.sample(include_series=True)
    conn.send_bytes(pack({"hello": {"proc": plan.proc_index, "pid": os.getpid()}}))
    conn.send_bytes(pack({"stats": {"registry": sample, "traces": [export_trace(trace)]}, "g": plan.generation}))
    conn.send_bytes(pack({"stats": {"registry": sample}, "g": plan.generation - 1}))
    conn.send_bytes(pack({"eos": True, "drained": True}))
    conn.close()


# -- tests/test_torch_import.py ------------------------------------------------


def modules_factory(plan):
    """Imports what a production reader imports (``_build_k8s_sources``:
    the watch client, the kubeconfig loader, the watch source, the registry,
    the prefilter with its native build, the checkpoint store), then streams
    one pod whose annotations list the heavy modules loaded in this child."""
    import sys

    import k8s_watcher_tpu_torch.k8s.client  # noqa: F401
    import k8s_watcher_tpu_torch.k8s.kubeconfig  # noqa: F401
    import k8s_watcher_tpu_torch.k8s.watch  # noqa: F401
    import k8s_watcher_tpu_torch.state.checkpoint  # noqa: F401
    from k8s_watcher_tpu_torch.native.scanner import make_scanner

    make_scanner("nvidia.com/gpu", mode="auto")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "k8s_watcher_tpu"))
    pod = build_pod("modules", uid="uid-modules", tpu_chips=4, annotations={"loaded": json.dumps(loaded)})
    return [FakeWatchSource([WatchEvent(type="ADDED", pod=pod, resource_version="1")])]


def fanin_modules_factory(plan, upstream):
    """A merge worker's client factory: the worker has imported what it
    runs on (the fan-in module, its registry and tracer) by the time it
    builds a client, so the heavy modules loaded in this child are listed
    into ``modules.json`` under the plan's token directory; then the
    client a production worker builds (JSON pinned, stamps on)."""
    import sys

    from k8s_watcher_tpu_torch.federate.client import CODEC_JSON, FleetClient

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "k8s_watcher_tpu"))
    with open(os.path.join(plan.token_dir, "modules.json"), "w") as fh:
        json.dump(loaded, fh)
    return FleetClient(upstream.url, token=upstream.token, timeout=5.0, codec=CODEC_JSON, fresh=True)
