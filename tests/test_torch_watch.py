"""The port's list+watch ingest held against the JAX package's.

Each package's ``KubernetesWatchSource`` runs against its own
``MockApiServer`` (the JAX package's; the port never imports it), seeded
alike from a numpy seed, and the same cluster history is applied to both:
the paged LIST, churn on the watch, a 410 Gone that forces a relist with
tombstones, a restart that resumes from the checkpoint (with and without
compaction in between), and ``abort_watch`` ending a blocked read. Both
must yield the same ``(type, uid, resourceVersion)`` sequence, also per
shard with ``shards: 2``. Every server, thread and wait has a timeout.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from k8s_watcher_tpu.config.schema import RetryPolicy as RefRetryPolicy
from k8s_watcher_tpu.k8s.client import K8sClient as RefClient
from k8s_watcher_tpu.k8s.kubeconfig import K8sConnection as RefConnection
from k8s_watcher_tpu.k8s.mock_server import MockApiServer, MockCluster
from k8s_watcher_tpu.k8s.watch import KubernetesWatchSource as RefSource
from k8s_watcher_tpu.native.scanner import PythonFrameScanner as RefScanner
from k8s_watcher_tpu.state.checkpoint import CheckpointStore as RefStore
from k8s_watcher_tpu.watch.fake import build_pod
from k8s_watcher_tpu_torch.config import RetryPolicy
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from k8s_watcher_tpu_torch.k8s.watch import KubernetesWatchSource
from k8s_watcher_tpu_torch.native.scanner import PythonFrameScanner
from k8s_watcher_tpu_torch.state.checkpoint import CheckpointStore

PACKAGES = {
    "ref": (RefClient, RefConnection, RefSource, RefScanner, RefStore, RefRetryPolicy),
    "port": (K8sClient, K8sConnection, KubernetesWatchSource, PythonFrameScanner, CheckpointStore, RetryPolicy),
}
WAIT_S = 15.0


class FastMockApiServer(MockApiServer):
    """The mock apiserver with a 50 ms shutdown poll."""

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        return self


def seeded_pod(rng, i, generation=0, phase=None):
    return build_pod(
        f"p{i}", "default" if i % 3 else "kube-system", uid=f"uid-{i}-g{generation}",
        phase=phase or str(rng.choice(["Pending", "Running"])), tpu_chips=4 if i % 2 else 0,
    )


def seed_cluster(seed, n=30):
    rng = np.random.default_rng(seed)
    cluster = MockCluster()
    for i in range(n):
        cluster.add_pod(seeded_pod(rng, i))
    return cluster


def churn(cluster, seed, n=40, first=30):
    """Seeded mutations: phase flips, deletions, re-creations, new pods."""
    rng = np.random.default_rng(seed + 100)
    live = {pod["metadata"]["name"]: pod for pod in cluster._pods.values()}
    created = first
    for _ in range(n):
        roll = rng.random()
        names = sorted(live)
        if roll < 0.15 and names:
            name = names[int(rng.integers(len(names)))]
            cluster.delete_pod(live[name]["metadata"]["namespace"], name)
            live.pop(name)
        elif roll < 0.3:
            pod = seeded_pod(rng, created)
            created += 1
            cluster.add_pod(pod)
            live[pod["metadata"]["name"]] = pod
        elif names:
            name = names[int(rng.integers(len(names)))]
            pod = dict(live[name])
            pod["status"] = dict(pod["status"], phase=str(rng.choice(["Running", "Failed", "Succeeded"])))
            cluster.modify_pod(pod)
            live[name] = pod


class Collector:
    """Drains ``source.events()`` on a thread into ``(type, uid, rv)``."""

    def __init__(self, source):
        self.source = source
        self.events = []
        self.lock = threading.Lock()
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for event in self.source.events():
                with self.lock:
                    self.events.append((event.type, event.uid, event.resource_version))
        except Exception as exc:  # noqa: BLE001 — reported by the test
            self.error = exc

    def count(self):
        with self.lock:
            return len(self.events)

    def wait_count(self, n):
        deadline = time.monotonic() + WAIT_S
        while self.count() < n and time.monotonic() < deadline:
            time.sleep(0.01)
        assert self.count() >= n, (self.count(), n, self.error)

    def wait_idle(self, quiet=0.3):
        deadline = time.monotonic() + WAIT_S
        last, since = -1, time.monotonic()
        while time.monotonic() < deadline:
            n = self.count()
            if n != last:
                last, since = n, time.monotonic()
            elif time.monotonic() - since >= quiet:
                return
            time.sleep(0.02)

    def stop(self):
        t0 = time.monotonic()
        self.source.stop()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()
        return time.monotonic() - t0


def make_source(pkg, server, *, checkpoint_dir=None, scanner=False, shard=0, shards=1):
    client_cls, conn_cls, source_cls, scanner_cls, store_cls, retry_cls = PACKAGES[pkg]
    checkpoint = None
    if checkpoint_dir is not None:
        checkpoint = store_cls(checkpoint_dir / "ck.json", interval_seconds=0.0)
        checkpoint.attach_journaled_map("known_pods")
    return source_cls(
        client_cls(conn_cls(server=server.url), request_timeout=5.0),
        retry=retry_cls(max_attempts=3, delay_seconds=0.05, max_delay_seconds=0.2),
        watch_timeout_seconds=5, checkpoint=checkpoint, list_page_size=7,
        scanner=scanner_cls("google.com/tpu", extract_uid=shards > 1) if scanner else None,
        shard=shard, shards=shards,
    ), checkpoint


def flush_known(source, checkpoint):
    checkpoint.put("known_pods", source.known_pods(), changed_keys=source.drain_dirty_uids())
    checkpoint.flush()


def both(scenario, *args):
    """``scenario(pkg, *args)`` for both packages at once, each against its
    own server: ``(ref's result, port's result)``."""
    with ThreadPoolExecutor(2) as pool:
        ref, port = (pool.submit(scenario, pkg, *args) for pkg in ("ref", "port"))
        return ref.result(timeout=4 * WAIT_S), port.result(timeout=4 * WAIT_S)


def scenario_churn(pkg, seed, scanner):
    with FastMockApiServer(seed_cluster(seed)) as server:
        source, _ = make_source(pkg, server, scanner=scanner)
        c = Collector(source)
        c.wait_count(15 if scanner else 30)  # the LIST: every pod (accelerator pods only when prefiltered)
        c.wait_idle(0.2)
        churn(server.cluster, seed)
        c.wait_idle()
        c.stop()
        return c.events


def scenario_gone(pkg, seed, scanner):
    with FastMockApiServer(seed_cluster(seed)) as server:
        source, _ = make_source(pkg, server, scanner=scanner)
        c = Collector(source)
        c.wait_idle()
        # hold the stream's next poll, mutate, compact: the watch resumes
        # below the compaction and gets 410 Gone -> relist with tombstones
        server.cluster.hold_watch(True)
        churn(server.cluster, seed)
        server.cluster.compact()
        server.cluster.hold_watch(False)
        c.wait_idle(0.6)
        c.stop()
        return c.events


def scenario_resume(pkg, seed, tmp_path, compact):
    d = tmp_path / pkg
    d.mkdir()
    with FastMockApiServer(seed_cluster(seed)) as server:
        source, checkpoint = make_source(pkg, server, checkpoint_dir=d)
        c = Collector(source)
        c.wait_idle()
        c.stop()
        flush_known(source, checkpoint)
        # while the watcher is down
        churn(server.cluster, seed)
        if compact:
            server.cluster.compact()
        source2, _ = make_source(pkg, server, checkpoint_dir=d)
        c2 = Collector(source2)
        c2.wait_idle(0.6)
        c2.stop()
        return c.events, c2.events, checkpoint.resource_version()


@pytest.mark.parametrize("seed, scanner", [(0, False), (1, True)])
def test_paging_and_churn_match(seed, scanner):
    want, got = both(scenario_churn, seed, scanner)
    assert got == want
    assert len(got) > (15 if scanner else 30)  # the watch delivered churn after the LIST
    if not scanner:
        assert any(t == "DELETED" for t, _, _ in got) and any(t == "MODIFIED" for t, _, _ in got)


@pytest.mark.parametrize("scanner", [False, True])
def test_gone_relists_with_tombstones_alike(scanner):
    want, got = both(scenario_gone, 2, scanner)
    assert got == want
    # the relist's tombstones: DELETED with the relist's rv
    assert any(t == "DELETED" for t, _, _ in got)


@pytest.mark.parametrize("compact", [False, True])
def test_resume_from_checkpoint_matches(tmp_path, compact):
    want, got = both(scenario_resume, 3, tmp_path, compact)
    assert got == want
    first, second, rv = got
    assert first and second and rv


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_abort_watch_ends_a_blocked_read(pkg):
    """On a quiet cluster the watch read blocks for its whole window; stop()
    must end it at once (abort_watch shuts the socket down)."""
    with FastMockApiServer(seed_cluster(4, n=5)) as server:
        source, _ = make_source(pkg, server)
        source.watch_timeout_seconds = 60
        c = Collector(source)
        c.wait_idle(0.5)
        assert c.stop() < 2.0
        assert c.error is None
        # sticky: a later watch on the aborted client ends at once too
        t0 = time.monotonic()
        with pytest.raises(Exception):
            list(source.client.watch_pods(timeout_seconds=30))
        assert time.monotonic() - t0 < 2.0


def scenario_shards(pkg):
    with FastMockApiServer(seed_cluster(5, n=40)) as server:
        shards = [make_source(pkg, server, scanner=True, shard=i, shards=2)[0] for i in range(2)]
        collectors = [Collector(s) for s in shards]
        for c in collectors:
            c.wait_idle(0.3)
        churn(server.cluster, 5, first=40)
        for c in collectors:
            c.wait_idle()
        for c in collectors:
            c.stop()
        return [c.events for c in collectors]


def test_two_shards_stream_alike():
    want, got = both(scenario_shards)
    assert got == want
    assert all(got)  # both shards carried events
