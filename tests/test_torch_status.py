"""The port's status server held against the JAX package's.

Both servers run on free ports, fed the same registry operations, the same
trend observations and the same cycle ring. Every route of the agent, with
and without a bearer token, must answer the same status code and the same
body; only ``/healthz``'s heartbeat age is left out of the comparison.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from k8s_watcher_tpu.metrics import MetricsRegistry as RefRegistry
from k8s_watcher_tpu.metrics.server import Liveness as RefLiveness
from k8s_watcher_tpu.metrics.server import StatusServer as RefStatusServer
from k8s_watcher_tpu.metrics.server import bearer_authorized as ref_bearer_authorized
from k8s_watcher_tpu.probe.trend import TrendTracker as RefTrendTracker
from k8s_watcher_tpu_torch.metrics import MetricsRegistry
from k8s_watcher_tpu_torch.probe.trend import TrendTracker
from k8s_watcher_tpu_torch.status import Liveness, StatusServer, bearer_authorized
from test_torch_metrics import apply, operations

TOKEN = "s3cret-tokén"
CYCLES = [
    {"ts": f"2026-10-16T00:00:0{i}+00:00", "healthy": i != 2, "duration_ms": 130.0 + i,
     "psum_rtt_ms": 0.05, "mxu_tflops": 30.0, "hbm_read_gbps": 3000.0 + i, "hbm_write_gbps": 3100.0,
     "link_suspects": 0, "dcn_suspect_slices": None, "trend_alerts": []}
    for i in range(6)
][::-1]
REMEDIATION = {"streaks": {"node-0": 1}, "confirm_cycles": 3, "dry_run": True, "quarantined_nodes": []}

ROUTES = [
    "/metrics", "/metrics?format=prometheus", "/healthz", "/debug/trend", "/debug/probes",
    "/debug/probes?n=2", "/debug/probes?n=0", "/debug/probes?n=x", "/debug/remediation", "/nope",
]


def _trend(cls):
    tracker = cls(window=8, recent=2, drop_factor=0.75, rise_factor=2.5, min_history=4)
    for v in (100.0, 101.0, 99.0, 100.5, 100.2, 60.0, 55.0):
        tracker.observe("hbm_read_gbps", v, higher_is_better=True)
    for v in (0.1, 0.11, 0.09, 0.1, 0.1):
        tracker.observe("psum_rtt_median_ms", v, higher_is_better=False)
    return tracker


def _start(pkg, *, token=None, liveness=None, remediation=REMEDIATION, wired=True, seed=5):
    if pkg == "ref":
        registry, server_cls, liveness_cls, trend_cls = RefRegistry(), RefStatusServer, RefLiveness, RefTrendTracker
    else:
        registry, server_cls, liveness_cls, trend_cls = MetricsRegistry(), StatusServer, Liveness, TrendTracker
    apply(registry, operations(seed))
    liveness = liveness or liveness_cls(stale_after_seconds=60.0)
    kwargs = {}
    if wired:
        kwargs = dict(trend=_trend(trend_cls).snapshot, probes=lambda n: CYCLES[: max(0, n)],
                      remediation=(lambda: remediation))
    if pkg == "ref":
        kwargs["host"] = "127.0.0.1"
    return server_cls(registry, liveness, port=0, auth_token=token, **kwargs).start()


def _get(port, route, headers=None):
    request = urllib.request.Request(f"http://127.0.0.1:{port}{route}", headers=headers or {})
    try:
        with urllib.request.urlopen(request, timeout=10) as r:
            status, body, hdrs = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, e.read(), e.headers
    if hdrs.get("Content-Type", "").startswith("application/json"):
        body = json.loads(body)
        if isinstance(body, dict):
            body.pop("last_heartbeat_age_seconds", None)
            for entry in body.values():
                if isinstance(entry, dict):
                    entry.pop("per_minute", None)
    return status, body, hdrs.get("WWW-Authenticate")


@pytest.fixture(scope="module")
def started():
    """Server pairs by configuration, started once per module (a stop waits
    out serve_forever's 0.5 s poll)."""
    pairs = {}
    yield pairs
    for pair in pairs.values():
        for s in pair:
            s.stop()


@pytest.fixture
def servers(request, started):
    params = getattr(request, "param", {})
    key = tuple(sorted(params.items()))
    if key not in started:
        started[key] = [_start("ref", **params), _start("port", **params)]
    return [s.port for s in started[key]]


@pytest.mark.parametrize("route", ROUTES)
def test_open_routes_match(servers, route):
    ref, port = (_get(p, route) for p in servers)
    assert port == ref
    if route == "/metrics?format=prometheus":
        assert b"k8s_watcher_probe_runs_total" in port[1]


def test_watcher_routes_are_not_served(servers):
    # the agent wires none of the watcher's planes: each route answers the
    # reference's 404 naming its config key
    for route in ("/debug/events", "/debug/trace", "/debug/slices", "/debug/checkpoint"):
        ref, port = (_get(p, route) for p in servers)
        assert port == ref and port[0] == 404, route


def test_prometheus_on_accept_header_matches(servers):
    for accept in ("text/plain", "application/openmetrics-text"):
        ref, port = (_get(p, "/metrics", {"Accept": accept}) for p in servers)
        assert port == ref and port[0] == 200 and port[1].startswith(b"# TYPE")


@pytest.mark.parametrize("servers", [{"token": TOKEN}], indirect=True)
@pytest.mark.parametrize("auth", [None, "Bearer wrong", f"Bearer {TOKEN}", f"bearer {TOKEN}", "Basic abc"])
@pytest.mark.parametrize("route", ["/metrics", "/healthz", "/debug/probes?n=3", "/debug/remediation", "/nope"])
def test_bearer_gate_matches(servers, auth, route):
    headers = {"Authorization": auth.encode("utf-8").decode("latin-1")} if auth else {}
    ref, port = (_get(p, route, headers) for p in servers)
    assert port == ref
    if route != "/healthz" and auth not in (f"Bearer {TOKEN}", f"bearer {TOKEN}"):
        assert port[0] == 401 and port[2] == "Bearer" and port[1] == b""
    else:
        assert port[0] in (200, 404)


@pytest.mark.parametrize("servers", [{"wired": False}], indirect=True)
@pytest.mark.parametrize("route", ["/debug/trend", "/debug/probes", "/debug/remediation", "/healthz"])
def test_unwired_routes_match(servers, route):
    ref, port = (_get(p, route) for p in servers)
    assert port == ref


@pytest.mark.parametrize("header, token", [
    (None, None), ("Bearer x", None), ("Bearer tok", "tok"), ("bearer  tok ", "tok"), ("Bearer tok", "other"),
    ("Bearer " + "té".encode("utf-8").decode("latin-1"), "té"), ("Bearer té", "té"),
    ("Bearer €", "€"), ("Token tok", "tok"),
])
def test_bearer_authorized_matches(header, token):
    assert bearer_authorized(header, token) == ref_bearer_authorized(header, token)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_liveness_grace_then_staleness(pkg):
    cls = RefLiveness if pkg == "ref" else Liveness
    live = cls(stale_after_seconds=0.5, first_beat_grace_seconds=30.0)
    time.sleep(0.7)
    assert live.alive()  # inside the first-beat grace
    live.beat()
    assert live.alive() and live.age_seconds() < 0.5
    time.sleep(0.7)
    assert not live.alive()  # the normal threshold after the first beat
    live.beat()
    assert live.alive()
    assert cls(stale_after_seconds=7.0).first_beat_grace_seconds == 7.0


def test_stale_heartbeat_is_503_on_both():
    servers = [
        _start("ref", liveness=RefLiveness(stale_after_seconds=0.05, first_beat_grace_seconds=0.05)),
        _start("port", liveness=Liveness(stale_after_seconds=0.05, first_beat_grace_seconds=0.05)),
    ]
    try:
        time.sleep(0.1)
        ref, port = (_get(s.port, "/healthz") for s in servers)
        assert port == ref
        assert port[0] == 503 and port[1] == {"alive": False, "watch_alive": False}
    finally:
        for s in servers:
            s.stop()
