"""The port's leader election held against the JAX package's.

``tests/test_leader.py`` is replayed through the port against the JAX
package's ``MockApiServer`` (the Lease calls and their 409 mapping, the
elector's acquire, standby, release, steal and loss, two ``WatcherApp``s
failing over). Side by side, one mock apiserver holds a Lease per package and
one both contend for: each package's electors step through acquire, renew, a
standby's refusal, a steal after expiry, release and re-acquire, and write
the same ``spec`` fields at each step, timestamps aside.
"""

import time

from k8s_watcher_tpu.k8s import leader as ref_leader
from k8s_watcher_tpu.k8s.client import K8sClient as RefClient
from k8s_watcher_tpu.k8s.kubeconfig import K8sConnection as RefConnection
from k8s_watcher_tpu.k8s.mock_server import MockApiServer
from k8s_watcher_tpu_torch.k8s import leader
from k8s_watcher_tpu_torch.k8s.client import K8sClient
from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection
from test_torch_replay import replay, replayed_tests

_leader = replay("test_leader.py", keep=("k8s_watcher_tpu.k8s.mock_server",), rewrites=[
    ("from k8s_watcher_tpu.config.loader import load_config",
     "from k8s_watcher_tpu.config import load_app_config as load_config"),
    ("from k8s_watcher_tpu.config.schema import LeaderElectionConfig, RetryPolicy",
     "from k8s_watcher_tpu.config import LeaderElectionConfig, RetryPolicy"),
    # development serves analytics, which the port runs on a GPU unless
    # the CPU is asked for
    ("app = WatcherApp(config, source=source, notifier=notifier)",
     'app = WatcherApp(config, source=source, notifier=notifier, device="cpu")'),
])
mock_api = _leader.mock_api  # the replayed tests' fixture
globals().update(replayed_tests(_leader))

PACKAGES = {"ref": (ref_leader, RefClient, RefConnection), "port": (leader, K8sClient, K8sConnection)}
TIMING = {"lease_duration_seconds": 1.2, "renew_deadline_seconds": 0.8, "retry_period_seconds": 0.1}


def _elector(pkg, server, identity, lease_name):
    mod, client_cls, conn_cls = PACKAGES[pkg]
    return mod.LeaderElector(client_cls(conn_cls(server=server.url), request_timeout=5.0),
                             lease_namespace="default", lease_name=lease_name, identity=identity, **TIMING)


def _spec(server, lease_name):
    """The Lease's spec with its two timestamps read as ``(parsed,
    acquireTime == renewTime)``: the wall clock differs between runs."""
    lease = RefClient(RefConnection(server=server.url)).get_lease("default", lease_name)
    spec = dict(lease["spec"])
    acquire, renew = spec.pop("acquireTime"), spec.pop("renewTime")
    for stamp in (acquire, renew):
        assert stamp.endswith("Z") and ref_leader._parse_time(stamp) is not None
    return spec, acquire == renew, acquire, renew


def test_both_packages_write_the_same_lease_specs():
    with MockApiServer() as server:
        electors = {}
        for lease, (first, second) in {"ref-lease": ("ref", "ref"), "port-lease": ("port", "port"),
                                       "mixed-lease": ("ref", "port")}.items():
            electors[lease] = (_elector(first, server, "replica-a", lease), _elector(second, server, "replica-b", lease))
        steps = {lease: [] for lease in electors}
        kept = {}

        def step(name, act):
            for lease, (a, b) in electors.items():
                won = act(a, b)
                spec, same_stamp, acquire, renew = _spec(server, lease)
                steps[lease].append((name, won, spec, same_stamp))
                kept.setdefault(lease, []).append((acquire, renew))

        step("acquire", lambda a, b: a._try_acquire_or_renew())
        time.sleep(0.02)
        step("renew", lambda a, b: a._try_acquire_or_renew())
        step("standby", lambda a, b: b._try_acquire_or_renew())
        time.sleep(TIMING["lease_duration_seconds"] + 0.2)  # replica-a died without releasing
        step("steal", lambda a, b: b._try_acquire_or_renew())
        step("release", lambda a, b: b._release())
        step("reacquire", lambda a, b: a._try_acquire_or_renew())

    want = [
        ("acquire", True, {"holderIdentity": "replica-a", "leaseDurationSeconds": 1, "leaseTransitions": 0}, True),
        ("renew", True, {"holderIdentity": "replica-a", "leaseDurationSeconds": 1, "leaseTransitions": 0}, False),
        ("standby", False, {"holderIdentity": "replica-a", "leaseDurationSeconds": 1, "leaseTransitions": 0}, False),
        ("steal", True, {"holderIdentity": "replica-b", "leaseDurationSeconds": 1, "leaseTransitions": 1}, True),
        ("release", None, {"holderIdentity": "", "leaseDurationSeconds": 1, "leaseTransitions": 1}, False),
        ("reacquire", True, {"holderIdentity": "replica-a", "leaseDurationSeconds": 1, "leaseTransitions": 2}, True),
    ]
    assert steps["ref-lease"] == want
    assert steps["port-lease"] == want
    assert steps["mixed-lease"] == want
    for lease, stamps in kept.items():
        # a renew keeps acquireTime and moves renewTime; a steal sets both
        (acq0, ren0), (acq1, ren1) = stamps[0], stamps[1]
        assert acq1 == acq0 and ren1 > ren0, lease
        assert stamps[2] == stamps[1], lease  # the standby wrote nothing
        assert stamps[3][0] > acq0, lease
