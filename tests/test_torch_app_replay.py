"""The JAX package's ``tests/test_app.py`` replayed through the port: the
watcher's wiring under the port's own fault injectors (``ChurnGenerator``,
``FaultyNotifier``) and mock apiserver.

The remediation-wiring test's report comes from the port's replay of
``tests/test_remediate.py:probe_report`` with its hosts keyed by rank, since
the port looks a link endpoint up as a rank (``ROADMAP.md`` §C "By design"):
ranks 2 and 3 on ``tpu-node-1`` as the reference's process 1. Two tests are
left out (§C "Replayed tests left out"): ``TestChurnLoad``'s
``test_ici_fault_localized_during_churn`` and
``test_remediation_quarantines_during_churn`` inject a fault into device 5 or
3 of the JAX package's 8-device mesh inside one process, where the port's
ranks are processes. Their ground is held on 8 gloo ranks by
``tests/test_torch_chaos.py`` (the corrupt rank localized) and
``tests/test_torch_chaos_remediate.py`` (localized, confirmed, quarantined
and released over the port's mock apiserver).
"""

from test_torch_replay import replay, replayed_tests

probe_report = replay("test_remediate.py").probe_report
RANK_HOSTS = {str(r): {"process_index": r, "node_name": f"tpu-node-{r // 2}"} for r in range(4)}

globals().update(replayed_tests(replay("test_app.py", rewrites=[
    ("from k8s_watcher_tpu.app import WatcherApp", "from test_torch_replay import CpuWatcherApp as WatcherApp"),
    ("from k8s_watcher_tpu.config.loader import load_config",
     "from k8s_watcher_tpu.config import load_app_config as load_config"),
    ("from test_remediate import probe_report", "from test_torch_app_replay import RANK_HOSTS, probe_report"),
    ("report = probe_report(suspect_devices=[2])  # process 1 -> tpu-node-1",
     "report = probe_report(suspect_devices=[2], hosts=RANK_HOSTS)  # rank 2 -> tpu-node-1"),
]), leave_out=(
    "TestChurnLoad.test_ici_fault_localized_during_churn",
    "TestChurnLoad.test_remediation_quarantines_during_churn",
)))
