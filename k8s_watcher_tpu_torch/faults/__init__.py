"""Fault injection: the collective probes' faults (``faults/ici.py``) and the
seeded churn and notifier faults of the watcher's tests and drills
(``faults/injection.py``)."""

from k8s_watcher_tpu_torch.faults.injection import ChurnGenerator, FaultyNotifier  # noqa: F401
