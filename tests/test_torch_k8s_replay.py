"""The client, paging, watch-source, checkpoint and dirty-uid classes of the
JAX package's ``tests/test_k8s.py``, replayed through the port against the
port's own mock apiserver (``k8s_watcher_tpu_torch.k8s.mock_server``).

``tests/test_torch_k8s.py`` holds the kubeconfig, exec-credential and
rotating-token classes, against the JAX package's mock apiserver.
"""

from test_torch_replay import replay, replayed_tests

_k8s = replay("test_k8s.py", rewrites=[
    ("from k8s_watcher_tpu.config.schema import RetryPolicy", "from k8s_watcher_tpu.config import RetryPolicy"),
])
mock_api = _k8s.mock_api  # the replayed tests' fixture
globals().update(replayed_tests(_k8s, only=(
    "TestK8sClient", "TestListPagination", "TestKubernetesWatchSource", "TestCheckpointStore",
    "TestJournaledMapStore", "TestWatchSourceDirtyUids",
)))
