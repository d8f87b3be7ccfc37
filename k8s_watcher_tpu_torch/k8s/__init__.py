"""The Kubernetes API layer: kubeconfig and in-cluster loading, a REST client
for the endpoints the watcher and remediation use, the resilient list+watch
source, leader election and the in-process mock apiserver
(``k8s/mock_server.py``)."""

from k8s_watcher_tpu_torch.k8s.kubeconfig import K8sConnection, load_connection  # noqa: F401
from k8s_watcher_tpu_torch.k8s.client import K8sApiError, K8sClient  # noqa: F401
from k8s_watcher_tpu_torch.k8s.watch import KubernetesWatchSource  # noqa: F401
