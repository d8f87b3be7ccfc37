"""The node plane: node readiness tracking and the node watch."""

from k8s_watcher_tpu_torch.nodes.tracker import NodeTracker, node_is_ready, node_tpu_info
from k8s_watcher_tpu_torch.nodes.watcher import NodeWatcher

__all__ = ["NodeTracker", "NodeWatcher", "node_is_ready", "node_tpu_info"]
