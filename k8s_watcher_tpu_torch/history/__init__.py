"""Durable fleet history plane (the JAX package's ``history/``): a segmented
delta WAL, recovery that keeps the rv line across restarts, and
deterministic replay."""

from k8s_watcher_tpu_torch.history.recovery import (
    RecoveredState,
    journal_deltas,
    reconstruct_at,
    recover_state,
)
from k8s_watcher_tpu_torch.history.replay import (
    ReplayResult,
    canonical_snapshot,
    replay_digest,
    replay_wal,
    snapshot_sha256,
)
from k8s_watcher_tpu_torch.history.wal import FSYNC_POLICIES, HistoryStore

__all__ = [
    "FSYNC_POLICIES",
    "HistoryStore",
    "RecoveredState",
    "ReplayResult",
    "canonical_snapshot",
    "journal_deltas",
    "reconstruct_at",
    "recover_state",
    "replay_digest",
    "replay_wal",
    "snapshot_sha256",
]
