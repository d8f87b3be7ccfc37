"""The probe plane: inventory, collective, GEMM and HBM probes, report, trend, agent."""

from k8s_watcher_tpu_torch.probe.trend import TrendTracker

__all__ = ["TrendTracker"]
