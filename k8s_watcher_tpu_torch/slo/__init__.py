"""SLO/burn-rate engine: config-declared objectives over the metrics
registry, evaluated with two-window burn rates (see slo/engine.py)."""

from k8s_watcher_tpu_torch.slo.engine import SLOPlane

__all__ = ["SLOPlane"]
