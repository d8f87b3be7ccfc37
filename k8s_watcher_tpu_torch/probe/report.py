"""Probe report schema: the payload the probe plane sends through the
notifier. Same ``healthy`` rules and ``to_payload`` keys as the JAX package's
``probe/report.py``."""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from k8s_watcher_tpu_torch.probe.ici import IciProbeResult


@dataclasses.dataclass
class ProbeReport:
    environment: str
    devices: Dict[str, Any]
    ici: Optional[IciProbeResult] = None
    mxu: Optional[Dict[str, Any]] = None
    hbm: Optional[Dict[str, Any]] = None
    hbm_write: Optional[Dict[str, Any]] = None  # write-bw + block integrity
    links: Optional[Any] = None  # ported with the links slice
    multislice: Optional[Any] = None  # ported with the multislice slice
    # sustained cross-cycle drift alerts (probe.trend.TrendAlert list)
    trend_alerts: List[Any] = dataclasses.field(default_factory=list)
    host: Optional[Dict[str, Any]] = None  # probe/device.py:host_identity
    hosts: Optional[Dict[str, Any]] = None  # str(rank) -> identity, every rank
    rtt_warn_ms: float = 50.0
    duration_ms: float = 0.0

    @property
    def healthy(self) -> bool:
        if self.devices.get("platform_mismatch", 0) > 0:
            return False  # measuring the wrong hardware is never "healthy"
        if self.devices.get("missing_local_devices", 0) > 0:
            return False
        if self.devices.get("healthy_devices", 0) < self.devices.get("visible_devices", 0):
            return False
        if self.ici is not None and not self.ici.ok:
            return False
        if self.ici is not None and self.ici.psum_rtt_ms > self.rtt_warn_ms:
            return False
        if self.mxu is not None and not self.mxu.get("ok", False):
            return False
        if self.hbm is not None and not self.hbm.get("ok", False):
            return False
        if self.hbm_write is not None and not self.hbm_write.get("ok", False):
            return False
        if self.links is not None and not self.links.ok:
            return False
        if self.multislice is not None and not self.multislice.ok:
            return False
        if self.trend_alerts:
            return False
        return True

    def to_payload(self) -> Dict[str, Any]:
        """Notification payload (event_type TPU_PROBE)."""
        return {
            "event_type": "TPU_PROBE",
            "environment": self.environment,
            "healthy": self.healthy,
            "devices": self.devices,
            "ici": self.ici.to_dict() if self.ici else None,
            "mxu": self.mxu,
            "hbm": self.hbm,
            "hbm_write": self.hbm_write,
            "links": self.links.to_dict() if self.links is not None else None,
            "multislice": self.multislice.to_dict() if self.multislice is not None else None,
            "trend_alerts": [a.to_dict() for a in self.trend_alerts],
            "host": self.host,
            "hosts": self.hosts,
            "duration_ms": self.duration_ms,
            "event_timestamp": datetime.now(timezone.utc).isoformat(),
        }
