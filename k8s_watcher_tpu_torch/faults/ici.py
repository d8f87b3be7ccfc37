"""Collective fault injection, as in the JAX package's ``faults/ici.py``.

A degraded GPU or link cannot be conjured on demand, so faults are modelled
inside the probe programs, on one rank:

- **slow rank**: the rank runs a chained-matmul delay before joining the
  collective, so every collective that waits on it stretches;
- **corrupt rank**: the rank perturbs its contribution, so checksums fail.

Production probes pass ``fault=None``. The spec is test and chaos tooling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class IciFaultSpec:
    """Which rank misbehaves, and how (ranks of the probe's process group)."""

    slow_rank: Optional[int] = None
    slow_matmul_size: int = 128
    slow_iters: int = 100
    corrupt_rank: Optional[int] = None
    corrupt_magnitude: float = 1e6

    @property
    def active(self) -> bool:
        return self.slow_rank is not None or self.corrupt_rank is not None


def apply_fault(x: torch.Tensor, fault: Optional[IciFaultSpec], rank: int) -> torch.Tensor:
    """``x`` as rank ``rank`` contributes it under ``fault`` (``x`` itself on
    a rank the spec does not name)."""
    if fault is None or not fault.active:
        return x
    if fault.slow_rank == rank:
        size = fault.slow_matmul_size
        m = torch.full((size, size), 1e-3, dtype=torch.bfloat16, device=x.device)
        for _ in range(fault.slow_iters):
            y = torch.matmul(m, m).float()
            # renormalize so the chain can't overflow bf16
            y = y * torch.rsqrt(torch.mean(y * y) + 1e-6)
            m = y.to(torch.bfloat16)
        # fold to a negligible scalar the result depends on
        x = x + (m.float().sum() * 1e-30).to(x.dtype)
    if fault.corrupt_rank == rank:
        x = x + fault.corrupt_magnitude
    return x
