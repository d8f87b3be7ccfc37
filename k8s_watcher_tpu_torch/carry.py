"""Carry the probe inputs between numpy and the port's tensors.

The probe plane has no weights. What the JAX package and the port must share
to be held against each other is the probes' input data: the all-reduce
input ``arange(1..n)`` (one element per rank), the MXU operands, the HBM
buffers, the write seed and a corrupting hook's effect. They are made once
with numpy and put on the device here in the port's layout, which is the
JAX package's layout: row-major, float32 (bfloat16 for the MXU operands).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def to_port(array: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A contiguous tensor on ``device`` holding ``array`` (cast to ``dtype``)."""
    t = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    return t if dtype is None else t.to(dtype)


def from_port(tensor: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``tensor`` (bfloat16, which numpy lacks, as float32)."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def psum_input(n: int) -> np.ndarray:
    """The all-reduce probe's input over ``n`` ranks: ``1.0 .. n``."""
    return np.arange(1.0, n + 1.0, dtype=np.float32)


def rank_share(array: np.ndarray, rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s element of a per-rank input, as a (1,) tensor."""
    return to_port(array[rank:rank + 1], device)


def seed(value: float, device) -> torch.Tensor:
    """The write probe's seed: a (1, 1) float32 tensor read by the kernel."""
    return to_port(np.full((1, 1), value, dtype=np.float32), device)


def additive_hook(delta: np.ndarray) -> Callable[[torch.Tensor], torch.Tensor]:
    """A corrupting hook for ``run_hbm_write_probe``: adds ``delta`` (the
    buffer's shape) to the written buffer, as the JAX hook adds it there."""

    def hook(y: torch.Tensor) -> torch.Tensor:
        return y + to_port(delta.astype(np.float32), y.device)

    return hook
