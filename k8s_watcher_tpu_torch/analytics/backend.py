"""The array backends of the analytics kernels (the JAX package's
``analytics/backend.py``, with PyTorch in place of JAX).

- ``torch`` (``analytics.backend: auto`` or ``jax``): tensors on one device,
  the rank's GPU unless the caller asks for the CPU
  (``probe/device.py:resolve_device``). Where CUDA is asked for and missing,
  resolution raises, as the probe does; it never falls back to numpy on its
  own. On a GPU every copy and launch runs on the backend's own CUDA stream,
  so an analytics request never queues inside the probe's timed windows on
  the default stream, and the stream is synchronized before a result crosses
  to the host.
- ``numpy``: the JAX package's numpy backend, never touching a device.

``segment_sum(data, segment_ids, num_segments)`` sums ``data`` over its LAST
axis (``(n,)`` or ``(S, n)``, the scenario axis) into ``num_segments`` int64
bins, exactly: on torch an ``index_add_`` into an int64 tensor. An id outside
``[0, num_segments)`` raises ``ValueError`` before anything is launched (on
CUDA it would be a device-side assert that poisons the context the probe
shares). ``jit`` is the identity.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Optional

import numpy as np
import torch

from k8s_watcher_tpu_torch.probe.device import resolve_device

logger = logging.getLogger(__name__)

#: accepted analytics.backend values: the JAX package's vocabulary, so both
#: packages load the same config files
BACKENDS = ("auto", "jax", "numpy")

BACKEND_TORCH = "torch"
BACKEND_NUMPY = "numpy"


def check_segment_ids(segment_ids: np.ndarray, num_segments: int) -> None:
    """Raise ``ValueError`` unless every id lies in ``[0, num_segments)``
    (checked on the host, where the ids already are)."""
    if segment_ids.size and (int(segment_ids.min()) < 0 or int(segment_ids.max()) >= num_segments):
        raise ValueError(
            f"segment ids must lie in [0, {num_segments}); got min {int(segment_ids.min())}, "
            f"max {int(segment_ids.max())}"
        )


class ArrayBackend:
    """One resolved backend: its array namespace ``xp``, ``segment_sum``,
    and the host/device boundary (``asarray``, ``segment_ids``,
    ``to_numpy``, and ``launch()``, the context every kernel runs in)."""

    def __init__(self, name: str, xp, segment_sum: Callable, *, device: Optional[torch.device] = None,
                 stream=None):
        self.name = name
        self.xp = xp
        self.device = device
        self.stream = stream  # torch.cuda.Stream on a GPU, else None
        self._segment_sum = segment_sum

    @staticmethod
    def jit(fn, **_kwargs):
        return fn

    def segment_sum(self, data, segment_ids, num_segments: int):
        return self._segment_sum(data, segment_ids, num_segments)

    def launch(self):
        """The context kernels run in: the backend's own CUDA stream on a GPU."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def asarray(self, a, dtype=None):
        """Host array -> backend array (on torch: a copy onto the device)."""
        if self.name == BACKEND_NUMPY:
            return np.asarray(a, dtype=dtype)
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype=dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype=dtype, non_blocking=True)

    def segment_ids(self, ids: np.ndarray, num_segments: int):
        """Checked segment ids as a backend array (int64 on torch)."""
        check_segment_ids(ids, num_segments)
        return self.asarray(ids, dtype=torch.int64 if self.name == BACKEND_TORCH else None)

    def to_numpy(self, a) -> np.ndarray:
        """Backend array -> host int64 numpy: the boundary every kernel result
        crosses before entering a verdict. Synchronizes the stream first."""
        if isinstance(a, torch.Tensor):
            if self.stream is not None:
                self.stream.synchronize()
            return a.cpu().numpy().astype(np.int64)
        return np.asarray(a).astype(np.int64)

    def __repr__(self) -> str:
        return f"ArrayBackend({self.name}, device={self.device})"


def _numpy_backend() -> ArrayBackend:
    def segment_sum(data, segment_ids, num_segments: int):
        data = np.asarray(data)
        segment_ids = np.asarray(segment_ids)
        if data.ndim == 1:
            # float64 bincount weights are exact for these small integer counts
            return np.bincount(segment_ids, weights=data, minlength=num_segments).astype(np.int64)
        return np.stack([
            np.bincount(segment_ids, weights=row, minlength=num_segments).astype(np.int64)
            for row in data
        ]) if data.shape[0] else np.zeros((0, num_segments), dtype=np.int64)

    return ArrayBackend(BACKEND_NUMPY, np, segment_sum)


def _torch_backend(device: torch.device) -> ArrayBackend:
    backend = None

    def segment_sum(data, segment_ids, num_segments: int):
        if not isinstance(segment_ids, torch.Tensor):
            segment_ids = backend.segment_ids(np.asarray(segment_ids), num_segments)
        data = backend.asarray(data)
        out = torch.zeros(data.shape[:-1] + (num_segments,), dtype=torch.int64, device=device)
        return out.index_add_(-1, segment_ids, data.to(torch.int64))

    # PyTorch's pool streams are non-blocking: no implicit ordering against
    # the legacy default stream the probe times its launches on
    stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
    backend = ArrayBackend(BACKEND_TORCH, torch, segment_sum, device=device, stream=stream)
    return backend


def resolve_backend(preference: str = "auto", device=None) -> ArrayBackend:
    """``analytics.backend`` -> a live backend. ``auto`` and ``jax`` give the
    torch backend on ``device`` (default: this rank's GPU; raises without
    CUDA); ``numpy`` gives numpy."""
    if preference not in BACKENDS:
        raise ValueError(f"analytics backend must be one of {', '.join(BACKENDS)}, got {preference!r}")
    if preference == BACKEND_NUMPY:
        return _numpy_backend()
    backend = _torch_backend(resolve_device(device))
    logger.info("analytics backend: torch on %s (analytics.backend=%s)", backend.device, preference)
    return backend
