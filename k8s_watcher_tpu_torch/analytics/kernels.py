"""Array kernels over :class:`~k8s_watcher_tpu_torch.analytics.encode.FleetColumns`
(the JAX package's ``analytics/kernels.py``).

Every computation is a reduction over dense integer columns: segment sums
into per-slice and per-cluster bins, masks and products. The torch kernels
are written on tensors; the numpy ones are the JAX package's numpy path. Both
return integer counts only, so the two backends (and the JAX package's) give
equal integers, never merely close ones.

- Results cross to the host as int64 numpy; ratios are derived on the host
  from those ints by the verdict layer.
- The what-if kernel is batched along a leading scenario axis: ``masks`` is
  ``[S, Nw]`` and one pass answers all S scenarios.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from k8s_watcher_tpu_torch.analytics.backend import BACKEND_TORCH, ArrayBackend
from k8s_watcher_tpu_torch.analytics.encode import POD_PHASES, FleetColumns


class SliceRollup(NamedTuple):
    """The vectorized recomputation of the per-slice aggregates the tracker
    keeps incrementally: ``observed``/``ready`` must equal
    ``FleetColumns.s_observed``/``s_ready`` exactly."""

    observed: np.ndarray  # int64 [Ns] workers per slice
    ready: np.ndarray  # int64 [Ns] up workers per slice
    chips_ready: np.ndarray  # int64 [Ns] chips on up workers


class WhatIfResult(NamedTuple):
    """One batched what-if evaluation over S scenarios."""

    ready_after: np.ndarray  # int64 [S, Ns] up workers surviving the mask
    chips_after: np.ndarray  # int64 [S, Ns] chips surviving the mask
    lost_workers: np.ndarray  # int64 [S] up workers masked away


# -- torch ------------------------------------------------------------------


def _torch_rollup(seg, w_slice, w_up, w_chips, n_slices: int):
    return (
        seg(torch.ones_like(w_up), w_slice, n_slices),
        seg(w_up, w_slice, n_slices),
        seg(w_up * w_chips, w_slice, n_slices),
    )


def _torch_whatif(seg, masks, w_slice, w_up, w_chips, n_slices: int):
    # masks: [S, Nw] int32, 1 = the worker survives the scenario; the S
    # scenarios ride one segment-sum launch each for ready and chips
    up_after = masks * w_up.unsqueeze(0)
    ready_after = seg(up_after, w_slice, n_slices)
    chips_after = seg(up_after * w_chips.unsqueeze(0), w_slice, n_slices)
    lost = (w_up.unsqueeze(0) * (1 - masks)).sum(dim=1, dtype=torch.int64)
    return ready_after, chips_after, lost


def _torch_phase_counts(seg, codes, cluster, n_codes: int, n_clusters: int):
    # the joint (cluster, phase) histogram in one segment sum over the
    # flattened bin cluster * P + phase
    return seg(torch.ones_like(codes), cluster * n_codes + codes, n_clusters * n_codes)


# -- numpy ------------------------------------------------------------------


def _numpy_rollup(seg, w_slice, w_up, w_chips, n_slices: int):
    ones = np.ones_like(w_up)
    return seg(ones, w_slice, n_slices), seg(w_up, w_slice, n_slices), seg(w_up * w_chips, w_slice, n_slices)


def _numpy_whatif(seg, masks, w_slice, w_up, w_chips, n_slices: int):
    up_after = masks * w_up[None, :]
    ready_after = seg(up_after, w_slice, n_slices)
    chips_after = seg(up_after * w_chips[None, :], w_slice, n_slices)
    lost = np.sum(w_up[None, :] * (1 - masks), axis=1)
    return ready_after, chips_after, lost


def _numpy_phase_counts(seg, codes, cluster, n_codes: int, n_clusters: int):
    return seg(np.ones_like(codes), cluster * n_codes + codes, n_clusters * n_codes)


class FleetKernels:
    """The kernel set bound to one resolved backend."""

    def __init__(self, backend: ArrayBackend):
        self.backend = backend
        kernels = (
            (_torch_rollup, _torch_whatif, _torch_phase_counts)
            if backend.name == BACKEND_TORCH
            else (_numpy_rollup, _numpy_whatif, _numpy_phase_counts)
        )
        self._rollup, self._whatif, self._phase_counts = (backend.jit(k) for k in kernels)

    # -- entry points (host numpy in, host int64 numpy out) ----------------

    def slice_rollup(self, cols: FleetColumns) -> SliceRollup:
        n = cols.n_slices
        if n == 0 or cols.n_workers == 0:
            zero = np.zeros(n, dtype=np.int64)
            return SliceRollup(zero, zero.copy(), zero.copy())
        b = self.backend
        with b.launch():
            out = self._rollup(b.segment_sum, b.segment_ids(cols.w_slice, n), b.asarray(cols.w_up),
                               b.asarray(cols.w_chips), n)
            return SliceRollup(*(b.to_numpy(a) for a in out))

    def what_if(self, cols: FleetColumns, masks: np.ndarray) -> WhatIfResult:
        """``masks``: bool/int ``[S, Nw]``, True = the worker SURVIVES the
        scenario (see ``whatif.build_masks``)."""
        n = cols.n_slices
        n_scenarios = masks.shape[0]
        if n == 0 or cols.n_workers == 0:
            return WhatIfResult(
                np.zeros((n_scenarios, n), dtype=np.int64),
                np.zeros((n_scenarios, n), dtype=np.int64),
                np.zeros(n_scenarios, dtype=np.int64),
            )
        b = self.backend
        with b.launch():
            out = self._whatif(b.segment_sum, b.asarray(masks.astype(np.int32)), b.segment_ids(cols.w_slice, n),
                               b.asarray(cols.w_up), b.asarray(cols.w_chips), n)
            return WhatIfResult(*(b.to_numpy(a) for a in out))

    def pod_phase_counts(self, cols: FleetColumns) -> np.ndarray:
        """``[n_clusters, len(POD_PHASES)]`` pod counts per cluster."""
        n_clusters = max(1, len(cols.clusters))
        n_codes = len(POD_PHASES)
        if cols.n_pods == 0:
            return np.zeros((n_clusters, n_codes), dtype=np.int64)
        b = self.backend
        with b.launch():
            # each factor in range keeps the flattened bin in range
            flat = self._phase_counts(b.segment_sum, b.segment_ids(cols.pod_phase, n_codes),
                                      b.segment_ids(cols.pod_cluster, n_clusters), n_codes, n_clusters)
            return b.to_numpy(flat).reshape(n_clusters, n_codes)


def crosscheck(cols: FleetColumns, rollup: SliceRollup) -> Dict[str, object]:
    """Vectorized slice aggregates against the tracker's incremental counters:
    exact integer equality per slice, with the names of any that differ."""
    observed_eq = cols.s_observed.astype(np.int64) == rollup.observed
    ready_eq = cols.s_ready.astype(np.int64) == rollup.ready
    ok = bool(observed_eq.all() and ready_eq.all())
    mismatched = [] if ok else sorted(cols.slice_names[i] for i in np.nonzero(~(observed_eq & ready_eq))[0])
    return {"ok": ok, "slices": int(cols.n_slices), "mismatched": mismatched}
