"""HBM bandwidth + integrity probes on the kernels of ``kernels/hbm.py``.

Degraded device memory is a failure mode the collective and GEMM probes can
miss: a GPU can compute and communicate correctly while its memory system
runs far below spec. Two probes, as in the JAX package's ``probe/hbm.py``:

- **read sweep** (``run_hbm_probe``): ``repeats`` passes over a large
  buffer, accumulating column sums; reports read bandwidth and an integrity
  check on the sums;
- **write + integrity** (``run_hbm_write_probe``): ``repeats`` passes
  writing a block-indexed pattern (write bandwidth), then per-block sums of
  the written buffer; a mismatch names the bad block's byte range.

Each timed measurement is one kernel launch of ``repeats`` full passes,
fenced once by a one-element readback with the median fence cost subtracted.
On the card there is no cap on the buffer and ``interpreted`` is False. On
the CPU the kernels' plain versions run, the buffer is capped at two blocks
as the JAX package caps its interpret mode, and the bandwidth numbers are
meaningless (``interpreted`` is True).
"""

from __future__ import annotations

import ctypes
import logging
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from k8s_watcher_tpu_torch import carry
from k8s_watcher_tpu_torch.kernels import hbm as kernels
from k8s_watcher_tpu_torch.kernels.hbm import (
    BLOCK_ROWS,
    BYTES_PER_BLOCK,
    WIDTH,
    WRITE_BLOCK_ELEMS,
    WRITE_BYTES_PER_BLOCK,
)
from k8s_watcher_tpu_torch.probe.device import device_id, resolve_device
from k8s_watcher_tpu_torch.probe.timing import fence_baseline_ms, fetch_scalar

logger = logging.getLogger(__name__)


def _pick_repeats(actual_bytes: int, target_traffic: int = 32 << 30) -> int:
    """Enough passes that device time dominates fence noise (~32 GiB of
    traffic, ~10 ms at the H100's 3.35 TB/s)."""
    return max(1, min(256, target_traffic // max(actual_bytes, 1)))


def _timed_pass_ms(run, device, iters: int, baseline_ms: float, repeats: int,
                   budget_ms: float = 10_000.0):
    """(per_pass_ms, per_pass_min_ms, unreliable): median (and min) time of
    ``iters`` fenced executions of ``run(timer)``, per pass. On a card the
    kernel times itself (``timer``: the device time between CUDA events its
    C entry point records around its launches; no fence inside). On the CPU
    the host clock spans run and fence, minus the fence baseline, and the
    reading is flagged unreliable when the device share is under a quarter
    of the baseline. The loop stops once ``budget_ms`` of wall time is spent
    (a badly degraded part)."""
    on_card = device.type == "cuda"
    if on_card:
        baseline_ms = 0.0
    per_exec = []
    loop_t0 = time.perf_counter()
    for _ in range(iters):
        if on_card:
            timer = ctypes.c_float()
            fetch_scalar(run(timer))
            per_exec.append(timer.value)
        else:
            t0 = time.perf_counter()
            fetch_scalar(run(None))
            per_exec.append(1e3 * (time.perf_counter() - t0))
        if 1e3 * (time.perf_counter() - loop_t0) > budget_ms:
            break
    median = statistics.median(per_exec)
    device_ms = median - baseline_ms
    device_min_ms = min(per_exec) - baseline_ms
    unreliable = device_ms < 0.25 * baseline_ms
    return (
        max(device_ms, 1e-3) / repeats,
        max(device_min_ms, 1e-3) / repeats,
        unreliable,
    )


def run_hbm_probe(
    total_bytes: int = 256 * 1024 * 1024,
    *,
    iters: int = 4,
    device=None,
) -> Dict[str, Any]:
    """Measure achieved HBM read bandwidth on one device."""
    try:
        device = resolve_device(device)
        interpret = device.type != "cuda"
        if interpret:
            total_bytes = min(total_bytes, BYTES_PER_BLOCK * 2)

        num_blocks = max(1, total_bytes // BYTES_PER_BLOCK)
        rows = num_blocks * BLOCK_ROWS
        actual_bytes = num_blocks * BYTES_PER_BLOCK
        repeats = 1 if interpret else _pick_repeats(actual_bytes)
        x = torch.ones((rows, WIDTH), dtype=torch.float32, device=device)

        t0 = time.perf_counter()
        out = kernels.read_sweep(x, repeats)
        got = float(out.sum()) / repeats  # fence doubles as integrity read
        compile_ms = 1e3 * (time.perf_counter() - t0)

        expected = float(rows * WIDTH)
        integrity_ok = abs(got - expected) <= 1e-6 * expected

        baseline_ms = fence_baseline_ms(device)
        pass_ms, pass_min_ms, unreliable = _timed_pass_ms(
            lambda timer: kernels.read_sweep(x, repeats, timer=timer), device, iters, baseline_ms, repeats
        )

        return {
            "ok": integrity_ok,
            "integrity_ok": integrity_ok,
            "bytes": actual_bytes,
            "repeats": repeats,
            "time_ms": pass_ms,
            "read_gbps": actual_bytes / (pass_ms / 1e3) / 1e9,  # median-based
            "read_gbps_best": actual_bytes / (pass_min_ms / 1e3) / 1e9,
            "bandwidth_unreliable": unreliable,
            "fence_baseline_ms": baseline_ms,
            "compile_ms": compile_ms,
            "interpreted": interpret,
            "device_id": device_id(device),
        }
    except Exception as exc:  # noqa: BLE001 — a failed probe is an unhealthy reading
        logger.error("HBM probe failed: %s", exc)
        return {"ok": False, "error": str(exc)}


def run_hbm_write_probe(
    total_bytes: int = 256 * 1024 * 1024,
    *,
    iters: int = 4,
    device=None,
    corrupt_hook=None,  # test/chaos: Tensor -> Tensor applied between write and verify
) -> Dict[str, Any]:
    """Measure achieved HBM write bandwidth and verify pattern integrity,
    naming WHICH blocks (which byte ranges) are bad."""
    try:
        device = resolve_device(device)
        interpret = device.type != "cuda"
        if interpret:
            total_bytes = min(total_bytes, WRITE_BYTES_PER_BLOCK * 2)

        num_blocks = max(1, total_bytes // WRITE_BYTES_PER_BLOCK)
        actual_bytes = num_blocks * WRITE_BYTES_PER_BLOCK
        repeats = 1 if interpret else _pick_repeats(actual_bytes)

        t0 = time.perf_counter()
        y = kernels.fill(carry.seed(0.0, device), num_blocks, repeats)  # kept for the verify pass
        fetch_scalar(y)
        compile_ms = 1e3 * (time.perf_counter() - t0)

        baseline_ms = fence_baseline_ms(device)
        # seeds made and fenced before the timed window, a fresh one per run
        seed_tensors = [carry.seed(float(k + 1), device) for k in range(iters)]
        for s in seed_tensors:
            fetch_scalar(s)
        seeds = iter(seed_tensors)

        pass_ms, pass_min_ms, unreliable = _timed_pass_ms(
            lambda timer: kernels.fill(next(seeds), num_blocks, repeats, timer=timer), device, iters,
            baseline_ms, repeats,
        )

        # verify the first buffer (every pass writes the same seed-0 pattern)
        # rather than re-running the multi-pass writer
        if corrupt_hook is not None:
            y = corrupt_hook(y)
        sums = kernels.blocksums(y)

        expected = np.arange(1, num_blocks + 1, dtype=np.float64) * WRITE_BLOCK_ELEMS
        got = carry.from_port(sums).astype(np.float64).reshape(-1)
        # block sums are v * 2^17 with small integer v, exact in f32; the
        # tolerance only absorbs reduction-order effects
        bad = np.nonzero(np.abs(got - expected) > 1e-5 * expected)[0]
        bad_blocks = [
            {
                "block": int(b),
                "byte_offset": int(b) * WRITE_BYTES_PER_BLOCK,
                "expected_sum": float(expected[b]),
                "got_sum": float(got[b]),
            }
            for b in bad[:8]
        ]

        return {
            "ok": len(bad) == 0,
            "integrity_ok": len(bad) == 0,
            "bad_block_count": int(len(bad)),
            "bad_blocks": bad_blocks,
            "bytes": actual_bytes,
            "repeats": repeats,
            "time_ms": pass_ms,
            "write_gbps": actual_bytes / (pass_ms / 1e3) / 1e9,  # median-based
            "write_gbps_best": actual_bytes / (pass_min_ms / 1e3) / 1e9,
            "bandwidth_unreliable": unreliable,
            "fence_baseline_ms": baseline_ms,
            "compile_ms": compile_ms,
            "interpreted": interpret,
            "device_id": device_id(device),
        }
    except Exception as exc:  # noqa: BLE001 — a failed probe is an unhealthy reading
        logger.error("HBM write probe failed: %s", exc)
        return {"ok": False, "error": str(exc)}
