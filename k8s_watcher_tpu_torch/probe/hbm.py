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

Each timed measurement is one kernel launch of ``repeats`` full passes. On
the card the kernel times itself, there is no cap on the buffer and
``interpreted`` is False; a stage queues its whole plan (input, untimed
launch, timed launches, the check) so that the device never waits on the
host between its launches, reads back once, and reads the timers after that
one wait. On the CPU it is fenced once by a one-element
readback with the median fence cost subtracted, the kernels' plain versions
run, the buffer is capped at two blocks as the JAX package caps its
interpret mode, and the bandwidth numbers are meaningless (``interpreted``
is True).
"""

from __future__ import annotations

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
from k8s_watcher_tpu_torch.probe import spans, timing
from k8s_watcher_tpu_torch.probe.device import device_id, resolve_device
from k8s_watcher_tpu_torch.probe.timing import fence_baseline_ms, fetch_scalar, read_scalar

logger = logging.getLogger(__name__)


def _pick_repeats(actual_bytes: int, target_traffic: int = 32 << 30) -> int:
    """Enough passes that device time dominates fence noise (~32 GiB of
    traffic, ~10 ms at the H100's 3.35 TB/s)."""
    return max(1, min(256, target_traffic // max(actual_bytes, 1)))


#: wall ms after which a stage queues no more timed launches (a badly degraded part)
BUDGET_MS = 10_000.0


def _fenced_ms(run, iters: int) -> list:
    """Host ms of up to ``iters`` executions of ``run(None)``, each fenced by
    a one-element readback (the CPU)."""
    per_exec = []
    loop_t0 = time.perf_counter()
    for _ in range(iters):
        t0 = time.perf_counter()
        read_scalar(run(None))
        per_exec.append(1e3 * (time.perf_counter() - t0))
        if 1e3 * (time.perf_counter() - loop_t0) > BUDGET_MS:
            break
    return per_exec


def _queued_timers(run, after: kernels.LaunchTimer, iters: int) -> list:
    """Up to ``iters`` launches ``run(timer)`` on the card, each timing itself
    (a :class:`kernels.LaunchTimer`), queued back to back behind the stage's
    untimed launch (timed by ``after``) with no host wait between them: the
    host waits for launch k's end only once launch k + 1 is queued, so the
    device has the next launch while the host checks ``BUDGET_MS``. A part so
    degraded that one launch overruns the budget thus gets at most one launch
    more. A launch submitted while the one before it is still queued or
    running counts in the cycle's ``queued_launches``. The timers are read
    after the stage's one wait."""
    timers = []
    loop_t0 = time.perf_counter()
    for _ in range(iters):
        timer = kernels.LaunchTimer()
        queued = (timers[-1] if timers else after).pending()
        run(timer)
        if queued:
            spans.count("queued_launches")
        if timers:
            timers[-1].wait()
        timers.append(timer)
        if 1e3 * (time.perf_counter() - loop_t0) > BUDGET_MS:
            break
    return timers


def _per_pass(per_exec: list, baseline_ms: float, repeats: int):
    """(per_pass_ms, per_pass_min_ms, unreliable): the median (and min) of
    ``per_exec`` less the fence baseline, per pass. The reading is flagged
    unreliable when the device share is under a quarter of the baseline (on
    the card the kernels time themselves, and ``baseline_ms`` is 0)."""
    device_ms = statistics.median(per_exec) - baseline_ms
    device_min_ms = min(per_exec) - baseline_ms
    unreliable = device_ms < 0.25 * baseline_ms
    return (
        max(device_ms, 1e-3) / repeats,
        max(device_min_ms, 1e-3) / repeats,
        unreliable,
    )


@spans.traced("probe.hbm_read")
def run_hbm_probe(
    total_bytes: int = 256 * 1024 * 1024,
    *,
    iters: int = 4,
    device=None,
) -> Dict[str, Any]:
    """Measure achieved HBM read bandwidth on one device."""
    try:
        with spans.span("probe.hbm_read.setup"):
            device = resolve_device(device)
            interpret = device.type != "cuda"
            if interpret:
                total_bytes = min(total_bytes, BYTES_PER_BLOCK * 2)

            num_blocks = max(1, total_bytes // BYTES_PER_BLOCK)
            rows = num_blocks * BLOCK_ROWS
            actual_bytes = num_blocks * BYTES_PER_BLOCK
            repeats = 1 if interpret else _pick_repeats(actual_bytes)
            x = torch.ones((rows, WIDTH), dtype=torch.float32, device=device)

            # on the card the untimed sweep is queued, unfenced, ahead of the
            # timed ones; its timer only marks its end
            queued = timing.timed_on_device(device)
            first = kernels.LaunchTimer() if queued else None
            t0 = time.perf_counter()
            out = kernels.read_sweep(x, repeats, timer=first)
            if not queued:
                with spans.sync():
                    got = float(out.sum()) / repeats  # fence doubles as integrity read
            compile_ms = 1e3 * (time.perf_counter() - t0)
            baseline_ms = 0.0 if queued else fence_baseline_ms(device)
        with spans.span("probe.hbm_read.timed"):
            def run(timer):
                return kernels.read_sweep(x, repeats, timer=timer)

            if queued:
                timers = _queued_timers(run, first, iters)
            else:
                per_exec = _fenced_ms(run, iters)
        if queued:
            with spans.span("probe.hbm_read.verify"):
                with spans.sync():  # the stage's one wait: every launch ahead of it has run
                    got = float(out.sum()) / repeats
                first.read()  # gives its events back
                per_exec = [t.read() for t in timers]

        expected = float(rows * WIDTH)
        integrity_ok = abs(got - expected) <= 1e-6 * expected
        pass_ms, pass_min_ms, unreliable = _per_pass(per_exec, baseline_ms, repeats)

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


@spans.traced("probe.hbm_write")
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
        with spans.span("probe.hbm_write.setup"):
            device = resolve_device(device)
            interpret = device.type != "cuda"
            if interpret:
                total_bytes = min(total_bytes, WRITE_BYTES_PER_BLOCK * 2)

            num_blocks = max(1, total_bytes // WRITE_BYTES_PER_BLOCK)
            actual_bytes = num_blocks * WRITE_BYTES_PER_BLOCK
            repeats = 1 if interpret else _pick_repeats(actual_bytes)

            queued = timing.timed_on_device(device)
            if queued:
                # every seed from one transfer, before the first launch: stream
                # order puts each ahead of the fill that reads it, unfenced
                seeds = carry.seeds([float(k) for k in range(iters + 1)], device)
                first = kernels.LaunchTimer()  # marks the untimed fill's end
                t0 = time.perf_counter()
                y = kernels.fill(seeds[0], num_blocks, repeats, timer=first)  # kept for the verify pass
                compile_ms = 1e3 * (time.perf_counter() - t0)
                baseline_ms = 0.0
                seeds = iter(seeds[1:])
            else:
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

        with spans.span("probe.hbm_write.timed"):
            # each fill's output is dropped as it is queued: the caching
            # allocator hands its block to the next fill in stream order
            def run(timer):
                return kernels.fill(next(seeds), num_blocks, repeats, timer=timer)

            if queued:
                timers = _queued_timers(run, first, iters)
            else:
                per_exec = _fenced_ms(run, iters)

        with spans.span("probe.hbm_write.verify"):
            # verify the first buffer (every pass writes the same seed-0 pattern)
            # rather than re-running the multi-pass writer
            if corrupt_hook is not None:
                y = corrupt_hook(y)
            sums = kernels.blocksums(y)

            expected = np.arange(1, num_blocks + 1, dtype=np.float64) * WRITE_BLOCK_ELEMS
            with spans.sync():  # on the card the stage's one wait
                got = carry.from_port(sums).astype(np.float64).reshape(-1)
            if queued:
                first.read()  # gives its events back
                per_exec = [t.read() for t in timers]
            # block sums are v * 2^17 with small integer v, exact in f32; the
            # tolerance only absorbs reduction-order effects
            bad = np.nonzero(np.abs(got - expected) > 1e-5 * expected)[0]
        pass_ms, pass_min_ms, unreliable = _per_pass(per_exec, baseline_ms, repeats)
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
