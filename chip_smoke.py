#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of the probe plane on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one H100, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch
built for CUDA. Imports nothing of JAX or of ``k8s_watcher_tpu``.

Phases, each fatal on failure (exit code 1, no result line):

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: the CUDA kernels of ``k8s_watcher_tpu_torch/csrc`` with ``nvcc``,
   printing ``-Xptxas -v`` (registers, spills);
3. each kernel against its plain PyTorch version on the card at the
   production size (256 MiB buffers);
4. the main path: one ``ProbeAgent.run_once()`` on CUDA with the
   ``production`` environment's probe settings as they are (the per-link
   walk on: no link on one card), which must be healthy, must have launched
   every kernel, and must read no rate above the card's published peak;
5. one cycle with the multislice probe on (one slice: no pairs);
6. the loop: ``ProbeAgent.start()`` at a 1 s interval for 5 cycles, then
   ``stop()``; every cycle healthy, one heartbeat per cycle, every kernel
   launched in every cycle; the first and the median steady-state cycle's
   ``duration_ms`` are printed;
7. each kernel's time beside its bound, its plain version's and one
   PyTorch library call's, at the main path's shapes.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: HBM3 rate, bf16 tensor-core and f32 rates
HBM_BYTES_PER_S = 3.35e12
BF16_TFLOPS = 989.0
F32_FLOPS_PER_S = 67e12
# a reading above peak by more than this means work was dropped
PEAK_SLACK = 1.05
MIB = 1 << 20
LOOP_CYCLES = 5
SOURCE = "k8s_watcher_tpu_torch/csrc/hbm.cu"


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, warm: int = 2, n: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``n`` warm back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def bound(bytes_moved: float, f32_ops: float):
    """(least ms, what bounds it) from bytes over HBM rate and ops over peak."""
    by_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    by_ops = 1e3 * f32_ops / F32_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    sys.path.insert(0, REPO)
    try:
        from k8s_watcher_tpu_torch.config import load_config
        from k8s_watcher_tpu_torch.kernels import build
        from k8s_watcher_tpu_torch.kernels import hbm as K
        from k8s_watcher_tpu_torch.probe.agent import ProbeAgent
        from k8s_watcher_tpu_torch.probe.ici import mxu_chain
    except ImportError as exc:
        fail(f"the port's package is not importable beside this script: {exc}")

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"device: {name} (count {count})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi_line}")
    power_limit = smi_line.split(",")[-1].strip()

    # 2. build
    lib_path = build.build()
    build.load()
    print(f"built {os.path.relpath(lib_path, REPO)}")
    print(build.build_log.strip() or "(library reused: no build output)")

    # 3. kernels against their plain versions at 256 MiB
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = 256 * MIB // K.BYTES_PER_BLOCK * K.BLOCK_ROWS
    x = torch.randint(0, 4, (rows, K.WIDTH), generator=gen, device=dev).to(torch.float32)
    got, want = K.read_sweep(x, 2), K.read_sweep_plain(x, 2)
    read_err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        fail(f"read_sweep differs from read_sweep_plain (max abs err {read_err})")
    num_blocks = 256 * MIB // K.WRITE_BYTES_PER_BLOCK
    seed3 = torch.full((1, 1), 3.0, device=dev)
    got, want = K.fill(seed3, num_blocks, 2), K.fill_plain(seed3, num_blocks, 2)
    fill_err = (got - want).abs().max().item()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"fill is not bitwise equal to fill_plain (max abs err {fill_err})")
    y = K.fill_plain(torch.zeros((1, 1), device=dev), num_blocks, 1)
    corrupted = [5, 200, num_blocks - 1]
    y.view(num_blocks, -1)[corrupted, 17] += 1e6
    got, want = K.blocksums(y), K.blocksums_plain(y)
    torch.cuda.synchronize()
    sums_err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        fail(f"blocksums differs from blocksums_plain beyond rel 1e-5 (max abs err {sums_err})")
    expected = torch.arange(1, num_blocks + 1, device=dev, dtype=torch.float64) * K.WRITE_BLOCK_ELEMS

    def bad(sums):
        return torch.nonzero((sums.double().view(-1) - expected).abs() > 1e-5 * expected).view(-1).tolist()

    if bad(got) != corrupted or bad(want) != corrupted:
        fail(f"bad blocks: kernel {bad(got)}, plain {bad(want)}, corrupted {corrupted}")
    print(f"kernels match plain versions at 256 MiB: read_sweep exact, fill bitwise, "
          f"blocksums max abs err {sums_err} with bad blocks {corrupted}")
    del x, got, want, y

    # 4. the main path: the production settings as they are
    config = load_config("production", os.path.join(REPO, "config"))
    if not config.probe_links_enabled:
        fail("the production settings no longer enable the per-link walk")
    build.reset_launch_counts()
    report = ProbeAgent(config, environment="production", sink=lambda n: None, device=dev).run_once()
    launches = build.launch_counts()
    payload = report.to_payload()
    ici, mxu, hbm, hbm_w, links = (payload[k] for k in ("ici", "mxu", "hbm", "hbm_write", "links"))
    readings = {
        "healthy": report.healthy,
        "psum_rtt_ms": ici["psum_rtt_ms"],
        "psum_correct": ici["psum_correct"],
        "mxu_tflops_median": mxu.get("tflops_median"),
        "hbm_read_gbps": hbm.get("read_gbps"),
        "hbm_write_gbps": hbm_w.get("write_gbps"),
        "hbm_bytes": hbm.get("bytes"),
        "repeats": hbm.get("repeats"),
        "bad_block_count": hbm_w.get("bad_block_count"),
        "links": links and {k: links[k] for k in ("ok", "n_links", "n_observed", "compile_ms", "error")},
        "duration_ms": payload["duration_ms"],
        # first call of each sub-probe: includes NCCL and library set-up
        "first_call_ms": {"ici": ici["compile_ms"], "hbm": hbm.get("compile_ms"),
                          "hbm_write": hbm_w.get("compile_ms")},
        "mxu_time_median_ms": mxu.get("time_median_ms"),
        "hbm_pass_ms": hbm.get("time_ms"),
        "hbm_write_pass_ms": hbm_w.get("time_ms"),
        "launches": launches,
    }
    print("main path readings: " + json.dumps(readings))
    for part, sub in (("ici", ici), ("mxu", mxu), ("hbm", hbm), ("hbm_write", hbm_w), ("links", links)):
        if not sub or not sub.get("ok") or sub.get("error"):
            fail(f"{part} probe not ok: {sub}")
    if links["n_links"] != 0 or links["n_observed"] != 0:
        fail(f"a one-card grid has no link, but the walk measured {links['n_observed']}")
    if not report.healthy:
        fail(f"the cycle is unhealthy: devices {payload['devices']}, trend {payload['trend_alerts']}")
    for part, sub in (("hbm", hbm), ("hbm_write", hbm_w)):
        if sub["interpreted"] is not False or sub["bandwidth_unreliable"] is not False:
            fail(f"{part}: interpreted={sub['interpreted']} bandwidth_unreliable={sub['bandwidth_unreliable']}")
        if sub["bytes"] != 256 * MIB or sub["repeats"] != 128:
            fail(f"{part} did not run at the production size: {sub['bytes']} bytes x {sub['repeats']}")
    for kernel, n in launches.items():
        if n <= 0:
            fail(f"kernel {kernel} was not launched by the main path")
    peak_gbps = HBM_BYTES_PER_S / 1e9 * PEAK_SLACK
    if hbm["read_gbps"] > peak_gbps or hbm_w["write_gbps"] > peak_gbps:
        fail(f"HBM reading above the card's peak: read {hbm['read_gbps']}, write {hbm_w['write_gbps']} GB/s")
    if mxu["tflops_median"] > BF16_TFLOPS * PEAK_SLACK:
        fail(f"MXU reading above the card's bf16 peak: {mxu['tflops_median']} TFLOP/s")

    # the GEMM chain on the card against the same chain on the CPU
    a = torch.randn((256, 256), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    b = torch.randn((256, 256), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    on_card = mxu_chain(a.to(dev), b.to(dev), 8, 1 / 16).float().cpu()
    on_cpu = mxu_chain(a, b, 8, 1 / 16).float()
    # bf16 rounds the product at each of 8 steps; sums run in another order
    rel = ((on_card - on_cpu).norm() / on_cpu.norm()).item()
    if not rel < 2e-2:
        fail(f"GEMM chain on the card differs from the CPU chain: relative error {rel}")
    print(f"GEMM chain card vs CPU: relative error {rel}")

    # 5. one cycle with the multislice probe on: one card is one slice
    build.reset_launch_counts()
    ms_report = ProbeAgent(dataclasses.replace(config, probe_multislice_enabled=True),
                           environment="production", sink=lambda n: None, device=dev).run_once()
    ms_launches = build.launch_counts()
    ms = ms_report.to_payload()["multislice"]
    print("multislice cycle: " + json.dumps({
        "healthy": ms_report.healthy, "duration_ms": ms_report.duration_ms, "launches": ms_launches,
        **{k: ms[k] for k in ("ok", "n_slices", "per_slice_sums", "ici_rtt_ms", "total_rtt_ms",
                              "dcn_overhead_ms", "compile_ms", "pair_rtts", "error")},
    }))
    if not ms["ok"] or ms["error"] or ms["n_slices"] != 1 or ms["pair_rtts"] or ms["per_slice_sums"] != [1.0]:
        fail(f"multislice probe on one card: {ms}")
    if not ms_report.healthy or min(ms_launches.values()) <= 0:
        fail(f"multislice cycle: healthy={ms_report.healthy}, launches {ms_launches}")

    # 6. the loop: LOOP_CYCLES cycles at a 1 s interval
    cycles, beats = [], []
    enough = threading.Event()

    def observe(cycle_report):
        # on the agent thread, after the cycle's heartbeat: the launches since
        # the last cycle are this cycle's
        counts = build.launch_counts()
        since = {k: counts[k] - sum(c["launches"][k] for c in cycles) for k in counts}
        cycles.append({"healthy": cycle_report.healthy, "duration_ms": cycle_report.duration_ms,
                       "launches": since})
        if len(cycles) >= LOOP_CYCLES:
            enough.set()

    loop_agent = ProbeAgent(dataclasses.replace(config, probe_interval_seconds=1.0), environment="production",
                            sink=lambda n: None, device=dev, heartbeat=lambda: beats.append(1))
    loop_agent.report_observer = observe
    build.reset_launch_counts()
    loop_agent.start()
    thread = loop_agent._thread
    finished = enough.wait(120)
    loop_agent.stop()
    if not finished or thread.is_alive():
        fail(f"the loop ran {len(cycles)} of {LOOP_CYCLES} cycles in 120 s (thread alive: {thread.is_alive()})")
    errors = loop_agent.metrics.counter("probe_errors").value
    print("loop cycles: " + json.dumps({"cycles": cycles, "heartbeats": len(beats), "probe_errors": errors}))
    if len(beats) != len(cycles) or errors:
        fail(f"{len(beats)} heartbeats and {errors} failed cycles for {len(cycles)} cycles")
    for n, cycle in enumerate(cycles):
        if not cycle["healthy"] or min(cycle["launches"].values()) <= 0:
            fail(f"loop cycle {n}: healthy={cycle['healthy']}, launches {cycle['launches']}")
    steady_ms = statistics.median(c["duration_ms"] for c in cycles)
    print(json.dumps({
        "first_cycle_duration_ms": payload["duration_ms"],
        "steady_cycle_duration_ms_median": steady_ms,
        "steady_cycle_duration_ms": [c["duration_ms"] for c in cycles],
        "link_walk_compile_ms": links["compile_ms"],
        "device": name, "power_limit": power_limit,
    }))

    # 7. times at the main path's shapes
    repeats = hbm["repeats"]
    x = torch.ones((rows, K.WIDTH), dtype=torch.float32, device=dev)
    y = K.fill_plain(torch.zeros((1, 1), device=dev), num_blocks, 1)
    buf = 256 * MIB

    def library_read():
        for _ in range(repeats):
            x.sum(0, keepdim=True)

    column = torch.arange(1, num_blocks + 1, dtype=torch.float32, device=dev)[:, None] + 3.0
    out = torch.empty((num_blocks, K.WRITE_BLOCK_ELEMS), dtype=torch.float32, device=dev)

    def library_fill():
        for _ in range(repeats):
            out.copy_(column.expand(num_blocks, K.WRITE_BLOCK_ELEMS))

    specs = [
        ("read_sweep", "k8s_watcher_tpu/probe/hbm.py:74 (_reduce_kernel; pallas_call :95)",
         lambda: K.read_sweep(x, repeats), lambda: K.read_sweep_plain(x, repeats), library_read,
         bound(buf * repeats + 4 * K.WIDTH, buf // 4 * repeats), read_err, 5),
        ("fill", "k8s_watcher_tpu/probe/hbm.py:107 (_fill_kernel; pallas_call :135)",
         lambda: K.fill(seed3, num_blocks, repeats), lambda: K.fill_plain(seed3, num_blocks, repeats),
         library_fill, bound(buf * repeats + 4, buf // 4 * repeats), fill_err, 5),
        ("blocksums", "k8s_watcher_tpu/probe/hbm.py:117 (_blocksum_kernel; pallas_call :145)",
         lambda: K.blocksums(y), lambda: K.blocksums_plain(y),
         lambda: y.view(num_blocks, -1).sum(1), bound(buf + 4 * num_blocks, buf // 4), sums_err, 50),
    ]
    kernels = []
    for kname, replaces, kernel_fn, plain_fn, library_fn, (bound_ms, bound_by), err, n in specs:
        kernel_ms = cuda_ms(torch, kernel_fn, n=n)
        plain_ms = cuda_ms(torch, plain_fn, n=max(3, n // 2))
        library_ms = cuda_ms(torch, library_fn, n=max(3, n // 2))
        print(json.dumps({
            "kernel": kname, "kernel_ms": kernel_ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "launches_per_cycle": launches[kname],
            "device": name, "power_limit": power_limit,
        }))
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })

    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
