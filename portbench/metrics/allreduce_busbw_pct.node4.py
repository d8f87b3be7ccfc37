"""The bandwidth all-reduce's bus bandwidth on rank 0 as a share of the
link's peak: 2 (n - 1) / n x the payload x the timed launches (the cycle
plan's, ``portbench.reference.ranks``), over the device time of the NCCL
kernels launched inside the window's ``probe.ici.bandwidth`` spans, divided
by the per-direction peak of one link between two of the cards.

The peak: NVIDIA's H100 SXM data sheet gives 900 GB/s of NVLink 4 bandwidth
a card, both directions together: 450 GB/s each way. On the four-card machine
``nvidia-smi nvlink --status`` reads 18 links at 26.562 GB/s on a card (478
GB/s, the links' signalling rate); ``nvidia-smi topo -m`` does not run there.
The ring algorithm moves 2 (n - 1) / n of the payload over each link in each
direction, so the share cannot pass 100%; a reading above 105% means the
bytes are counted too high or the kernels' time is cut short. The int32
all-reduce ahead of each timed launch (its barrier) is not counted."""

from portbench.devtrace import union_s
from portbench.program_spans import cycles
from portbench.spans import Range

NVLINK_BYTES_PER_S = 450e9


def read(obs):
    from portbench.reference.ranks import BANDWIDTH_ITERS, CollectivePlan

    trace, plan = obs.get("device_trace"), obs.get("collective_plan")
    spans = [s for c in cycles(obs) for s in c.named("probe.ici.bandwidth")]
    if trace is None or plan is None or not spans:
        return None
    ranges = [Range(s.name, s.thread, s.start, s.end) for s in spans]
    thread = trace.by_thread(ranges)
    # the payload's all-reduce (bfloat16), not the int32 barrier ahead of each timed launch
    device_s = sum(union_s([op for op in trace.ops_of(r, thread) if "nccl" in op[2].lower() and "bf16" in op[2]])
                   for r in ranges)
    if device_s <= 0:
        return None
    moved = CollectivePlan(plan["n"]).bandwidth_bus_bytes(plan["payload_bytes"]) * BANDWIDTH_ITERS * len(ranges)
    return 100.0 * moved / NVLINK_BYTES_PER_S / device_s
