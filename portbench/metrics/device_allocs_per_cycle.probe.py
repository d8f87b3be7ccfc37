"""Device allocations each cycle: the change in the CUDA caching allocator's
``num_device_alloc`` across the cycle (``cudaMalloc`` and ``cuMemMap`` calls,
not allocations the cache served), the mean over the window's cycles. None
off CUDA, where the program counts none."""

from portbench.program_spans import per_cycle


def read(obs):
    return per_cycle(obs, lambda c: c.counters.get("device_allocs"))
