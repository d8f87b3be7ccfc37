"""The GEMM stage's work outside its timed launches, each cycle: the mean
``probe.mxu.setup`` span (operands drawn, the eager warm-up chain, its fence
and finiteness check, the CUDA graph's capture), in ms per cycle."""

from portbench.program_spans import per_cycle


def read(obs):
    return per_cycle(obs, lambda c: sum(s.ms for s in c.named("probe.mxu.setup")))
