"""The link walk on rank 0, each cycle: the mean ``probe.links`` span (the
agreement that every link is prepared, the warm and timed exchanges of the
two links that touch the rank, the all-gather of every rank's records and the
classification of the merged walk), in ms per cycle."""

from portbench.program_spans import per_cycle


def read(obs):
    return per_cycle(obs, lambda c: sum(s.ms for s in c.named("probe.links")) or None)
