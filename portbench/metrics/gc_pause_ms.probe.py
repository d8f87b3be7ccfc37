"""The interpreter's garbage collections during each cycle, on any thread of
the process (each holds the probe thread through the interpreter lock): the
cycle counters' GC ms over every generation, in ms per cycle."""

from portbench.program_spans import per_cycle


def read(obs):
    return per_cycle(obs, lambda c: c.gc_ms())
