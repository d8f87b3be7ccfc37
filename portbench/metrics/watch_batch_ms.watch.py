"""One ingest batch through the watcher's pipeline (filters, phase and slice
trackers, payloads, the view) to its egress lanes: the mean ``watch.batch``
span in the window, in ms."""

from portbench.watcher_spans import mean_ms


def read(obs):
    return mean_ms(obs, "watch.batch")
