"""The watch events the watcher took off its streams in the window (the
``watch_events`` counter: each one parsed, and each one the prefilter dropped
unparsed), over the window's seconds; None where no batch stamped the count
in the window."""

from portbench.watcher_spans import kept


def read(obs):
    found = kept(obs)
    if not found or not any(s.name == "watch.batch" for s in found[0]):
        return None
    w0, w1 = obs["window"]
    return found[1] / (w1 - w0)
