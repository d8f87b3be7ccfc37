"""One egress POST to the notification sink, per item or batched, the probe's
reports among them: the mean ``notify.post`` span in the window, in ms."""

from portbench.watcher_spans import mean_ms


def read(obs):
    return mean_ms(obs, "notify.post")
