"""The share of the traced window with no operation on the device."""

from portbench.readers import idle_pct


def read(obs):
    return idle_pct(obs)
