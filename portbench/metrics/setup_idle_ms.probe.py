"""The device's idle time inside the stages' set-up, each cycle: over the
outermost ``probe.<stage>.setup`` spans of every stage, each span's length
less the time the device was busy inside it (the union of every device
operation's interval), in ms per cycle. Program spans and the device trace on
one clock; None without a device trace."""

from portbench.program_spans import outermost_setups, per_cycle


def read(obs):
    trace = obs.get("device_trace")
    if trace is None:
        return None
    return per_cycle(obs, lambda c: 1e3 * sum(
        (s.end - s.start) - trace.busy_s(s.start, s.end) for s in outermost_setups(c)))
