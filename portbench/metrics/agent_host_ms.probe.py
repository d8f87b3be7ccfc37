"""A probe cycle's wall time less the time the device was busy inside it
(the union of every device operation's interval), the mean over the window's
cycles: the agent's host work between and around its kernels."""

from portbench.readers import ranges_in_window


def read(obs):
    trace = obs.get("device_trace")
    cycles = ranges_in_window(obs, "probe.cycle")
    if trace is None or not cycles:
        return None
    return 1e3 * sum((c.t1 - c.t0) - trace.busy_s(c.t0, c.t1) for c in cycles) / len(cycles)
