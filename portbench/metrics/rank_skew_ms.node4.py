"""What a straggler costs the group at its first barrier: for each of rank
0's cycles in the window, the latest rank's ``probe.ici`` start less the
earliest rank's, the mean over those cycles, in ms. Every rank's spans are
on the host's ``time.monotonic()``, one clock for the processes of one host.
A rank's cycle is the one whose ``probe.ici`` starts nearest rank 0's (the
ranks' cycles run in step: each stage is a collective). None where a rank
kept no such span."""

from portbench.program_spans import cycles


def read(obs):
    others = obs.get("rank_cycles")
    mine = cycles(obs)
    if not others or not mine or any(not r for r in others):
        return None
    skews = []
    for c in mine:
        ici = c.named("probe.ici")
        if not ici:
            return None
        starts = [ici[0].start]
        for rank in others:
            near = min((x["ici_start"] for x in rank if x.get("ici_start") is not None),
                       key=lambda t: abs(t - starts[0]), default=None)
            if near is None or not c.start - 1.0 <= near <= c.end:
                return None
            starts.append(near)
        skews.append(max(starts) - min(starts))
    return 1e3 * sum(skews) / len(skews)
