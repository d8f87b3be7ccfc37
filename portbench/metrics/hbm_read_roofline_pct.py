"""The read stage's bytes (its report's buffer x passes, each sweep's output,
and the buffer's one fill) over 3.35 TB/s, as a share of the device time of
what ``probe.agent.run_hbm_probe`` launched."""

from portbench.peaks import HBM_BYTES_PER_S
from portbench.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "probe.agent.run_hbm_probe", "bytes", HBM_BYTES_PER_S)
