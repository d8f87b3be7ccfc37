"""The write stage's bytes (every fill's buffer x passes, plus the block sums'
read of the kept buffer) over 3.35 TB/s, as a share of the device time of what
``probe.agent.run_hbm_write_probe`` launched."""

from portbench.peaks import HBM_BYTES_PER_S
from portbench.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "probe.agent.run_hbm_write_probe", "bytes", HBM_BYTES_PER_S)
