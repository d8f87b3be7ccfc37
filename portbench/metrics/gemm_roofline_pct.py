"""The GEMM stage's operations (2 n^3 x inner_iters for each graph launch it
makes) over 989 TFLOP/s (bf16, dense), as a share of the device time of what
``probe.agent.run_mxu_probe`` launched."""

from portbench.peaks import BF16_FLOPS_PER_S
from portbench.readers import roofline_pct


def read(obs):
    return roofline_pct(obs, "probe.agent.run_mxu_probe", "flops", BF16_FLOPS_PER_S)
