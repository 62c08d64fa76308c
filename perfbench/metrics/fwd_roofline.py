"""The forward kernel's least time per launch at the cell's shapes over its
device time per launch in the trace."""

from perfbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "fused_rk4_fwd_kernel")
