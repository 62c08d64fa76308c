"""The hand adjoint's least time per launch at the cell's shapes over its
device time per launch in the trace (its kernel and the sum of its blocks'
partials)."""

from perfbench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "fused_rk4_bwd_kernel")
