"""Shared arithmetic of the metric readers (`perfbench/metrics/<name>.py`).

A reader takes a finished run and returns its metric's value, or None where
the run holds nothing to read: then the metric is left out of the line.
"""

from __future__ import annotations

# device operations that belong to a kernel's function: the hand adjoint
# sums its blocks' weight-cotangent partials in a second kernel
PARTS = {"fused_rk4_bwd_kernel": ("sum_rows",)}
COUNTERS = {"fused_rk4_fwd_kernel": "fused_rk4_fwd_launches",
            "fused_rk4_bwd_kernel": "fused_rk4_bwd_launches"}


def roofline_pct(run, kernel: str):
    """The kernel's least time per launch (flops.bound at the cell's shapes)
    over its device time per launch in the trace, in %. None where the
    trace holds no launch of it, or where its launches in the trace differ
    from the program's launch counter over the same units."""
    trace = run.trace
    bound_s = run.workload.kernel_bounds.get(kernel)
    if trace is None or bound_s is None:
        return None
    seconds, launches = trace.kernel(kernel)
    counted = trace.counters.get(COUNTERS.get(kernel))
    if launches == 0 or (counted is not None and counted != launches):
        return None
    for part in PARTS.get(kernel, ()):
        seconds += trace.kernel(part)[0]
    return 100.0 * bound_s * launches / seconds
