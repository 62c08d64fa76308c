"""The whole step's share of the card's f32 peak: the operations that the
profiled units needed (perfbench/flops.py) over the traced window, in %."""

from perfbench.flops import PEAK_F32_FLOPS


def read(run):
    if run.trace is None:
        return None
    ops = run.workload.ops(run.trace.units, run.trace.counters)
    if not ops:
        return None
    return 100.0 * ops / run.trace.window_s / PEAK_F32_FLOPS
