"""Simulated windows per second: every window of the units that the window
completed, over the window's length (host clock, ending synchronised).
`sim_windows_per_s.eager`, the eager adaptive path's, reads the same: it is
a metric of its own only for its bound, its runs spreading several times
more than the fused path's."""


def read(run):
    return run.attempted / run.window_s if run.trace is None else None
