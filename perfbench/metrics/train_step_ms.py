"""Milliseconds per training update: the window's length over the updates it
completed (host clock, ending synchronised)."""


def read(run):
    return 1e3 * run.window_s / run.units if run.trace is None else None
