"""Gradient evaluations of the log posterior per second, summed over chains:
the calls the benchmark's wrapper counted in the window times the chains,
over the window's length (host clock, ending synchronised)."""


def read(run):
    return run.attempted / run.window_s if run.trace is None else None
