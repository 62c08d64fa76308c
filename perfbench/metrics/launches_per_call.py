"""Device operations (kernels, copies, sets) in the trace per cohort."""


def read(run):
    if run.trace is None or run.trace.units == 0:
        return None
    return run.trace.launches / run.trace.units
