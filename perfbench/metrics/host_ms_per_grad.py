"""Host time per gradient call of all chains: the traced window less the
card's busy time, over the gradient calls the benchmark's wrapper counted."""


def read(run):
    if run.trace is None or not run.trace.counters.get("grad_calls"):
        return None
    return 1e3 * (run.trace.window_s - run.trace.busy_s) / run.trace.counters["grad_calls"]
