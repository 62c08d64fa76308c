"""The program's host time outside its blocking reads, per unit: the
top-level `hode.*` spans less the `hode.sync.*` spans inside them (a unit is
a step, a cohort, or for NUTS a gradient call as the driver counts it)."""

from perfbench.span_log import dispatch_ns, spans_of, units


def read(run):
    spans = spans_of(run)
    n = units(run) if spans else 0
    return 1e-6 * dispatch_ns(spans) / n if n else None
