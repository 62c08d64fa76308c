"""Device operations in the trace per batched field evaluation of the
adaptive solver (`hode.solve.field` spans): amortised, the step controller's
launches included."""

from perfbench.span_log import spans_of


def read(run):
    spans = spans_of(run)
    n = sum(s.name == "hode.solve.field" for s in spans) if spans else 0
    return run.trace.launches / n if n else None
