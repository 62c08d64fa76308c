"""The NUTS loop's leapfrogs of chains still building their tree over all
the leapfrogs it evaluated, in %: 100 x sum(chain_leapfrogs) /
sum(iterations x chains) over the `hode.nuts.transition` spans."""

from perfbench.span_log import attr_sum, spans_of


def read(run):
    spans = spans_of(run)
    if not spans:
        return None
    name = "hode.nuts.transition"
    total = attr_sum(spans, name, lambda a: a.get("iterations", 0) * a.get("chains", 0))
    used = attr_sum(spans, name, lambda a: a.get("chain_leapfrogs", 0))
    return 100.0 * used / total if total else None
